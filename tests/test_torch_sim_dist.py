"""Port parity, end to end, distributed directory: the
``tests/test_equivalence.py`` cases with ``centralized_directory=False``
(see ``test_torch_sim.py``)."""
import pytest

from test_torch_sim import assert_port_equals_references


@pytest.mark.parametrize("app,seed", [("mgrid", 2), ("random", 3)])
def test_end_to_end_identical_distributed(app, seed):
    got = assert_port_equals_references(
        dict(rows=4, cols=4, addr_bits=14, migrate_threshold=2,
             centralized_directory=False), app, seed)
    assert got["finished"] == 1
