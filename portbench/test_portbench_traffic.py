"""The frozen traffic generators against the port's, and the mixes."""
import dataclasses

import numpy as np
import pytest

from portbench import traffic
from portbench.reference import config as ref_config
from repro_torch.core.config import CacheConfig, SimConfig
from repro_torch.core.workloads import resolve_trace

SOURCES = ["random", "matmul", "apsi", "mgrid", "wupwise", "equake",
           "transpose:0.1", "bitcomp", "tornado:rate=0.5", "neighbor",
           "hotspot:frac=0.8,hot=2", "hotspot:0.3"]
GEOMETRIES = [dict(rows=8, cols=8),
              dict(rows=6, cols=10, cache=dict(l1_sets=128, l1_ways=4,
                                               l1_block=32, l2_sets=512,
                                               l2_ways=8, l2_block=64))]


def both(fields):
    port = dict(fields)
    if "cache" in port:
        port["cache"] = CacheConfig(**port["cache"])
    return ref_config.from_fields(fields), SimConfig(**port)


@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("source", SOURCES)
def test_frozen_generators_equal_the_ports(source, geometry):
    mine, port = both(dict(geometry, centralized_directory=False))
    for seed in (0, 3_000_000_019):
        got = traffic.source_trace(mine, source, 24, seed)
        want = resolve_trace(port, source, 24, seed)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_a_mix_pads_its_scenarios_and_offsets_their_seeds():
    cfg = ref_config.Config(rows=4, cols=4)
    mix = {"entry": "run_sweep", "chunk": 8, "scenarios": [
        {"source": "random", "refs_per_core": 5, "seed_offset": 0,
         "knobs": {}},
        {"source": "matmul", "refs_per_core": 3, "seed_offset": 2,
         "knobs": {"migrate_threshold": 1}}]}
    tr = traffic.make_traces(cfg, mix, 40)
    assert tr.shape == (2, 16, 5)
    np.testing.assert_array_equal(tr[0], traffic.source_trace(cfg, "random",
                                                              5, 40))
    np.testing.assert_array_equal(tr[1, :, :3],
                                  traffic.source_trace(cfg, "matmul", 3, 42))
    assert (tr[1, :, 3:] == -1).all()
    cfgs = traffic.scenario_configs(cfg, mix)
    assert cfgs[0] == cfg
    assert cfgs[1] == dataclasses.replace(cfg, migrate_threshold=1)


@pytest.mark.parametrize("spec", ["nosuch", "random:0.5", "hotspot:hot=x",
                                  "transpose:rate=0.1,rate=0.2",
                                  "hotspot:warm=1"])
def test_a_bad_source_is_refused(spec):
    with pytest.raises(ValueError):
        traffic.parse_source(spec)
