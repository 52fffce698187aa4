"""Port parity of the multi-scenario sweep (``repro_torch.core.sweep``).

On the CPU the port's ``run_sweep`` must give, scenario for scenario,
exactly the statistics dicts of the JAX package's ``run_sweep`` and of
the port's own ``run_sequential`` (one solo ``run`` per scenario): every
counter, the cycle count and the finished flag.  The cases are those of
``tests/test_sweep.py`` at a short memory latency, so each scenario ends
in a few hundred cycles.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import sweep as jsweep
from repro.core.config import SimConfig as JConfig

from repro_torch.core import sweep as tsweep
from repro_torch.core.config import SimConfig as TConfig

torch.set_num_threads(1)

#: one structural config, batch size, trace length and chunk for every
#: JAX sweep in the file: JAX compiles one program per (config, B, M,
#: chunk), about 20 s each on the CPU, so the cases share one
KW = dict(rows=4, cols=4, addr_bits=14, mem_cycles=8, migrate_threshold=2,
          centralized_directory=False)
B, M, CHUNK = 4, 6, 8


def specs(scenarios, **cfg_kw):
    """The same sweep in both packages: (JAX spec, port spec)."""
    kw = {**KW, **cfg_kw}
    return (jsweep.SweepSpec(JConfig(**kw), tuple(
                jsweep.ScenarioSpec(**dataclasses.asdict(s))
                for s in scenarios)),
            tsweep.SweepSpec(TConfig(**kw), tuple(scenarios)))


def diff(want, got):
    return [{k: (w.get(k), g.get(k)) for k in set(w) | set(g)
             if w.get(k) != g.get(k)} for w, g in zip(want, got)]


def assert_sweep_parity(scenarios, sequential=True, **cfg_kw):
    """The port's ``run_sweep`` (CPU) on ``KW`` + ``cfg_kw`` equals JAX
    ``run_sweep`` on ``KW`` (a storage layout changes no result) and, if
    ``sequential``, the port's ``run_sequential``; returns its stats."""
    assert len(scenarios) == B and max(s.refs_per_core
                                       for s in scenarios) == M
    jspec, tspec = specs(scenarios, **cfg_kw)
    got = tsweep.run_sweep(tspec, chunk=CHUNK, device="cpu")
    want = jsweep.run_sweep(specs(scenarios)[0], chunk=CHUNK)
    assert len(got) == tspec.size
    assert got == want, diff(want, got)
    if sequential:
        seq = tsweep.run_sequential(tspec, chunk=CHUNK, device="cpu")
        assert got == seq, diff(seq, got)
    return got


S = tsweep.ScenarioSpec
APPS_BY_SEEDS = tsweep.SweepSpec.cross(TConfig(**KW), ["matmul", "random"],
                                       [1, 7], refs_per_core=M).scenarios


@pytest.fixture(scope="module")
def apps_by_seeds():
    return assert_sweep_parity(APPS_BY_SEEDS, sequential=False)


def test_spec_traces_and_knobs_equal_the_reference():
    """Stacked traces, knob vectors and resolved configs equal JAX's."""
    scs = (S("matmul", 3, 6, migration_enabled=False),
           S("random", 1, 10, eject_age_threshold=8),
           S("hotspot:frac=0.8,hot=2", 2, 4, centralized_directory=True,
             migrate_threshold=1))
    jspec, tspec = specs(scs)
    assert np.array_equal(tspec.traces(), jspec.traces())
    assert tspec.traces().shape == (3, 16, 10)
    for a, b in zip(tspec.knob_arrays(), jspec.knob_arrays()):
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
    for ts, js in zip(tspec.scenarios, jspec.scenarios):
        assert (dataclasses.asdict(ts.resolve_cfg(tspec.cfg))
                == dataclasses.asdict(js.resolve_cfg(jspec.cfg)))
    cross = tsweep.SweepSpec.cross(tspec.cfg, ["a", "b"], [1, 2], 7)
    assert [(s.app, s.seed, s.refs_per_core) for s in cross.scenarios] == \
        [("a", 1, 7), ("a", 2, 7), ("b", 1, 7), ("b", 2, 7)]
    for b, n in ((1, 1), (4, 1), (4, 8), (3, 2), (0, 4)):
        assert tsweep.scenario_device_count(b, n) == \
            jsweep.scenario_device_count(b, n)


def test_sweep_apps_by_seeds_bit_exact(apps_by_seeds):
    """2 apps x 2 seeds in one batch == JAX's batch of the same four."""
    assert all(g["finished"] for g in apps_by_seeds)
    assert len({g["cycles"] for g in apps_by_seeds}) > 1


def test_sweep_chunked_equals_unchunked(apps_by_seeds):
    _, tspec = specs(APPS_BY_SEEDS)
    assert tsweep.run_sweep(tspec, chunk=1, device="cpu") == apps_by_seeds


def test_sweep_mixed_termination():
    """Scenarios of different lengths share a batch: early finishers stop
    counting bit-exactly while the others keep stepping (chunked)."""
    got = assert_sweep_parity((S("wupwise", 5, 2), S("wupwise", 5, 6),
                               S("apsi", 2, 4), S("equake", 4, 3)),
                              sequential=False)
    assert got[0]["cycles"] < got[1]["cycles"]
    assert all(g["finished"] for g in got)


def test_sweep_policy_knobs():
    """All four per-scenario knobs, with two ejection age thresholds in
    the batch, match solo runs whose config carries the knob."""
    got = assert_sweep_parity((
        S("matmul", 3, M, migration_enabled=False, eject_age_threshold=8),
        S("matmul", 3, M, migrate_threshold=1),
        S("matmul", 3, M, centralized_directory=True),
        S("matmul", 3, M)))
    # the knobs must change behaviour, not just be carried along
    assert len({tuple(sorted(g.items())) for g in got}) > 1
    assert got[0]["migrations"] == 0 < got[1]["migrations"]


def test_sweep_packed_with_unequal_refs():
    """Under the packed layout the trace and ``tr_ptr`` dtypes follow the
    stacked block's padded length, so each scenario equals a packed solo
    run on its padded trace (``run_sequential``) and JAX's batch."""
    got = assert_sweep_parity((S("equake", 1, 2), S("random", 2, M),
                               S("transpose", 0, 3), S("matmul", 6, 5)),
                              state_dtype_policy="packed")
    assert got[0]["cycles"] < got[1]["cycles"]


def test_sweep_rejects_centralized_with_home_layout():
    _, tspec = specs((S("matmul", 0, 4, centralized_directory=True),),
                     dir_layout="home")
    with pytest.raises(ValueError, match="home-sharded directory layout"):
        tsweep.run_sweep(tspec, device="cpu")
    with pytest.raises(ValueError, match="empty sweep"):
        tsweep.SweepSpec(tspec.cfg, ()).validate()


def test_sweep_needs_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    _, tspec = specs((S("matmul", 0, 4),))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsweep.run_sweep(tspec)
