"""Port parity of the execution-plan layer (``repro_torch.core.engine``).

The planner is pure Python and must plan exactly as the JAX package's
``repro.core.engine`` does: the same buckets, backends, grids, notes and
state-byte estimates for every scenario list at every device count,
backend pin and memory budget, and the same errors.  Executing a plan on
the CPU must give the statistics of the port's solo runs and of JAX's
``execute_plan``, bit for bit.
"""
import dataclasses
import json

import pytest
import torch

from repro.core import engine as jengine
from repro.core.config import SimConfig as JConfig

from repro_torch.core import engine as tengine
from repro_torch.core import sim as tsim
from repro_torch.core.config import SimConfig as TConfig
from repro_torch.core.workloads import resolve_trace

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def no_env_budget(monkeypatch):
    monkeypatch.delenv("REPRO_MEM_BUDGET", raising=False)


def both(base_kw, items):
    """The same scenario list in both packages; ``items`` holds
    ``(rows, cols, app, seed, refs, overrides)`` tuples."""
    out = []
    for eng, cfg in ((jengine, JConfig), (tengine, TConfig)):
        base = cfg(**base_kw)
        out.append([eng.make_scenario(base, r, c, app, seed, refs, **ov)
                    for r, c, app, seed, refs, ov in items])
    return out


#: scenario lists to plan: mixed shapes with knob variety, knob-only
#: differences (one bucket), centralized scenarios, unequal refs, meshes
#: big enough for the spatial and composed backends, an indivisible mesh
PLAN_CASES = {
    "mixed-shapes": (dict(addr_bits=15, centralized_directory=False), [
        (4, 4, "matmul", 0, 23, {}),
        (6, 6, "equake", 1, 24, {}),
        (4, 4, "mgrid", 2, 23, dict(migration_enabled=False)),
        (6, 6, "random", 3, 24, dict(migrate_threshold=1)),
        (4, 4, "matmul", 5, 23, dict(centralized_directory=True)),
        (16, 16, "loop:matmul", 0, 20, {}),
        (8, 8, "hotspot:frac=0.8,hot=2", 4, 40, {})]),
    "knobs-one-bucket": (dict(rows=8, cols=8, centralized_directory=False), [
        (None, None, "matmul", 0, 10, {}),
        (None, None, "matmul", 1, 10, dict(migration_enabled=False,
                                           migrate_threshold=2)),
        (None, None, "random", 2, 10, dict(eject_age_threshold=8)),
        (None, None, "equake", 3, 10, dict(centralized_directory=True)),
        # structural changes split
        (8, 16, "matmul", 0, 10, {}),
        (None, None, "matmul", 0, 10, dict(addr_bits=13)),
        (None, None, "matmul", 0, 10, dict(mem_cycles=40)),
        (None, None, "matmul", 0, 10, dict(pc_depth=2))]),
    "centralized": (dict(rows=16, cols=16, centralized_directory=True), [
        (None, None, "matmul", 0, 50, {}),
        (None, None, "apsi", 1, 50, {}),
        (64, 64, "random", 0, 20, {})]),
    "unequal-refs-packed": (dict(rows=32, cols=32, centralized_directory=False,
                                 state_dtype_policy="packed"), [
        (None, None, "matmul", 0, 10, {}),
        (None, None, "random", 1, 200, {}),
        (None, None, "equake", 2, 50, dict(migration_enabled=False))]),
    "big": (dict(centralized_directory=False), [
        (256, 256, "random", 0, 8, {}),
        (208, 208, "random", 0, 8, dict(state_dtype_policy="packed",
                                          dir_layout="home")),
        *[(64, 64, "transpose", s, 30, {}) for s in range(8)],
        (5, 7, "matmul", 0, 10, {})]),
}
NDEVS = (1, 2, 4, 8)
FORCES = (None, "sweep", "sharded", "composed")
BUDGETS = (None, "64M", "2M", "300K")


def plan_or_error(eng, scs, ndev, force, budget):
    try:
        return eng.compile_plan(scs, ndev=ndev, force_backend=force,
                                mem_budget=eng.parse_mem_budget(budget)
                                ).describe()
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plans_describe_themselves_as_the_reference(case):
    base_kw, items = PLAN_CASES[case]
    jscs, tscs = both(base_kw, items)
    seen = set()
    for ndev in NDEVS:
        for force in FORCES:
            for budget in BUDGETS:
                want = plan_or_error(jengine, jscs, ndev, force, budget)
                got = plan_or_error(tengine, tscs, ndev, force, budget)
                assert got == want, (ndev, force, budget)
                seen.add(want[0] if isinstance(want, tuple) else
                         tuple(b["backend"] for b in want["buckets"]))
    # the table reaches more than one outcome per case
    assert len(seen) > 1, seen


def test_table_reaches_every_backend_note_and_the_budget_error():
    """The plan table above covers every backend, every kind of note and
    the over-budget error, so its equality means something."""
    notes, backends, errors = [], set(), []
    for base_kw, items in PLAN_CASES.values():
        _, tscs = both(base_kw, items)
        for ndev in NDEVS:
            for force in FORCES:
                for budget in BUDGETS:
                    d = plan_or_error(tengine, tscs, ndev, force, budget)
                    if isinstance(d, tuple):
                        errors.append(d[1])
                        continue
                    backends |= {b["backend"] for b in d["buckets"]}
                    notes += [b.get("note", "") for b in d["buckets"]]
    assert backends == {"sweep", "sharded", "composed"}
    for part in ("forced", "sharded unavailable (batch > 1); fell back",
                 "sharded unavailable (centralized directory)",
                 "sharded unavailable (no device tiling divides",
                 "composed unavailable (centralized directory)",
                 "composed unavailable (no device grid tiles", "cost ",
                 "memory budget excluded"):
        assert any(part in n for n in notes), part
    assert any("over the 300.0K budget; use state_dtype_policy='packed'" in e
               for e in errors)


def test_default_ndev_is_one_device():
    _, tscs = both(dict(rows=256, cols=256, centralized_directory=False),
                   [(None, None, "random", 0, 8, {})])
    plan = tengine.compile_plan(tscs)
    assert plan.ndev == tengine.RUN_DEVICES == 1
    assert plan.buckets[0].backend == "sweep"


def test_state_bytes_equal_the_reference():
    from repro.core.state import state_bytes as jbytes
    from repro_torch.core.state import state_bytes as tbytes
    for base_kw, items in PLAN_CASES.values():
        jscs, tscs = both(base_kw, items)
        for j, t, it in zip(jscs, tscs, items):
            for policy in ("wide", "packed"):
                assert tbytes(t.cfg, it[4], policy) == \
                    jbytes(j.cfg, it[4], policy)


def test_parse_mem_budget_costs_and_grids():
    for text in (None, "", "  ", "512", "512M", "4G", "1.5g", "64k", "2Mi",
                 "3MiB", "1t"):
        assert tengine.parse_mem_budget(text) == \
            jengine.parse_mem_budget(text)
    for bad in ("lots", "-5M", "0"):
        with pytest.raises(ValueError) as te:
            tengine.parse_mem_budget(bad)
        with pytest.raises(ValueError) as je:
            jengine.parse_mem_budget(bad)
        assert str(te.value) == str(je.value)
    for args in (("sweep", 5, 4096, 4), ("sweep", 1, 65536, 1),
                 ("sharded", 1, 65536, 8, (2, 4)), ("sharded", 2, 64, 4),
                 ("composed", 8, 4096, 8, (2, 2, 2)),
                 ("composed", 3, 4096, 8, (4, 1, 2)),
                 ("composed", 3, 4096, 8, (1, 2))):
        assert tengine.backend_cost(*args) == jengine.backend_cost(*args)
    with pytest.raises(ValueError, match="unknown backend"):
        tengine.backend_cost("nope", 1, 1, 1)
    for r, c, n in ((16, 16, 8), (16, 16, 3), (6, 6, 4), (5, 7, 8),
                    (256, 256, 8), (4, 4, 1)):
        assert tengine.choose_tiling(r, c, n) == jengine.choose_tiling(r, c, n)
    tcfg = TConfig(rows=64, cols=64, centralized_directory=False)
    jcfg = JConfig(rows=64, cols=64, centralized_directory=False)
    for batch, ndev, budget in ((8, 8, None), (3, 8, None), (8, 4, 2 << 20),
                                (1, 1, None), (16, 8, 1 << 20)):
        assert tengine.choose_grid(batch, 64, 64, ndev, tcfg, budget, 30) \
            == jengine.choose_grid(batch, 64, 64, ndev, jcfg, budget, 30)
    with pytest.raises(ValueError, match="unknown backend"):
        tengine.choose_backend(tcfg, 1, 1, force="nope")


def test_cost_constants_share_one_file(tmp_path):
    path = str(tmp_path / "cost.json")
    old_t, old_j = tengine.cost_constants(), jengine.cost_constants()
    try:
        c = tengine.CostConstants(halo_overhead=2.0, shard_fixed=100.0,
                                  batch_fixed=7.0)
        tengine.save_cost_constants(path, c, meta={"host": "test"})
        assert jengine.load_cost_constants(path) == jengine.CostConstants(
            2.0, 100.0, 7.0)
        assert tengine.load_cost_constants(path) == c
        assert tengine.cost_constants() == c
        assert tengine.backend_cost("sharded", 1, 4096, 4, (2, 2)) == \
            jengine.backend_cost("sharded", 1, 4096, 4, (2, 2))
    finally:
        tengine.set_cost_constants(old_t)
        jengine.set_cost_constants(old_j)


def test_manifests_load_the_same_scenarios(tmp_path):
    obj = {"base": {"addr_bits": 13, "mem_cycles": 40,
                    "cache": {"l1_sets": 16}},
           "scenarios": [
               {"rows": 4, "cols": 4, "app": "matmul", "seed": 2,
                "refs_per_core": 11},
               {"rows": 8, "cols": 4, "app": "random",
                "migration_enabled": False, "refs": 5},
               {"rows": 6, "cols": 6, "cache": {"l2_ways": 4}}]}
    path = tmp_path / "m.json"
    path.write_text(json.dumps(obj))
    compact = ("4x4:matmul:0:10; 8x8:equake:3, 6x6:hotspot:frac=0.8,hot=2:1:7;"
               "5x5:loop:matmul:2;4X4")
    for src in (obj, json.dumps(obj), obj["scenarios"], str(path), compact):
        base_t = TConfig(addr_bits=14, centralized_directory=False)
        base_j = JConfig(addr_bits=14, centralized_directory=False)
        got = tengine.load_manifest(src, base=base_t)
        want = jengine.load_manifest(src, base=base_j)
        assert [(dataclasses.asdict(s.cfg), s.app, s.seed, s.refs_per_core)
                for s in got] == \
            [(dataclasses.asdict(s.cfg), s.app, s.seed, s.refs_per_core)
             for s in want]
    assert len(tengine.load_manifest(compact)) == 5
    for bad in ({"scenarios": [{"rows": 4, "bogus_key": 1}]},
                {"scenarios": [{"refs": 1, "refs_per_core": 2}]},
                "totally not a manifest", {"scenarios": []},
                "4x4:nosuchapp:0:1"):
        with pytest.raises(ValueError) as te:
            tengine.load_manifest(bad)
        with pytest.raises(ValueError) as je:
            jengine.load_manifest(bad)
        assert str(te.value) == str(je.value)
    with pytest.raises(FileNotFoundError):
        tengine.load_manifest("no/such/manifest.json")


def test_execute_plan_equals_solo_runs_and_the_reference():
    """A 4x4/6x6 plan, planned for 4 devices and forced composed: both
    buckets fall back to the sweep backend on one device; the statistics
    equal the port's solo runs and JAX's ``execute_plan``, in order."""
    base_kw = dict(addr_bits=14, mem_cycles=8, centralized_directory=False)
    items = [(4, 4, "matmul", 0, 4, {}),
             (6, 6, "equake", 1, 3, {}),
             (4, 4, "random", 2, 4, dict(migrate_threshold=1,
                                         eject_age_threshold=8))]
    jscs, tscs = both(base_kw, items)
    tplan = tengine.compile_plan(tscs, ndev=4, force_backend="composed")
    jplan = jengine.compile_plan(jscs, ndev=4, force_backend="composed")
    assert tplan.describe() == jplan.describe()
    assert [b.backend for b in tplan.buckets] == ["composed", "composed"]
    assert [b.batch for b in tplan.buckets] == [2, 1]
    got = tengine.execute_plan(tplan, chunk=8, device="cpu")
    solo = [tsim.run(sc.cfg, resolve_trace(sc.cfg, sc.app, sc.refs_per_core,
                                           sc.seed), chunk=8, device="cpu")
            for sc in tscs]
    assert got == solo
    assert all(g["finished"] for g in got)
    assert got == jengine.execute_plan(jplan, chunk=8)
    assert tengine.plan_and_run(tscs[1:2], chunk=8, device="cpu") == got[1:2]


def test_multi_device_runners_are_not_ported_yet(monkeypatch):
    """The spatial and composed runners are ported
    (``repro_torch.core.sharded``; ``tests/test_torch_composed.py`` runs
    them on ranks): outside a process group of enough ranks they refuse
    the bucket, naming the ranks it needs, unless ``execute_plan``
    degrades it to the sweep backend first, as it does whenever the group
    is too small."""
    _, tscs = both(dict(rows=4, cols=4, centralized_directory=False),
                   [(None, None, "matmul", 0, 4, {})])
    plan = tengine.compile_plan(tscs, ndev=4, force_backend="sharded")
    assert plan.buckets[0].backend == "sharded"
    assert tengine.RUN_DEVICES == tengine.run_devices() == 1
    monkeypatch.setattr(tengine, "run_devices", lambda: 4)
    with pytest.raises(ValueError, match="needs 4 rank"):
        tengine.execute_plan(plan, device="cpu")
    plan = tengine.compile_plan(tscs * 2, ndev=4, force_backend="composed")
    assert plan.buckets[0].backend == "composed"
    with pytest.raises(ValueError, match=r"needs \d rank"):
        tengine.execute_plan(plan, device="cpu")
