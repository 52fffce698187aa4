"""The port's recorder (``repro_torch.tracing``) and the simulator driver's
spans and counters: off it records nothing; on, ``sim.run`` and
``sweep.run_sweep`` give one ``cycle`` span a scenario-cycle with its six
children, one ``step`` and one ``monitor`` a cycle, and ``host_syncs``
one more than the ``check`` spans, with statistics bit-identical to a
run with the recorder off."""
import collections

import pytest
import torch

from repro_torch import tracing
from repro_torch.core import sim, sweep
from repro_torch.core.config import SimConfig
from repro_torch.core.workloads import resolve_trace
from repro_torch.kernels import build, flash_attention, router_phase
from repro_torch.tracing import Recorder, Span, innermost, self_ns

CYCLE_CHILDREN = ["cast", "phase1a", "phase1b", "phase2", "phase3", "cast"]


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def recorder():
    """The process's recorder, on for the test and off and empty after."""
    tracing.RECORDER.drain()
    tracing.RECORDER.start()
    try:
        yield tracing.RECORDER
    finally:
        tracing.RECORDER.stop()
        tracing.RECORDER.drain()


def test_off_records_nothing_and_allocates_no_context():
    rec = Recorder()
    assert rec.span("a") is rec.span("b")
    with rec.span("a"):
        rec.count("n", 3)
    assert rec.drain() == ([], {})


def test_spans_carry_parent_ids_and_the_drivers_position():
    rec = Recorder()
    rec.start()
    rec.at(None, 7)
    with rec.span("step"):
        rec.at(2, 7)
        with rec.span("cycle"):
            with rec.span("phase1a"):
                pass
    spans, _ = rec.drain()
    by = {s.name: s for s in spans}
    assert [s.name for s in spans] == ["phase1a", "cycle", "step"]
    assert by["step"].parent is None
    assert by["cycle"].parent == by["step"].id
    assert by["phase1a"].parent == by["cycle"].id
    assert len({s.id for s in spans}) == 3
    assert (by["step"].scenario, by["step"].cycle) == (None, 7)
    assert (by["cycle"].scenario, by["cycle"].cycle) == (2, 7)
    assert all(s.start_ns <= s.end_ns for s in spans)
    assert by["step"].start_ns <= by["phase1a"].start_ns
    assert by["phase1a"].end_ns <= by["step"].end_ns


def test_self_time_subtracts_the_children():
    spans = [Span("cycle", 0, None, 0, 0, 100, 200),
             Span("cast", 1, 0, 0, 0, 100, 110),
             Span("phase1a", 2, 0, 0, 0, 110, 170),
             Span("cast", 3, 0, 0, 0, 180, 195),
             Span("cycle", 4, None, 0, 1, 300, 310)]
    assert self_ns(spans) == {"cycle": 15 + 10, "cast": 25, "phase1a": 60}


def test_counters_add_while_on_and_drain_empties():
    rec = Recorder()
    rec.count("host_syncs")
    rec.start()
    rec.count("host_syncs")
    rec.count("host_syncs", 2)
    with rec.span("check"):
        pass
    spans, counters = rec.drain()
    assert counters == {"host_syncs": 3} and len(spans) == 1
    assert rec.drain() == ([], {})
    rec.stop()
    rec.count("host_syncs")
    assert rec.drain() == ([], {})


def test_spans_open_across_a_switch_are_dropped():
    rec = Recorder()
    with rec.span("step"):          # opened off: not recorded
        rec.start()
        with rec.span("cycle"):
            pass
    with rec.span("step"):
        with rec.span("cycle"):
            rec.stop()              # closes while off: dropped
    spans, _ = rec.drain()
    assert [(s.name, s.parent) for s in spans] == [("cycle", None)]


def test_innermost_finds_the_deepest_open_span():
    spans = [Span("step", 0, None, None, 0, 0, 100),
             Span("cycle", 1, 0, 0, 0, 10, 60),
             Span("phase2", 2, 1, 0, 0, 20, 30),
             Span("monitor", 3, 0, None, 0, 70, 90)]
    got = innermost(spans, [25, 5, 40, 80, 95, 150, None, 20, 30, 60])
    assert [s.name if s else None for s in got] == [
        "phase2", "step", "cycle", "monitor", "step", None, None, "phase2",
        "phase2", "cycle"]


def test_launch_count_lives_in_tracing():
    assert build.LaunchCount is tracing.LaunchCount
    for c in (router_phase.LAUNCHES, router_phase.ARB_LAUNCHES,
              flash_attention.LAUNCHES, flash_attention.F32_LAUNCHES):
        assert isinstance(c, tracing.LaunchCount)
    c = build.LaunchCount()
    c.n += 2
    c.reset()
    assert c.n == 0


def _check_driver_spans(spans, counters, scenarios, cycles):
    names = collections.Counter(s.name for s in spans)
    assert names["step"] == names["monitor"] == cycles
    assert names["cycle"] == scenarios * cycles
    assert counters["host_syncs"] == names["check"] + 1
    by_id = {s.id: s for s in spans}
    kids = collections.defaultdict(list)
    for s in spans:
        if s.parent is not None:
            kids[s.parent].append(s)
    cyc = [s for s in spans if s.name == "cycle"]
    assert sorted((s.scenario, s.cycle) for s in cyc) == [
        (b, c) for b in range(scenarios) for c in range(cycles)]
    for s in cyc:
        assert [k.name for k in sorted(kids[s.id], key=lambda k: k.start_ns)
                ] == CYCLE_CHILDREN
        assert all((k.scenario, k.cycle) == (s.scenario, s.cycle)
                   for k in kids[s.id])
        step = by_id[s.parent]
        assert step.name == "step" and step.cycle == s.cycle
    for s in spans:
        if s.name == "monitor":
            assert by_id[s.parent].name == "step"
            assert by_id[s.parent].cycle == s.cycle and s.scenario is None
        if s.name in ("step", "check"):
            assert s.parent is None


def test_run_emits_the_drivers_spans_with_equal_statistics(recorder):
    cfg = SimConfig(rows=8, cols=8)
    trace = resolve_trace(cfg, "random", 8, 3)
    on = sim.run(cfg, trace, max_cycles=20, chunk=8, device="cpu")
    spans, counters = recorder.drain()
    recorder.stop()
    off = sim.run(cfg, trace, max_cycles=20, chunk=8, device="cpu")
    assert on == off and recorder.drain() == ([], {})
    _check_driver_spans(spans, counters, 1, 20)
    # two whole chunks, then the tail's four cycles, each checked
    assert counters["host_syncs"] == 1 + 2 + 4


def test_run_sweep_emits_the_drivers_spans_with_equal_statistics(recorder):
    cfg = SimConfig(rows=8, cols=8)
    spec = sweep.SweepSpec(cfg, (
        sweep.ScenarioSpec("random", 1, 8),
        sweep.ScenarioSpec("random", 2, 8, migration_enabled=False)))
    on = sweep.run_sweep(spec, max_cycles=12, chunk=4, device="cpu")
    spans, counters = recorder.drain()
    recorder.stop()
    off = sweep.run_sweep(spec, max_cycles=12, chunk=4, device="cpu")
    assert on == off
    _check_driver_spans(spans, counters, 2, 12)
    assert counters["host_syncs"] == 1 + 3
