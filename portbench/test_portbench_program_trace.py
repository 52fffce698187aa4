"""``program_trace.py``: the program's spans joined with a device trace.
Made-up launch records and device operations with correlation ids land
in the right span; a rehearsal on the CPU reads the host-span and
counter metrics and no launch metric; (marked ``gpu``) on the card every
launch of the fused Phase-2 kernel falls in a ``phase2`` span and the
launches by span add up to the trace's operations."""
import json
import os
import subprocess
import sys

import pytest
import torch
from torch.autograd import DeviceType

from portbench import bench, program_trace as pt_mod
from repro_torch.tracing import Span

RUN = [sys.executable, os.path.join(str(bench.HERE), "program_trace.py")]
ENV = dict(os.environ, OMP_NUM_THREADS="1")
LAUNCH_METRICS = ("phase1a_launches", "phase1b_launches", "phase3_launches",
                  "cast_launches")
HOST_METRICS = ("cast_host_ms", "monitor_host_ms", "host_syncs_per_cycle")


def _cycle(sid: int, scenario: int, cycle: int, t: int):
    """A ``cycle`` span at ``t`` (its parent ``sid - 1``) and its six
    children, 100 ns each from ``t``."""
    names = ["cast", "phase1a", "phase1b", "phase2", "phase3", "cast"]
    kids = [Span(n, sid + 1 + i, sid, scenario, cycle, t + 100 * i,
                 t + 100 * (i + 1)) for i, n in enumerate(names)]
    return [Span("cycle", sid, sid - 1, scenario, cycle, t, t + 600)] + kids


def _synthetic():
    """Two steps of one scenario: ``step`` 0-1000, its cycle 0-600,
    ``monitor`` 700-900; a ``check`` 1000-1050; ``step`` 2000-3000."""
    spans = ([Span("step", 0, None, None, 0, 0, 1000)] + _cycle(1, 0, 0, 0)
             + [Span("monitor", 8, 0, None, 0, 700, 900),
                Span("check", 9, None, None, 1, 1000, 1050),
                Span("step", 10, None, None, 1, 2000, 3000)]
             + _cycle(11, 0, 1, 2000)
             + [Span("monitor", 18, 10, None, 1, 2700, 2900)])
    # (name, device start, device end, launch instant)
    ops = [("k_a", 50, 60, 50),           # cast at entry
           ("k_b", 150, 160, 150),        # phase1a
           ("k_c", 160, 170, 199),        # phase1a, at its end
           ("k_d", 260, 270, 250),        # phase1b
           ("phase2_router_kernel", 360, 380, 350),
           ("k_e", 450, 460, 450),        # phase3
           ("k_f", 550, 560, 550),        # cast at exit
           ("k_g", 800, 810, 800),        # monitor
           ("k_h", 1020, 1030, 1020),     # check
           ("k_i", 1500, 1510, 1500),     # outside every span
           ("k_j", 1600, 1610, None),     # no launch record
           ("k_k", 2150, 2160, 2150),     # phase1a
           ("phase2_router_kernel", 2460, 2470, 2450)]  # in phase3
    return pt_mod.ProgramTrace(2, spans, {"host_syncs": 1}, ops)


def test_made_up_launches_land_in_their_spans():
    pt = _synthetic()
    assert pt_mod.launches_by_span(pt) == {
        "cast": 2, "phase1a": 3, "phase1b": 1, "phase2": 1, "phase3": 2,
        "monitor": 1, "check": 1, "outside": 1, "unlinked": 1}
    assert pt_mod.k1_in_phase2(pt) == (2, 1)
    # the second launch lies 50 ns past its phase2 span's end
    assert pt_mod.k1_margins_us(pt) == (0.05, -0.05)
    got = {k: r(pt) for k, r in pt_mod.READERS.items()}
    assert got == {"cast_host_ms": 4 * 100 / 2 * 1e-6,
                   "monitor_host_ms": 2 * 200 / 2 * 1e-6,
                   "host_syncs_per_cycle": 0.5,
                   "phase1a_launches": 1.5, "phase1b_launches": 0.5,
                   "phase3_launches": 1.0, "cast_launches": 1.0}


def test_idle_gaps_go_to_the_span_the_host_was_in_as_they_ended():
    idle = pt_mod.idle_by_span(_synthetic())
    # gaps end at 150 (phase1a), 260 (phase1b), 360 (phase2), 450
    # (phase3), 550 (cast), 800 (monitor), 1020 (check), 1500 and 1600
    # (outside), 2150 (phase1a), 2460 (phase3)
    want = {"phase1a": 90 + 540, "phase1b": 90, "phase2": 90,
            "phase3": 70 + 300, "cast": 90, "monitor": 240, "check": 210,
            "outside": 470 + 90}
    assert idle.keys() == want.keys()
    for k, v in want.items():
        assert idle[k] == pytest.approx(v * 1e-9)


def test_without_spans_or_a_device_trace_the_metrics_read_nothing():
    empty = pt_mod.ProgramTrace(32, [], {}, [])
    assert {k: r(empty) for k, r in pt_mod.READERS.items()} == dict.fromkeys(
        pt_mod.READERS)


class _Event:
    def __init__(self, name, dev, corr, start, end):
        self.v = (name, dev, corr, start, end)

    def name(self):
        return self.v[0]

    def device_type(self):
        return self.v[1]

    def correlation_id(self):
        return self.v[2]

    def start_ns(self):
        return self.v[3]

    def end_ns(self):
        return self.v[4]


def test_device_operations_take_their_launch_record_by_correlation_id():
    CPU, CUDA = DeviceType.CPU, DeviceType.CUDA
    events = [_Event("Activity Buffer Request", CPU, 0, 5, 9),
              _Event("cudaLaunchKernel", CPU, 47, 100, 130),
              _Event("cuLaunchKernel", CPU, 47, 110, 120),
              _Event("cudaMemcpyAsync", CPU, 55, 200, 230),
              _Event("kernel", CUDA, 47, 300, 310),
              _Event("Memcpy DtoD (Device -> Device)", CUDA, 55, 320, 330),
              _Event("kernel", CUDA, 61, 340, 350)]

    class Results:
        def events(self):
            return events

    class Prof:
        class profiler:
            kineto_results = Results()

    assert pt_mod.device_ops(Prof()) == [
        ("kernel", 300, 310, 100),
        ("Memcpy DtoD (Device -> Device)", 320, 330, 200),
        ("kernel", 340, 350, None)]


def _run(*args, timeout=120):
    proc = subprocess.run(RUN + list(args), capture_output=True, text=True,
                          cwd=str(bench.ROOT), env=ENV, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(out)[-1] == "checks"
    return out


def test_a_cpu_rehearsal_reads_the_host_spans_and_counters_only():
    out = _run("--workload", "paper-208.random", "--seed", "3000000029",
               "--seconds", "0.1", "--rehearse-cpu")
    assert out["correct"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(HOST_METRICS) <= set(m)
    assert not set(LAUNCH_METRICS) & set(m)
    assert "idle_by_program_span_s" not in out["run"]
    # one check a chunk of 8 over the 32 scenario-cycles
    assert m["host_syncs_per_cycle"] == 0.125
    assert 0 < m["cast_host_ms"] + m["monitor_host_ms"] < m["driver_host_ms"]
    # the program's phase spans hold the benchmark's own, and little more
    for p in bench.PHASES:
        want = m[f"{p}_host_ms"]
        assert want * 0.999 <= out["program"]["self_ms"][p] <= want * 1.05


@pytest.mark.gpu
def test_on_the_card_the_join_accounts_for_every_launch():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the port's kernel has no CPU mode)")
    out = _run("--workload", "paper-208.random", "--seed", "3000000031",
               "--seconds", "2", timeout=600)
    assert out["correct"]
    prog, m = out["program"], out["metrics"]
    assert prog["k1_launches"] == prog["k1_in_phase2"] == 32
    named = sum(m[k]["value"] for k in LAUNCH_METRICS) + sum(
        prog["launches"].get(k, 0) for k in ("phase2", "monitor", "check"))
    total = m["launches_per_cycle"]["value"]
    assert abs(named - total) <= 0.01 * total
    assert prog["device_ops"] == round(total * 32)
