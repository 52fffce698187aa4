"""The check catches a broken timed path.  Each case drives the rest of
a run on the CPU (the look for a card and for JAX skipped) with the
port's timed path broken underneath, and ``correct`` must come out
false: a step that returns its state unchanged, an answer altered where
it is produced, and, in a sweep, half of the batch left out."""
import pytest
import torch

import repro_torch.core.sim as sim
import repro_torch.core.sweep as sweep
from portbench import bench
from portbench.test_portbench_reference import small
from repro_torch.core.state import SimState

CPU = torch.device("cpu")


def unchanged(monkeypatch, cell):
    monkeypatch.setattr(sim, "cycle_step", lambda s, cfg, geo, ctx: s)


def altered(monkeypatch, cell):
    mod = sweep if cell.mix["entry"] == "run_sweep" else sim
    real = mod.stats_list

    def stats_list(s, aux):
        out = real(s, aux)
        out[-1]["hops"] += 1
        return out
    monkeypatch.setattr(mod, "stats_list", stats_list)


def half_left_out(monkeypatch, cell):
    real = sweep._drive

    def drive(s, cfg, max_cycles, chunk):
        half = s.cycle.shape[0] // 2
        done, aux = real(SimState(*(x[:half] for x in s)), cfg, max_cycles,
                         chunk)
        rest = SimState(*(x[half:] for x in s))
        both = SimState(*(torch.cat([a, b]) for a, b in zip(done, rest)))
        return both, type(aux)(*(torch.cat([a, torch.zeros_like(a)])
                                 for a in aux))
    monkeypatch.setattr(sweep, "_drive", drive)


CASES = [(w, f) for w in ("paper-208.random", "paper-208-bigcache.matmul",
                          "paper-208.sweep4")
         for f in (unchanged, altered)] + [("paper-208.sweep4",
                                            half_left_out)]


@pytest.mark.parametrize("name,fault", CASES,
                         ids=[f"{w}-{f.__name__}" for w, f in CASES])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    cell = small(name)
    monkeypatch.setattr(bench, "forbidden_modules", lambda: [])
    fault(monkeypatch, cell)
    out = bench.measure(cell, 1234, 0.05, False, CPU, 0.0, "cpu")
    assert out["correct"] is False
    assert out["checks"]["stat_mismatches"]["value"] > 0
    assert out["failed"] >= 1


def test_the_same_run_unbroken_is_correct(monkeypatch):
    cell = bench.load_cell("paper-208.sweep4", rehearse=True)
    monkeypatch.setattr(bench, "forbidden_modules", lambda: [])
    out = bench.measure(cell, 1234, 0.05, False, CPU, 0.0, "cpu")
    assert out["correct"] is True and out["failed"] == 0
