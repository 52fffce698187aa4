"""The harness end to end: a rehearsal on the CPU, the refusal to run
without a card, the look for JAX, and (marked ``gpu``) a short run on
the card."""
import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import bench

RUN = [sys.executable, os.path.join(str(bench.HERE), "run.py")]
ENV = dict(os.environ, OMP_NUM_THREADS="1")


def run(*args, timeout=120):
    return subprocess.run(RUN + list(args), capture_output=True, text=True,
                          cwd=str(bench.ROOT), env=ENV, timeout=timeout)


def result(proc):
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    tail = proc.stderr.strip().splitlines()[-len(out["checks"]):]
    assert tail == [f"check {k} {c['value']} limit {c['limit']}"
                    for k, c in out["checks"].items()]
    return out


def test_a_rehearsal_runs_the_window_and_the_check():
    out = result(run("--workload", "paper-208.sweep4", "--seed",
                     "3000000017", "--seconds", "0.1", "--trace", "0",
                     "--rehearse-cpu"))
    assert out["correct"] and out["failed"] == 0 and out["attempted"] == 4
    assert set(out["metrics"]) == {"node_cycles_per_s", "setup_s"}
    assert out["device"]["platform"] == "cpu"
    assert out["device"]["memory_peak_bytes"] is None


def test_a_traced_rehearsal_reads_only_host_metrics():
    out = result(run("--workload", "paper-208.random", "--seed", "9",
                     "--seconds", "0.1", "--trace", "1", "--rehearse-cpu"))
    assert out["correct"] and out["attempted"] == 1
    assert set(out["metrics"]) == {"driver_host_ms", "phase1a_host_ms",
                                   "phase1b_host_ms", "phase2_host_ms",
                                   "phase3_host_ms"}
    assert out["breakdown"] == {"device_ops": [], "idle_gaps": []}
    assert "busy_s" not in out["device"]


def test_without_a_card_a_run_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = run("--workload", "paper-208.random", "--seed", "1", "--seconds",
               "1", "--trace", "0")
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


def test_jax_and_the_jax_package_are_found_by_whole_top_level_names(
        monkeypatch):
    mods = {"repro_torch": 0, "repro_torch.core.sim": 0, "jaxtyping": 0,
            "torch": 0}
    monkeypatch.setattr(sys, "modules", mods)
    assert bench.forbidden_modules() == []
    mods["repro.core.sim"] = 0
    mods["jax"] = 0
    assert bench.forbidden_modules() == ["jax", "repro"]


@pytest.mark.gpu
def test_a_short_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the port's kernel has no CPU mode)")
    out = result(run("--workload", "paper-208.random", "--seed",
                     "3000000021", "--seconds", "2", "--trace", "1",
                     timeout=600))
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0
    assert 0 < out["metrics"]["k1_roofline"]["value"] <= 100
