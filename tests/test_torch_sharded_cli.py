"""The simulator launcher under ``torchrun`` on CPU ranks.

``torchrun --nproc-per-node 4 -m repro_torch.launch.simulate ...
--device cpu``: every rank joins one gloo group and runs the plan, rank 0
alone prints.  The spatial backend's payload reports ``backend:
sharded``, its ``grid`` and ``ranks``, and statistics equal to the
one-device run's (the port's launcher alone, which falls back to the
sweep backend) and to the JAX launcher's (one JAX program).  A composed
sweep runs its scenarios over the ranks; a rank that fails makes the
whole run fail.
"""
import json
import os
import subprocess
import sys

import torch

from repro.launch import simulate as jlaunch

from repro_torch.launch import simulate as tlaunch

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
#: seconds a torchrun may take
TIMEOUT = 600
SOLO = ["--rows", "8", "--cols", "8", "--app", "mgrid", "--refs", "6",
        "--seed", "2"]
#: keys that measure the host or that only a run over ranks prints
OWN_KEYS = ("wall_s", "scenarios_per_sec", "device",
            "arbitration_kernel_launches", "backend", "backend_note", "grid",
            "ranks", "plan")


def torchrun(*argv, n=4):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(n), "-m", "repro_torch.launch.simulate",
         *argv], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=TIMEOUT)


def stats(payload):
    return {k: v for k, v in payload.items() if k not in OWN_KEYS}


def test_sharded_backend_under_torchrun(capsys):
    out = torchrun(*SOLO, "--backend", "sharded", "--device", "cpu")
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout)               # rank 0 alone prints
    assert got["backend"] == "sharded" and got["grid"] == [1, 2, 2]
    assert got["ranks"] == 4 and got["device"] == "cpu"
    assert got["backend_note"] == "forced"
    assert got["finished"] == 1 and got["nodes"] == 64
    tlaunch.main(SOLO + ["--backend", "sharded", "--device", "cpu"])
    one = json.loads(capsys.readouterr().out)
    assert one["backend"] == "sweep" and "ranks" not in one
    assert one["backend_note"].startswith("sharded unavailable")
    assert stats(got) == stats(one)
    jlaunch.main(SOLO + ["--backend", "sharded"])
    assert stats(got) == stats(json.loads(capsys.readouterr().out))


def test_composed_sweep_under_torchrun(capsys):
    argv = ["--sweep", "--apps", "matmul,random", "--seeds", "1,2", "--rows",
            "4", "--cols", "4", "--refs", "2", "--device", "cpu"]
    out = torchrun(*argv, "--backend", "composed", "--dist-backend", "gloo")
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout)
    plan = got["plan"]
    assert got["ranks"] == 4 and plan["devices"] == 4
    (bucket,) = plan["buckets"]
    assert bucket["backend"] == "composed" and bucket["batch"] == 4
    assert bucket["grid"][0] > 1                 # scenario shards
    tlaunch.main(argv)
    one = json.loads(capsys.readouterr().out)
    assert one["plan"]["buckets"][0]["backend"] == "sweep"
    assert got["scenarios"] == one["scenarios"]
    assert all(s["finished"] == 1 for s in got["scenarios"])


def test_a_failing_rank_fails_torchrun():
    """Ranks that cannot reach their device (CUDA asked for, on a
    machine without a GPU, or past its card count) end the run with a
    non-zero exit and print no result."""
    dev = ("cpu" if not torch.cuda.is_available()
           else f"cuda:{torch.cuda.device_count()}")
    out = torchrun("--rows", "4", "--cols", "4", "--refs", "2",
                   "--device", "cuda" if dev == "cpu" else dev, n=2)
    assert out.returncode != 0
    assert '"finished"' not in out.stdout
    assert "CUDA" in out.stderr or "does not exist" in out.stderr
