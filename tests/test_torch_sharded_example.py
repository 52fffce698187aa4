"""The sharded training example under ``torchrun`` on four gloo CPU
ranks: a run stopped (and checkpointed) on a (2, 2) mesh resumes on a
(1, 4) mesh from where it stopped."""
import math
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(ROOT, "examples", "train_lm_sharded_torch.py")


def _torchrun(cwd, *args) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", EXAMPLE, *args, "--device", "cpu"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_example_stops_on_one_mesh_and_resumes_on_another(tmp_path):
    first = _torchrun(tmp_path, "--mesh", "2,2", "--steps", "4",
                      "--stop-at", "2")
    assert re.search(r"on a \(2, 2\) mesh: 2 steps to step 2, final loss",
                     first), first
    assert (tmp_path / "checkpoints/lm-sharded-torch/step_00000002").is_dir()
    second = _torchrun(tmp_path, "--mesh", "1,4", "--steps", "4")
    m = re.search(r"on a \(1, 4\) mesh: 2 steps to step 4, final loss "
                  r"(\S+)", second)
    assert m, second
    assert math.isfinite(float(m.group(1)))
    assert (tmp_path / "checkpoints/lm-sharded-torch/step_00000004").is_dir()
