"""The port stands alone and never falls back to the CPU.

* ``repro_torch`` imports neither ``jax`` nor anything of ``repro``;
* its entry points run on the GPU unless asked for the CPU, and raise
  when there is none;
* ``chip_smoke.py`` fails without a GPU, and alone in a directory.
"""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import sim as tsim
from repro_torch.core.config import SimConfig
from repro_torch.launch import simulate

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(ROOT, "src")


def _py(*args, cwd=ROOT, timeout=120):
    """Run ``python *args`` in a clean environment (no PYTHONPATH)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_imports_no_jax_and_no_repro():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import repro_torch, repro_torch.core, repro_torch.core.sim, "
        "repro_torch.kernels.ops, repro_torch.convert, "
        "repro_torch.launch.simulate\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n" % SRC)
    out = _py("-c", code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_no_source_mentions_a_jax_or_repro_import():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                     re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(SRC, "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for f in files:
        with open(f) as fh:
            assert not pat.search(fh.read()), f


def test_run_without_a_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    cfg = SimConfig(rows=2, cols=2)
    tr = np.full((4, 2), 64, np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsim.run(cfg, tr)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsim.VectorSim(cfg, tr)
    with pytest.raises(RuntimeError, match="CUDA"):
        simulate.main(["--rows", "2", "--cols", "2", "--refs", "2"])


def test_launcher_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "r.json"
    simulate.main(["--rows", "2", "--cols", "3", "--app", "random",
                   "--refs", "6", "--seed", "1", "--state-dtype", "packed",
                   "--device", "cpu", "--json", str(out)])
    printed = json.loads(capsys.readouterr().out)
    saved = json.loads(out.read_text())
    assert printed == saved
    assert printed["finished"] == 1 and printed["nodes"] == 6
    assert printed["arbitration_kernel_launches"] == 0   # plain version
    from repro_torch.core.workloads import random_trace
    cfg = SimConfig(rows=2, cols=3, centralized_directory=False,
                    max_cycles=200_000, state_dtype_policy="packed")
    want = tsim.run(cfg, random_trace(cfg, 6, 1), chunk=8, device="cpu")
    assert {k: printed[k] for k in want} == want


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    out = _py("chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "GPU" in out.stderr
    # alone in a directory, without the repo around it
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    out = _py("chip_smoke.py", cwd=str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
