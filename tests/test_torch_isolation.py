"""The port stands alone and never falls back to the CPU.

* ``repro_torch`` and the port's drivers (``examples/*_torch.py``,
  ``scripts/*_torch.py``) import neither ``jax`` nor anything of
  ``repro``;
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

from repro_torch.configs import registry
from repro_torch.core import sim as tsim
from repro_torch.core.config import SimConfig
from repro_torch.launch import serve, simulate
from repro_torch.launch import train as train_cli
from repro_torch.models import api
from repro_torch.serve.server import Server
from repro_torch.train.data import DataConfig
from repro_torch.train.loop import LoopConfig, Trainer
from repro_torch.train.optim import OptConfig
from repro_torch.train.step import make_train_step

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
        "repro_torch.launch.simulate, repro_torch.kernels.flash_attention, "
        "repro_torch.models.config, repro_torch.models.params, "
        "repro_torch.models.common, repro_torch.models.zoo, "
        "repro_torch.models.moe, repro_torch.models.ssm, "
        "repro_torch.models.api, repro_torch.configs.registry, "
        "repro_torch.serve.server, repro_torch.launch.serve, "
        "repro_torch.train.step, repro_torch.core.sweep, "
        "repro_torch.core.engine, repro_torch.core.zoo, "
        "repro_torch.core.ref_serial, repro_torch.core.trace, "
        "repro_torch.train.optim, repro_torch.train.data, "
        "repro_torch.train.checkpoint, repro_torch.train.loop, "
        "repro_torch.launch.train, repro_torch.models.costs, "
        "repro_torch.core.sharded, repro_torch.dist, "
        "repro_torch.parallel.sharding, repro_torch.launch.mesh, "
        "repro_torch.configs.shapes, repro_torch.launch.dryrun\n"
        "from repro_torch.configs import registry\n"
        "[registry.get(a) for a in registry.ARCH_IDS]\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n" % SRC)
    out = _py("-c", code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_dry_run_runs_a_cell_without_jax():
    """The dry run imports and runs (fake group, fake tensors, meters)
    with neither JAX nor ``repro`` in the process."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from repro_torch.configs import registry\n"
        "from repro_torch.configs.shapes import ShapeSpec\n"
        "from repro_torch.launch import dryrun\n"
        "rec = dryrun.lm_cell('qwen2-moe-a2.7b', ShapeSpec('x', 32, 4, "
        "'train'), ((2, 2), ('data', 'model')), "
        "cfg=registry.reduced('qwen2-moe-a2.7b'))\n"
        "assert rec['flops'] > 0 and rec['mem']['argument'] > 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n" % SRC)
    out = _py("-c", code)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def test_core_package_import_stays_light():
    """``repro_torch.core`` resolves its names lazily: importing it, the
    planner and the zoo pulls in no torch; a name pulls in its module."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import repro_torch.core as c, repro_torch.core.engine, "
        "repro_torch.core.zoo\n"
        "print('torch' in sys.modules, end=' ')\n"
        "c.execute_plan, c.expand_zoo, c.load_manifest\n"
        "print('torch' in sys.modules, end=' ')\n"
        "print(c.run.__module__, sorted(c.__all__) == c.__all__)\n" % SRC)
    out = _py("-c", code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False", "repro_torch.core.sim",
                                  "True"], out.stdout


def test_no_source_mentions_a_jax_or_repro_import():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                     re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    # the port's drivers beside the JAX package's
    for d in ("examples", "scripts"):
        files += [os.path.join(ROOT, d, n)
                  for n in sorted(os.listdir(os.path.join(ROOT, d)))
                  if n.endswith("_torch.py")]
    for d, _, names in os.walk(os.path.join(SRC, "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    assert os.path.join(ROOT, "scripts", "smoke_zoo_torch.py") in files
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


def test_lm_entry_points_need_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    cfg = registry.reduced("tinyllama-1.1b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init_params(cfg, 0)
    params = api.init_params(cfg, 0, device="cpu")
    tokens = np.zeros((1, 4), np.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.forward_logits(cfg, params, {"tokens": tokens})
    with pytest.raises(RuntimeError, match="CUDA"):
        Server(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "tinyllama-1.1b", "--reduced",
                    "--requests", "1"])
    # asked for the CPU, each runs there
    logits, _ = api.forward_logits(cfg, params, {"tokens": tokens},
                                   device="cpu")
    assert logits.device.type == "cpu" and logits.shape == (1, 4, cfg.vocab)
    assert Server(cfg, params, device="cpu").cache["k"].device.type == "cpu"


def test_train_entry_points_need_a_gpu_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    cfg = registry.reduced("tinyllama-1.1b")
    opt = OptConfig(lr=1e-3, warmup=1, total_steps=2)
    data = DataConfig(batch=1, seq=8)
    loop = LoopConfig(steps=1, ckpt_dir=str(tmp_path), resume=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(cfg, opt)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, opt, data, loop)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--arch", "tinyllama-1.1b", "--reduced", "--steps",
                        "1", "--ckpt-dir", str(tmp_path)])
    params = api.init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        api.loss_fn(cfg, params, {"tokens": np.zeros((1, 4), np.int32),
                                  "labels": np.zeros((1, 4), np.int32)})
    assert not list(tmp_path.iterdir())      # nothing was written
    # asked for the CPU, the trainer runs there
    tr = Trainer(cfg, opt, data, loop, device="cpu")
    assert tr.run()["steps"] == 1
    assert tr.params["embed"].device.type == "cpu"


def test_sharded_entry_points_need_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from repro_torch.core.sharded import run_composed, run_sharded
    from repro_torch.core.sweep import ScenarioSpec, SweepSpec
    from repro_torch.dist import init_rank
    cfg = SimConfig(rows=2, cols=2, centralized_directory=False,
                    dir_layout="home")
    tr = np.full((4, 2), 64, np.int32)
    spec = SweepSpec(cfg, (ScenarioSpec("matmul", 0, 2),))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_sharded(cfg, tr, (1, 1, 1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_composed(spec, (1, 1, 1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_rank()                   # a rank's default device is CUDA
    with pytest.raises(ValueError, match="nccl backend needs a CUDA"):
        init_rank("cpu", "nccl")
    from repro_torch.launch.mesh import make_mesh
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh((1, 1), ("data", "model"))   # a mesh's default is CUDA
    # asked for the CPU, each runs there
    assert run_sharded(cfg, tr, (1, 1, 1), device="cpu")["finished"] == 1
    assert run_composed(spec, (1, 1, 1), device="cpu")[0]["finished"] == 1


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
