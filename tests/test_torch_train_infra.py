"""The port's training substrate: data, the Trainer, checkpoints and the
train launcher, on the CPU — the counterparts of
``tests/test_train_infra.py``, plus their agreement with the JAX package:

* the port's ``DataSource`` gives the JAX package's batches bit for bit;
* a checkpoint written by either package restores in the other exactly
  (the same files, array keys and config hash), bfloat16 moments too.

JAX compiles one program here: its train step, for the checkpoint that
the JAX ``Trainer`` writes.
"""
import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models.config import ModelConfig as JModelConfig
from repro.train import checkpoint as jckpt
from repro.train import data as jdata
from repro.train import loop as jloop
from repro.train import optim as joptim

from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.launch import train as train_cli
from repro_torch.models.config import ModelConfig
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import DataConfig, DataSource, DataState
from repro_torch.train.loop import LoopConfig, Trainer
from repro_torch.train.optim import OptConfig, OptState, init_opt, tree_items

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=64, vocab=128, max_seq=64, remat=False)


def tiny_cfg() -> ModelConfig:
    return ModelConfig(**TINY)


def trainer(ckpt_dir, steps, every=1000, resume=False, opt=None, **kw):
    opt = opt or OptConfig(lr=1e-3, warmup=2, total_steps=12)
    return Trainer(tiny_cfg(), opt, DataConfig(batch=2, seq=16, seed=2),
                   LoopConfig(steps=steps, ckpt_dir=str(ckpt_dir),
                              ckpt_every=every, resume=resume,
                              log_every=1000, **kw), device="cpu")


def leaves(tree):
    return [v for _, v in tree_items(tree)]


def test_data_deterministic_resumable_and_equal_to_jax():
    cfg = tiny_cfg()
    src = DataSource(DataConfig(batch=2, seq=16, seed=5), cfg)
    a = src.batch_at(DataState(7))
    b = src.batch_at(DataState(7))
    c = src.batch_at(DataState(8))
    assert np.array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert np.array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    # the JAX package's source gives the same batches, bit for bit, also
    # at the launcher's defaults for the full-width vocabulary
    for mcfg, dcfg in ((cfg, DataConfig(batch=2, seq=16, seed=5)),
                       (registry.get("tinyllama-1.1b"), DataConfig())):
        jsrc = jdata.DataSource(jdata.DataConfig(**dataclasses.asdict(dcfg)),
                                JModelConfig(**dataclasses.asdict(mcfg)))
        mine = DataSource(dcfg, mcfg)
        for step in (0, 1, 7, 1000):
            want, got = jsrc.batch_at(jdata.DataState(step)), \
                mine.batch_at(DataState(step))
            assert sorted(want) == sorted(got)
            for k in want:
                assert got[k].dtype == want[k].dtype == np.int32
                assert np.array_equal(got[k], want[k]), (step, k)
    # the iterator walks the cursor from 0
    it = iter(src)
    assert np.array_equal(next(it)["tokens"],
                          src.batch_at(DataState(0))["tokens"])
    assert np.array_equal(next(it)["tokens"],
                          src.batch_at(DataState(1))["tokens"])


def test_loss_decreases(tmp_path):
    tr = Trainer(tiny_cfg(), OptConfig(lr=1e-3, warmup=5, total_steps=40),
                 DataConfig(batch=2, seq=32, seed=1),
                 LoopConfig(steps=40, ckpt_dir=str(tmp_path), resume=False,
                            ckpt_every=1000, log_every=1000), device="cpu")
    out = tr.run()
    first = tr.metrics_log[0]["loss"]
    assert out["steps"] == 40
    assert out["final_loss"] < first, (first, out)


def test_checkpoint_restart_exact(tmp_path):
    """Interrupted-then-resumed == uninterrupted (fault tolerance)."""
    t1 = trainer(tmp_path / "a", 12)
    t1.run()
    t2 = trainer(tmp_path / "b", 6, every=6)
    t2.run()     # stops at step 6 ("preemption"), checkpoint written
    t3 = trainer(tmp_path / "b", 12, resume=True)
    assert t3.init_or_restore() == 6 and t3.data_state.step == 6
    t3.run()
    assert [m["step"] for m in t3.metrics_log] == list(range(6, 12))
    assert [m["loss"] for m in t3.metrics_log] == \
        [m["loss"] for m in t1.metrics_log[6:]]
    for r, g in zip(leaves(t1.params), leaves(t3.params)):
        assert torch.equal(r, g)
    for r, g in zip(leaves(t1.opt_state._asdict()),
                    leaves(t3.opt_state._asdict())):
        assert torch.equal(r, g)


def test_checkpoint_roundtrip_and_gc(tmp_path):
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": {"c": np.ones(4, np.int32)},
            "t": torch.arange(3, dtype=torch.int64)}
    for step in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), step, tree, data_state={"step": step},
                  cfg_hash="x", keep=3)
    kept = sorted(p.name for p in tmp_path.glob("step_*"))
    assert len(kept) == 3 and kept[-1] == "step_00000005"
    assert not list(tmp_path.glob(".tmp_*"))
    got, manifest = ckpt.restore(ckpt.latest(str(tmp_path)), tree)
    assert manifest["step"] == 5 and manifest["data_state"] == {"step": 5}
    np.testing.assert_array_equal(got["a"], tree["a"])
    np.testing.assert_array_equal(got["b"]["c"], tree["b"]["c"])
    assert got["t"].dtype == torch.int64 and torch.equal(got["t"], tree["t"])
    with pytest.raises(KeyError, match="missing leaf"):
        ckpt.restore(ckpt.latest(str(tmp_path)), {**tree, "z": tree["a"]})
    # a manifest-less (unfinished) directory is never the latest
    (tmp_path / "step_00000009").mkdir()
    assert ckpt.latest(str(tmp_path)).name == "step_00000005"
    assert ckpt.latest(str(tmp_path / "none")) is None


def test_trainer_refuses_a_checkpoint_of_another_config(tmp_path):
    trainer(tmp_path, 2, every=2).run()
    other = trainer(tmp_path, 4, resume=True,
                    opt=OptConfig(lr=2e-3, warmup=2, total_steps=12))
    with pytest.raises(ValueError, match="config mismatch"):
        other.run()


def test_nan_guard_skips_the_update_and_keeps_the_state(tmp_path):
    tr = trainer(tmp_path, 5, max_bad_steps=2)
    tr.init_or_restore()
    before = [p.clone() for p in leaves(tr.params)]
    real = tr._step

    def poisoned(params, opt_state, batch):
        p, o, m = real(params, opt_state, batch)
        return p, o, {**m, "loss": torch.tensor(float("nan"))}

    tr._step = poisoned
    tr.init_or_restore = lambda: 0
    with pytest.raises(RuntimeError, match="diverged at step 2"):
        tr.run()
    assert tr.data_state.step == 0 and tr.metrics_log == []
    assert int(tr.opt_state.step) == 0
    for b, a in zip(before, leaves(tr.params)):
        assert torch.equal(b, a)


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A JAX-written checkpoint resumes in the port's Trainer and a
    port-written one in the JAX package's, exactly, under one config
    hash."""
    jcfg = JModelConfig(**TINY)
    kw = dict(lr=1e-3, warmup=2, total_steps=12)
    jt = jloop.Trainer(jcfg, joptim.OptConfig(**kw),
                       jdata.DataConfig(batch=2, seq=16, seed=2),
                       jloop.LoopConfig(steps=3, ckpt_dir=str(tmp_path),
                                        ckpt_every=1000, resume=False,
                                        log_every=1000))
    jt.run()
    pt = trainer(tmp_path, 6, resume=True)
    assert pt.cfg_hash == jt.cfg_hash
    assert pt.init_or_restore() == 3 and pt.data_state.step == 3
    want = jax.tree.map(np.asarray, {"params": jt.params, "opt": jt.opt_state})
    got = {"params": convert.params_to_numpy(pt.params),
           "opt": convert.opt_state_to_numpy(pt.opt_state)}
    assert got["opt"]["step"].dtype == np.int32 and int(got["opt"]["step"]) == 3
    for key, w in ckpt._items(want):
        g = dict(ckpt._items({"params": got["params"],
                              "opt": OptState(**got["opt"])}))[key]
        assert g.dtype == w.dtype and np.array_equal(g, w), key

    # the port goes on to step 6 and writes; JAX reads it exactly
    pt.run()
    path = ckpt.latest(str(tmp_path))
    assert path.name == "step_00000006"
    like = {"params": jt.params, "opt": jt.opt_state}
    tree, manifest = jckpt.restore(path, like)
    assert manifest["cfg_hash"] == jt.cfg_hash
    assert manifest["data_state"] == {"step": 6}
    mine = {"params": pt.params, "opt": pt.opt_state}
    for (key, w), (key2, g) in zip(ckpt._items(jax.tree.map(np.asarray,
                                                            tree)),
                                   ckpt._items(mine)):
        assert key == key2
        assert np.array_equal(w, g.numpy()), key
    jt2 = jloop.Trainer(jcfg, joptim.OptConfig(**kw),
                        jdata.DataConfig(batch=2, seq=16, seed=2),
                        jloop.LoopConfig(steps=6, ckpt_dir=str(tmp_path),
                                         resume=True))
    assert jt2.init_or_restore() == 6


def test_bfloat16_moments_cross_without_ml_dtypes(tmp_path):
    opt = OptConfig(lr=1e-3, warmup=2, total_steps=12,
                    moment_dtype="bfloat16")
    tr = trainer(tmp_path / "port", 3, opt=opt)
    tr.run()
    assert tr.opt_state.mu["embed"].dtype == torch.bfloat16
    # the port reads its own back exactly
    like = {"params": tr.params, "opt": tr.opt_state}
    back, _ = ckpt.restore(ckpt.latest(str(tmp_path / "port")), like)
    for (k, a), (_, b) in zip(ckpt._items(like), ckpt._items(back)):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    # the JAX package reads it exactly, into bfloat16 moments
    jopt = joptim.OptConfig(**dataclasses.asdict(opt))
    jparams = jax.tree.map(jnp.asarray, convert.params_to_numpy(tr.params))
    jlike = {"params": jparams, "opt": joptim.init_opt(jopt, jparams)}
    jback, _ = jckpt.restore(ckpt.latest(str(tmp_path / "port")), jlike)
    mu = np.asarray(jback["opt"].mu["embed"])
    assert mu.dtype == jnp.bfloat16
    assert np.array_equal(mu.astype(np.float32),
                          tr.opt_state.mu["embed"].float().numpy())
    # and a JAX-written bfloat16 leaf (raw 2-byte records) restores here
    jlike["opt"] = jlike["opt"]._replace(mu=jback["opt"].mu)
    jckpt.save(str(tmp_path / "jax"), 1, jlike)
    again, _ = ckpt.restore(ckpt.latest(str(tmp_path / "jax")), like)
    want = jax.tree.map(lambda a: np.asarray(a).astype(np.float32), jlike)
    for (k, a), (_, b), (_, w) in zip(ckpt._items(like), ckpt._items(again),
                                      ckpt._items(want)):
        assert a.dtype == b.dtype, k
        assert np.array_equal(b.float().numpy(), w), k
    assert torch.equal(again["opt"].mu["embed"], tr.opt_state.mu["embed"])


def test_train_launcher_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    args = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "tinyllama-1.1b", "--reduced", "--steps", "3", "--batch", "2",
            "--seq", "32", "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    out = subprocess.run(args, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith("[train] done: {'final_loss': ")
    assert last.endswith(", 'steps': 3}")
    assert (tmp_path / "step_00000003" / "manifest.json").exists()
    # resumed at its last step, it has nothing left to run
    out = subprocess.run(args, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("'steps': 0}")


def test_train_launcher_has_one_device_only():
    """Without ranks to span it, the launcher trains on one device: a
    production mesh raises, naming the world size it needs."""
    for mesh, n in (("single", 256), ("multi", 512)):
        with pytest.raises(RuntimeError, match=f"needs {n} ranks"):
            train_cli.main(["--arch", "tinyllama-1.1b", "--reduced",
                            "--mesh", mesh, "--device", "cpu"])
