"""Fault-tolerant training loop.

The counterpart of the JAX package's ``repro.train.loop``, on one device
or on a device mesh:

- checkpoint/restart (atomic, includes the data cursor — restart-exact;
  the checkpoint's config hash must match)
- elastic re-meshing (restore places each leaf onto the trainer's own
  mesh, whatever mesh wrote the checkpoint)
- straggler watchdog (flags steps slower than ``straggler_factor`` x the
  running median — on real fleets this feeds the controller's replace list)
- NaN/divergence guard (skips the update; raises after ``max_bad_steps``
  bad steps in a row)

The JAX loop donates its buffers to the step and so restores from the
last checkpoint after a non-finite loss.  Here the step returns new
tensors and the old ones stay whole, so a skipped update keeps the state
from before the step; nothing is restored.

With a ``mesh`` (a ``DeviceMesh``; every rank of it runs the same
``Trainer``), parameters and moments are DTensors placed by the
resolved ``param_pspecs`` (``tree_shardings``), the optimizer step is
replicated, and each batch is cut by ``input_pspecs``; rank 0 prints.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.sharding import P, NamedSharding, tree_shardings
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import DataConfig, DataSource, DataState
from repro_torch.train.optim import OptConfig, OptState, init_opt
from repro_torch.train.step import make_train_step


@dataclasses.dataclass
class LoopConfig:
    steps: int = 100
    ckpt_dir: str = "checkpoints"
    ckpt_every: int = 50
    log_every: int = 10
    resume: bool = True
    straggler_factor: float = 3.0
    max_bad_steps: int = 3
    seed: int = 0


class Trainer:
    """Trains ``model_cfg`` on ``device`` (default ``cuda``, which raises
    without a GPU; ``device="cpu"`` runs on the CPU), over ``mesh`` when
    one is given (the device is then the rank's own)."""

    def __init__(self, model_cfg: ModelConfig, opt_cfg: OptConfig,
                 data_cfg: DataConfig, loop_cfg: LoopConfig, device=None,
                 mesh=None):
        self.mcfg, self.ocfg, self.dcfg, self.lcfg = (
            model_cfg, opt_cfg, data_cfg, loop_cfg)
        self.device = resolve_device(device)
        self.mesh = mesh
        self.data = DataSource(data_cfg, model_cfg)
        self.cfg_hash = ckpt.config_hash((model_cfg, opt_cfg, data_cfg))
        self.s_params = self.s_opt = None
        if mesh is not None:
            self.s_params = tree_shardings(api.param_pspecs(model_cfg), mesh,
                                           api.abstract_params(model_cfg))
            self.s_opt = OptState(mu=self.s_params, nu=self.s_params,
                                  step=NamedSharding(mesh, P()))
        self._step = make_train_step(model_cfg, opt_cfg, device=self.device,
                                     mesh=mesh)
        self.verbose = mesh is None or dist.get_rank() == 0

        self.params = None
        self.opt_state = None
        self.data_state = DataState(0)
        self.metrics_log = []
        self.step_times = []

    # -- state ----------------------------------------------------------------
    def init_or_restore(self) -> int:
        latest = ckpt.latest(self.lcfg.ckpt_dir) if self.lcfg.resume else None
        params = api.init_params(self.mcfg, self.lcfg.seed, self.device,
                                 mesh=self.mesh)
        opt_state = init_opt(self.ocfg, params)
        if latest is not None:
            sh = None if self.mesh is None else {"params": self.s_params,
                                                 "opt": self.s_opt}
            tree, manifest = ckpt.restore(
                latest, {"params": params, "opt": opt_state}, sh)
            if manifest["cfg_hash"] not in ("", self.cfg_hash):
                raise ValueError("checkpoint/config mismatch: "
                                 f"{manifest['cfg_hash']} != {self.cfg_hash}")
            self.params, self.opt_state = tree["params"], tree["opt"]
            self.data_state = DataState.from_dict(
                manifest.get("data_state", {"step": manifest["step"]}))
            return int(manifest["step"])
        self.params, self.opt_state = params, opt_state
        return 0

    def save(self, step: int) -> None:
        ckpt.save(self.lcfg.ckpt_dir, step,
                  {"params": self.params, "opt": self.opt_state},
                  data_state=self.data_state.to_dict(),
                  cfg_hash=self.cfg_hash)

    # -- loop -----------------------------------------------------------------
    def run(self, on_metrics: Optional[Callable[[Dict], None]] = None) -> Dict:
        start = self.init_or_restore()
        bad = 0
        for step in range(start, self.lcfg.steps):
            batch = self.data.batch_at(self.data_state)
            t0 = time.time()
            new_params, new_opt, metrics = self._step(
                self.params, self.opt_state, batch)
            loss = float(metrics["loss"])          # waits for the step
            dt = time.time() - t0
            self.step_times.append(dt)

            if not np.isfinite(loss):
                bad += 1
                if bad > self.lcfg.max_bad_steps:
                    raise RuntimeError(f"diverged at step {step}")
                # skip the poisoned update: the state from before the step
                # is whole (nothing was donated), so keep it
                if self.verbose:
                    print(f"[train] step {step}: non-finite loss, skipping")
                continue
            bad = 0
            self.params, self.opt_state = new_params, new_opt
            self.data_state.step += 1

            med = float(np.median(self.step_times[-20:]))
            if len(self.step_times) > 5 and self.verbose \
                    and dt > self.lcfg.straggler_factor * med:
                print(f"[train] step {step}: straggler ({dt:.2f}s vs "
                      f"median {med:.2f}s) — would flag host for replacement")

            m = {"step": step, "loss": loss,
                 "grad_norm": float(metrics["grad_norm"]), "time_s": dt}
            self.metrics_log.append(m)
            if on_metrics:
                on_metrics(m)
            if step % self.lcfg.log_every == 0 and self.verbose:
                print(f"[train] step {step} loss {loss:.4f} "
                      f"gnorm {m['grad_norm']:.3f} {dt:.2f}s")
            if (step + 1) % self.lcfg.ckpt_every == 0:
                self.save(step + 1)
        self.save(self.lcfg.steps)
        return {"final_loss": self.metrics_log[-1]["loss"]
                if self.metrics_log else float("nan"),
                "steps": len(self.metrics_log)}
