"""What each rank runs in ``tests/test_torch_sharded_lm.py``: the sharded
LM on a device mesh over gloo ranks on the CPU.  A module of its own, free
of JAX, so that the spawned ranks import it quickly."""
import dataclasses
import os
import shutil

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import registry
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import api
from repro_torch.parallel.sharding import P, NamedSharding, distribute
from repro_torch.train import optim, step
from repro_torch.train.data import DataConfig
from repro_torch.train.loop import LoopConfig, Trainer

#: family name -> (architecture, changes to its reduced config); every
#: one in float32.  "dense-gq": 12 q heads and 3 KV heads, so that on a
#: 4-wide model axis each rank's 3 q heads straddle two GQA groups and
#: the sharded attention gathers q.  "ssm-v67", "dense-v67": a
#: vocabulary that does not divide a 4-wide model axis, so the head
#: splits d and its logits are reduce-scattered onto an uneven
#: vocabulary split, on which the loss reduces
FAMILIES = {
    "dense": ("tinyllama-1.1b", {}),
    "dense-v67": ("tinyllama-1.1b", {"vocab": 67}),
    "dense-gq": ("tinyllama-1.1b", {"n_heads": 12, "n_kv_heads": 3,
                                    "d_head": 16}),
    "moe-ep": ("qwen2-moe-a2.7b", {}),
    "moe-ftp": ("qwen2-moe-a2.7b", {"moe_mode": "ftp"}),
    "ssm": ("mamba2-130m", {}),
    "ssm-v67": ("mamba2-130m", {"vocab": 67}),
    "hybrid": ("hymba-1.5b", {}),
    "vlm": ("llama-3.2-vision-11b", {}),
    "audio": ("whisper-small", {}),
}
AXES = ("data", "model")
LR = 1e-3
TRAINER_STEPS = 12


def config(family: str):
    arch, kw = FAMILIES[family]
    return dataclasses.replace(registry.reduced(arch),
                               compute_dtype="float32", **kw)


def opt_config():
    return optim.OptConfig(lr=LR, warmup=2, total_steps=10)


def _full(tree):
    return {"/".join(k): v.full_tensor().numpy()
            for k, v in optim.tree_items(tree)}


def lm_cases(cases, batches):
    """For each (mesh shape, family): the sharded forward's logits, the
    loss, three train steps (losses, grad norms, final parameters) and
    the prefill's last-token logits, all whole (numpy)."""
    meshes = {}
    out = {}
    for shape, fam in cases:
        if shape not in meshes:
            meshes[shape] = make_mesh(shape, AXES, device="cpu")
        mesh, cfg = meshes[shape], config(fam)
        params = api.init_params(cfg, 0, "cpu", mesh=mesh)
        b = batches[fam]
        fwd, _ = api.forward_logits(cfg, params, {"tokens": b[0]["tokens"]},
                                    device="cpu", mesh=mesh)
        loss = api.loss_fn(cfg, params, b[0], device="cpu", mesh=mesh)
        prefill = step.make_prefill_step(cfg, "cpu", mesh)(
            params, {"tokens": b[0]["tokens"]})
        fn = step.make_train_step(cfg, opt_config(), "cpu", mesh)
        p, o = params, optim.init_opt(opt_config(), params)
        losses, gnorms = [], []
        for bi in b:
            p, o, m = fn(p, o, bi)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        out[(shape, fam)] = {
            "logits": fwd.full_tensor().numpy(), "loss": float(loss),
            "prefill": prefill.full_tensor().numpy(), "losses": losses,
            "gnorms": gnorms, "params": _full(p),
            "step": int(o.step.full_tensor()),
            "placements": str(fwd.placements)}
    return out


def forward_cases(cases, batches):
    """For each (mesh shape, family): the sharded forward's logits and
    loss, whole (the hybrid family's gradients on a mesh are
    ``grad_cases``', in ``tests/test_torch_train_families.py``)."""
    out = {}
    for shape, fam in cases:
        mesh = make_mesh(shape, AXES, device="cpu")
        cfg = config(fam)
        params = api.init_params(cfg, 0, "cpu", mesh=mesh)
        b = batches[fam][0]
        inputs = {k: v for k, v in b.items() if k != "labels"}
        fwd, _ = api.forward_logits(cfg, params, inputs, device="cpu",
                                    mesh=mesh)
        out[(shape, fam)] = {
            "logits": fwd.full_tensor().numpy(),
            "loss": float(api.loss_fn(cfg, params, b, device="cpu",
                                      mesh=mesh))}
    return out


def block_order():
    """Each rank's block of an (8, 3) tensor under ``P(("pod", "data"),
    None)`` on a (2, 2, 1) mesh: (JAX's block, DTensor's own block of
    the same placements, the whole tensor gathered back)."""
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"), device="cpu")
    full = torch.arange(24.0).reshape(8, 3)
    sh = NamedSharding(mesh, P(("pod", "data"), None))
    x = distribute(full, mesh, sh.placements)
    pod, data, _ = mesh.get_coordinate()
    i = pod * 2 + data                  # JAX's order: the first axis major
    want = full[2 * i:2 * i + 2]
    from torch.distributed.tensor import distribute_tensor
    own = distribute_tensor(full, mesh, sh.placements).to_local()
    return (bool(torch.equal(x.to_local(), want)),
            bool(torch.equal(own, want)),
            bool(torch.equal(x.full_tensor(), full)))


def staged_collectives():
    """DTensor's redistributions with its collectives routed through host
    copies (``dist.stage_through_host``, registered here for CPU tensors:
    the copies are then no-ops, the routing the same as for CUDA):
    (all-gather, reduce-scatter, all-reduce) each right."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.dist import stage_through_host
    stage_through_host("CPU")
    mesh = make_mesh((2, 2), AXES, device="cpu")
    full = torch.arange(48.0).reshape(8, 6)
    x = distribute(full, mesh, NamedSharding(mesh, P("data", "model"))
                   .placements)
    gathered = x.redistribute(mesh, [Replicate(), Replicate()]).to_local()
    from torch.distributed.tensor import DTensor
    part = DTensor.from_local(full / 4, mesh, [Partial(), Partial()],
                              run_check=False)
    scattered = part.redistribute(mesh, [Shard(0), Shard(1)]).full_tensor()
    reduced = part.redistribute(mesh, [Replicate(), Replicate()]).to_local()
    return (bool(torch.equal(gathered, full)),
            bool(torch.allclose(scattered, full)),
            bool(torch.allclose(reduced, full)))


def _trainer(shape, ckpt_dir, steps, resume):
    cfg = config("dense")
    mesh = None if shape is None else make_mesh(shape, AXES, device="cpu")
    tr = Trainer(cfg, optim.OptConfig(lr=LR, warmup=2,
                                      total_steps=TRAINER_STEPS),
                 DataConfig(batch=4, seq=32),
                 LoopConfig(steps=steps, ckpt_dir=ckpt_dir, ckpt_every=6,
                            log_every=100, resume=resume),
                 device="cpu", mesh=mesh)
    tr.run()
    return tr


def trainer_restarts(root: str):
    """Trainer on (2, 2): 12 steps in one run; 6 steps, then resumed to
    12 from the step-6 checkpoint; and that checkpoint resumed to 12 on
    (1, 4).  Returns each run's final parameters whole."""
    whole = _trainer((2, 2), os.path.join(root, "whole"), TRAINER_STEPS,
                     False)
    _trainer((2, 2), os.path.join(root, "split"), 6, False)
    resumed = _trainer((2, 2), os.path.join(root, "split"), TRAINER_STEPS,
                       True)
    if dist.get_rank() == 0:
        shutil.copytree(os.path.join(root, "split", "step_00000006"),
                        os.path.join(root, "remesh", "step_00000006"))
    dist.barrier()
    remeshed = _trainer((1, 4), os.path.join(root, "remesh"),
                        TRAINER_STEPS, True)
    return {"whole": _full(whole.params), "resumed": _full(resumed.params),
            "remeshed": _full(remeshed.params),
            "losses": [m["loss"] for m in whole.metrics_log],
            "resumed_losses": [m["loss"] for m in resumed.metrics_log]}


def run(cases, fwd_cases, batches, root):
    """Everything a rank checks, in one group of four ranks; rank 0's
    results come back."""
    torch.manual_seed(0)
    out = {"lm": lm_cases(cases, batches),
           "fwd": forward_cases(fwd_cases, batches), "order": block_order(),
           "trainer": trainer_restarts(root)}
    # last: it reroutes this process's collectives for good
    out["staged"] = staged_collectives()
    return out if dist.get_rank() == 0 else None


def grad_cases(cases, batches):
    """For each (mesh shape, family): the loss and every gradient of
    ``step.value_and_grad`` on the first batch, whole (numpy), with each
    gradient's placements and its parameter's."""
    out = {}
    for shape, fam in cases:
        mesh = make_mesh(shape, AXES, device="cpu")
        cfg = config(fam)
        params = api.init_params(cfg, 0, "cpu", mesh=mesh)
        loss, grads = step.value_and_grad(cfg, params, batches[fam][0],
                                          device="cpu", mesh=mesh)
        out[(shape, fam)] = {
            "loss": float(loss), "grads": _full(grads),
            "placed": {"/".join(k): (str(g.placements),
                                     str(p.placements))
                       for (k, g), (_, p) in zip(optim.tree_items(grads),
                                                 optim.tree_items(params))}}
    return out


def serve_cases(cases, tokens, cache_len):
    """For each (mesh shape, family): ``len(tokens[0])`` data-parallel
    decode steps of ``make_serve_step(mesh=)`` from a zeroed cache placed
    by ``cache_pspecs``: each step's logits, whole (numpy), and the final
    cache's leaves whole with their placements."""
    from repro_torch.parallel.sharding import resolve_pspec, placements
    out = {}
    for shape, fam in cases:
        mesh = make_mesh(shape, AXES, device="cpu")
        cfg = config(fam)
        params = api.init_params(cfg, 0, "cpu", mesh=mesh)
        b = tokens.shape[0]
        cache = optim.tree_map(
            lambda c, s: distribute(c, mesh, placements(
                resolve_pspec(s, mesh, c.shape), mesh)),
            api.init_cache(cfg, b, cache_len, "cpu"),
            api.cache_pspecs(cfg, b, cache_len),
            is_leaf=lambda x: isinstance(x, torch.Tensor))
        fn = step.make_serve_step(cfg, "cpu", mesh)
        logits = []
        for t in range(tokens.shape[1]):
            lg, cache = fn(params, cache, tokens[:, t:t + 1])
            logits.append(lg.full_tensor().numpy())
        leaves = []
        optim.tree_map(lambda c: leaves.append(
            (c.full_tensor().numpy(), str(c.placements))), cache)
        out[(shape, fam)] = {"logits": np.stack(logits, 1),
                             "cache": leaves}
    return out


def run_grads(cases, batches, serve, tokens, cache_len):
    """``grad_cases`` and ``serve_cases`` in one group of ranks; rank
    0's results come back."""
    torch.manual_seed(0)
    out = {"grads": grad_cases(cases, batches),
           "serve": serve_cases(serve, tokens, cache_len)}
    return out if dist.get_rank() == 0 else None
