"""Device meshes over the ranks of the process group.

The counterpart of the JAX package's ``repro.launch.mesh``: the
production meshes (single-pod 16x16 and 2-pod 2x16x16, with the JAX
package's axis names) and arbitrary ones for tests and small runs.
FUNCTIONS, not module-level constants, so importing this module never
touches the process group.  Every rank of the group calls them alike.
A mesh's device type is the ranks' (``cuda`` unless the caller names
the CPU); rank ``r`` of the world sits at the ``r``-th position of the
mesh in row-major order, as ``jax.make_mesh`` lays out devices.  A CUDA
mesh over gloo ranks routes DTensor's collectives through host copies
(:func:`repro_torch.dist.stage_through_host`).
"""
from __future__ import annotations

import math

import torch

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def make_mesh(shape, axes, device=None):
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over the
    world of the default process group, on the ranks' device type
    (default ``cuda``).  Raises, naming the world size it needs, when
    the world has another size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.device import resolve_device

    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if need != have:
        raise RuntimeError(
            f"a {shape} mesh over {axes} needs {need} ranks, and the world "
            f"has {have}: start {need} ranks (torchrun --nproc-per-node, or "
            f"repro_torch.dist.spawn)")
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("no process group: join one first "
                           "(repro_torch.dist.init_rank)")
    if dev.type == "cuda" and dist.get_backend() == "gloo":
        from repro_torch.dist import stage_through_host
        stage_through_host("CUDA")
    return DeviceMesh(dev.type, torch.arange(need).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The production mesh: (16, 16) over ("data", "model"), or with
    ``multi_pod`` (2, 16, 16) over ("pod", "data", "model").  Needs a
    world of 256 or 512 ranks."""
    shape, axes = PRODUCTION[bool(multi_pod)]
    return make_mesh(shape, axes, device=device)
