"""Sharding utilities: resolve alias / fallback PartitionSpecs on a mesh,
and place tensors by them.

The counterpart of the JAX package's ``repro.parallel.sharding``.  Model
code writes specs with the alias ``DP = ("pod", "data")`` and may give
ordered alternatives (:class:`repro_torch.models.params.Alt`).
Resolution:

1. filter alias axes down to those the mesh actually has;
2. among ``Alt`` alternatives pick the first whose sharded dims divide the
   array shape evenly;
3. as a final safety net, drop (replicate) any still-non-divisible dim.

The resolver reads only the mesh's axis names and sizes, so a spec
resolves on an :class:`AbstractMesh` of any size with no process group.
A resolved spec becomes DTensor placements (:func:`placements`): mesh
axis ``a`` named in the entry of tensor dim ``d`` is ``Shard(d)`` on
``a``'s mesh dim, and every other mesh dim is ``Replicate()``.  An entry
that names two axes, such as ``("pod", "data")``, splits its dim over
both, the first axis major, as JAX splits it; DTensor's ``Shard`` on two
mesh dims splits in mesh-dim order, so the entry's axes must come in the
mesh's order (they do in every spec of the model zoo).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.models.params import Alt
from repro_torch.train.optim import tree_map


class _Unconstrained:
    """The ``UNCONSTRAINED`` entry: the dim keeps whatever sharding it
    has."""

    def __repr__(self) -> str:
        return "UNCONSTRAINED"

    def __reduce__(self):
        return (_unconstrained, ())


def _unconstrained():
    return UNC


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), a mesh axis name,
    a tuple of axis names, or :data:`UNC`.  A tuple, as JAX's
    ``PartitionSpec`` was, so specs compare and hash as tuples."""

    UNCONSTRAINED = _Unconstrained()

    def __new__(cls, *entries):
        return super().__new__(cls, (tuple(e) if isinstance(e, list) else e
                                     for e in entries))

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"

    def __reduce__(self):
        return (PartitionSpec, tuple(self))


P = PartitionSpec
UNC = P.UNCONSTRAINED


class AbstractMesh:
    """Axis names and sizes, with no devices: enough to resolve specs at
    any mesh size (the production meshes need 256 or 512 ranks)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} in mesh-dim order, for a ``DeviceMesh`` or
    anything with ``axis_names`` and a ``shape`` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                       # torch DeviceMesh
        return dict(zip(names, mesh.mesh.shape))
    return {a: mesh.shape[a] for a in mesh.axis_names}


def _axis_size(mesh, entry) -> int:
    if entry is None or entry is UNC:
        return 1
    axes = mesh_axes(mesh)
    if isinstance(entry, tuple):
        return math.prod(axes[a] for a in entry)
    return axes[entry]


def _filter_alias(spec, mesh) -> P:
    names = set(mesh_axes(mesh))
    out = []
    for entry in spec:
        if entry is None or entry is UNC:
            out.append(entry)
        elif isinstance(entry, tuple):
            kept = tuple(a for a in entry if a in names)
            out.append(kept if kept else None)
        else:
            out.append(entry if entry in names else None)
    return P(*out)


def _divides(spec: P, shape, mesh) -> bool:
    return all(dim % _axis_size(mesh, entry) == 0
               for dim, entry in zip(shape, spec))


def _drop_bad(spec: P, shape, mesh) -> P:
    out = []
    for i, entry in enumerate(spec):
        dim = shape[i] if i < len(shape) else 1
        out.append(entry if dim % _axis_size(mesh, entry) == 0 else None)
    return P(*out)


def resolve_pspec(spec, mesh, shape=None) -> P:
    """The spec (or the first fitting alternative of an ``Alt``) as it
    applies to ``mesh`` and an array of ``shape``."""
    alts = spec if isinstance(spec, Alt) else (spec,)
    resolved = [_filter_alias(s, mesh) for s in alts]
    if shape is not None:
        shape = tuple(shape)
        for s in resolved:
            if _divides(s, shape, mesh):
                return s
        return _drop_bad(resolved[0], shape, mesh)
    return resolved[0]


def _is_spec(x) -> bool:
    return isinstance(x, (P, Alt))


def tree_pspecs_resolved(spec_tree: Any, mesh, shape_tree: Any = None):
    """Spec tree (+ optional matching tree of arrays) -> resolved specs."""
    if shape_tree is None:
        return tree_map(lambda s: resolve_pspec(s, mesh), spec_tree,
                        is_leaf=_is_spec)
    return tree_map(lambda s, a: resolve_pspec(s, mesh, a.shape), spec_tree,
                    shape_tree, is_leaf=_is_spec)


class NamedSharding:
    """A resolved spec on a mesh: where each shard of a tensor lives."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = P(*spec)

    @property
    def placements(self):
        return placements(self.spec, self.mesh)

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec})"


def tree_shardings(spec_tree: Any, mesh, shape_tree: Any = None):
    """Spec tree (+ optional matching tree of arrays) -> tree of
    :class:`NamedSharding`."""
    if shape_tree is None:
        return tree_map(lambda s: NamedSharding(mesh, resolve_pspec(s, mesh)),
                        spec_tree, is_leaf=_is_spec)
    return tree_map(
        lambda s, a: NamedSharding(mesh, resolve_pspec(s, mesh, a.shape)),
        spec_tree, shape_tree, is_leaf=_is_spec)


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None or entry is UNC:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec, mesh, current: Optional[Sequence] = None) -> tuple:
    """DTensor placements, one per mesh dim, of a resolved ``spec``.

    A mesh dim whose axis no entry names is replicated, except that with
    ``current`` (the tensor's placements now) a ``Shard`` of a dim whose
    entry is ``UNCONSTRAINED`` stays as it is."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_axes(mesh))
    where = {}
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise NotImplementedError(
                f"entry {entry!r} of {spec!r} names its axes out of the "
                f"mesh's order {tuple(names)}: DTensor would split the dim "
                f"in another order than JAX")
        for a in axes:
            if a in where:
                raise ValueError(f"axis {a!r} shards two dims of {spec!r}")
            where[a] = d
    out = []
    for i, a in enumerate(names):
        if a in where:
            out.append(Shard(where[a]))
            continue
        cur = None if current is None else current[i]
        if isinstance(cur, Shard) and cur.dim < len(spec) \
                and spec[cur.dim] is UNC:
            out.append(cur)
        else:
            out.append(Replicate())
    return tuple(out)


def block(full: torch.Tensor, mesh, placements: Sequence,
          coord: Sequence[int]) -> torch.Tensor:
    """The block of ``full`` (a view) that the rank at ``coord``, its
    index on each mesh dim, holds under ``placements``: the chunk of
    DTensor's ``Shard``, mesh dim by mesh dim, which for an entry naming
    two axes in the mesh's order is JAX's first-major chunk."""
    from torch.distributed.tensor import Shard

    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            full = full.chunk(mesh.size(i), dim=p.dim)[coord[i]]
        elif p.is_partial():
            raise ValueError("a partial sum has no block to keep")
    return full


def distribute(full: torch.Tensor, mesh, placements: Sequence,
               device=None):
    """``full`` (the whole array, the same on every rank) as a DTensor
    placed by ``placements`` on ``mesh``, with no communication: each rank
    cuts its own block where ``full`` lies (on the host, for a
    checkpoint's leaf) and moves only that block to ``device`` (default
    ``full``'s).  torch's ``distribute_tensor(src_data_rank=None)`` keeps
    the same block, but moves the whole array to the mesh's device
    first."""
    from torch.distributed.tensor import DTensor

    local = block(full, mesh, placements, mesh.get_coordinate())
    return DTensor.from_local(local.to(device).contiguous(), mesh,
                              placements, run_check=False, shape=full.shape,
                              stride=full.contiguous().stride())
