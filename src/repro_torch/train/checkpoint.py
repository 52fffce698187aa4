"""Checkpointing: atomic, restart-exact, in the JAX package's format.

Layout: ``<dir>/step_<n>/arrays.npz`` + ``manifest.json`` holding step,
data cursor and config hash.  Writes go to a temp dir and are renamed
(preemption-safe); ``latest()`` picks the newest complete checkpoint, and
the newest ``keep`` are kept.

The counterpart of the JAX package's ``repro.train.checkpoint``, with the
same files and the same array keys, so a checkpoint written by either
package restores in the other.  A key is a leaf's path, each step
written as JAX prints its key paths and joined with ``|``: ``['params']``
for a dict key, ``.mu`` for a named-tuple field, e.g.
``['params']|['embed']`` and ``['opt']|.step``.

Trees are nested dicts and named tuples (``OptState``) of tensors or
numpy arrays.  A bfloat16 tensor is written as float32, which
holds it exactly and which the JAX package's ``restore`` casts back to
bfloat16 (numpy writes its own bfloat16 arrays as raw 2-byte records,
which it cannot cast back); ``restore`` here reads either, and needs no
``ml_dtypes``.

Sharded trees (DTensor leaves on a device mesh over the whole process
group): every rank calls ``save``, which gathers each leaf's blocks to
rank 0's host (a collective), and rank 0 alone writes the files, with
the same keys and arrays as one device would.  ``restore`` places each
leaf onto whatever mesh it is given, as the JAX package's
``device_put`` against new shardings does (elastic re-meshing): a
checkpoint taken on one mesh restores onto another, or onto one device.  It reads one leaf at a time and cuts each rank's block
on the host, so a rank holds one whole leaf at most, on the host.
"""
from __future__ import annotations

import hashlib
import json
import shutil
import time
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.parallel.sharding import block, distribute
from repro_torch.train.optim import tree_items, tree_map

SEP = "|"


def _is_record(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _keyed(tree, prefix: Tuple[str, ...]) -> Iterator[Tuple[Tuple[str, ...],
                                                            Any]]:
    """(path, subtree) one level down ``tree``: a named tuple's fields, or
    a dict's leaves in ``optim.tree_items``'s order (named tuples inside a
    dict are its leaves there); each path step written as JAX prints it."""
    if _is_record(tree):
        for f in tree._fields:
            yield prefix + (f".{f}",), getattr(tree, f)
    else:
        for path, leaf in tree_items(tree):
            yield prefix + tuple(f"[{k!r}]" for k in path), leaf


def _items(tree, prefix: Tuple[str, ...] = ()
           ) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) for every leaf of ``tree``, keyed as the JAX package
    keys it."""
    if not (_is_record(tree) or isinstance(tree, dict)):
        yield SEP.join(prefix), tree
        return
    for path, sub in _keyed(tree, prefix):
        yield from _items(sub, path)


def _rebuild(tree, leaf_of, prefix: Tuple[str, ...] = ()):
    """``tree``'s structure with each leaf replaced by ``leaf_of(key,
    leaf)``."""
    if _is_record(tree):
        return type(tree)(*(_rebuild(sub, leaf_of, path)
                            for path, sub in _keyed(tree, prefix)))
    if isinstance(tree, dict):
        leaves = iter(_rebuild(sub, leaf_of, path)
                      for path, sub in _keyed(tree, prefix))
        return tree_map(lambda _: next(leaves), tree, is_leaf=_is_record)
    return leaf_of(SEP.join(prefix), tree)


def _gathered(leaf: DTensor) -> Optional[torch.Tensor]:
    """The whole of a DTensor leaf on rank 0's host, from one gather of
    every rank's block (over gloo as host tensors); ``None`` on the other
    ranks, which never hold more than their own block."""
    mesh = leaf.device_mesh
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"a checkpoint of a mesh of {mesh.size()} ranks "
                         f"in a world of {dist.get_world_size()}")
    local = leaf.to_local().detach().contiguous()
    if dist.get_backend() == "gloo":
        local = local.cpu()
    first = dist.get_rank() == 0
    blocks = [torch.empty_like(local) for _ in range(mesh.size())] \
        if first else None
    dist.gather(local, blocks, dst=0)
    if not first:
        return None
    full = torch.empty(leaf.shape, dtype=leaf.dtype)
    for r, b in enumerate(blocks):
        coord = (mesh.mesh == r).nonzero()[0].tolist()
        block(full, mesh, leaf.placements, coord).copy_(b)
    return full


def _to_numpy(leaf) -> Optional[np.ndarray]:
    """``leaf`` as a host array; a DTensor's on rank 0 only."""
    if isinstance(leaf, DTensor):
        leaf = _gathered(leaf)
        if leaf is None:
            return None
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)             # exact
        return t.cpu().numpy()
    return np.asarray(leaf)


def _from_array(a: np.ndarray, like, sharding=None):
    """``a`` as a leaf like ``like``: a tensor of its dtype on its device
    (a DTensor placed by ``sharding``, or else as ``like`` is, cut to
    this rank's block on the host), or a numpy array of its dtype."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        # the JAX package's bfloat16 leaf (ml_dtypes), stored as raw bits
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, order="C"))   # keeps 0-d
    if not isinstance(like, torch.Tensor):
        dt = np.asarray(like).dtype
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy().astype(dt)
    t = t.to(like.dtype)
    if sharding is not None:
        where = (sharding.mesh, sharding.placements)
    elif isinstance(like, DTensor):
        where = (like.device_mesh, like.placements)
    else:
        return t.to(like.device)
    return distribute(t, *where, like.device)


def config_hash(obj: Any) -> str:
    return hashlib.sha256(repr(obj).encode()).hexdigest()[:16]


def save(ckpt_dir: str, step: int, tree: Any, *, data_state: Dict = None,
         cfg_hash: str = "", keep: int = 3) -> Path:
    root = Path(ckpt_dir)
    final = root / f"step_{step:08d}"
    sharded = any(isinstance(v, DTensor) for _, v in _items(tree))
    writer = not sharded or dist.get_rank() == 0
    arrays = {}
    for k, v in _items(tree):
        a = _to_numpy(v)             # on a mesh: a collective, every rank
        if writer:
            arrays[k] = a
    if writer:
        root.mkdir(parents=True, exist_ok=True)
        tmp = root / f".tmp_step_{step}_{int(time.time())}"
        tmp.mkdir()
        np.savez(tmp / "arrays.npz", **arrays)
        manifest = {"step": step, "data_state": data_state or {},
                    "cfg_hash": cfg_hash, "time": time.time(),
                    "n_arrays": len(arrays)}
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                  # atomic publish
        _gc(root, keep)
    if sharded:
        dist.barrier()                     # published before any rank reads
    return final


def _gc(root: Path, keep: int) -> None:
    ckpts = sorted(root.glob("step_*"))
    for old in ckpts[:-keep]:
        shutil.rmtree(old, ignore_errors=True)


def latest(ckpt_dir: str) -> Optional[Path]:
    root = Path(ckpt_dir)
    if not root.exists():
        return None
    ckpts = sorted(p for p in root.glob("step_*")
                   if (p / "manifest.json").exists())
    return ckpts[-1] if ckpts else None


def restore(path: Path, tree_like: Any, shardings: Any = None
            ) -> Tuple[Any, Dict]:
    """Restore into the structure of ``tree_like``: each leaf takes the
    dtype (and, for a tensor, the device) of ``tree_like``'s leaf, and is
    placed by the matching :class:`NamedSharding` of ``shardings`` when
    given, or else as ``tree_like``'s leaf is placed (a DTensor's mesh
    and placements) — elastic re-mesh."""
    manifest = json.loads((Path(path) / "manifest.json").read_text())
    placed = {} if shardings is None else dict(_items(shardings))
    with np.load(Path(path) / "arrays.npz") as z:
        keys = set(z.files)

        def leaf_of(key, like):
            if key not in keys:
                raise KeyError(f"checkpoint missing leaf {key}")
            return _from_array(z[key], like, placed.get(key))

        tree = _rebuild(tree_like, leaf_of)
    return tree, manifest
