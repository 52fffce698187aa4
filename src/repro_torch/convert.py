"""Carry simulator state and LM parameters and caches across between the
JAX package and the port.

A simulator state crosses as a mapping of leaf name to numpy array, so
neither side imports the other:
``{k: np.asarray(v) for k, v in jax_state._asdict().items()}`` on the JAX
side, :func:`state_from_numpy` here, and back with :func:`state_to_numpy`.
LM parameters and decode caches cross as the nested dict of the JAX
package's tree with every leaf converted by ``np.asarray``
(:func:`params_from_numpy`, :func:`cache_from_numpy` and back).  An
optimizer state crosses as the mapping of the JAX package's ``OptState``
fields, ``jax.tree.map(np.asarray, opt_state)._asdict()``
(:func:`opt_state_from_numpy` and back; on the JAX side
``OptState(**tree)``).  Every
leaf keeps its shape, dtype and values; bfloat16 leaves are numpy arrays
of ``ml_dtypes.bfloat16``, as JAX gives them.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .core.state import SimState
from .models.api import abstract_params, init_cache
from .models.config import ModelConfig
from .models.params import abstract_leaf
from .models.zoo import param_tree
from .train.optim import OptConfig, OptState


def state_from_numpy(leaves: Mapping[str, np.ndarray], device) -> SimState:
    """A port ``SimState`` on ``device`` from per-leaf numpy arrays (keyed
    by ``SimState`` field; extra keys are an error, missing ones too)."""
    missing = set(SimState._fields) - set(leaves)
    extra = set(leaves) - set(SimState._fields)
    if missing or extra:
        raise ValueError(f"state leaves do not match SimState: missing "
                         f"{sorted(missing)}, unexpected {sorted(extra)}")
    return SimState(*(torch.from_numpy(np.array(leaves[k])).to(device)
                      for k in SimState._fields))


def state_to_numpy(s: SimState) -> Dict[str, np.ndarray]:
    """Per-leaf numpy arrays (on the host) from a port ``SimState``."""
    return {k: v.detach().cpu().numpy() for k, v in s._asdict().items()}


def _tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.array(a, order="C")          # a writable copy of its own
    if a.dtype.name == "bfloat16":      # ml_dtypes, as JAX hands it out
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes   # only where a bfloat16 leaf leaves the port
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _tree_from_numpy(tree, like, device, path: str = ""):
    """``tree``'s leaves as tensors on ``device``, checked leaf by leaf
    against the shape-only tree ``like`` (keys, tuple lengths, shapes and
    dtypes).  Subtrees are mappings or tuples (the hybrid family's
    per-layer caches)."""
    if isinstance(like, Mapping):
        if not isinstance(tree, Mapping):
            raise ValueError(f"tree{path} should be a mapping")
        missing = set(like) - set(tree)
        extra = set(tree) - set(like)
        if missing or extra:
            raise ValueError(f"tree{path} does not match: missing "
                             f"{sorted(missing)}, unexpected {sorted(extra)}")
        return {k: _tree_from_numpy(tree[k], want, device, f"{path}[{k!r}]")
                for k, want in like.items()}
    if isinstance(like, tuple):
        if not isinstance(tree, (tuple, list)) or len(tree) != len(like):
            raise ValueError(f"tree{path} should be a sequence of "
                             f"{len(like)}")
        return tuple(_tree_from_numpy(t, want, device, f"{path}[{i}]")
                     for i, (t, want) in enumerate(zip(tree, like)))
    t = _tensor_from_numpy(tree, device)
    if tuple(t.shape) != tuple(like.shape) or t.dtype != like.dtype:
        raise ValueError(f"tree{path} is {t.dtype} {tuple(t.shape)}, "
                         f"expected {like.dtype} {tuple(like.shape)}")
    return t


def _tree_to_numpy(tree):
    if isinstance(tree, Mapping):
        return {k: _tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree_to_numpy(v) for v in tree)
    return _tensor_to_numpy(tree)


def params_from_numpy(tree: Mapping[str, Any], device,
                      cfg: ModelConfig) -> Dict[str, Any]:
    """Port parameters on ``device`` from the JAX package's parameter tree
    for ``cfg`` with numpy leaves.  Keys, shapes and dtypes must be those
    of :func:`repro_torch.models.api.abstract_params`; extra or missing
    keys are an error."""
    return _tree_from_numpy(tree, abstract_params(cfg), device)


def params_to_numpy(params: Mapping[str, Any]) -> Dict[str, Any]:
    """The port's parameter tree with numpy leaves (on the host)."""
    return _tree_to_numpy(params)


def _cache_dims(tree: Mapping[str, Any], cfg: ModelConfig):
    """(batch, cache length) of a cache tree of ``cfg``'s family, read
    from its own leaves.  An SSM cache has no length (1 stands for it);
    a hybrid cache's is its longest layer's (a global layer's, or the
    window, which any longer length gives too)."""
    def dims(leaf, name, ndim, at):
        shape = np.shape(leaf)
        if len(shape) != ndim:
            raise ValueError(f"cache leaf {name} has shape {shape}, "
                             f"expected {ndim} dimensions")
        return tuple(shape[i] for i in at)

    fam = cfg.family
    if fam == "ssm":                                # (L, B, K-1, conv)
        return dims(tree["conv"], "'conv'", 4, (1,)) + (1,)
    if fam == "hybrid":                             # per layer (B, T, KV, D)
        if not tree["layers"]:
            raise ValueError("a hybrid cache with no layers")
        bt = [dims(layer[0], f"['layers'][{l}][0]", 4, (0, 1))
              for l, layer in enumerate(tree["layers"])]
        return bt[0][0], max(t for _, t in bt)
    if fam == "vlm":                                # (g, inner, B, T, KV, D)
        return dims(tree["k"], "'k'", 6, (2, 3))
    return dims(tree["k"], "'k'", 5, (1, 2))        # (L, B, T, KV, D)


def _state_like(want: torch.Tensor, got) -> torch.Tensor:
    """An SSM state leaf leaves a decode step in float32 (``ssd_decode``,
    in both packages): accept that as well as the compute dtype."""
    if np.asarray(got).dtype == np.float32:
        return torch.empty(want.shape, dtype=torch.float32, device="meta")
    return want


def cache_from_numpy(tree: Mapping[str, Any], device,
                     cfg: ModelConfig) -> Dict[str, Any]:
    """A port decode cache on ``device`` from the JAX package's cache tree
    for ``cfg`` with numpy leaves (a hybrid cache's per-layer tuples as
    tuples or lists).  Batch and cache length are read from the family's
    own leaves; the SSM state may be float32, as a decode step leaves
    it."""
    batch, cache_len = _cache_dims(tree, cfg)
    like = init_cache(cfg, batch, cache_len, "meta")
    if cfg.family == "ssm":
        like["h"] = _state_like(like["h"], tree["h"])
    elif cfg.family == "hybrid" and len(tree["layers"]) == len(
            like["layers"]):
        like["layers"] = tuple(
            want[:3] + (_state_like(want[3], got[3]),)
            for want, got in zip(like["layers"], tree["layers"]))
    return _tree_from_numpy(tree, like, device)


def cache_to_numpy(cache: Mapping[str, Any]) -> Dict[str, Any]:
    """The port's decode cache with numpy leaves (on the host)."""
    return _tree_to_numpy(cache)


def opt_state_from_numpy(tree: Mapping[str, Any], device, cfg: ModelConfig,
                         opt: OptConfig) -> OptState:
    """A port ``OptState`` on ``device`` from the JAX package's
    ``OptState`` fields (``mu``, ``nu``, ``step``) with numpy leaves:
    the moments have the parameter tree of ``cfg`` in
    ``opt.moment_dtype``, the step is a 0-d int32."""
    if set(tree) != set(OptState._fields):
        raise ValueError(f"optimizer state has fields {sorted(tree)}, "
                         f"expected {list(OptState._fields)}")
    like = param_tree(cfg, abstract_leaf(getattr(torch, opt.moment_dtype)))
    step = _tensor_from_numpy(tree["step"], device)
    if step.shape != () or step.dtype != torch.int32:
        raise ValueError(f"step is {step.dtype} {tuple(step.shape)}, "
                         f"expected a 0-d int32")
    return OptState(_tree_from_numpy(tree["mu"], like, device, "['mu']"),
                    _tree_from_numpy(tree["nu"], like, device, "['nu']"),
                    step)


def opt_state_to_numpy(st: OptState) -> Dict[str, Any]:
    """The port's ``OptState`` as a mapping of its fields with numpy
    leaves (on the host)."""
    return {"mu": _tree_to_numpy(st.mu), "nu": _tree_to_numpy(st.nu),
            "step": _tensor_to_numpy(st.step)}
