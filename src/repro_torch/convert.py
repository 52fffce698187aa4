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
from .train.optim import OptConfig, OptState, tree_map


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


def _tree_from_numpy(tree: Mapping[str, Any], like: Mapping[str, Any],
                     device, path: str = "") -> Dict[str, Any]:
    """``tree``'s leaves as tensors on ``device``, checked leaf by leaf
    against the shape-only tree ``like`` (keys, shapes and dtypes)."""
    missing = set(like) - set(tree)
    extra = set(tree) - set(like)
    if missing or extra:
        raise ValueError(f"tree{path} does not match: missing "
                         f"{sorted(missing)}, unexpected {sorted(extra)}")
    out = {}
    for k, want in like.items():
        if isinstance(want, Mapping):
            if not isinstance(tree[k], Mapping):
                raise ValueError(f"tree{path}[{k!r}] should be a subtree")
            out[k] = _tree_from_numpy(tree[k], want, device,
                                      f"{path}[{k!r}]")
            continue
        t = _tensor_from_numpy(tree[k], device)
        if tuple(t.shape) != tuple(want.shape) or t.dtype != want.dtype:
            raise ValueError(f"tree{path}[{k!r}] is {t.dtype} "
                             f"{tuple(t.shape)}, expected {want.dtype} "
                             f"{tuple(want.shape)}")
        out[k] = t
    return out


def _tree_to_numpy(tree: Mapping[str, Any]) -> Dict[str, Any]:
    return tree_map(_tensor_to_numpy, tree)


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


def cache_from_numpy(tree: Mapping[str, Any], device,
                     cfg: ModelConfig) -> Dict[str, Any]:
    """A port decode cache on ``device`` from the JAX package's cache tree
    with numpy leaves; batch and cache length are read from its ``k``
    leaf (L, B, T, KV, D)."""
    _, batch, cache_len = np.shape(tree["k"])[:3]
    return _tree_from_numpy(tree, init_cache(cfg, batch, cache_len, "meta"),
                            device)


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
