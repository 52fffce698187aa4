"""Carry simulator state across between the JAX package and the port.

A state crosses as a mapping of leaf name to numpy array, so neither side
imports the other: ``{k: np.asarray(v) for k, v in jax_state._asdict().items()}``
on the JAX side, :func:`state_from_numpy` here, and back with
:func:`state_to_numpy`.  Every leaf keeps its shape, dtype and values.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .core.state import SimState


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
