"""Parameter-tree construction with a single source of truth.

Every model family defines one ``tree(cfg, leaf)`` function where ``leaf``
is a callback ``leaf(name, shape, spec, scale)``.  Instantiating it with
different callbacks yields real parameters, shape-only stand-ins or
PartitionSpec trees, which can never drift.  The counterpart of the JAX
package's ``repro.models.params``; ``spec`` is the leaf's sharding spec
(:mod:`repro_torch.parallel.sharding`), a spec or an :class:`Alt`.
"""
from __future__ import annotations

import zlib
from typing import Any, Callable

import torch

Leaf = Callable[[str, tuple, Any, float], torch.Tensor]


class Alt(tuple):
    """Ordered sharding alternatives; the resolver picks the first whose
    sharded dims divide evenly on the target mesh (e.g. GQA head-sharding
    falls back to input-dim row-parallel when heads % tp != 0)."""

    def __new__(cls, *specs):
        return super().__new__(cls, specs)

    def __reduce__(self):
        return (Alt, tuple(self))


def zlib_crc(name: str) -> int:
    return zlib.crc32(name.encode()) & 0x7FFFFFFF


def init_leaf(seed: int, dtype: torch.dtype, device) -> Leaf:
    """Initializer; folds the leaf name into the seed, so a leaf's values
    depend on the seed and its name only.

    Conventions: ``scale == 0`` -> zeros (biases, gates);
    ``scale == 1`` -> ones (norm scales); otherwise normal * scale, drawn
    in float32 from a ``torch.Generator`` on ``device``.  These are not
    ``jax.random``'s numbers: parity with the JAX package goes through
    :func:`repro_torch.convert.params_from_numpy`.
    """
    def leaf(name: str, shape: tuple, spec, scale: float):
        if scale == 0.0:
            return torch.zeros(shape, dtype=dtype, device=device)
        if scale == 1.0:
            return torch.ones(shape, dtype=dtype, device=device)
        gen = torch.Generator(device=device)
        gen.manual_seed((seed << 31) ^ zlib_crc(name))
        x = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        return (x * scale).to(dtype)
    return leaf


def abstract_leaf(dtype: torch.dtype) -> Leaf:
    """Shape-only stand-ins: tensors on the ``meta`` device."""
    def leaf(name, shape, spec, scale):
        return torch.empty(shape, dtype=dtype, device="meta")
    return leaf


def spec_leaf() -> Leaf:
    """The leaf's sharding spec."""
    def leaf(name, shape, spec, scale):
        return spec
    return leaf
