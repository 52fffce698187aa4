"""Assigned input shapes and the per-(arch, shape) applicability rules.

A copy of the JAX package's ``repro.configs.shapes`` (pure Python; the
port imports nothing of ``repro``): the same four shapes, the same rule
and the same ``why`` text.  The dry run (:mod:`repro_torch.launch.dryrun`)
reads them.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

#: families with sub-quadratic attention that can serve a 500k-token decode
SUBQUADRATIC = ("ssm", "hybrid")


def applicable(family: str, shape: str) -> Tuple[bool, str]:
    """Does (arch family, shape) form a runnable cell?  Returns (ok, why)."""
    if shape == "long_500k" and family not in SUBQUADRATIC:
        return False, ("pure full-attention arch: 512k dense-attention decode "
                       "is quadratic with no sub-quadratic variant specified "
                       "(skip noted in DESIGN.md §Arch-applicability)")
    return True, ""
