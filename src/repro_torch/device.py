"""The device an entry point of the port runs on."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device.  Raises when CUDA
    is asked for (or implied) and there is no GPU: nothing falls back to
    the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU by "
            "default and does not fall back to the CPU — pass device='cpu' "
            "to run on the CPU")
    return dev
