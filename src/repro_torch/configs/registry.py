"""Architecture registry: ``get(arch_id)`` and ``reduced(arch_id)``.

Each architecture lives in its own module (``yi_6b.py`` …) with the
exact published config; ``reduced()`` returns a tiny same-family config
for CPU tests.  A copy of the JAX package's ``repro.configs.registry``.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "yi-6b",
    "deepseek-coder-33b",
    "tinyllama-1.1b",
    "qwen2-0.5b",
    "qwen2-moe-a2.7b",
    "moonshot-v1-16b-a3b",
    "llama-3.2-vision-11b",
    "mamba2-130m",
    "whisper-small",
    "hymba-1.5b",
]


def _module(arch_id: str):
    return importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))


def get(arch_id: str) -> ModelConfig:
    if arch_id == "noc-sim":
        raise ValueError("noc-sim is configured via repro_torch.core.config")
    return _module(arch_id).CONFIG


def reduced(arch_id: str) -> ModelConfig:
    return _module(arch_id).reduced()


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get(a) for a in ARCH_IDS}
