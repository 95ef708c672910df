"""Architecture registry of the port: one module per architecture, each
exporting

    CONFIG        — the exact published configuration
    smoke_config()— a reduced same-family config for CPU smoke tests

These are the port's own copies of the reference's configs (same values).
Only the configs that the port runs are here (the dense qwen-distill
family and xlstm-1.3b); the other families come with their slices.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.api import ModelConfig

_ARCH_MODULES = {
    "qwen-distill-1.5b": "qwen_distill_1_5b",
    "qwen-distill-7b": "qwen_distill_7b",
    "qwen-distill-14b": "qwen_distill_14b",
    "xlstm-1.3b": "xlstm_1_3b",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; ported: {list(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
