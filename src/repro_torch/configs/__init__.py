"""Architecture registry of the port: one module per architecture, each
exporting

    CONFIG        — the exact published configuration
    smoke_config()— a reduced same-family config for CPU smoke tests

These are the port's own copies of the reference's configs (same values):
the ten assigned architectures and the paper's DeepSeek-Distill-Qwen
models.  Select with ``--arch <id>`` in the launchers.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.api import ModelConfig

_ARCH_MODULES = {
    # --- assigned architectures (10) ---
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "starcoder2-15b": "starcoder2_15b",
    "yi-34b": "yi_34b",
    "qwen2.5-3b": "qwen2_5_3b",
    "whisper-small": "whisper_small",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "grok-1-314b": "grok_1_314b",
    "xlstm-1.3b": "xlstm_1_3b",
    "internvl2-2b": "internvl2_2b",
    "hymba-1.5b": "hymba_1_5b",
    # --- the paper's evaluation models ---
    "qwen-distill-1.5b": "qwen_distill_1_5b",
    "qwen-distill-7b": "qwen_distill_7b",
    "qwen-distill-14b": "qwen_distill_14b",
}

ASSIGNED_ARCHS: List[str] = list(_ARCH_MODULES)[:10]
PAPER_ARCHS: List[str] = list(_ARCH_MODULES)[10:]


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
