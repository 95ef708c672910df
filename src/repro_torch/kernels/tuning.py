"""Per-device-type kernel knobs (block sizes), the port's copy of
``repro.kernels.tuning``.

Devices are keyed by ``torch.cuda.get_device_name()`` instead of the TPU
kinds.  Nothing is registered yet, so the builtin defaults apply; the
tuning pass (ROADMAP M7) fills ``_TUNED``.
"""
from __future__ import annotations

from typing import Dict, Optional

BUILTIN_DEFAULTS: Dict[str, Dict[str, int]] = {
    "flash_attention": {"block_q": 128, "block_k": 128},
    "decode_attention": {"block_c": 512},
    "ssm_scan": {"chunk": 64},
    "paged_attention": {"page_size": 128},
}

# (device_type, kernel) -> {knob: value}
_TUNED: Dict[tuple, Dict[str, int]] = {}

# torch.cuda.get_device_name() prefixes -> device-type names
_DEVICE_NAME_TO_TYPE = {
    "NVIDIA H100": "H100",
    "NVIDIA H200": "H200",
}


def current_device_type() -> Optional[str]:
    """Device-type name of the local GPU, or None (CPU / unknown card)."""
    import torch
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name()
    for prefix, dev_type in _DEVICE_NAME_TO_TYPE.items():
        if name.startswith(prefix):
            return dev_type
    return None


def register_tuned(device_type: str, kernel: str,
                   config: Dict[str, int]) -> None:
    known = BUILTIN_DEFAULTS.get(kernel)
    if known is None:
        raise KeyError(f"unknown kernel {kernel!r}; "
                       f"tunable: {sorted(BUILTIN_DEFAULTS)}")
    bad = set(config) - set(known)
    if bad:
        raise KeyError(f"unknown knobs {sorted(bad)} for kernel {kernel!r}; "
                       f"tunable: {sorted(known)}")
    _TUNED[(device_type, kernel)] = {k: int(v) for k, v in config.items()}


def tuned_config(kernel: str,
                 device_type: Optional[str] = None) -> Dict[str, int]:
    out = dict(BUILTIN_DEFAULTS[kernel])
    dt = device_type if device_type is not None else current_device_type()
    if dt is not None:
        out.update(_TUNED.get((dt, kernel), {}))
    return out


def resolve(kernel: str, knob: str, value: Optional[int]) -> int:
    """An explicitly passed value wins; None consults the tuned table
    (falling back to the builtin default)."""
    if value is not None:
        return int(value)
    return tuned_config(kernel)[knob]
