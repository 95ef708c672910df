"""Per-device-type kernel knobs, the port's copy of
``repro.kernels.tuning``.

The wrappers resolve each knob they read through ``resolve``: an explicit
value wins, else the tuned table for the local device type, else
``BUILTIN_DEFAULTS``.  The table names exactly the knobs the port's
wrappers read, at the values they launched with before any tuning, so an
empty table changes no launch:

* ``decode_attention`` (K3) and ``paged_attention`` (K2):
  ``min_split_tiles``, the least number of 16-slot tiles a split of the
  cache walks (``decode_attention.ops._num_splits``), the port's analog
  of the reference's ``block_c``;
* ``paged_attention`` also ``page_size``, read by
  ``serve.kv_cache.PagedKVCache`` when it sizes the pool (the wrapper
  takes the page from the pool's shape);
* ``ssm_scan`` (K4): ``chunk``, at most the kernels' 64-row score tile;
* ``flash_attention`` (K1): none.  The tiles of its packed tensor-core
  kernels (``flash_attention/ops.py::TILES``: the bf16 kernel's ``ROWS,
  KEYS = 128, 64``, the float32 3xTF32 kernel's ``TF32_ROWS, TF32_KEYS =
  64, 32``) are compile-time constants of the CUDA sources, listed in
  ``COMPILED``: a CostDB record under ``flash_attention`` may name either
  kernel's set, at those values only.

Devices are keyed by ``torch.cuda.get_device_name()`` (``"H100"`` on the
card).  The table is filled by ``repro_torch.autotune.load_tuned_defaults``
from a CostDB, or by ``register_tuned``; ``clear_tuned`` empties it.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional, Tuple

BUILTIN_DEFAULTS: Dict[str, Dict[str, int]] = {
    "flash_attention": {},
    "decode_attention": {"min_split_tiles": 8},
    "ssm_scan": {"chunk": 64},
    "paged_attention": {"page_size": 128, "min_split_tiles": 8},
}

# knobs fixed when a kernel is compiled, one set per compiled kernel (K1:
# the bf16 wgmma kernel's tiles, then the float32 tf32x3 kernel's): a
# config may name one set's values only, and registering them changes no
# launch
COMPILED: Dict[str, Tuple[Dict[str, int], ...]] = {
    "flash_attention": ({"rows": 128, "keys": 64}, {"rows": 64, "keys": 32}),
}

# the values each knob's kernel can take, inclusive (None: no upper limit)
RANGES: Dict[Tuple[str, str], Tuple[int, Optional[int]]] = {
    ("decode_attention", "min_split_tiles"): (1, None),
    ("paged_attention", "min_split_tiles"): (1, None),
    ("paged_attention", "page_size"): (1, 1 << 20),
    ("ssm_scan", "chunk"): (1, 64),       # ssm_scan.ops.MAX_CHUNK
}

# (device_type, kernel) -> {knob: value}
_TUNED: Dict[tuple, Dict[str, int]] = {}

# torch.cuda.get_device_name() prefixes -> device-type names
_DEVICE_NAME_TO_TYPE = {
    "NVIDIA H100": "H100",
    "NVIDIA H200": "H200",
}
CARD_TYPES = tuple(sorted(set(_DEVICE_NAME_TO_TYPE.values())))

_DEVICE_TYPE_OVERRIDE: Optional[str] = None
_NOT_READ = object()
_detected = _NOT_READ      # the local card's type, read once


def _detect() -> Optional[str]:
    import torch
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name()
    for prefix, dev_type in _DEVICE_NAME_TO_TYPE.items():
        if name.startswith(prefix):
            return dev_type
    return None


def current_device_type() -> Optional[str]:
    """Device-type name of the local GPU, or None (CPU / unknown card)."""
    global _detected
    if _DEVICE_TYPE_OVERRIDE is not None:
        return _DEVICE_TYPE_OVERRIDE
    if _detected is _NOT_READ:
        _detected = _detect()
    return _detected


@contextlib.contextmanager
def override_device_type(name: Optional[str]) -> Iterator[None]:
    """Pretend the local device type is ``name`` (tests, CPU dry-runs)."""
    global _DEVICE_TYPE_OVERRIDE
    prev = _DEVICE_TYPE_OVERRIDE
    _DEVICE_TYPE_OVERRIDE = name
    try:
        yield
    finally:
        _DEVICE_TYPE_OVERRIDE = prev


def register_tuned(device_type: str, kernel: str,
                   config: Dict[str, int]) -> None:
    """Install tuned knobs for (device_type, kernel).  Unknown knobs raise
    ``KeyError`` (a stale CostDB must not misconfigure silently), and so
    do a TPU CostDB's block sizes; a value the port's kernel cannot take
    raises ``ValueError``."""
    known = BUILTIN_DEFAULTS.get(kernel)
    if known is None:
        raise KeyError(f"unknown kernel {kernel!r}; "
                       f"tunable: {sorted(BUILTIN_DEFAULTS)}")
    sets = COMPILED.get(kernel, ())
    fixed = {knob for compiled in sets for knob in compiled}
    bad = set(config) - set(known) - fixed
    if bad:
        raise KeyError(f"unknown knobs {sorted(bad)} for kernel {kernel!r}; "
                       f"tunable: {sorted(known)}")
    named = {knob: int(v) for knob, v in config.items() if knob in fixed}
    if named and not any(all(compiled.get(knob) == v
                             for knob, v in named.items())
                         for compiled in sets):
        raise ValueError(f"{kernel} is compiled with "
                         f"{' or '.join(map(str, sets))}, not {named}")
    tuned = {}
    for knob, value in config.items():
        value = int(value)
        if knob in fixed:
            continue
        lo, hi = RANGES[(kernel, knob)]
        if value < lo or (hi is not None and value > hi):
            raise ValueError(f"{kernel}.{knob} = {value} is outside the "
                             f"kernel's range [{lo}, {hi}]")
        tuned[knob] = value
    _TUNED[(device_type, kernel)] = tuned


def clear_tuned() -> None:
    _TUNED.clear()


def tuned_config(kernel: str,
                 device_type: Optional[str] = None) -> Dict[str, int]:
    """Effective knobs for ``kernel`` on the local (or given) device type:
    builtin defaults overlaid with any registered tuned values."""
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
