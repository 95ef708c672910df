"""The sweep: kernels × shape buckets × configs → CostDB."""
from __future__ import annotations

import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..core.cluster import PROFILES
from ..device import DeviceLike, resolve_device
from .bench import bench_shape, configs_tried, on_device_type
from .costdb import KERNELS, CostDB, Record
from .space import SPACES

DEFAULT_DEVICE_TYPES = ("H800", "H20")


def run_sweep(
    kernels: Optional[Sequence[str]] = None,
    device_types: Optional[Sequence[str]] = None,
    *,
    tiny: bool = False,
    base: Optional[CostDB] = None,
    device: DeviceLike = None,
    log: Callable[[str], None] = lambda s: print(s, file=sys.stderr),
    trials: Optional[Dict[Tuple[str, str], List]] = None,
) -> CostDB:
    """Sweep and return a CostDB (merged over ``base`` when given).

    ``device=None`` is the GPU: the local card's type (``"H100"``) is
    measured there in device mode and needs no scheduler profile; every
    other type is estimated and needs one (``core.cluster.PROFILES``).
    ``device="cpu"`` estimates every type.  The default types are the
    local card's, if any, plus ``DEFAULT_DEVICE_TYPES``.  ``tiny`` is the
    CI mode: one shape bucket per kernel, ≤8 configs each.  ``trials``,
    when given, collects each device-mode ``(config, seconds)`` under
    ``(kernel, bucket name)``.
    """
    dev = resolve_device(device)
    local = on_device_type(dev)
    kernels = list(kernels or KERNELS)
    if device_types:
        device_types = list(device_types)
    else:
        device_types = ([local] if local else []) + list(DEFAULT_DEVICE_TYPES)
    for k in kernels:
        if k not in SPACES:
            raise KeyError(f"unknown kernel {k!r} (known: {sorted(SPACES)})")
    for dt in device_types:
        if dt != local and dt not in PROFILES:
            raise KeyError(f"unknown device type {dt!r} (known: "
                           f"{sorted(PROFILES)}, or the local card's)")
    log(f"autotune sweep: kernels={kernels} device_types={device_types} "
        f"tiny={tiny} local_accelerator={local or 'none (estimates only)'}")

    db = CostDB()
    if base is not None:
        db.merge(base)
    for kernel in kernels:
        space = SPACES[kernel]
        for shape in space.buckets(tiny=tiny):
            tried = (trials.setdefault((kernel, shape.name), [])
                     if trials is not None else None)
            best = bench_shape(kernel, shape, device_types, tiny=tiny,
                               device=dev, log=log, trials=tried)
            for dt, m in best.items():
                rec = Record(
                    shape=shape.d, size=shape.size,
                    best_config=m.config, time_s=m.time_s,
                    flops=m.flops, useful_flops=m.useful_flops,
                    bytes=m.bytes, mode=m.mode,
                    configs_tried=configs_tried(kernel, shape, dt,
                                                tiny=tiny))
                prev = db.lookup(dt, kernel, shape.name)
                if prev is None or rec.better_than(prev):
                    db.put(dt, kernel, shape.name, rec)
                cfg = " ".join(f"{k}={v}"
                               for k, v in sorted(m.config.items()))
                log(f"  {kernel:18s} {shape.name:24s} {dt:8s} -> {cfg}  "
                    f"t={m.time_s * 1e3:.4f}ms ({m.mode})")
    return db
