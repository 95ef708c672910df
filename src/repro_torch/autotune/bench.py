"""Timing harness of the port's kernel sweep.

Two modes, chosen per requested device type:

* ``device`` — the local card (``kernels.tuning.current_device_type()``,
  e.g. ``"H100"``) when the sweep runs on a CUDA device: every feasible
  config is launched through the real wrapper in bfloat16, its knob
  passed explicitly (a keyword the wrapper resolves through
  ``tuning.resolve``, where an explicit value wins), and timed with CUDA
  events: 3 warm-up launches, then ``REPS`` launches each after a write of
  a 256 MiB buffer that flushes the 50 MB L2, and the **median** of the
  ``REPS`` event times is kept (``chip_smoke.py::_time_ms`` is this
  timer).  Each rep's flush is queued behind a device-side wait
  (``torch.cuda._sleep``) of at least twice the host's enqueue time of
  one call, so the launch is already queued when the start event is
  reached and a slow host does not leave the card idle inside the timed
  window.  Configs
  that launch the same way (``KernelSpace.launch_key``: K3's split count,
  K2's split count and page, K4's chunk) are one candidate: its time is
  the median of their times, and it is represented by the config nearest
  the builtin default (the least sum over knobs of |log(value /
  default)|, the first such in the space's order), so that a knob the
  launch ignores at this shape is not chosen by the noise of equal
  launches.  Each bucket starts with ``WARM_S`` of launches of its first
  config, so that the first configs are not timed on a card that has
  been idle (clocks ramping up).  An error raised on the card is a fault
  and ends the sweep: infeasible configs are filtered by
  ``KernelSpace.feasible`` before they launch.
* ``interpret`` — every other requested type (and every type on the CPU):
  the reference's roofline estimate (``estimate_time``, its formula and
  priors) over the port's spaces.  No interpreter runs; the records keep
  the reference's mode name so the CostDB format stays the same.

``flop_calibration`` is 1.0: the reference corrects its analytic model by
XLA's ``cost_analysis``, which the port has no counterpart of.  It still
runs each kernel's wrapper once at a micro shape on the sweep's device (on
the CPU, the plain version), so the knob plumbing is exercised.
"""
from __future__ import annotations

import math
import statistics
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..core.cluster import PROFILES, DeviceProfile
from ..kernels import tuning
from ..kernels.decode_attention.ops import (decode_attention,
                                            decode_attention_ref)
from ..kernels.flash_attention.ops import flash_attention, flash_attention_ref
from ..kernels.paged_attention.ops import (paged_decode_attention,
                                           paged_decode_attention_ref)
from ..kernels.ssm_scan import ops as scan_ops
from .space import KernelSpace, ShapeBucket, SPACES

# Roofline-estimate priors (interpret mode only; device mode measures).
BASE_MXU_UTIL = 0.72       # pipelined MXU utilization at perfect alignment
STREAM_EFF = 0.80          # achievable fraction of peak HBM bandwidth
GRID_STEP_S = 0.03e-6      # per-grid-step sequencing overhead (amortized
                           # under double-buffered DMA; favors fewer tiles)
MXU_LANE = 128             # MXU consumes 128×128 tiles
REPS = 20                  # timed launches per config (median kept)
WARMUP = 3                 # untimed launches before each config's REPS
WARM_S = 0.2               # seconds of launches before a bucket's first
FLUSH_BYTES = 256 * 2 ** 20
MIN_WAIT_S = 50e-6         # least device-side wait before each flush
MAX_CLOCK_HZ = 1.98e9      # the H100's highest SM clock: cycles of a wait

# Micro shapes: run once per kernel to exercise the plumbing.
_MICRO_SHAPES = {
    "flash_attention": ShapeBucket.make("micro", B=1, S=64, H=4, Hkv=2,
                                        D=64),
    "decode_attention": ShapeBucket.make("micro", B=2, C=64, H=4, Hkv=2,
                                         D=64),
    "paged_attention": ShapeBucket.make("micro", B=2, C=64, H=4, Hkv=2,
                                        D=64),
    "ssm_scan": ShapeBucket.make("micro", B=1, S=64, H=2, D=64),
}
_MICRO_CONFIGS = {
    "flash_attention": dict(tuning.COMPILED["flash_attention"][0]),
    "decode_attention": dict(tuning.BUILTIN_DEFAULTS["decode_attention"]),
    "paged_attention": dict(tuning.BUILTIN_DEFAULTS["paged_attention"]),
    "ssm_scan": dict(tuning.BUILTIN_DEFAULTS["ssm_scan"]),
}


@dataclass(frozen=True)
class Measurement:
    config: Dict[str, int]
    time_s: float
    flops: float               # executed, incl. padding waste
    useful_flops: float
    bytes: float
    mode: str                  # "device" | "interpret"


# ------------------------------------------------------------- kernel calls
def kernel_case(kernel: str, shape: ShapeBucket, cfg: Dict[str, int],
                device: torch.device, seed: int = 0) -> tuple:
    """Inputs of one launch at ``shape`` in bfloat16 on ``device`` (K2's
    pool in pages of ``cfg["page_size"]``, shuffled tables; K3's cache and
    K2's rows fully valid)."""
    d = shape.d
    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(*dims):
        return torch.randn(dims, generator=gen, device=device).to(
            torch.bfloat16)

    if kernel == "flash_attention":
        return (rand(d["B"], d["S"], d["H"], d["D"]),
                rand(d["B"], d["S"], d["Hkv"], d["D"]),
                rand(d["B"], d["S"], d["Hkv"], d["D"]))
    if kernel == "decode_attention":
        B, C = d["B"], d["C"]
        q_pos = torch.full((B,), C - 1, dtype=torch.int32, device=device)
        k_pos = torch.arange(C, dtype=torch.int32, device=device).expand(
            B, C).contiguous()
        return (rand(B, d["H"], d["D"]), rand(B, C, d["Hkv"], d["D"]),
                rand(B, C, d["Hkv"], d["D"]), q_pos, k_pos)
    if kernel == "paged_attention":
        B, C, pg = d["B"], d["C"], cfg["page_size"]
        maxp = -(-C // pg)
        P = B * maxp + 1                            # + the null page
        ids = torch.randperm(P - 1, generator=gen, device=device) + 1
        tables = ids.reshape(B, maxp).to(torch.int32).contiguous()
        lengths = torch.full((B,), C, dtype=torch.int32, device=device)
        return (rand(B, d["H"], d["D"]), rand(P, pg, d["Hkv"], d["D"]),
                rand(P, pg, d["Hkv"], d["D"]), tables, lengths)
    if kernel == "ssm_scan":
        dims = (d["B"], d["S"], d["H"], d["D"])
        gates = (d["B"], d["S"], d["H"])
        return (rand(*dims), rand(*dims), rand(*dims),
                torch.randn(gates, generator=gen, device=device),
                torch.randn(gates, generator=gen, device=device) + 2.0)
    raise KeyError(f"unknown kernel {kernel!r} (known: {sorted(SPACES)})")


def launch(kernel: str, cfg: Dict[str, int], args: tuple) -> torch.Tensor:
    """One call of the kernel's wrapper with the config's knobs passed
    explicitly (K1 has none; K2's page size is the pool's)."""
    if kernel == "flash_attention":
        return flash_attention(*args)
    if kernel == "decode_attention":
        return decode_attention(*args,
                                min_split_tiles=cfg["min_split_tiles"])
    if kernel == "paged_attention":
        return paged_decode_attention(*args,
                                      min_split_tiles=cfg["min_split_tiles"])
    if kernel == "ssm_scan":
        return scan_ops.mlstm_scan(*args, chunk=cfg["chunk"])
    raise KeyError(f"unknown kernel {kernel!r} (known: {sorted(SPACES)})")


def plain(kernel: str, cfg: Dict[str, int], args: tuple) -> torch.Tensor:
    """The kernel's plain PyTorch version on the same inputs (K4 at the
    config's chunk)."""
    if kernel == "flash_attention":
        return flash_attention_ref(*args)
    if kernel == "decode_attention":
        return decode_attention_ref(*args)
    if kernel == "paged_attention":
        return paged_decode_attention_ref(*args)
    if kernel == "ssm_scan":
        return scan_ops._plain(*args, cfg["chunk"])
    raise KeyError(f"unknown kernel {kernel!r} (known: {sorted(SPACES)})")


def on_device_type(device: torch.device) -> Optional[str]:
    """The device type measured in device mode: the local card's when the
    sweep runs on a CUDA device, None on the CPU.  A card the tuning table
    cannot name cannot key its records, so it raises."""
    if device.type != "cuda":
        return None
    dev_type = tuning.current_device_type()
    if dev_type is None:
        raise RuntimeError(
            f"no device type for {torch.cuda.get_device_name(device)!r} "
            f"(known cards: {tuning.CARD_TYPES})")
    return dev_type


def time_on_device(fn: Callable[[], object], flush: torch.Tensor,
                   reps: int = REPS) -> float:
    """Median seconds of ``reps`` launches of ``fn`` by CUDA events, each
    after ``flush`` is rewritten (L2 cold), after WARMUP launches; each
    flush waits on the card (``torch.cuda._sleep``) at least twice the
    longest host time of one call, so the start event never waits on the
    host."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    host = 0.0                     # the longest enqueue of one call
    for _ in range(WARMUP):
        t0 = time.perf_counter()
        fn()
        host = max(host, time.perf_counter() - t0)
        torch.cuda.synchronize()
    cycles = int(max(MIN_WAIT_S, 2 * host) * MAX_CLOCK_HZ)
    events = []
    for _ in range(reps):
        torch.cuda._sleep(cycles)  # the card waits while the host queues
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events) / 1e3


def warm_card(fn: Callable[[], object], seconds: float = WARM_S) -> None:
    """Launch ``fn`` for ``seconds`` of host time, synchronising every 32
    launches, so that the card runs at its working clocks."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(32):
            fn()
        torch.cuda.synchronize()


# --------------------------------------------------------------- calibration
_CALIB: Dict[str, float] = {}


def flop_calibration(kernel: str, device: torch.device) -> float:
    """1.0: the analytic FLOP model as it is (see the module docstring).
    The first call per kernel runs its wrapper at the micro shape on
    ``device`` with the default knobs."""
    if kernel in _CALIB:
        return _CALIB[kernel]
    cfg = _MICRO_CONFIGS[kernel]
    out = launch(kernel, cfg, kernel_case(kernel, _MICRO_SHAPES[kernel], cfg,
                                          device))
    if not bool(torch.isfinite(out.float()).all()):
        raise RuntimeError(f"{kernel}: non-finite output at the micro shape")
    _CALIB[kernel] = 1.0
    return 1.0


# ---------------------------------------------------------------- estimation
def _alignment_util(cfg: Dict[str, int]) -> float:
    """MXU utilization degradation for tile dims below the 128 lane width
    (the reference's prior, applied to every knob as it does)."""
    util = 1.0
    for v in cfg.values():
        util *= min(1.0, v / MXU_LANE)
    return max(util, 1.0 / 64.0)


def estimate_time(space: KernelSpace, shape: ShapeBucket,
                  cfg: Dict[str, int], profile: DeviceProfile,
                  flop_ratio: float = 1.0) -> float:
    """Roofline estimate: seconds for one kernel call on ``profile``."""
    flops = space.flops(shape, cfg) * flop_ratio
    byts = space.bytes_moved(shape, cfg)
    util = BASE_MXU_UTIL * _alignment_util(cfg)
    t_compute = flops / (profile.flops * util)
    t_memory = byts / (profile.hbm_bw * STREAM_EFF)
    overhead = space.grid_steps(shape, cfg) * GRID_STEP_S
    return max(t_compute, t_memory) + overhead


# -------------------------------------------------------------------- bench
def _input_key(kernel: str, cfg: Dict[str, int]) -> Tuple:
    """The knobs that change a launch's inputs (K2's page size)."""
    return (cfg["page_size"],) if kernel == "paged_attention" else ()


def bench_shape(kernel: str, shape: ShapeBucket, device_types: List[str],
                *, tiny: bool = False, device: torch.device,
                log: Callable[[str], None] = lambda s: None,
                trials: Optional[List[Tuple[Dict[str, int], float]]] = None,
                ) -> Dict[str, Measurement]:
    """Sweep every feasible config of ``kernel`` on one shape bucket and
    return the best Measurement per requested device type.

    The local card's type is timed on the card (every feasible config);
    every other type gets the roofline estimate for its profile.  Each
    device-mode ``(config, seconds)`` is appended to ``trials`` when
    given."""
    space = SPACES[kernel]
    local = on_device_type(device)
    ratio = flop_calibration(kernel, device)
    flush = (torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)
             if local in device_types else None)
    cases: Dict[Tuple, tuple] = {}
    timed: List[Tuple[Dict[str, int], float]] = []
    best: Dict[str, Measurement] = {}
    useful = space.useful_flops(shape)

    def measurement(cfg, t, mode):
        return Measurement(config=dict(cfg), time_s=t,
                           flops=space.flops(shape, cfg) * ratio,
                           useful_flops=useful,
                           bytes=space.bytes_moved(shape, cfg), mode=mode)

    for cfg in space.configs(tiny=tiny):
        for dt in device_types:
            if not space.feasible(shape, cfg, dt):
                continue
            if dt == local:
                key = _input_key(kernel, cfg)
                if key not in cases:
                    cases[key] = kernel_case(kernel, shape, cfg, device)
                args = cases[key]
                if not timed:
                    warm_card(lambda: launch(kernel, cfg, args))
                t = time_on_device(lambda: launch(kernel, cfg, args), flush)
                timed.append((dict(cfg), t))
                continue
            m = measurement(cfg, estimate_time(space, shape, cfg,
                                               PROFILES[dt], ratio),
                            "interpret")
            cur = best.get(dt)
            if cur is None or m.time_s < cur.time_s:
                best[dt] = m
    if timed:
        if trials is not None:
            trials.extend(timed)
        groups: Dict[Tuple, List] = {}
        for cfg, t in timed:
            groups.setdefault(space.launch_key(shape, cfg), []).append(
                (cfg, t))
        default = tuning.BUILTIN_DEFAULTS[kernel]

        def distance(cfg):
            return sum(abs(math.log(v / default[k])) for k, v in cfg.items()
                       if k in default)

        for members in groups.values():
            t = statistics.median(t for _, t in members)
            cfg = min((c for c, _ in members), key=distance)
            cur = best.get(local)
            if cur is None or t < cur.time_s:
                best[local] = measurement(cfg, t, "device")
    return best


def configs_tried(kernel: str, shape: ShapeBucket, device_type: str,
                  tiny: bool = False) -> int:
    space = SPACES[kernel]
    return sum(1 for cfg in space.configs(tiny=tiny)
               if space.feasible(shape, cfg, device_type))
