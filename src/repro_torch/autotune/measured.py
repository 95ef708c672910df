"""MeasuredCostModel — scheduler cost factors re-derived from a CostDB
(the port's copy of ``repro.autotune.measured``).

The analytic cost model prices every plan with hand-calibrated per-phase
efficiency constants (TRAIN_MFU / PREFILL_MFU / DECODE_* / HBM_EFF in
core/cost_model.py).  This overlay replaces them, per device type, with
factors computed from the autotuner's best-config measurements:

  prefill_mfu       median achieved fraction of peak FLOPs over the
                    flash_attention buckets (useful FLOPs / time / peak —
                    padding waste counts against the device).
  train_mfu         prefill_mfu × the analytic train:prefill ratio for the
                    type.  The forward kernels are measured; backward and
                    optimizer overheads are not, so the analytic *ratio*
                    (how much worse a train step utilizes the MXU than a
                    pure forward) is retained while the measured *level*
                    replaces the guessed one.
  hbm_eff           median achieved fraction of peak HBM bandwidth over
                    the decode_attention buckets (decode streams the whole
                    cache per token — the paper's Observation 1).
  decode_compute_eff  max(analytic, measured decode compute fraction): a
                    kernel-level measurement cannot isolate the compute
                    branch of the decode roofline when the kernel is
                    HBM-bound, so it can only raise the analytic floor.
  decode_engine_eff analytic — an engine-level factor (continuous-batching
                    gaps, sampling, scheduler overhead) that no kernel
                    microbenchmark can see.

Every factor falls back to the analytic constant when the DB lacks the
(device type × kernel) coverage it needs — an empty CostDB makes this
overlay behave exactly like ``AnalyticCostModel``.

The model prices only the scheduler's profiles (``core.cluster.PROFILES``),
as the reference does.  A card's own records (``"H100"``) have no profile:
``card_fractions`` reports their fractions of the card's published peaks
(``CARD_PEAKS``), to read beside the analytic factors of a profile.
"""
from __future__ import annotations

import statistics
from typing import Dict, Optional, Tuple

from ..core.cluster import DeviceProfile
from ..core.cost_model import (ANALYTIC, CostProvider, PROFILES)
from ..kernels import tuning
from .costdb import CostDB

# the cards' published dense bf16 tensor-core FLOP/s and HBM bytes/s
# (NVIDIA's data sheets: H100 SXM 989 TFLOP/s, 3.35 TB/s)
CARD_PEAKS: Dict[str, Tuple[float, float]] = {
    "H100": (989e12, 3.35e12),
}

_EFF_FLOOR, _EFF_CEIL = 0.01, 0.95


def _clip(x: float) -> float:
    return min(_EFF_CEIL, max(_EFF_FLOOR, x))


class MeasuredCostModel(CostProvider):
    """CostProvider overlay over a CostDB (see module docstring)."""

    name = "measured"

    def __init__(self, db: CostDB,
                 fallback: Optional[CostProvider] = None):
        self.db = db
        self.fallback = fallback if fallback is not None else ANALYTIC
        self._cache: Dict[str, Dict[str, Optional[float]]] = {}

    # ------------------------------------------------------------- derivation
    def _derived(self, profile: DeviceProfile) -> Dict[str, Optional[float]]:
        if profile.name in self._cache:
            return self._cache[profile.name]
        out: Dict[str, Optional[float]] = {
            "prefill_mfu": None, "train_mfu": None,
            "hbm_eff": None, "decode_compute_eff": None,
        }
        flash = self.db.records(profile.name, "flash_attention").values()
        if flash:
            eff = statistics.median(
                r.compute_efficiency(profile.flops) for r in flash)
            out["prefill_mfu"] = _clip(eff)
            ratio = (self.fallback.train_mfu(profile)
                     / max(self.fallback.prefill_mfu(profile), 1e-9))
            out["train_mfu"] = _clip(eff * ratio)
        decode = list(self.db.records(profile.name,
                                      "decode_attention").values())
        # the paged decode kernel is the serving engine's cache-read path —
        # its buckets sharpen the same HBM-stream estimate (absent ones
        # change nothing: the union degenerates to the dense records)
        paged = list(self.db.records(profile.name,
                                     "paged_attention").values())
        if decode or paged:
            out["hbm_eff"] = _clip(statistics.median(
                r.hbm_efficiency(profile.hbm_bw) for r in decode + paged))
        if decode:
            comp = statistics.median(
                r.compute_efficiency(profile.flops) for r in decode)
            out["decode_compute_eff"] = _clip(
                max(self.fallback.decode_compute_eff(profile), comp))
        self._cache[profile.name] = out
        return out

    def _factor(self, profile: DeviceProfile, key: str,
                analytic) -> float:
        v = self._derived(profile).get(key)
        return analytic(profile) if v is None else v

    # ------------------------------------------------------------ provider API
    def train_mfu(self, profile: DeviceProfile) -> float:
        return self._factor(profile, "train_mfu", self.fallback.train_mfu)

    def prefill_mfu(self, profile: DeviceProfile) -> float:
        return self._factor(profile, "prefill_mfu",
                            self.fallback.prefill_mfu)

    def decode_compute_eff(self, profile: DeviceProfile) -> float:
        return self._factor(profile, "decode_compute_eff",
                            self.fallback.decode_compute_eff)

    def decode_engine_eff(self, profile: DeviceProfile) -> float:
        return self.fallback.decode_engine_eff(profile)

    def hbm_eff(self, profile: DeviceProfile) -> float:
        return self._factor(profile, "hbm_eff", self.fallback.hbm_eff)

    # -------------------------------------------------------------- reporting
    def measured_types(self) -> list:
        return self.db.device_types()

    def efficiency_table(self) -> str:
        """Measured vs analytic factors, one row per covered device type."""
        rows = ["device    factor              measured  analytic"]
        for name in self.db.device_types():
            prof = PROFILES.get(name)
            if prof is None:
                continue
            for key, mine, theirs in (
                ("train_mfu", self.train_mfu, self.fallback.train_mfu),
                ("prefill_mfu", self.prefill_mfu,
                 self.fallback.prefill_mfu),
                ("decode_compute_eff", self.decode_compute_eff,
                 self.fallback.decode_compute_eff),
                ("hbm_eff", self.hbm_eff, self.fallback.hbm_eff),
            ):
                rows.append(f"{name:9s} {key:19s} {mine(prof):8.3f}  "
                            f"{theirs(prof):8.3f}")
        return "\n".join(rows)


def card_fractions(db: CostDB, device_type: str) -> Dict[str, float]:
    """A card's measured fractions of its own peaks, unclipped, the way
    ``MeasuredCostModel`` derives a profile's: ``prefill_mfu``, the median
    over the flash_attention buckets of useful FLOPs / time / peak FLOP/s,
    and ``hbm_eff``, the median over the decode and paged buckets of bytes
    / time / peak bytes/s.  Keys without records are left out."""
    flops, hbm_bw = CARD_PEAKS[device_type]
    out: Dict[str, float] = {}
    flash = db.records(device_type, "flash_attention").values()
    if flash:
        out["prefill_mfu"] = statistics.median(
            r.compute_efficiency(flops) for r in flash)
    reads = (list(db.records(device_type, "decode_attention").values())
             + list(db.records(device_type, "paged_attention").values()))
    if reads:
        out["hbm_eff"] = statistics.median(
            r.hbm_efficiency(hbm_bw) for r in reads)
    return out


def load_tuned_defaults(db: CostDB) -> int:
    """Install the DB's best configs as the kernels' per-device-type
    defaults (kernels.tuning).  Returns the number of (device, kernel)
    tables registered.  A config the port's kernels cannot take (a TPU
    CostDB's block sizes) raises."""
    n = 0
    for dt in db.device_types():
        for kernel in db.entries[dt]:
            cfg = db.best_config(dt, kernel)
            if cfg:
                tuning.register_tuned(dt, kernel, cfg)
                n += 1
    return n
