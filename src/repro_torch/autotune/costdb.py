"""Versioned, mergeable measured-cost database: the port's copy of
``repro.autotune.costdb``, in the same JSON format (each package loads the
other's file and writes it back byte for byte).

JSON schema (``SCHEMA_VERSION`` guards compatibility):

    {
      "schema_version": 1,
      "entries": {
        "<device_type>": {                  # DeviceProfile name, e.g. H800,
                                            # or the local card's, e.g. H100
          "<kernel>": {                     # one of KERNELS below
            "<bucket>": {                   # shape-bucket name, e.g. b1_s4096_h8_d128
              "shape":        {"B": 1, "S": 4096, ...},
              "size":         4096,         # interpolation coordinate (S or C)
              "best_config":  {"min_split_tiles": 16},
              "time_s":       0.0123,      # best config's per-call time
              "flops":        1.2e11,      # executed (incl. padding waste)
              "useful_flops": 1.1e11,      # what the math needed
              "bytes":        4.5e8,       # HBM traffic, executed
              "mode":         "device" | "interpret",
              "configs_tried": 16
            } } } }
    }

Merging unions entries; on bucket collision the *better measurement* wins:
device-mode beats interpret-mode, then lower best time.  A schema-version
mismatch raises ``CostDBVersionError`` — measured numbers silently
reinterpreted under a different schema would poison every MILP coefficient
downstream.

``interpolated_time`` answers shape queries between buckets by log-log
interpolation of time vs the bucket ``size`` coordinate (costs here are
polynomial in sequence/cache length, so they are straight lines in log-log
space); outside the covered range it extrapolates from the nearest bucket
at constant efficiency (time ∝ size).  A device/kernel with no buckets
returns None — callers (MeasuredCostModel) must fall back to the analytic
constants, never guess.
"""
from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from ..core.cluster import PROFILES
from ..kernels.tuning import CARD_TYPES

SCHEMA_VERSION = 1

KERNELS = ("flash_attention", "decode_attention", "paged_attention",
           "ssm_scan")


class CostDBVersionError(RuntimeError):
    """Schema-version mismatch between a CostDB file and this code."""


class CostDBSchemaError(RuntimeError):
    """Structurally invalid CostDB payload."""


@dataclass(frozen=True)
class Record:
    """One measured (device_type × kernel × shape-bucket) cell."""

    shape: Dict[str, int]
    size: int
    best_config: Dict[str, int]
    time_s: float
    flops: float
    useful_flops: float
    bytes: float
    mode: str                      # "device" | "interpret"
    configs_tried: int

    def compute_efficiency(self, peak_flops: float) -> float:
        """Achieved fraction of peak, counting only useful FLOPs — padding
        waste shows up as lost efficiency, as it should."""
        return self.useful_flops / (self.time_s * peak_flops)

    def hbm_efficiency(self, hbm_bw: float) -> float:
        return self.bytes / (self.time_s * hbm_bw)

    def better_than(self, other: "Record") -> bool:
        if self.mode != other.mode:
            return self.mode == "device"     # real measurement beats estimate
        return self.time_s < other.time_s

    def validate(self) -> None:
        if self.mode not in ("device", "interpret"):
            raise CostDBSchemaError(f"bad mode {self.mode!r}")
        if not (self.time_s > 0 and math.isfinite(self.time_s)):
            raise CostDBSchemaError(f"bad time_s {self.time_s!r}")
        for f in ("flops", "useful_flops", "bytes"):
            v = getattr(self, f)
            if not (v > 0 and math.isfinite(v)):
                raise CostDBSchemaError(f"bad {f} {v!r}")
        if self.size <= 0:
            raise CostDBSchemaError(f"bad size {self.size!r}")
        if not self.best_config:
            raise CostDBSchemaError("empty best_config")


@dataclass
class CostDB:
    # device_type -> kernel -> bucket name -> Record
    entries: Dict[str, Dict[str, Dict[str, Record]]] = field(
        default_factory=dict)
    schema_version: int = SCHEMA_VERSION

    # -------------------------------------------------------------- mutation
    def put(self, device_type: str, kernel: str, bucket: str,
            rec: Record) -> None:
        # unknown device types are rejected up front: a scheduler profile
        # (core.cluster.PROFILES) or a card the port measures on
        # (kernels.tuning.CARD_TYPES, e.g. "H100").  MeasuredCostModel
        # prices only the profiles; a card's records stay under its own
        # type and configure its kernels (load_tuned_defaults).
        if device_type not in PROFILES and device_type not in CARD_TYPES:
            raise CostDBSchemaError(
                f"unknown device type {device_type!r} "
                f"(known profiles: {sorted(PROFILES)}, cards: "
                f"{sorted(CARD_TYPES)})")
        rec.validate()
        self.entries.setdefault(device_type, {}) \
            .setdefault(kernel, {})[bucket] = rec

    def merge(self, other: "CostDB") -> "CostDB":
        """Union of the two DBs; colliding buckets keep the better
        measurement (device beats interpret, then lower time)."""
        if other.schema_version != self.schema_version:
            raise CostDBVersionError(
                f"cannot merge CostDB schema v{other.schema_version} into "
                f"v{self.schema_version}")
        for dt, kernels in other.entries.items():
            for kn, buckets in kernels.items():
                for bk, rec in buckets.items():
                    mine = self.entries.get(dt, {}).get(kn, {}).get(bk)
                    if mine is None or rec.better_than(mine):
                        self.put(dt, kn, bk, rec)
        return self

    # --------------------------------------------------------------- queries
    def device_types(self) -> List[str]:
        return sorted(self.entries)

    def records(self, device_type: str,
                kernel: str) -> Dict[str, Record]:
        return self.entries.get(device_type, {}).get(kernel, {})

    def lookup(self, device_type: str, kernel: str,
               bucket: str) -> Optional[Record]:
        return self.records(device_type, kernel).get(bucket)

    def best_config(self, device_type: str, kernel: str,
                    size: Optional[int] = None) -> Optional[Dict[str, int]]:
        """Tuned knobs for a kernel on a device type: the bucket nearest
        ``size`` (or the largest bucket — steady-state shapes — when no
        size is given)."""
        recs = self.records(device_type, kernel)
        if not recs:
            return None
        if size is None:
            rec = max(recs.values(), key=lambda r: r.size)
        else:
            rec = min(recs.values(),
                      key=lambda r: abs(math.log(r.size / size)))
        return dict(rec.best_config)

    def interpolated_time(self, device_type: str, kernel: str,
                          size: float) -> Optional[float]:
        """Best-config time at an off-bucket ``size`` (see module docstring).
        None when the (device, kernel) pair has no coverage at all."""
        recs = sorted(self.records(device_type, kernel).values(),
                      key=lambda r: r.size)
        if not recs:
            return None
        if size <= 0:
            raise ValueError(f"size must be positive, got {size}")
        if len(recs) == 1 or size <= recs[0].size:
            r = recs[0]
            return r.time_s * size / r.size       # constant-efficiency scale
        if size >= recs[-1].size:
            r = recs[-1]
            return r.time_s * size / r.size
        for lo, hi in zip(recs[:-1], recs[1:]):
            if lo.size <= size <= hi.size:
                t = ((math.log(size) - math.log(lo.size))
                     / (math.log(hi.size) - math.log(lo.size)))
                return math.exp((1 - t) * math.log(lo.time_s)
                                + t * math.log(hi.time_s))
        raise AssertionError("unreachable")       # pragma: no cover

    # ----------------------------------------------------------------- (de)ser
    def to_json(self) -> Dict:
        return {
            "schema_version": self.schema_version,
            "entries": {
                dt: {kn: {bk: asdict(rec) for bk, rec in buckets.items()}
                     for kn, buckets in kernels.items()}
                for dt, kernels in self.entries.items()
            },
        }

    @staticmethod
    def from_json(payload: Dict) -> "CostDB":
        if not isinstance(payload, dict) or "schema_version" not in payload:
            raise CostDBSchemaError("not a CostDB payload "
                                    "(missing schema_version)")
        version = payload["schema_version"]
        if version != SCHEMA_VERSION:
            raise CostDBVersionError(
                f"CostDB schema v{version} incompatible with this code "
                f"(wants v{SCHEMA_VERSION}); re-run the sweep")
        db = CostDB(schema_version=version)
        for dt, kernels in payload.get("entries", {}).items():
            if not isinstance(kernels, dict):
                raise CostDBSchemaError(f"entries[{dt!r}] is not an object")
            for kn, buckets in kernels.items():
                if kn not in KERNELS:
                    raise CostDBSchemaError(f"unknown kernel {kn!r} "
                                            f"(known: {KERNELS})")
                for bk, raw in buckets.items():
                    try:
                        rec = Record(**raw)
                    except TypeError as e:
                        raise CostDBSchemaError(
                            f"bad record {dt}/{kn}/{bk}: {e}") from None
                    db.put(dt, kn, bk, rec)
        return db

    def save(self, path) -> None:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(self.to_json(), indent=2, sort_keys=True))

    @staticmethod
    def load(path) -> "CostDB":
        return CostDB.from_json(json.loads(Path(path).read_text()))

    def describe(self) -> str:
        lines = [f"CostDB v{self.schema_version}"]
        for dt in self.device_types():
            for kn in sorted(self.entries[dt]):
                for bk, rec in sorted(self.entries[dt][kn].items()):
                    cfgs = " ".join(f"{k}={v}"
                                    for k, v in sorted(rec.best_config.items()))
                    lines.append(
                        f"  {dt:8s} {kn:18s} {bk:24s} {cfgs}  "
                        f"t={rec.time_s * 1e3:.3f}ms "
                        f"({rec.mode}, {rec.configs_tried} cfgs)")
        return "\n".join(lines)
