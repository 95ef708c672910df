"""Serving → scheduler feedback: measured generation behavior as costs,
the port of ``repro.serve.feedback``.

``EngineReport`` is one engine's observed serving behavior on one device
type: throughput, slot and page occupancy, and the prefix-sharing
measurements (prefix hit rate, shared page fraction, ``g_eff`` = prompt
tokens logically needed per prompt token computed, radix hit rate), plus
the measured episode shape of multi-turn serving.  It is built from the
engine's metrics registry (``EngineStats.to_metrics``), the contract
between the engine and the cost-fitting loop.

Kernel microbenchmarks can measure the decode roofline, but the
*engine-level* factor — continuous-batching gaps, admission stalls,
sampling and scheduling overhead — is what no microbenchmark sees (the
analytic tables guess it as ``DECODE_ENGINE_EFF``).  The engine measures
it directly: ``slot_occupancy`` is the kept-token fraction of decode slot
capacity.  ``ServingCostModel`` overlays that observation, and the
measured prefix-sharing ``g_eff`` (replica prefill priced as
C_prefill / G_eff), per device type onto any fallback provider, so
``core.scheduler.schedule`` / ``core.pool.schedule_pool`` price rollout
replicas from observed serving behavior.  With no report for a type it
defers to the fallback, and with no provider at all plans stay
bit-identical to the analytic tables.  The roofline constants (peak
FLOPS, HBM bandwidth, MFU tables) stay the profile's.

``fit_env_model`` rebuilds the scheduler's third-stage ``EnvCostModel``
from a multi-turn report's episode shape (turns per episode, mean
inter-turn env gap), and ``fit_gen_time`` turns the engine's per-request
(length, seconds) samples into a ``core.cost_model.GenTimeModel``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.cluster import DeviceProfile
from repro_torch.core.cost_model import (ANALYTIC, CostProvider,
                                         EnvCostModel, GenTimeModel)

from .engine import EngineStats

# measured efficiency factors are clamped to [floor, ceil] before pricing
_EFF_FLOOR, _EFF_CEIL = 0.01, 0.95


def _clip(x: float) -> float:
    return min(_EFF_CEIL, max(_EFF_FLOOR, x))


@dataclass(frozen=True)
class EngineReport:
    """One engine's observed serving behavior on one device type."""

    device_type: str               # DeviceProfile name, e.g. "H800"
    engine: str                    # "paged" | "static"
    tokens_per_sec: float
    slot_occupancy: float          # kept tokens / (decode steps × slots)
    page_occupancy: float          # live tokens / allocated page capacity
    batch_slots: int
    decode_steps: int
    # prefix sharing (COW forks): measured on the engine, priced by the
    # scheduler as C_prefill / g_eff.  Defaults = no sharing observed.
    prefix_hit_rate: float = 0.0   # prompt tokens served by a fork / needed
    shared_page_fraction: float = 0.0  # logical page refs on shared pages
    g_eff: float = 1.0             # needed prompt tokens / computed ones
    # multi-turn agentic serving: the radix-cache share of the prefix hits
    # (subset of prefix_hit_rate) plus the measured episode shape
    radix_hit_rate: float = 0.0    # prompt tokens served from the radix tree
    turns_per_episode: float = 1.0
    turn_gap_s: float = 0.0        # mean measured env/tool inter-turn gap
    # block-table upload count: how often steady decode had to re-stream
    # the [max_slots, maxp] table to the device
    bt_uploads: int = 0

    @classmethod
    def from_metrics(cls, snap: Dict, device_type: str,
                     *, engine: str = "paged",
                     tokens_per_sec: float = 0.0,
                     turns_per_episode: float = 1.0,
                     turn_gap_s: float = 0.0) -> "EngineReport":
        """Build a report from a ``MetricsRegistry.snapshot()`` produced
        by ``EngineStats.to_metrics()`` — nothing here touches
        ``EngineStats`` fields directly."""
        c = snap.get("counters", {})
        g = snap.get("gauges", {})
        return cls(device_type=device_type, engine=engine,
                   tokens_per_sec=tokens_per_sec,
                   slot_occupancy=float(g.get("engine/slot_occupancy", 1.0)),
                   page_occupancy=float(g.get("engine/page_occupancy", 1.0)),
                   batch_slots=int(g.get("engine/max_slots", 0)),
                   decode_steps=int(c.get("engine/decode_steps", 0)),
                   prefix_hit_rate=float(g.get("engine/prefix_hit_rate",
                                               0.0)),
                   shared_page_fraction=float(
                       g.get("engine/shared_page_fraction", 0.0)),
                   g_eff=float(g.get("engine/g_eff", 1.0)),
                   radix_hit_rate=float(g.get("engine/radix_hit_rate", 0.0)),
                   turns_per_episode=turns_per_episode,
                   turn_gap_s=turn_gap_s,
                   bt_uploads=int(c.get("engine/bt_uploads", 0)))

    @classmethod
    def from_stats(cls, stats: EngineStats, device_type: str,
                   *, engine: str = "paged",
                   tokens_per_sec: float = 0.0,
                   turns_per_episode: float = 1.0,
                   turn_gap_s: float = 0.0) -> "EngineReport":
        """Routed through the metrics registry (``to_metrics`` →
        ``from_metrics``) so stats stay a single-writer detail of the
        engine."""
        return cls.from_metrics(stats.to_metrics().snapshot(), device_type,
                                engine=engine, tokens_per_sec=tokens_per_sec,
                                turns_per_episode=turns_per_episode,
                                turn_gap_s=turn_gap_s)


class ServingCostModel(CostProvider):
    """CostProvider overlay: decode_engine_eff from engine reports."""

    name = "serving"

    def __init__(self, reports: Union[Iterable[EngineReport],
                                      Dict[str, EngineReport]],
                 fallback: Optional[CostProvider] = None):
        if isinstance(reports, dict):
            self.reports = dict(reports)
        else:
            self.reports = {r.device_type: r for r in reports}
        self.fallback = fallback if fallback is not None else ANALYTIC

    def decode_engine_eff(self, profile: DeviceProfile) -> float:
        rep = self.reports.get(profile.name)
        if rep is None or rep.decode_steps <= 0:
            return self.fallback.decode_engine_eff(profile)
        return _clip(rep.slot_occupancy)

    def prefill_g_eff(self, profile: DeviceProfile) -> float:
        """Measured prefix-sharing amortization: replica prefill is priced
        as C_prefill / G_eff.  Clamped at ≥1 (sharing can only help); no
        report for the type → fallback (default 1.0 → bit-identical)."""
        rep = self.reports.get(profile.name)
        if rep is None or rep.decode_steps <= 0:
            return self.fallback.prefill_g_eff(profile)
        return max(float(rep.g_eff), 1.0)

    # every roofline-level factor defers to the fallback provider
    def train_mfu(self, profile: DeviceProfile) -> float:
        return self.fallback.train_mfu(profile)

    def prefill_mfu(self, profile: DeviceProfile) -> float:
        return self.fallback.prefill_mfu(profile)

    def decode_compute_eff(self, profile: DeviceProfile) -> float:
        return self.fallback.decode_compute_eff(profile)

    def hbm_eff(self, profile: DeviceProfile) -> float:
        return self.fallback.hbm_eff(profile)


def fit_env_model(report: EngineReport, *, workers: int = 64,
                  cv: float = 0.5,
                  overlap: float = 0.0) -> Optional[EnvCostModel]:
    """Measured multi-turn serving → the scheduler's third-stage env model.

    Rebuilds a ``core.cost_model.EnvCostModel`` from the engine-side
    episode shape (mean turns per episode, mean inter-turn gap); the
    pool-side knobs the engine cannot observe (worker count, latency
    spread, decode overlap) are passed through.  A single-turn report
    (turns ≤ 1 or no measured gap) returns None — callers keep
    ``SchedulerConfig.env = None`` and plans stay bit-identical.
    """
    if report.turns_per_episode <= 1.0 or report.turn_gap_s <= 0.0:
        return None
    return EnvCostModel(mean_s=report.turn_gap_s, cv=cv,
                        turns=report.turns_per_episode,
                        workers=workers, overlap=overlap)


def fit_gen_time(samples: Sequence[Tuple[int, float]],
                 prompt_len: float = 0.0,
                 g_eff: float = 1.0,
                 turns: float = 1.0,
                 turn_gap_s: float = 0.0) -> Optional[GenTimeModel]:
    """Least-squares fit of T(L) = t_prefill + a·L + b·L·(prompt + L/2)
    over the engine's per-request (completion length, seconds) samples.
    Needs ≥3 distinct lengths to resolve the quadratic; returns None
    otherwise (callers keep the analytic model).

    ``g_eff`` (e.g. ``EngineStats.g_eff``) marks the prefix-sharing
    amortization the simulator should charge: the fitted t_prefill is
    divided by it at evaluation time (``GenTimeModel.raw``).  Pass it
    when the samples came from an engine WITHOUT sharing but the
    simulated deployment will share; samples from a sharing engine
    already absorb the saving, so the default 1.0 is correct there.

    ``turns``/``turn_gap_s`` (e.g. from a multi-turn ``EngineReport``)
    stamp the episode shape onto the model: ``GenTimeModel.duration``
    adds (turns−1)·gap of un-normalized env wall time per episode.  The
    defaults add nothing — single-turn fits are unchanged."""
    if len({ln for ln, _ in samples}) < 3:
        return None
    L = np.asarray([ln for ln, _ in samples], np.float64)
    T = np.asarray([t for _, t in samples], np.float64)
    X = np.stack([np.ones_like(L), L, L * (prompt_len + L / 2.0)], axis=1)
    coef, *_ = np.linalg.lstsq(X, T, rcond=None)
    tp, a, b = (max(float(c), 0.0) for c in coef)
    if a == 0.0 and b == 0.0:
        return None
    return GenTimeModel(a=a, b=b, t_prefill=tp, g_eff=max(g_eff, 1.0),
                        turns=max(turns, 1.0),
                        turn_gap_s=max(turn_gap_s, 0.0))
