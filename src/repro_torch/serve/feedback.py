"""Serving → scheduler feedback: the engine's observed behavior as a
report, the part of ``repro.serve.feedback`` the launcher prints.

``EngineReport`` is one engine's observed serving behavior on one device
type: throughput, slot and page occupancy, and the prefix-sharing
measurements (prefix hit rate, shared page fraction, ``g_eff`` = prompt
tokens logically needed per prompt token computed, radix hit rate), plus
the measured episode shape of multi-turn serving.  It is built from the
engine's metrics registry (``EngineStats.to_metrics``), the contract
between the engine and the cost-fitting loop.

``ServingCostModel``, ``fit_env_model`` and ``fit_gen_time`` price these
reports for the scheduler; they need the scheduler's cost model
(``core/``), which the port has not copied yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from .engine import EngineStats


@dataclass(frozen=True)
class EngineReport:
    """One engine's observed serving behavior on one device type."""

    device_type: str               # device-type name, e.g. "H100"
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
