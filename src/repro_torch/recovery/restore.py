"""Reconstruct runtime state from a snapshot and prove it consistent (the
port's copy of ``repro.recovery.restore``).

``snapshot.py`` stores opaque state; this module is the typed layer for
the *runtime* objects of the multi-tenant stack — it serializes
``ControlPlane`` records, ``JobBuffers`` contents, and the
``PoolStalenessRegistry`` into plain dicts (``capture_*``), rebuilds
live objects from them (``restore_*``), and verifies on restore that
the invariants the rest of the repo relies on hold *across the crash
boundary* (``verify_restored``):

* η bounds: every job's recorded staleness ≤ its configured η
  (``PoolStalenessRegistry.assert_bounds``), and every buffered rollout
  is still admissible under the restored version counter.
* Conservation: per-job ``launched == consumed + dropped + in_flight``
  and ``in_flight == generating + buffered``; the device ledger's
  ``owned ⊎ excluded == initial`` partition.

Violations raise the typed ``RecoveryError`` — a restore that cannot
prove its invariants must fail loudly, not resume corrupt.

Restoring onto a *changed* device pool (the crash took devices with it)
is not a special case: ``replan_for_restore`` routes the restored plan
through the existing ``replan_pool`` warm-start path, so crash + shrink
degenerates to the elastic replan the system already knows how to do.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core.jobs import ControlPlane, JobRecord
from repro_torch.core.staleness import (PoolStalenessRegistry, StalenessConfig,
                                  StalenessController)
from repro_torch.rl.buffer import JobBuffers, Rollout, RolloutBuffer

from .snapshot import RecoveryError

__all__ = ["capture_control_plane", "restore_control_plane",
           "capture_registry", "restore_registry",
           "capture_buffers", "restore_buffers",
           "verify_restored", "replan_for_restore"]


# ------------------------------------------------------------ ControlPlane
def capture_control_plane(cp: ControlPlane) -> Dict[str, Any]:
    """Deep-enough copy of the mutable control-plane state: records (with
    their lifecycle histories) and the decision log.  Specs and configs
    are shared by reference — they are immutable inputs."""
    recs = {}
    for name, rec in cp.records.items():
        cp2 = copy.copy(rec)
        cp2.history = list(rec.history)
        recs[name] = cp2
    return {"records": recs, "decisions": list(cp.decisions)}


def restore_control_plane(cp: ControlPlane, state: Dict[str, Any]) -> None:
    """Overwrite ``cp``'s mutable state in place from a capture.  The
    capture is consumed (re-copied) so one snapshot can be restored from
    more than once."""
    cp.records = {}
    for name, rec in state["records"].items():
        r2 = copy.copy(rec)
        r2.history = list(rec.history)
        cp.records[name] = r2
    cp.decisions = list(state["decisions"])


# --------------------------------------------------------------- Registry
def capture_registry(reg: PoolStalenessRegistry) -> Dict[str, Any]:
    ctls = {}
    for name, ctl in reg.controllers.items():
        ctls[name] = {
            "config": ctl.config,             # frozen-in-practice input
            "version": ctl.version,
            "in_flight": ctl.in_flight,
            "plan_epoch": ctl.plan_epoch,
            "staleness_hist": list(ctl._staleness_hist),
            "swap_log": list(ctl._swap_log),
        }
    return {"controllers": ctls, "handoff_log": list(reg._handoff_log)}


def restore_registry(state: Dict[str, Any]) -> PoolStalenessRegistry:
    reg = PoolStalenessRegistry()
    for name, c in state["controllers"].items():
        ctl = StalenessController(
            c["config"], version=c["version"], in_flight=c["in_flight"],
            plan_epoch=c["plan_epoch"],
            _staleness_hist=list(c["staleness_hist"]),
            _swap_log=list(c["swap_log"]))
        reg.controllers[name] = ctl
    reg._handoff_log = list(state["handoff_log"])
    return reg


# ---------------------------------------------------------------- Buffers
def _rollout_state(r: Rollout) -> Dict[str, Any]:
    return {"prompt_ids": list(r.prompt_ids),
            "completion_ids": list(r.completion_ids),
            "behavior_logp": list(r.behavior_logp),
            "version": r.version, "group_id": r.group_id,
            "reward": r.reward, "task": r.task,
            "plan_epoch": r.plan_epoch}


def capture_buffers(bufs: JobBuffers) -> Dict[str, Any]:
    out = {}
    for name in bufs.jobs():
        b = bufs[name]
        out[name] = {
            "config": b.config,
            "items": [_rollout_state(r) for r in b._items],
            "dropped": b.dropped,
            "ctl": {"version": b.ctl.version, "in_flight": b.ctl.in_flight,
                    "plan_epoch": b.ctl.plan_epoch,
                    "staleness_hist": list(b.ctl._staleness_hist),
                    "swap_log": list(b.ctl._swap_log)},
        }
    return out


def restore_buffers(state: Dict[str, Any]) -> JobBuffers:
    bufs = JobBuffers()
    for name, s in state.items():
        b = bufs.add_job(name, s["config"])
        b._items = [Rollout(**dict(r)) for r in s["items"]]
        b.dropped = s["dropped"]
        c = s["ctl"]
        b.ctl.version = c["version"]
        b.ctl.in_flight = c["in_flight"]
        b.ctl.plan_epoch = c["plan_epoch"]
        b.ctl._staleness_hist = list(c["staleness_hist"])
        b.ctl._swap_log = list(c["swap_log"])
    return bufs


# ------------------------------------------------------------ verification
def verify_restored(registry: Optional[PoolStalenessRegistry] = None,
                    buffers: Optional[JobBuffers] = None,
                    ledger=None,
                    counters: Optional[Dict[str, Dict[str, int]]] = None
                    ) -> None:
    """Prove the restored state consistent; raise ``RecoveryError`` if not.

    ``counters`` is an optional per-job conservation map
    ``{job: {launched, consumed, dropped, in_flight}}`` (the simulator
    ledger); ``ledger`` is a ``sim.DeviceLedger``-like object exposing
    ``conserved``.
    """
    if registry is not None:
        try:
            registry.assert_bounds()
        except AssertionError as e:
            raise RecoveryError(f"η bound violated after restore: {e}") \
                from e
    if buffers is not None:
        for name in buffers.jobs():
            b = buffers[name]
            eta = b.config.eta
            for r in b._items:
                lag = b.ctl.version - r.version
                if lag > eta:
                    raise RecoveryError(
                        f"job {name!r}: restored rollout staleness {lag} "
                        f"> η={eta}")
            if len(b._items) > b.ctl.in_flight:
                raise RecoveryError(
                    f"job {name!r}: buffered {len(b._items)} > "
                    f"in_flight {b.ctl.in_flight}")
    if ledger is not None and not ledger.conserved:
        raise RecoveryError("device ledger not conserved after restore")
    if counters is not None:
        for name, c in counters.items():
            lhs = c["launched"]
            rhs = c["consumed"] + c["dropped"] + c["in_flight"]
            if lhs != rhs:
                raise RecoveryError(
                    f"job {name!r}: conservation broken after restore: "
                    f"launched={lhs} != consumed+dropped+in_flight={rhs}")


# ------------------------------------------------------- changed-pool path
def replan_for_restore(prev_pool, cluster, pool_cfg=None, *,
                       dead_devices: Sequence[int] = (),
                       reason: str = "crash_restore"):
    """Restore onto a changed pool: exclude the devices the crash took
    and route through the ``replan_pool`` warm-start path, so the
    restored jobs land on what survives with their η accounting intact.
    Returns the new ``PoolPlan``."""
    import dataclasses
    from repro_torch.core.pool import replan_pool
    dead = set(dead_devices)
    if dead:
        surviving = [d for d in cluster.devices if d.index not in dead]
        cluster = dataclasses.replace(cluster, devices=surviving)
    return replan_pool(prev_pool, cluster, pool_cfg, reason=reason)
