"""Crash-consistent snapshot + write-ahead journal for the async stack,
the port's copy of ``repro.recovery.snapshot``.

``RecoveryManager`` is the durability substrate used by both simulator
loops, the training launcher, and the restore layer (``restore.py``):

* ``snapshot(t, state)`` captures one *atomic* unit of controller state
  (the caller assembles the dict — control-plane records, pool plan,
  device ledger, per-job buffers with version/η counters, trainer
  params/optimizer, RNG streams) and truncates the journal.  In-memory
  mode stores the object as handed over (the caller must pass fresh
  copies); file mode persists it through the ``repro_torch.ckpt`` atomic
  write-tmp → fsync → rename → fsync-parent primitive.
* ``journal(entry)`` appends one write-ahead record between snapshots —
  rollout completions, train-step consumptions, launches, fault
  applications — so restore can *replay* forward from the last snapshot
  to exactly-once semantics: no rollout trained twice, none lost beyond
  the in-flight set.
* ``latest()`` returns ``(t, state, entries)`` for the restore path.

All IO goes through retry-with-exponential-backoff
(``RecoveryConfig.max_retries`` / ``backoff_s``) and surfaces as a typed
``RecoveryError`` once retries are exhausted — a transient full disk or
NFS hiccup must not take the controller down with it.

Observability: each snapshot updates the ``ckpt/snapshot_age_s`` gauge,
feeds ``HealthMonitor.on_snapshot`` (the snapshot-age detector alerts
when age exceeds the configured interval), and records a trace instant
on the ``recovery`` group.  All hooks are behind ``is not None`` so an
attached-but-unobserved manager is free.
"""
from __future__ import annotations

import os
import pickle
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, List, Optional, Tuple

__all__ = ["RecoveryError", "RecoveryConfig", "RecoveryEvent",
           "RecoveryManager"]


class RecoveryError(RuntimeError):
    """Typed failure of the recovery subsystem: exhausted IO retries,
    missing snapshot at restore time, or a journal-replay consistency
    violation (double consume, head mismatch)."""


@dataclass(frozen=True)
class RecoveryConfig:
    """Cadence + durability policy for ``RecoveryManager``.

    ``interval_s``      snapshot cadence (sim seconds in the simulators,
                        wall seconds in the launcher).
    ``restore_latency_s``  modeled controller downtime per crash (MTTR):
                        detect + reload + replay before work resumes.
    ``journal``         write-ahead journal on (exactly-once replay) or
                        off (loss bounded by one interval instead).
    ``snapshot_cost_s`` modeled trainer pause per snapshot (0 = free;
                        the fig13 sweep trades this against loss).
    ``directory``       None = in-memory (simulators); a path = durable
                        file-backed mode through the ``ckpt`` primitive.
    ``max_retries`` / ``backoff_s``  transient-IO retry policy: attempt
                        ``max_retries`` times, sleeping
                        ``backoff_s * 2**attempt`` between tries.
    """
    interval_s: float = 60.0
    restore_latency_s: float = 5.0
    journal: bool = True
    snapshot_cost_s: float = 0.0
    directory: Optional[str] = None
    max_retries: int = 4
    backoff_s: float = 0.05
    keep: int = 3

    def __post_init__(self) -> None:
        if self.interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        if self.restore_latency_s < 0 or self.snapshot_cost_s < 0:
            raise ValueError("latencies must be >= 0")
        if self.snapshot_cost_s >= self.interval_s:
            raise ValueError(
                "snapshot_cost_s must be < interval_s: a stop-the-world "
                "pause at least as long as the cadence starves the "
                "trainer forever")
        if self.max_retries < 1:
            raise ValueError("max_retries must be >= 1")


@dataclass
class RecoveryEvent:
    """Per-crash recovery record carried on the sim results.

    ``lost_inflight``  rollouts that were generating at the crash and
                       are re-generated after resume (the only loss the
                       journal allows).
    ``lost_consumed``  consumed-rollout progress rolled back across the
                       crash (0 with the journal on; ≤ one snapshot
                       interval's consumption with it off).
    ``journal_replayed``  write-ahead entries applied during restore.
    """
    t_crash: float
    t_snapshot: float
    t_resume: float
    mttr_s: float
    steps_before: int
    steps_after: int
    consumed_before: int
    consumed_after: int
    lost_inflight: int
    lost_consumed: int
    journal_replayed: int

    @property
    def snapshot_age_s(self) -> float:
        """How stale the restored snapshot was at the crash instant."""
        return self.t_crash - self.t_snapshot


class RecoveryManager:
    """Snapshot + journal store with retrying IO (module docstring)."""

    def __init__(self, cfg: Optional[RecoveryConfig] = None, *,
                 metrics=None, monitor=None, tracer=None):
        self.cfg = cfg or RecoveryConfig()
        self.metrics = metrics
        self.monitor = monitor
        self.tracer = tracer
        self.n_snapshots = 0
        self.n_journal_entries = 0           # appended since construction
        self.last_snapshot_t: Optional[float] = None
        self._snap: Optional[Tuple[float, Any]] = None
        self._entries: List[Any] = []
        self._sleep: Callable[[float], None] = time.sleep
        if self.cfg.directory is not None:
            Path(self.cfg.directory).mkdir(parents=True, exist_ok=True)

    # ------------------------------------------------------------- retry
    def _with_retry(self, what: str, fn: Callable[[], Any]) -> Any:
        last: Optional[BaseException] = None
        for attempt in range(self.cfg.max_retries):
            try:
                return fn()
            except OSError as e:             # transient IO: retry w/ backoff
                last = e
                if attempt + 1 < self.cfg.max_retries:
                    self._sleep(self.cfg.backoff_s * (2 ** attempt))
        raise RecoveryError(
            f"{what} failed after {self.cfg.max_retries} attempts: "
            f"{last!r}") from last

    # --------------------------------------------------------- snapshot
    def snapshot(self, t: float, state: Any) -> None:
        """Atomically capture ``state`` at time ``t`` and truncate the
        journal.  The caller hands over ownership of ``state`` (pass
        fresh containers; shared immutable objects like plans are fine
        by reference)."""
        if self.cfg.directory is not None:
            from repro_torch.ckpt.checkpoint import save_checkpoint
            self._with_retry("snapshot write", lambda: save_checkpoint(
                self.cfg.directory, self.n_snapshots,
                {"t": t, "state": state}, keep=self.cfg.keep))
            self._with_retry("journal truncate", self._truncate_journal)
        self._snap = (t, state)
        self._entries = []
        self.n_snapshots += 1
        self.last_snapshot_t = t
        if self.metrics is not None:
            self.metrics.gauge("ckpt/snapshot_age_s").set(0.0)
            self.metrics.counter("ckpt/snapshots").inc()
        if self.monitor is not None:
            self.monitor.on_snapshot(t)
        if self.tracer is not None:
            self.tracer.instant("recovery", "snapshot", "snapshot", t,
                                n=self.n_snapshots)

    # ---------------------------------------------------------- journal
    def journal(self, entry: Any) -> None:
        """Append one write-ahead record (no-op when journaling is off)."""
        if not self.cfg.journal:
            return
        self._entries.append(entry)
        self.n_journal_entries += 1
        if self.cfg.directory is not None:
            self._with_retry("journal append",
                             lambda: self._append_journal(entry))

    def _journal_path(self) -> Path:
        return Path(self.cfg.directory) / "journal.pkl"

    def _truncate_journal(self) -> None:
        with open(self._journal_path(), "wb") as f:
            f.flush()
            os.fsync(f.fileno())

    def _append_journal(self, entry: Any) -> None:
        with open(self._journal_path(), "ab") as f:
            pickle.dump(entry, f, protocol=pickle.HIGHEST_PROTOCOL)
            f.flush()
            os.fsync(f.fileno())

    # ---------------------------------------------------------- restore
    def latest(self) -> Tuple[float, Any, List[Any]]:
        """``(t, state, journal entries)`` of the most recent snapshot.

        In-memory mode returns the live objects; file mode reloads from
        disk (so a fresh process restores what a dead one wrote).
        Raises ``RecoveryError`` when no snapshot exists."""
        if self.cfg.directory is not None and self._snap is None:
            self._load_from_disk()
        if self._snap is None:
            raise RecoveryError("no snapshot to restore from")
        t, state = self._snap
        return t, state, list(self._entries)

    def _load_from_disk(self) -> None:
        from repro_torch.ckpt.checkpoint import latest_step, read_checkpoint
        if latest_step(self.cfg.directory) is None:
            return
        # host arrays, as the reference's restore returns them: a trainer
        # state goes onto its device through ``load_trainer_state``
        _, payload = self._with_retry(
            "snapshot read", lambda: read_checkpoint(self.cfg.directory))
        self._snap = (payload["t"], payload["state"])
        entries: List[Any] = []
        jp = self._journal_path()
        if jp.exists():
            with open(jp, "rb") as f:
                while True:
                    try:
                        entries.append(pickle.load(f))
                    except EOFError:
                        break
        self._entries = entries

    # ------------------------------------------------------------ stats
    def age(self, now: float) -> float:
        """Seconds since the last snapshot (inf when none was taken)."""
        if self.last_snapshot_t is None:
            return float("inf")
        return now - self.last_snapshot_t

    def observe_age(self, now: float) -> None:
        """Publish the snapshot-age gauge (callers poll on a cadence)."""
        if self.metrics is not None and self.last_snapshot_t is not None:
            self.metrics.gauge("ckpt/snapshot_age_s").set(self.age(now))

    def stats(self) -> dict:
        return {"n_snapshots": self.n_snapshots,
                "n_journal_entries": self.n_journal_entries,
                "pending_journal": len(self._entries),
                "last_snapshot_t": self.last_snapshot_t}
