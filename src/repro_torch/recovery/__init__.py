"""Crash-consistent recovery for the whole async-RL stack, the port's
copy of ``repro.recovery`` (host code: no torch).

The control plane is a single point of total loss: device failures are
survived by elastic replanning (``sim.replan``), but nothing survived the
*controller* dying — job records, the incumbent pool plan, per-job
rollout buffers, staleness counters, the device ledger, and the RNG
streams all lived only in memory.  This package makes a controller
crash cost at most one snapshot interval of work, never an η violation,
and never a conservation-ledger discrepancy.

Lifecycle — snapshot → journal → crash → restore → replay
---------------------------------------------------------

1. **Snapshot** (``snapshot.RecoveryManager.snapshot``): on a
   configurable cadence the controller captures its full state as one
   atomic unit — control-plane job lifecycle + admission queue,
   incumbent ``PoolPlan`` + device-ownership ledger, per-job buffer
   contents with version/η counters, trainer step + params/optimizer
   (through the ``repro_torch.ckpt`` atomic write-tmp → fsync → rename →
   fsync-parent primitive in file mode), and RNG streams.  Taking a
   snapshot truncates the journal: everything before it is durable.

2. **Journal**: between snapshots every state transition that must not
   be lost is appended to a write-ahead journal *before* the next
   snapshot would capture it — rollout launches, completions
   (admitted or dropped), staleness evictions, train-step consumptions
   (with the consumed rollout ids), fault applications, and job
   submissions.  Entries are idempotence-keyed by monotonic rollout ids
   that are never reused across a crash.

3. **Crash** (``sim.ControllerCrash``): at ``t_crash`` everything since
   the last snapshot is discarded — in both simulators the event queue
   is stripped of all controller-internal events (completions, train
   steps, drain/commit timers, monitor polls), modeling total loss of
   controller memory.  External injections (hardware failures,
   stragglers, future arrivals) survive: the world keeps happening
   while the controller is down.

4. **Restore** (``restore.py``): state is reloaded from the snapshot
   and ``verify_restored`` *proves* it consistent before resuming — η
   bounds via ``PoolStalenessRegistry.assert_bounds``, per-job
   conservation ``launched == consumed + dropped + in_flight``, and the
   device ledger's ``owned ⊎ excluded == initial`` partition.  A
   restore that cannot prove its invariants raises ``RecoveryError``
   instead of resuming corrupt.  If the crash took devices with it,
   ``replan_for_restore`` routes the restored plan through the existing
   ``replan_pool`` warm start — crash + shrink is just an elastic
   replan from the snapshot.

5. **Replay**: journal entries are applied in order on top of the
   snapshot.  Launches whose completion never made it into the journal
   are *lost in-flight* (re-generated after resume); completions
   re-fill the buffers; consumption entries re-pop exactly the batches
   that were trained, asserting the popped rollout ids match the
   journal record — the **exactly-once guarantee**: no rollout is ever
   trained twice (a global consumed-id set is checked on every
   consumption, before and after the crash), and none is lost beyond
   the in-flight set.  A train step whose consumption committed but
   whose step did not is rolled back whole (the batch returns to the
   buffer head).  With the journal disabled, loss is instead bounded
   by one snapshot interval of consumed progress — the fig13 benchmark
   sweeps exactly this trade.

6. **Resume**: the controller comes back ``restore_latency_s`` (MTTR)
   after the crash, takes an immediate fresh snapshot (so a second
   crash replays from a clean base), relaunches generation on every
   surviving replica, and re-arms its timers.  Each crash is recorded
   as a ``RecoveryEvent`` (MTTR, lost rollouts, replayed entries) on
   the sim result.

Interaction with elastic replanning: a replan that was mid-drain at the
crash is simply dropped — ``pending_dead`` is part of the snapshot, so
the restored controller re-triggers the replan itself.  Device-failure
events that fire *during* the outage still mutate the world and are
handled at resume like any other accumulated damage.

Engine snapshots: ``serve.PagedEngine.quiesce`` drains in-flight
prefill/fork work (admitting nothing new) so an engine snapshot never
captures a half-prefilled request; a resumed run is token-identical.

Everything is off by default and provably free when attached but
unused: a no-crash run with a ``RecoveryManager`` attached is
bit-identical to one without (gated by tests).
"""
from .snapshot import (RecoveryConfig, RecoveryError, RecoveryEvent,
                       RecoveryManager)
from .restore import (capture_buffers, capture_control_plane,
                      capture_registry, replan_for_restore,
                      restore_buffers, restore_control_plane,
                      restore_registry, verify_restored)

__all__ = [
    "RecoveryConfig", "RecoveryError", "RecoveryEvent", "RecoveryManager",
    "capture_buffers", "capture_control_plane", "capture_registry",
    "restore_buffers", "restore_control_plane", "restore_registry",
    "replan_for_restore", "verify_restored",
]
