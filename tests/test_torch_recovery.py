"""The port's crash recovery (``repro_torch.recovery``) against the
reference's ``repro.recovery``, on the CPU.

* ``RecoveryManager``: the same retry-with-backoff sleeps, the same typed
  ``RecoveryError`` after the last attempt, the same config checks, and
  the snapshot feeding a registry and a monitor alike.
* File mode: a snapshot of plain values and its journal written by either
  package read back by either, through each package's own
  ``ckpt.checkpoint`` (four writer/reader pairs).
* ``capture_*`` / ``restore_*`` / ``verify_restored`` under random
  interleavings of launches, pushes, pops, version bumps, handoffs, plan
  swaps, snapshots and crashes: both packages' captures are equal after
  every operation, and a restore is idempotent and conserves rollouts.
* ``replan_for_restore`` onto a pool that lost devices: the same plan.
* The simulators' controller crash in file mode: the same results as in
  memory and as the reference's.
* The port's runtime: a ``PagedEngine`` quiesced twice mid-run gives the
  tokens of an uninterrupted run, and a trainer's params, AdamW moments
  and buffered rollouts snapshotted in file mode restore bit for bit
  into a fresh trainer."""
import collections
import copy
import dataclasses
import importlib
import pickle

import numpy as np
import pytest

try:
    import hypothesis.strategies as st
    from hypothesis import given, settings
except ImportError:
    from _prop import given, settings, st

from _plan_parity import plain

PKGS = ("repro", "repro_torch")


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def both(case):
    ref, port = (plain(case(pkg)) for pkg in PKGS)
    assert port == ref
    return ref


# ------------------------------------------------------ RecoveryManager unit
def test_retry_with_backoff_matches_reference():
    def case(pkg):
        rec = mod(pkg, "recovery")
        m = rec.RecoveryManager(rec.RecoveryConfig(max_retries=4,
                                                   backoff_s=0.1))
        sleeps, calls = [], {"n": 0}
        m._sleep = sleeps.append

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise OSError("disk hiccup")
            return "ok"
        return m._with_retry("write", flaky), sleeps, calls["n"]
    assert both(case) == ["ok", [0.1, 0.2], 3]


def test_retry_exhaustion_raises_the_typed_error():
    def case(pkg):
        rec = mod(pkg, "recovery")
        m = rec.RecoveryManager(rec.RecoveryConfig(max_retries=3,
                                                   backoff_s=0.01))
        sleeps = []
        m._sleep = sleeps.append

        def always_fails():
            raise OSError("full")
        with pytest.raises(rec.RecoveryError) as e:
            m._with_retry("journal append", always_fails)
        assert isinstance(e.value, RuntimeError)
        assert isinstance(e.value.__cause__, OSError)
        with pytest.raises(rec.RecoveryError, match="no snapshot"):
            rec.RecoveryManager().latest()
        return str(e.value), sleeps
    msg, _ = both(case)
    assert "3 attempts" in msg


@pytest.mark.parametrize("kw", [dict(interval_s=0.0),
                                dict(restore_latency_s=-1.0),
                                dict(interval_s=5.0, snapshot_cost_s=5.0),
                                dict(max_retries=0)])
def test_config_checks_match_reference(kw):
    def case(pkg):
        with pytest.raises(ValueError) as e:
            mod(pkg, "recovery").RecoveryConfig(**kw)
        return str(e.value)
    both(case)


def test_snapshot_feeds_metrics_monitor_and_trace_like_reference():
    def case(pkg):
        rec, obs = mod(pkg, "recovery"), mod(pkg, "obs")
        reg, tr = obs.MetricsRegistry(), obs.Tracer()
        mon = obs.HealthMonitor(obs.MonitorConfig(snapshot_interval_s=5.0,
                                                  cooldown_s=1.0))
        m = rec.RecoveryManager(rec.RecoveryConfig(interval_s=5.0),
                                metrics=reg, monitor=mon, tracer=tr)
        m.snapshot(10.0, {})
        m.journal({"k": "rollout", "rid": 1})
        m.observe_age(14.0)
        alerts = [a.to_dict() for a in mon.poll(21.0)]
        return (m.stats(), m.age(13.5), reg.snapshot(), alerts,
                [ev[:4] for ev in tr._events])
    out = both(case)
    assert out[0]["n_snapshots"] == 1 and out[3]


# ------------------------------------------------------------------ file mode
STATE = {"steps": 3, "buffer": [1, 2], "cfg": {"eta": 4, "name": "j"},
         "pair": (0.5, -1), "none": None, "arr": np.arange(4.0)}
ENTRIES = [{"k": "rollout", "rid": 7}, {"k": "train", "rids": [7, 8]}]


@pytest.mark.parametrize("writer", PKGS)
@pytest.mark.parametrize("reader", PKGS)
def test_file_mode_snapshot_and_journal_cross_read(tmp_path, writer,
                                                   reader):
    d = str(tmp_path / "rec")
    w = mod(writer, "recovery")
    m = w.RecoveryManager(w.RecoveryConfig(interval_s=5.0, directory=d))
    m.snapshot(10.0, copy.deepcopy(STATE))
    for e in ENTRIES:
        m.journal(e)
    r = mod(reader, "recovery")
    t, state, entries = r.RecoveryManager(
        r.RecoveryConfig(interval_s=5.0, directory=d)).latest()
    # what the reference reads from its own files is the yardstick
    ref = mod("repro", "recovery")
    d2 = str(tmp_path / "ref")
    m2 = ref.RecoveryManager(ref.RecoveryConfig(interval_s=5.0,
                                                directory=d2))
    m2.snapshot(10.0, copy.deepcopy(STATE))
    for e in ENTRIES:
        m2.journal(e)
    want = ref.RecoveryManager(ref.RecoveryConfig(interval_s=5.0,
                                                  directory=d2)).latest()
    assert plain((t, state, entries)) == plain(want)
    assert t == 10.0 and entries == ENTRIES
    assert state["steps"] == 3 and list(state["buffer"]) == [1, 2]
    # a new snapshot truncates the journal durably
    m3 = r.RecoveryManager(r.RecoveryConfig(interval_s=5.0, directory=d))
    m3.snapshot(20.0, {"steps": 4})
    assert plain(w.RecoveryManager(w.RecoveryConfig(
        interval_s=5.0, directory=d)).latest()) == plain(
        (np.asarray(20.0), {"steps": np.asarray(4)}, []))


def test_file_mode_keeps_objects_and_reads_host_arrays(tmp_path):
    """The port pickles a snapshot's configs as themselves and reads
    tensors back as host arrays (no device is touched on restore)."""
    import torch
    from repro_torch.core.staleness import StalenessConfig
    from repro_torch.recovery import RecoveryConfig, RecoveryManager
    d = str(tmp_path / "rec")
    cfg = StalenessConfig(eta=3, rollouts_per_step=8)
    x = torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)
    RecoveryManager(RecoveryConfig(directory=d)).snapshot(
        1.0, {"cfg": cfg, "x": x})
    _, state, _ = RecoveryManager(RecoveryConfig(directory=d)).latest()
    assert state["cfg"] == cfg
    assert isinstance(state["x"], np.ndarray)
    assert state["x"].dtype == np.float32
    np.testing.assert_array_equal(state["x"], x.float().numpy())


Pair = collections.namedtuple("Pair", "a b")


@dataclasses.dataclass
class Holder:
    x: object


class Plain:
    def __init__(self, x):
        self.inner = {"t": x}


def test_checkpoint_descends_namedtuples_and_refuses_hidden_tensors(
        tmp_path):
    """A namedtuple's tensors are written as host arrays, as the
    reference's ``tree_map`` writes them; an object that is not a
    container and holds a tensor is refused instead of pickled with it."""
    import torch
    from repro_torch.ckpt.checkpoint import read_checkpoint, save_checkpoint
    save_checkpoint(tmp_path, 1, {"p": Pair(torch.ones(2), [torch.zeros(1),
                                                            None])})
    _, state = read_checkpoint(tmp_path)
    assert type(state["p"]) is Pair
    assert isinstance(state["p"].a, np.ndarray)
    np.testing.assert_array_equal(state["p"].a, np.ones(2, np.float32))
    assert isinstance(state["p"].b[0], np.ndarray) and state["p"].b[1] is None
    for bad in (Holder(torch.ones(1)), Holder([Holder(torch.ones(1))]),
                Plain(torch.ones(1))):
        with pytest.raises(TypeError, match="holds a tensor"):
            save_checkpoint(tmp_path, 2, {"bad": bad})
    save_checkpoint(tmp_path, 3, {"ok": Holder(np.ones(1))})
    _, state = read_checkpoint(tmp_path, 3)
    np.testing.assert_array_equal(state["ok"].x, np.ones(1))


# ------------------------------------- capture / restore / verify (property)
_OPS = ["push_a", "push_b", "gen_a", "finish_a", "pop_a", "pop_b",
        "bump_a", "bump_b", "handoff_ab", "handoff_ba", "swap_a",
        "snap", "crash"]


def _replay(pkg, ops):
    """The reference test's model of two jobs' buffers and registry driven
    by ``ops``; returns the capture after every op."""
    rec, buf_m = mod(pkg, "recovery"), mod(pkg, "rl.buffer")
    stm = mod(pkg, "core.staleness")
    bufs, reg, model = buf_m.JobBuffers(), stm.PoolStalenessRegistry(), {}
    for name, eta in (("a", 2), ("b", 1)):
        cfg = stm.StalenessConfig(eta=eta, rollouts_per_step=4)
        bufs.add_job(name, cfg)
        reg.add_job(name, cfg)
        model[name] = {"launched": 0, "consumed": 0, "dropped": 0,
                       "generating": 0}

    def capture():
        return {"bufs": rec.capture_buffers(bufs),
                "reg": rec.capture_registry(reg),
                "model": copy.deepcopy(model)}

    def rollout(version):
        return buf_m.Rollout(prompt_ids=[1, 2], completion_ids=[3],
                             behavior_logp=np.zeros(1, np.float32),
                             version=version, group_id=0)

    snap, trail = capture(), []
    for op in ops:
        if op in ("push_a", "push_b"):
            name = op[-1]
            b = bufs[name]
            if b.can_launch(1):
                b.launch(1)
                reg.controller(name).launch(1)
                b.push(rollout(b.ctl.version))
                model[name]["launched"] += 1
        elif op == "gen_a":
            if bufs["a"].can_launch(1):
                bufs["a"].launch(1)
                reg.controller("a").launch(1)
                model["a"]["launched"] += 1
                model["a"]["generating"] += 1
        elif op == "finish_a":
            if model["a"]["generating"] > 0:
                bufs["a"].push(rollout(bufs["a"].ctl.version))
                model["a"]["generating"] -= 1
        elif op in ("pop_a", "pop_b"):
            name = op[-1]
            if bufs[name].ready(2):
                batch = bufs[name].pop_batch(2)
                reg.controller(name).consume([r.version for r in batch])
                model[name]["consumed"] += 2
        elif op in ("bump_a", "bump_b"):
            name = op[-1]
            before = bufs[name].dropped
            bufs[name].bump_version()
            evicted = bufs[name].dropped - before
            reg.controller(name).bump_version()
            if evicted:
                reg.controller(name).drop(evicted)
        elif op in ("handoff_ab", "handoff_ba"):
            bufs.on_device_handoff(op[-2], op[-1])
            reg.record_handoff(op[-2], op[-1])
        elif op == "swap_a":
            bufs["a"].on_plan_swap()
        elif op == "snap":
            snap = capture()
        elif op == "crash":
            bufs = rec.restore_buffers(snap["bufs"])
            reg = rec.restore_registry(snap["reg"])
            model = copy.deepcopy(snap["model"])
            again = rec.restore_buffers(snap["bufs"])
            assert rec.capture_buffers(again) == rec.capture_buffers(bufs)
        counters = {}
        for name in bufs.jobs():
            b, m = bufs[name], model[name]
            assert b.ctl.in_flight == len(b._items) + m["generating"]
            counters[name] = {"launched": m["launched"],
                              "consumed": m["consumed"],
                              "dropped": m["dropped"] + b.dropped,
                              "in_flight": b.ctl.in_flight}
        rec.verify_restored(registry=reg, buffers=bufs, counters=counters)
        trail.append(capture())
    return trail


@settings(max_examples=25, deadline=None)
@given(st.lists(st.sampled_from(_OPS), min_size=1, max_size=50))
def test_snapshot_restore_replay_matches_reference(ops):
    ref, port = (plain(_replay(pkg, ops)) for pkg in PKGS)
    assert port == ref


def test_verify_restored_raises_the_typed_error_like_reference():
    def case(pkg):
        rec, buf_m = mod(pkg, "recovery"), mod(pkg, "rl.buffer")
        stm = mod(pkg, "core.staleness")
        msgs = []
        bufs = buf_m.JobBuffers()
        b = bufs.add_job("a", stm.StalenessConfig(eta=1, rollouts_per_step=2))
        b.launch(1)
        b.push(buf_m.Rollout([1], [2], np.zeros(1, np.float32), version=0,
                             group_id=0))
        b.ctl.version = 3                      # a restored stale rollout
        reg = stm.PoolStalenessRegistry()
        reg.add_job("a", stm.StalenessConfig(eta=1))._staleness_hist = [3]
        bad_ledger = type("L", (), {"conserved": False})()
        for kw in (dict(buffers=bufs), dict(registry=reg),
                   dict(ledger=bad_ledger),
                   dict(counters={"a": {"launched": 3, "consumed": 1,
                                        "dropped": 0, "in_flight": 1}})):
            with pytest.raises(rec.RecoveryError) as e:
                rec.verify_restored(**kw)
            msgs.append(str(e.value))
        return msgs
    assert len(both(case)) == 4


def test_control_plane_capture_restore_matches_reference():
    def case(pkg):
        rec, jobs = mod(pkg, "recovery"), mod(pkg, "core.jobs")
        P = mod(pkg, "core.cost_model").LengthDistribution(mean_len=1024,
                                                           prompt_len=128)
        sched = mod(pkg, "core.scheduler")
        spec = mod(pkg, "core.model_spec").PAPER_MODELS["1.5B"]
        job = mod(pkg, "core.pool").JobSpec(
            "a", spec, P, sched.SchedulerConfig(
                tokens_per_step=2 ** 18, stable_iters=3, max_iters=12,
                adapt_delta=False))
        cp = jobs.ControlPlane(mod(pkg, "core.cluster").paper_heterogeneous(
            8, 8), cfg=jobs.AdmissionConfig(price_on_submit=False))
        cp.submit(job, t=1.0)
        cap = rec.capture_control_plane(cp)
        cp.records = {}
        cp.decisions = []
        rec.restore_control_plane(cp, cap)
        rec.restore_control_plane(cp, cap)       # a capture restores twice
        return cp.records, cp.decisions
    both(case)


# ----------------------------------------------------------- changed pool
@pytest.fixture(scope="module")
def pools():
    out = {}
    for pkg in PKGS:
        pool, stm = mod(pkg, "core.pool"), mod(pkg, "core.staleness")
        sched = mod(pkg, "core.scheduler")
        P = mod(pkg, "core.cost_model").LengthDistribution(mean_len=1024,
                                                           prompt_len=128)
        specs = mod(pkg, "core.model_spec").PAPER_MODELS

        def cfg(eta):
            return sched.SchedulerConfig(
                tokens_per_step=2 ** 18, stable_iters=3, max_iters=12,
                adapt_delta=False, staleness=stm.StalenessConfig(eta=eta))
        jobs = [pool.JobSpec("j1.5b", specs["1.5B"], P, cfg(4), weight=1.0),
                pool.JobSpec("j7b", specs["7B"], P, cfg(2), weight=4.0)]
        cluster = mod(pkg, "core.cluster").paper_heterogeneous(8, 24)
        out[pkg] = (pool.schedule_pool(jobs, cluster), cluster)
    assert plain(out["repro_torch"][0]) == plain(out["repro"][0])
    return out


def test_replan_for_restore_matches_reference(pools):
    def case(pkg):
        pool, cluster = pools[pkg]
        dead = sorted(pool.job_devices("j1.5b"))[:2]
        new = mod(pkg, "recovery").replan_for_restore(pool, cluster,
                                                      dead_devices=dead)
        assert not set(dead) & set(new.owner)
        surviving = dataclasses.replace(
            cluster, devices=[d for d in cluster.devices
                              if d.index not in set(dead)])
        new.assert_partition(surviving)
        return new
    both(case)


SIM = dict(n_steps=8, rollouts_per_step=32, eta=4, reward_cost_s=0.1)


@pytest.mark.parametrize("journal", [True, False])
def test_sim_crash_in_file_mode_matches_memory_and_reference(tmp_path,
                                                             journal):
    res = {}
    for pkg in PKGS:
        sim, rec = mod(pkg, "sim"), mod(pkg, "recovery")
        P = mod(pkg, "core.cost_model").LengthDistribution(mean_len=1024,
                                                           prompt_len=128)
        plan = mod(pkg, "core.scheduler").schedule(
            mod(pkg, "core.model_spec").PAPER_MODELS["1.5B"],
            mod(pkg, "core.cluster").paper_heterogeneous(8, 8), P,
            mod(pkg, "core.scheduler").SchedulerConfig(
                tokens_per_step=2 ** 18, stable_iters=3, max_iters=12,
                adapt_delta=False))
        runs = []
        for directory in (None, str(tmp_path / pkg)):
            mgr = rec.RecoveryManager(rec.RecoveryConfig(
                interval_s=5.0, restore_latency_s=2.0, journal=journal,
                directory=directory))
            runs.append(sim.AsyncRLSimulator(plan, P, sim.SimConfig(
                **SIM, seed=3, recovery=mgr, check_invariants=True,
                crashes=[sim.ControllerCrash(12.0)])).run())
        assert runs[0] == runs[1]
        res[pkg] = runs[1]
        [rv] = runs[1].recoveries
        assert rv.snapshot_age_s <= 5.0 + 1e-9 and rv.mttr_s == 2.0
        if journal:
            assert rv.lost_consumed == 0
    assert plain(res["repro_torch"]) == plain(res["repro"])


def test_multi_job_crash_matches_reference(pools):
    res = {}
    for pkg in PKGS:
        sim, rec = mod(pkg, "sim"), mod(pkg, "recovery")
        pool, _ = pools[pkg]
        r = sim.MultiJobSimulator(pool, sim.MultiSimConfig(
            n_steps=6, rollouts_per_step=32, check_invariants=True,
            recovery=rec.RecoveryManager(rec.RecoveryConfig(
                interval_s=5.0, restore_latency_s=2.0)),
            crashes=[sim.ControllerCrash(4.0)])).run()
        res[pkg] = (r.per_job, r.recoveries, r.wall_time_s, r.owner_final,
                    sorted(r.excluded))
        assert all(j.steps == 6 for j in r.per_job.values())
        [rv] = r.recoveries
        assert rv.lost_consumed == 0
    assert plain(res["repro_torch"]) == plain(res["repro"])


def test_sim_crash_requires_a_manager():
    from repro_torch.core.cost_model import LengthDistribution
    from repro_torch.sim import AsyncRLSimulator, ControllerCrash, SimConfig
    from repro_torch.core.cluster import paper_heterogeneous
    from repro_torch.core.model_spec import PAPER_MODELS
    from repro_torch.core.scheduler import schedule
    P = LengthDistribution(mean_len=1024, prompt_len=128)
    plan = schedule(PAPER_MODELS["1.5B"], paper_heterogeneous(8, 8), P)
    with pytest.raises(ValueError, match="recovery"):
        AsyncRLSimulator(plan, P, SimConfig(
            **SIM, crashes=[ControllerCrash(5.0)])).run()


# ------------------------------------------------- the port's own runtime
def _tiny_engine():
    from repro_torch.data.tasks import MathTaskGenerator, Tokenizer
    from repro_torch.models import transformer
    from repro_torch.models.api import ModelConfig
    from repro_torch.rl.rollout import GenConfig
    from repro_torch.rl.weight_sync import WeightStore
    from repro_torch.serve import PagedEngine, ServeConfig

    tiny = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=32,
                       n_heads=4, n_kv_heads=2, d_ff=64,
                       vocab=Tokenizer().vocab_size, dtype="float32",
                       remat=False)
    store = WeightStore()
    store.publish(transformer.init(0, tiny, "cpu"))
    # small prefill chunks: prompts take several steps, so quiesce finds
    # requests mid-prefill to drain
    sc = ServeConfig(max_slots=4, max_len=96, prefill_chunk=2)
    eng = PagedEngine(tiny, store, GenConfig(max_new_tokens=12, greedy=True),
                      sc, rng_seed=1, device="cpu")
    return eng, MathTaskGenerator(seed=0).batch(6)


def test_paged_engine_quiesce_is_token_identical():
    eng, tasks = _tiny_engine()
    eng.submit(tasks)
    eng.drain()
    plain_run, _ = eng.collect()

    eng, tasks = _tiny_engine()
    eng.submit(tasks)
    eng.step()
    assert any(r.state in ("PREFILL", "FORK") for r in eng._active.values())
    assert eng.quiesce() > 0
    assert all(r.state == "DECODE" for r in eng._active.values())
    assert eng._queue                       # unadmitted work stays queued
    eng.step()
    eng.quiesce()
    eng.drain()
    quiesced, _ = eng.collect()
    assert [r.completion_ids for r in quiesced] == \
        [r.completion_ids for r in plain_run]


def test_trainer_state_and_rollouts_restore_bit_for_bit(tmp_path):
    """The card's recovery phase at smoke size: a trainer's params, AdamW
    moments and buffered rollouts are snapshotted after one step; the
    trainer takes another; a fresh manager on the same directory restores
    the snapshot into a fresh trainer, bit for bit, and the restored
    buffers pass ``verify_restored``."""
    import torch
    from repro_torch.ckpt.checkpoint import load_trainer_state, trainer_state
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.staleness import StalenessConfig
    from repro_torch.optim.adamw import named_leaves
    from repro_torch.recovery import (RecoveryConfig, RecoveryManager,
                                      capture_buffers, restore_buffers,
                                      verify_restored)
    from repro_torch.rl.async_trainer import AsyncGRPOTrainer, TrainerConfig
    from repro_torch.rl.buffer import JobBuffers

    cfg = get_smoke_config("qwen-distill-1.5b").replace(
        vocab=259, dtype="float32", remat=False)
    tc = TrainerConfig(group_size=4, prompts_per_step=2, engine="paged",
                       staleness=StalenessConfig(eta=2, rollouts_per_step=8))
    tr = AsyncGRPOTrainer(cfg, tc, device="cpu")
    tr.run(1, verbose=False)
    tr.produce()                            # a batch waits in the buffer
    bufs = JobBuffers()
    bufs._bufs["trainer"] = tr.buffer
    want = {n: p.detach().clone() for n, p in named_leaves(tr.params)}
    want_m = {n: t.clone() for n, t in tr.opt_state["m"].items()}
    want_rollouts = [copy.deepcopy(r) for r in tr.buffer._items]
    d = str(tmp_path / "rec")
    RecoveryManager(RecoveryConfig(directory=d)).snapshot(1.0, {
        "trainer": trainer_state(tr.params, tr.opt_state, tr.store.version),
        "buffers": capture_buffers(bufs)})
    tr.run(1, verbose=False)
    assert any(not torch.equal(p, want[n]) for n, p in named_leaves(tr.params))

    _, state, _ = RecoveryManager(RecoveryConfig(directory=d)).latest()
    fresh = AsyncGRPOTrainer(cfg, tc, device="cpu")
    load_trainer_state(state["trainer"], fresh.params, fresh.opt_state)
    for n, p in named_leaves(fresh.params):
        assert torch.equal(p, want[n]), n
        assert torch.equal(fresh.opt_state["m"][n], want_m[n]), n
    assert fresh.opt_state["count"] == 1
    restored = restore_buffers(state["buffers"])
    verify_restored(buffers=restored)
    got = restored["trainer"]._items
    assert len(got) == len(want_rollouts) > 0
    for r, w in zip(got, want_rollouts):
        assert [int(t) for t in r.prompt_ids] == list(w.prompt_ids)
        assert [int(t) for t in r.completion_ids] == list(w.completion_ids)
        logp = np.asarray(r.behavior_logp)
        assert logp.dtype == np.asarray(w.behavior_logp).dtype
        np.testing.assert_array_equal(logp, w.behavior_logp)
        assert (r.version, r.group_id, r.reward, r.plan_epoch) == (
            w.version, w.group_id, w.reward, w.plan_epoch)
    assert pickle.loads(pickle.dumps(restored["trainer"].config)) == \
        tc.staleness
