"""The port's discrete-event simulator (``repro_torch.sim``) against the
reference's ``repro.sim``.  Each package schedules its own plan from the
same small cluster and fast scheduler settings the reference tests use;
the plans must be equal, and every simulation run on them must give the
same ``SimResult`` / ``MultiJobSimResult`` field for field, floats bit
for bit (``_plan_parity.plain``; the schedulers' own wall times are left
out).  Cases: bare, stragglers, failures with an ``ElasticReplanner``, a
length-aware ``GenTimeModel`` with an agentic ``EnvCostModel``, a
``ControllerCrash`` under a ``RecoveryManager``, and a two-job pool whose
replan hands devices from one job to the other.  A run with a tracer,
a metrics registry, a health monitor or a recovery manager attached must
equal the bare run bit for bit in each package."""
import dataclasses
import importlib

import pytest

from _plan_parity import plain

PKGS = ("repro", "repro_torch")
SIM = dict(n_steps=8, rollouts_per_step=32, eta=4, reward_cost_s=0.1)
# benchmarks/fig3_end_to_end.py's simulator settings
FIG3 = dict(n_steps=30, rollouts_per_step=256, eta=4, reward_cost_s=0.5)


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _P(pkg):
    return mod(pkg, "core.cost_model").LengthDistribution(mean_len=1024,
                                                          prompt_len=128)


def _sched_cfg(pkg, eta=4):
    st = mod(pkg, "core.staleness")
    return mod(pkg, "core.scheduler").SchedulerConfig(
        tokens_per_step=2 ** 18, stable_iters=3, max_iters=12,
        adapt_delta=False, staleness=st.StalenessConfig(eta=eta))


def _spec(pkg, model="1.5B"):
    return mod(pkg, "core.model_spec").PAPER_MODELS[model]


def _cluster(pkg, n_h800=16, n_h20=16):
    return mod(pkg, "core.cluster").paper_heterogeneous(n_h800, n_h20)


@pytest.fixture(scope="module")
def plans():
    """1.5B on 16 H800 + 16 H20, scheduled once by each package."""
    out = {pkg: mod(pkg, "core.scheduler").schedule(
        _spec(pkg), _cluster(pkg), _P(pkg), _sched_cfg(pkg)) for pkg in PKGS}
    assert plain(out["repro_torch"]) == plain(out["repro"])
    return out


@pytest.fixture(scope="module")
def pools():
    """Two jobs (1.5B at η 4, 7B at η 2) on 8 H800 + 56 H20."""
    out = {}
    for pkg in PKGS:
        pool = mod(pkg, "core.pool")
        jobs = [pool.JobSpec("j1.5b", _spec(pkg, "1.5B"), _P(pkg),
                             _sched_cfg(pkg, 4), weight=1.0),
                pool.JobSpec("j7b", _spec(pkg, "7B"), _P(pkg),
                             _sched_cfg(pkg, 2), weight=4.0)]
        cluster = _cluster(pkg, 8, 56)
        out[pkg] = (pool.schedule_pool(jobs, cluster), cluster)
    assert plain(out["repro_torch"][0]) == plain(out["repro"][0])
    return out


def _fast_replica_failures(pkg, plan, t_fail=8.0):
    """Every H800 rollout replica (the fast pool) dies at ``t_fail``."""
    ev = mod(pkg, "sim.events")
    idx, fails = 0, []
    for a in plan.rollout_plan.assignments:
        for _ in range(a.count):
            if a.config.profile_name == "H800":
                fails.append(ev.FailureInjection(idx, t_fail=t_fail))
            idx += 1
    assert fails
    return fails


def _case_kwargs(pkg, case, plan):
    sim, cm = mod(pkg, "sim"), mod(pkg, "core.cost_model")
    if case == "bare":
        return {}
    if case == "stragglers":
        n = len(sim.AsyncRLSimulator(plan, _P(pkg)).replicas)
        return dict(stragglers=[sim.StragglerInjection(i, factor=0.05)
                                for i in range(max(1, n // 2))])
    if case == "transient_failure":
        return dict(failures=[sim.FailureInjection(0, t_fail=1.0,
                                                   downtime=50.0)])
    if case == "failures_elastic":
        rp = sim.ElasticReplanner(_spec(pkg), _cluster(pkg), _P(pkg),
                                  _sched_cfg(pkg),
                                  sim.ElasticConfig(replan_latency_s=4.0,
                                                    straggler_threshold=0.5))
        return dict(failures=_fast_replica_failures(pkg, plan),
                    replanner=rp)
    if case == "straggler_elastic":
        rp = sim.ElasticReplanner(_spec(pkg), _cluster(pkg), _P(pkg),
                                  _sched_cfg(pkg),
                                  sim.ElasticConfig(replan_latency_s=4.0,
                                                    straggler_threshold=0.5))
        return dict(stragglers=[sim.StragglerInjection(0, factor=0.1,
                                                       t_start=5.0)],
                    replanner=rp)
    if case == "gen_time_env":
        return dict(gen_time=cm.GenTimeModel(a=2e-3, b=1e-5, t_prefill=0.05),
                    env=cm.EnvCostModel(mean_s=2.0, turns=4.0, workers=8))
    if case == "crash":
        rec = mod(pkg, "recovery")
        return dict(recovery=rec.RecoveryManager(rec.RecoveryConfig(
            interval_s=5.0, restore_latency_s=2.0)),
            crashes=[sim.ControllerCrash(7.5)])
    if case == "double_crash_no_journal":
        rec = mod(pkg, "recovery")
        return dict(recovery=rec.RecoveryManager(rec.RecoveryConfig(
            interval_s=5.0, restore_latency_s=2.0, journal=False)),
            crashes=[sim.ControllerCrash(8.0), sim.ControllerCrash(16.0)])
    raise KeyError(case)


CASES = ("bare", "stragglers", "transient_failure", "failures_elastic",
         "straggler_elastic", "gen_time_env", "crash",
         "double_crash_no_journal")


@pytest.mark.parametrize("case", CASES)
def test_single_job_sim_matches_reference(plans, case):
    res = {}
    for pkg in PKGS:
        sim = mod(pkg, "sim")
        kw = _case_kwargs(pkg, case, plans[pkg])
        res[pkg] = sim.AsyncRLSimulator(plans[pkg], _P(pkg), sim.SimConfig(
            **SIM, seed=3, check_invariants=True, **kw)).run()
    assert plain(res["repro_torch"]) == plain(res["repro"])
    r = res["repro_torch"]
    assert r.steps == SIM["n_steps"] and r.max_staleness <= SIM["eta"]
    assert r.rollouts_launched == (r.rollouts_trained + r.dropped
                                   + r.rollouts_in_buffer
                                   + r.rollouts_generating)
    if case.endswith("elastic"):
        assert r.swaps
    if case == "crash":
        [rv] = r.recoveries
        assert rv.lost_consumed == 0 and rv.mttr_s == 2.0


@pytest.mark.parametrize("size", [dict(SIM, seed=0), dict(SIM, seed=7),
                                  FIG3])
def test_observed_sim_is_bit_identical_to_bare(plans, size):
    """A tracer, a registry and a recovery manager only observe: each
    package's instrumented run equals its bare run bit for bit, and the
    port's bare run is the reference's.  With a health monitor attached
    too, the port's run and alerts equal the reference's (buffer detector
    on), and equal the bare run in every field but ``stalls_data``: a
    monitor poll runs the trainer probe, which may count a data stall, as
    the reference's own tests allow."""
    bare, quiet, seen, alerts = {}, {}, {}, {}
    for pkg in PKGS:
        sim, obs, rec = mod(pkg, "sim"), mod(pkg, "obs"), mod(pkg, "recovery")
        bare[pkg] = sim.AsyncRLSimulator(plans[pkg], _P(pkg), sim.SimConfig(
            **size)).run()
        mgr = rec.RecoveryManager(rec.RecoveryConfig(interval_s=5.0))
        quiet[pkg] = sim.AsyncRLSimulator(plans[pkg], _P(pkg), sim.SimConfig(
            **size, trace=obs.Tracer(), metrics=obs.MetricsRegistry(),
            recovery=mgr)).run()
        assert mgr.n_snapshots > 1
        tr, mon = obs.Tracer(), obs.HealthMonitor(obs.MonitorConfig(
            window_s=30.0, poll_interval_s=2.0, snapshot_interval_s=5.0))
        assert mon.cfg.detect_buffer
        mgr = rec.RecoveryManager(rec.RecoveryConfig(interval_s=5.0),
                                  monitor=mon)
        seen[pkg] = sim.AsyncRLSimulator(plans[pkg], _P(pkg), sim.SimConfig(
            **size, trace=tr, metrics=obs.MetricsRegistry(), monitor=mon,
            recovery=mgr)).run()
        alerts[pkg] = [a.to_dict() for a in mon.alerts]
        assert mgr.n_snapshots > 1 and mon.polls > 1
        assert tr.open_spans() == {}
        assert obs.check_report(obs.analyze_trace(tr.to_chrome()),
                                min_stages=2) == []
        assert quiet[pkg] == bare[pkg]
        assert dataclasses.replace(
            seen[pkg], stalls_data=bare[pkg].stalls_data) == bare[pkg]
        assert seen[pkg].stalls_data >= bare[pkg].stalls_data
    assert plain(bare["repro_torch"]) == plain(bare["repro"])
    assert plain(seen["repro_torch"]) == plain(seen["repro"])
    assert plain(alerts["repro_torch"]) == plain(alerts["repro"])


def _kill_one_node_of(pkg, pool_plan, cluster, job):
    sim = mod(pkg, "sim")
    plan = pool_plan.plans[job]
    rmap = sim.replica_device_map(cluster.subset(plan.infer_devices), plan)
    node = rmap[0][0].node
    fails = [sim.JobFailure(job, i, t_fail=30.0)
             for i, devs in enumerate(rmap) if devs and devs[0].node == node]
    assert fails
    return fails


ETA = {"j1.5b": 4, "j7b": 2}


def _multi(r):
    """``plain`` of a ``MultiJobSimResult`` (its ``excluded`` is a set)."""
    return {f.name: (sorted(getattr(r, f.name)) if f.name == "excluded"
                     else plain(getattr(r, f.name)))
            for f in dataclasses.fields(r)}


@pytest.mark.parametrize("case", ["bare", "handoff", "crash", "straggler"])
def test_multi_job_sim_matches_reference(pools, case):
    res = {}
    for pkg in PKGS:
        sim, rec = mod(pkg, "sim"), mod(pkg, "recovery")
        pool_plan, cluster = pools[pkg]
        kw = {}
        if case == "handoff":
            kw = dict(failures=_kill_one_node_of(pkg, pool_plan, cluster,
                                                 "j7b"),
                      replanner=sim.PoolReplanner(
                          cluster,
                          elastic=sim.ElasticConfig(replan_latency_s=4.0)))
        elif case == "crash":
            kw = dict(recovery=rec.RecoveryManager(rec.RecoveryConfig(
                interval_s=5.0, restore_latency_s=2.0)),
                crashes=[sim.ControllerCrash(11.0)])
        elif case == "straggler":
            kw = dict(stragglers=[sim.JobStraggler("j1.5b", 0, factor=0.2,
                                                   t_start=5.0)])
        res[pkg] = sim.MultiJobSimulator(pool_plan, sim.MultiSimConfig(
            n_steps=6, rollouts_per_step=32, check_invariants=True,
            **kw)).run()
    assert _multi(res["repro_torch"]) == _multi(res["repro"])
    r = res["repro_torch"]
    for name, j in r.per_job.items():
        assert j.steps == 6
        assert j.max_staleness <= ETA[name]
        assert j.rollouts_launched == (j.rollouts_trained + j.dropped
                                       + j.rollouts_in_buffer
                                       + j.rollouts_generating)
    if case == "handoff":
        assert r.handoffs
    if case == "crash":
        [rv] = r.recoveries
        assert rv.lost_consumed == 0


def test_multi_job_observed_is_bit_identical_to_bare(pools):
    sim, obs, rec = (mod("repro_torch", n) for n in ("sim", "obs",
                                                     "recovery"))
    pool_plan, _ = pools["repro_torch"]
    base = dict(n_steps=6, rollouts_per_step=32, check_invariants=True)
    bare = sim.MultiJobSimulator(pool_plan, sim.MultiSimConfig(**base)).run()
    mon = obs.HealthMonitor(obs.MonitorConfig(window_s=30.0,
                                              poll_interval_s=2.0))
    seen = sim.MultiJobSimulator(pool_plan, sim.MultiSimConfig(
        **base, trace=obs.Tracer(), metrics=obs.MetricsRegistry(),
        monitor=mon,
        recovery=rec.RecoveryManager(rec.RecoveryConfig(interval_s=5.0))
    )).run()
    assert seen == bare and mon.polls > 1


def test_device_ledger_matches_reference(pools):
    out = {}
    for pkg in PKGS:
        sim = mod(pkg, "sim")
        pool_plan, cluster = pools[pkg]
        ledger = sim.DeviceLedger(pool_plan.owner)
        dead = sorted(pool_plan.job_devices("j7b"))[:4]
        ledger.exclude(dead)
        new_owner = {i: ("j1.5b" if j == "j7b" and i % 2 else j)
                     for i, j in ledger.owner.items()}
        recs = ledger.apply(new_owner, 3.0)
        assert ledger.conserved and recs
        out[pkg] = (sorted(ledger.owner.items()), sorted(ledger.excluded),
                    recs, ledger.handoffs)
    assert plain(out["repro_torch"]) == plain(out["repro"])


def test_replica_device_map_matches_reference(plans):
    out = {}
    for pkg in PKGS:
        sim = mod(pkg, "sim")
        cluster = _cluster(pkg)
        rmap = sim.replica_device_map(
            cluster.subset(plans[pkg].infer_devices), plans[pkg])
        out[pkg] = [[d.index for d in devs] for devs in rmap]
    assert out["repro_torch"] == out["repro"]
    flat = [i for devs in out["repro"] for i in devs]
    assert len(flat) == len(set(flat))
