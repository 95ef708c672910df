"""The port's multi-job layer against the reference's: ``core.pool``
(``schedule_pool`` / ``replan_pool``), ``core.jobs`` (``ControlPlane``,
the job lifecycle, ``EwmaThroughputTrend``) and ``rl.buffer.JobBuffers``.
Each case runs the same script inside each package; the results must be
equal field for field, floats bit for bit (``_plan_parity.plain``; the
schedulers' own wall times are left out)."""
import importlib

import numpy as np
import pytest

from _plan_parity import plain

PKGS = ("repro", "repro_torch")


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def both(case):
    ref, port = (plain(case(pkg)) for pkg in PKGS)
    assert port == ref
    return ref


def _P(pkg):
    return mod(pkg, "core.cost_model").LengthDistribution(mean_len=1024,
                                                          prompt_len=128)


def _cfg(pkg, eta=4):
    st = mod(pkg, "core.staleness")
    return mod(pkg, "core.scheduler").SchedulerConfig(
        tokens_per_step=2 ** 18, stable_iters=3, max_iters=12,
        adapt_delta=False, staleness=st.StalenessConfig(eta=eta))


def _job(pkg, name, model, eta=4, **kw):
    spec = mod(pkg, "core.model_spec").PAPER_MODELS[model]
    return mod(pkg, "core.pool").JobSpec(name, spec, _P(pkg),
                                         _cfg(pkg, eta), **kw)


def _jobs(pkg):
    return [_job(pkg, "j1.5b", "1.5B", eta=4, weight=1.0),
            _job(pkg, "j7b", "7B", eta=2, weight=4.0)]


def _cluster(pkg, n_h800=8, n_h20=32):
    return mod(pkg, "core.cluster").paper_heterogeneous(n_h800, n_h20)


def _pool(pkg, **kw):
    return mod(pkg, "core.pool").schedule_pool(_jobs(pkg), _cluster(pkg),
                                               **kw)


# ------------------------------------------------------------------ pool
def test_schedule_pool_matches_reference():
    def case(pkg):
        pool = _pool(pkg)
        pool.assert_partition(_cluster(pkg))
        return pool, pool.describe(), pool.signature(), \
            pool.weighted_throughput()
    pool, text, _, tput = both(case)
    assert tput > 0 and "j7b" in text


def test_schedule_pool_with_a_cost_provider_matches_reference():
    def case(pkg):
        cm = mod(pkg, "core.cost_model")
        return _pool(pkg, cost_provider=cm.AnalyticCostModel())
    both(case)


@pytest.mark.parametrize("scenario", ["failure", "departure", "arrival",
                                      "frozen"])
def test_replan_pool_matches_reference(scenario):
    def case(pkg):
        pool_mod = mod(pkg, "core.pool")
        cl = mod(pkg, "core.cluster")
        c = _cluster(pkg)
        pool = _pool(pkg)
        if scenario == "failure":
            survivors = cl.Cluster(
                devices=[d for d in c.devices if d.node != 4],
                cross_type_bw=c.cross_type_bw)
            new = pool_mod.replan_pool(pool, survivors, reason="failure")
        elif scenario == "departure":
            survivors = c
            new = pool_mod.replan_pool(pool, c, reason="departure",
                                       departed=["j7b"])
        elif scenario == "arrival":
            survivors = c
            new = pool_mod.replan_pool(
                pool, c, reason="arrival", allow_partial=True,
                arrivals=[_job(pkg, "newbie", "1.5B")])
        else:                 # a frozen job keeps its slice verbatim
            survivors = c
            new = pool_mod.replan_pool(pool, c, reason="straggler",
                                       frozen=["j1.5b"])
        new.assert_partition(survivors)
        return new, new.describe()
    new, text = both(case)
    assert new[1]["pool_epoch"] == 1


def test_pool_infeasibility_matches_reference():
    def case(pkg):
        pool_mod = mod(pkg, "core.pool")
        small = _cluster(pkg, 8, 8)          # 2 domains < 2 jobs x 2
        cfg = pool_mod.PoolConfig(min_domains_per_job=2)
        with pytest.raises(pool_mod.PoolInfeasibleError) as ei:
            pool_mod.schedule_pool(_jobs(pkg), small, cfg)
        partial = pool_mod.schedule_pool(_jobs(pkg), small, cfg,
                                         allow_partial=True)
        return str(ei.value), ei.value.infeasible, partial
    msg, infeasible, partial = both(case)
    assert infeasible and partial[1]["infeasible"]


# ------------------------------------------------------------------ jobs
def _control_plane_script(pkg):
    """A lifecycle through the control plane: initial jobs, submissions
    that queue, miss their floor, are infeasible or overflow the queue,
    a pool commit, retry ticks, and a drain/complete and a preemption."""
    jobs = mod(pkg, "core.jobs")
    cp = jobs.ControlPlane(
        _cluster(pkg), cfg=jobs.AdmissionConfig(max_queue=1,
                                                retry_interval_s=10.0))
    cp.register_initial(_jobs(pkg), t=0.0)
    out = [cp.submit(_job(pkg, "w1", "1.5B", min_tput=100.0), t=1.0),
           cp.submit(_job(pkg, "floor", "14B", min_tput=1e12), t=2.0),
           cp.submit(_job(pkg, "w2", "1.5B"), t=3.0)]
    pool = mod(pkg, "core.pool").replan_pool(
        _pool(pkg), _cluster(pkg), reason="arrival", allow_partial=True,
        arrivals=[rec.spec for rec in cp.queued()])
    out.append(cp.on_pool_commit(pool, t=4.0))
    out.append(cp.tick(20.0))
    cp.drain("j1.5b", t=30.0)
    cp.complete("j1.5b", t=31.0)
    cp.preempt("j7b", t=32.0, reason="operator")
    tiny = jobs.ControlPlane(_cluster(pkg, 0, 8))
    out.append(tiny.submit(_job(pkg, "big", "14B"), t=0.0))
    return out, cp.records, cp.decisions, cp.admission_latencies(), \
        [r.name for r in cp.queued()], tiny.records


def test_control_plane_script_matches_reference():
    out, records, decisions, latencies, queued, tiny = both(
        _control_plane_script)
    states = {k: v[1]["state"][1] for k, v in records.items()}
    assert states["j1.5b"] == "COMPLETED" and states["j7b"] == "PREEMPTED"
    assert states["floor"] == "REJECTED" and states["w2"] == "REJECTED"
    assert tiny["big"][1]["state"][1] == "REJECTED"


@pytest.mark.parametrize("moves", [
    ("RUNNING",), ("ADMITTED", "DRAINING"), ("REJECTED", "ADMITTED"),
    ("ADMITTED", "RUNNING", "COMPLETED", "RUNNING")])
def test_invalid_transitions_raise_in_both(moves):
    def case(pkg):
        jobs = mod(pkg, "core.jobs")
        rec = jobs.JobRecord(_job(pkg, "a", "1.5B"), t_submit=0.0)
        with pytest.raises(jobs.InvalidTransitionError) as ei:
            for t, state in enumerate(moves):
                rec.to(jobs.JobState[state], float(t + 1))
        return str(ei.value), rec
    both(case)


def test_ewma_trend_matches_reference():
    samples = np.random.default_rng(5).uniform(50.0, 150.0, 40)
    samples[25:] *= 0.2

    def case(pkg):
        jobs = mod(pkg, "core.jobs")
        tr = jobs.EwmaThroughputTrend(jobs.TrendConfig(
            alpha=0.3, min_samples=4, threshold=0.6))
        fired = [tr.observe(float(s)) for s in samples]
        state = (tr.ewma, tr.reference, tr.n)
        tr.reset()
        return fired, state, tr.observe(1.0)
    fired, _, _ = both(case)
    assert any(fired)


# --------------------------------------------------------------- buffers
def test_job_buffers_match_reference():
    def case(pkg):
        buf_mod = mod(pkg, "rl.buffer")
        st = mod(pkg, "core.staleness")
        jb = buf_mod.JobBuffers()
        a = jb.add_job("a", st.StalenessConfig(eta=1, rollouts_per_step=2))
        b = jb.add_job("b", st.StalenessConfig(eta=2, rollouts_per_step=4))
        with pytest.raises(ValueError):
            jb.add_job("a")
        for i, buf in enumerate((a, b, a)):
            buf.launch(2)
            for k in range(2):
                buf.push(buf_mod.Rollout(
                    prompt_ids=[1, 2], completion_ids=[3] * (k + 1),
                    behavior_logp=np.zeros(k + 1, np.float32),
                    version=buf.version, group_id=i))
        a.pop_batch(2)
        a.bump_version()
        a.bump_version()
        epochs = jb.on_device_handoff("a", "b")
        mid = jb.stats()
        with pytest.raises(RuntimeError):
            jb.remove_job("b")
        final_b = jb.remove_job("b", force=True)
        with pytest.raises(KeyError):
            jb.remove_job("b")
        return (epochs, mid, final_b, jb.jobs(), "a" in jb, "b" in jb,
                jb.stats())
    epochs, mid, final_b, names, *_ = both(case)
    assert epochs == {"a": 1, "b": 1} and names == ["a"]
    assert final_b["dropped"] == 2
