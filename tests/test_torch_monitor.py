"""The port's health monitor, SLO arithmetic and metrics registry
(``repro_torch.obs``) against the reference's ``repro.obs``, and the
monitor attached to the port's own runtime on the CPU.

Every detector scenario of the reference's monitor tests is scripted once
and replayed into each package's ``HealthMonitor``: the alerts (detector,
key, severity, time, message and evidence) must be equal, floats bit for
bit.  So must ``BurnWindow`` / ``burn_rate`` / ``classify_burn``, the
histogram estimators (``mean``, ``quantile``, ``frac_ge``) and
``snapshot_delta`` on seeded observations, and the multi-job run in which
the monitor's straggler alert drives the replan ahead of the throughput
EWMA.  On the port's runtime: a ``PagedEngine`` with a monitor and a
tracer gives the tokens of a bare one, and the async GRPO trainer on the
paged engine feeds the monitor its stage spans, stalls, staleness and
buffer depth, with a trace that passes ``check_report``."""
import dataclasses
import importlib

import numpy as np
import pytest

from _plan_parity import plain

PKGS = ("repro", "repro_torch")


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _mon(pkg, **kw):
    obs = mod(pkg, "obs")
    base = dict(window_s=30.0, poll_interval_s=2.0, cooldown_s=30.0)
    base.update(kw)
    return obs.HealthMonitor(obs.MonitorConfig(**base))


def _straggling_fleet(mon, t0=10, t1=30, reps=4):
    for t in range(t0, t1, 2):
        for rep in range(reps):
            rate = 20.0 if rep == 0 else 100.0        # r0 is 5x slower
            mon.on_gen_span("j", rep, float(t), 100.0 / rate, 100.0)


def _polls(mon, *times):
    return [[a.to_dict() for a in mon.poll(t)] for t in times]


# Each scenario feeds one package's monitor and returns what it observed.
def sc_straggler(pkg):
    mon = _mon(pkg)
    _straggling_fleet(mon)
    return _polls(mon, 30.0)


def sc_healthy_fleet(pkg):
    mon = _mon(pkg)
    for t in range(0, 30, 2):
        for rep in range(6):
            mon.on_gen_span("j", rep, float(t), 100.0 / (100.0 + rep), 100.0)
    return _polls(mon, 30.0)


def sc_needs_peers(pkg):
    mon = _mon(pkg)
    for t in range(0, 30, 2):
        mon.on_gen_span("j", 0, float(t), 1.0, 10.0)
        mon.on_gen_span("j", 1, float(t), 1.0, 100.0)
    return _polls(mon, 30.0)


def sc_buffer(pkg):
    mon = _mon(pkg)
    for t in range(0, 20, 2):
        mon.on_buffer("a", float(t), 95, 100)
        mon.on_stall("a", float(t), "capacity")
        mon.on_buffer("b", float(t), 2, 100)
        mon.on_stall("b", float(t), "data")
        mon.on_buffer("c", float(t), 50, 100)
    return _polls(mon, 20.0)


def sc_staleness(pkg):
    mon = _mon(pkg)
    for i in range(16):
        mon.on_staleness("hot", float(i), 4, eta=4)
        mon.on_staleness("cold", float(i), 0, eta=4)
        mon.on_staleness("mixed", float(i), i % 5, eta=4)
    return _polls(mon, 16.0)


def sc_bubble(pkg):
    mon = _mon(pkg, detect_straggler=False, detect_buffer=False,
               detect_staleness=False, detect_admission=False,
               bubble_ref_polls=2, bubble_drift=0.2)
    t, out = 0.0, []
    for _ in range(4):
        for s in range(30):
            mon.on_stage_span("train", t + s, 1.0)
        t += 30.0
        out += _polls(mon, t)
    for _ in range(3):
        for s in range(0, 30, 5):
            mon.on_stage_span("train", t + s, 1.0)
        t += 30.0
    return out + _polls(mon, t)


def sc_admission(pkg):
    slow, fast = _mon(pkg), _mon(pkg)
    for i in range(8):
        slow.on_admission(f"job{i}", float(i), 120.0)
        fast.on_admission(f"job{i}", float(i), 5.0)
    return _polls(slow, 8.0) + _polls(fast, 8.0)


def sc_cooldown(pkg):
    mon = _mon(pkg, cooldown_s=100.0)
    _straggling_fleet(mon)
    first = _polls(mon, 30.0)
    _straggling_fleet(mon, 30, 40)
    return first + _polls(mon, 40.0), len(mon.alerts)


def sc_reset_job(pkg):
    mon = _mon(pkg)
    _straggling_fleet(mon)
    first = _polls(mon, 30.0)
    mon.reset_job("j")
    after = _polls(mon, 32.0)
    mon.reset()
    return first + after, mon.polls


def sc_snapshot_age(pkg):
    mon = _mon(pkg, snapshot_interval_s=10.0, cooldown_s=1.0)
    out = _polls(mon, 50.0)
    mon.on_snapshot(0.0)
    return out + _polls(mon, 8.0, 15.0, 25.0, 26.5)


def sc_registry(pkg):
    mx = mod(pkg, "obs").MetricsRegistry()
    mx.gauge("buffer/eta").set(4)
    h = mx.histogram("buffer/staleness")
    for _ in range(16):
        h.observe(4.0)
    mon = _mon(pkg, detect_straggler=False, detect_buffer=False,
               detect_bubble=False, detect_admission=False)
    mon.observe_registry(mx, t=10.0)
    for _ in range(8):
        h.observe(1.0)
    mon.observe_registry(mx, t=11.0)
    return _polls(mon, 12.0)


def sc_trace_stream(pkg):
    obs = mod(pkg, "obs")
    tr = obs.Tracer()
    mon = obs.HealthMonitor(obs.MonitorConfig(window_s=30.0,
                                              poll_interval_s=2.0),
                            tracer=tr)
    tr.add_sink(mon.on_trace_event)
    for t in range(10, 30, 2):
        for rep in range(4):
            rate = 20.0 if rep == 0 else 100.0
            tr.span("replica", f"j/r{rep}", "generate", float(t),
                    100.0 / rate, tokens=100.0)
        tr.span("stage", "train", "step", float(t), 1.0, tokens=10)
    alerts = _polls(mon, 30.0)
    instants = [ev[1:4] for ev in tr._events if ev[0] == "i"]
    return alerts, instants


SCENARIOS = [sc_straggler, sc_healthy_fleet, sc_needs_peers, sc_buffer,
             sc_staleness, sc_bubble, sc_admission, sc_cooldown,
             sc_reset_job, sc_snapshot_age, sc_registry, sc_trace_stream]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_monitor_alerts_match_reference(scenario):
    ref, port = (plain(scenario(pkg)) for pkg in PKGS)
    assert port == ref
    if scenario in (sc_straggler, sc_buffer, sc_staleness, sc_bubble,
                    sc_admission, sc_snapshot_age, sc_registry,
                    sc_trace_stream):
        assert "detector" in repr(port)            # the scenario did alert


def test_burn_window_and_classification_match_reference():
    def case(pkg):
        slo_m = mod(pkg, "obs.slo")
        slo = slo_m.SLOSpec("x", objective=0.9, description="")
        bw = slo_m.BurnWindow(slo, window_s=10.0)
        out = []
        for t in range(10):
            bw.observe(float(t), bad=(t % 3 == 0))
            out.append((bw.n(float(t)), bw.bad_frac(float(t)),
                        bw.burn(float(t))))
        bw.observe(25.0, bad=False)
        out.append((bw.n(25.0), bw.burn(25.0)))
        out.append([slo_m.classify_burn(b) for b in (0.5, 1.0, 5.0, 15.0)])
        out.append([slo_m.burn_rate(f, slo) for f in (0.0, 0.05, 0.5)])
        with pytest.raises(ValueError):
            slo_m.SLOSpec("bad", objective=1.5, description="")
        return out
    ref, port = (plain(case(pkg)) for pkg in PKGS)
    assert port == ref


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_estimators_and_delta_match_reference(seed):
    rng = np.random.default_rng(seed)
    first = rng.lognormal(1.0, 1.5, 200).tolist()
    second = rng.integers(0, 9, 50).astype(float).tolist()

    def case(pkg):
        m = mod(pkg, "obs.metrics")
        reg = m.MetricsRegistry()
        h = reg.histogram("lat")
        g = reg.histogram("tight", buckets=(0.5, 1.0, 2.0))
        for x in first:
            h.observe(x)
            g.observe(x / 10)
            reg.counter("n").inc()
        reg.gauge("depth").set(first[0])
        snap0 = reg.snapshot()
        for x in second:
            h.observe(x)
            reg.counter("n").inc(0.5)
        reg.counter("new").inc()
        qs = (0.0, 0.1, 0.5, 0.9, 0.99, 1.0)
        xs = (0.0, 0.5, 1.0, 3.0, 100.0, 5000.0)
        return (h.mean, [h.quantile(q) for q in qs],
                [h.frac_ge(x) for x in xs], [g.frac_ge(x) for x in xs],
                [m.hist_frac_ge(reg.snapshot()["histograms"]["lat"], x)
                 for x in xs],
                reg.delta(snap0), m.snapshot_delta(reg.snapshot(), {}),
                m.snapshot_delta(snap0, snap0), reg.snapshot())
    ref, port = (plain(case(pkg)) for pkg in PKGS)
    assert port == ref


@pytest.fixture(scope="module")
def pools():
    out = {}
    for pkg in PKGS:
        pool, st = mod(pkg, "core.pool"), mod(pkg, "core.staleness")
        sched = mod(pkg, "core.scheduler")
        P = mod(pkg, "core.cost_model").LengthDistribution(mean_len=1024,
                                                           prompt_len=128)
        specs = mod(pkg, "core.model_spec").PAPER_MODELS

        def cfg(eta):
            return sched.SchedulerConfig(
                tokens_per_step=2 ** 18, stable_iters=3, max_iters=12,
                adapt_delta=False, staleness=st.StalenessConfig(eta=eta))
        jobs = [pool.JobSpec("j1.5b", specs["1.5B"], P, cfg(4), weight=1.0),
                pool.JobSpec("j7b", specs["7B"], P, cfg(2), weight=4.0)]
        cluster = mod(pkg, "core.cluster").paper_heterogeneous(8, 24)
        out[pkg] = (pool.schedule_pool(jobs, cluster), cluster)
    return out


def test_monitor_replan_run_matches_reference(pools):
    """The monitor's straggler alert routes into the pool replan: the
    same triggers, alerts and results in both packages."""
    res = {}
    for pkg in PKGS:
        sim, obs = mod(pkg, "sim"), mod(pkg, "obs")
        trend = mod(pkg, "core.jobs").TrendConfig(alpha=0.5, min_samples=3,
                                                  threshold=0.85)
        pool, cluster = pools[pkg]
        elastic = sim.ElasticConfig(replan_latency_s=4.0,
                                    straggler_threshold=0.005)
        mon = obs.HealthMonitor(obs.MonitorConfig(
            detect_buffer=False, detect_bubble=False, detect_staleness=False))
        r = sim.MultiJobSimulator(pool, sim.MultiSimConfig(
            n_steps=14, rollouts_per_step=256, check_invariants=True,
            stragglers=[sim.JobStraggler("j7b", i, factor=0.01,
                                         t_start=150.0) for i in (0, 1, 2)],
            replanner=sim.PoolReplanner(cluster, elastic=elastic),
            trend=trend, monitor=mon, monitor_replan=True)).run()
        res[pkg] = (r.per_job, r.handoffs, r.pool_swaps, r.wall_time_s,
                    r.owner_final, sorted(r.excluded), r.replan_triggers,
                    [a.to_dict() for a in mon.alerts], mon.polls)
    assert plain(res["repro_torch"]) == plain(res["repro"])
    triggers = res["repro_torch"][6]
    assert any(t.reason == "monitor_straggler" for t in triggers)


def test_monitored_pool_sim_alerts_match_reference(pools):
    """Every detector on (the buffer detector too, fed by the data stalls
    the poll's trainer probe counts), no replan: the same alerts and the
    same per-job results, ``stalls_data`` included, in both packages;
    every field but ``stalls_data`` equal to the unmonitored run's."""
    res = {}
    for pkg in PKGS:
        sim, obs = mod(pkg, "sim"), mod(pkg, "obs")
        pool, _ = pools[pkg]
        base = dict(n_steps=6, rollouts_per_step=32, check_invariants=True)
        off = sim.MultiJobSimulator(pool, sim.MultiSimConfig(**base)).run()
        mon = obs.HealthMonitor(obs.MonitorConfig(poll_interval_s=2.0))
        assert mon.cfg.detect_buffer
        on = sim.MultiJobSimulator(pool, sim.MultiSimConfig(
            **base, monitor=mon)).run()
        assert mon.polls > 0
        assert on.wall_time_s == off.wall_time_s
        for n, jr in off.per_job.items():
            assert dataclasses.replace(
                on.per_job[n], stalls_data=jr.stalls_data) == jr
        res[pkg] = (on.per_job, [a.to_dict() for a in mon.alerts],
                    mon.polls)
    assert plain(res["repro_torch"]) == plain(res["repro"])


# ------------------------------------------------- the port's own runtime
def _tiny_engine(**kw):
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
    gen = GenConfig(max_new_tokens=12, greedy=True)
    sc = ServeConfig(max_slots=4, max_len=96, page_size=8, prefill_chunk=4)
    eng = PagedEngine(tiny, store, gen, sc, rng_seed=1, device="cpu", **kw)
    return eng, MathTaskGenerator(seed=0).batch(3)


def test_paged_engine_tokens_identical_with_monitor_and_tracer():
    from repro_torch.obs import HealthMonitor, Tracer, analyze_trace
    eng, tasks = _tiny_engine()
    bare, _ = eng.generate_groups(tasks, 4)
    mon, tr = HealthMonitor(), Tracer()
    eng, tasks = _tiny_engine(monitor=mon, tracer=tr)
    seen, _ = eng.generate_groups(tasks, 4)
    assert [r.completion_ids for r in seen] == \
        [r.completion_ids for r in bare]
    for a, b in zip(seen, bare):
        np.testing.assert_array_equal(a.behavior_logp, b.behavior_logp)
    assert set(mon._stages) >= {"decode", "prefill"}
    assert tr.open_spans() == {}
    report = analyze_trace(tr.to_chrome())
    assert report["wall_s"] > 0 and report["stages"] == {}


def test_trainer_feeds_monitor_and_trace_on_cpu():
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.staleness import StalenessConfig
    from repro_torch.obs import (HealthMonitor, MetricsRegistry,
                                 MonitorConfig, Tracer, analyze_trace,
                                 check_report, summarize_metrics)
    from repro_torch.rl.async_trainer import AsyncGRPOTrainer, TrainerConfig

    tr, mx = Tracer(), MetricsRegistry()
    mon = HealthMonitor(MonitorConfig(poll_interval_s=1e-6), tracer=tr)
    cfg = get_smoke_config("qwen-distill-1.5b").replace(
        vocab=259, dtype="float32", remat=False)
    trainer = AsyncGRPOTrainer(cfg, TrainerConfig(
        group_size=4, prompts_per_step=2, engine="paged",
        staleness=StalenessConfig(eta=2, rollouts_per_step=8),
        trace=tr, metrics=mx, monitor=mon), device="cpu")
    hist = trainer.run(2, verbose=False)
    assert len(hist) == 2 and mon.polls >= 2
    assert {"generation", "train"} <= set(mon._stages)
    report = analyze_trace(tr.to_chrome())
    assert check_report(report, min_stages=2) == []
    for stage in ("generation", "train"):
        s = report["stages"][stage]
        assert 0.0 < s["utilization"] <= 1.0
        assert s["bubble_fraction"] == 1.0 - s["utilization"]
    summary = summarize_metrics(mx.snapshot())
    assert summary["counters"]["buffer/consumed"] == 16
