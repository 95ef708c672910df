"""The port's scheduler (``repro_torch.core``) against the reference's
(``repro.core``): each case builds the same inputs inside each package and
the results must be equal field for field, floats bit for bit
(``_plan_parity.plain``; the scheduler's own wall time is left out).

Covers ``ModelConfig.spec``, the device profiles and cluster builders,
the cost models, phase (i)'s constrained search, phase (ii)'s MILPs, the
graph partition, the adaptive δ(η), Algorithm 1 (``schedule``) over the
paper's clusters and a small TPU one, its Table-5 baselines and the
warm-started ``reschedule``.  No exhaustive search runs at paper scale.
"""
import importlib
import math

import numpy as np
import pytest

from _plan_parity import plain

PKGS = ("repro", "repro_torch")
ARCHS = ("qwen-distill-1.5b", "qwen-distill-7b", "qwen-distill-14b",
         "xlstm-1.3b")


def core(pkg, name):
    return importlib.import_module(f"{pkg}.core.{name}")


def both(case):
    """Run ``case(pkg)`` in each package; the plain results must agree."""
    ref, port = (plain(case(pkg)) for pkg in PKGS)
    assert port == ref
    return ref


def _P(pkg, mean_len=2048, prompt_len=256):
    return core(pkg, "cost_model").LengthDistribution(
        mean_len=mean_len, prompt_len=prompt_len)


def _cfg(pkg, **kw):
    kw.setdefault("tokens_per_step", 2 ** 19)
    kw.setdefault("stable_iters", 3)
    kw.setdefault("max_iters", 16)
    return core(pkg, "scheduler").SchedulerConfig(**kw)


CLUSTERS = {
    "hetero-8+8": lambda c: c.paper_heterogeneous(8, 8),
    "h800-16": lambda c: c.paper_homogeneous_h800(16),
    "h20-16": lambda c: c.paper_homogeneous_h20(16),
    "tpu-8+16": lambda c: c.tpu_heterogeneous(8, 16),
}


def _cluster(pkg, name):
    return CLUSTERS[name](core(pkg, "cluster"))


# ------------------------------------------------------------ descriptions
@pytest.mark.parametrize("arch", ARCHS)
def test_model_config_spec_matches_reference(arch):
    def case(pkg):
        return importlib.import_module(f"{pkg}.configs").get_config(arch).spec
    spec = both(case)
    assert spec[1]["name"] == arch


def test_paper_model_specs_match_reference():
    both(lambda pkg: core(pkg, "model_spec").PAPER_MODELS)
    for name in ("1.5B", "7B", "14B"):
        ref = core("repro", "model_spec").PAPER_MODELS[name]
        port = core("repro_torch", "model_spec").PAPER_MODELS[name]
        assert port.params() == ref.params()
        assert port.kv_bytes_per_token() == ref.kv_bytes_per_token()


@pytest.mark.parametrize("name", sorted(CLUSTERS))
def test_profiles_and_clusters_match_reference(name):
    both(lambda pkg: (list(core(pkg, "cluster").PROFILES),
                      core(pkg, "cluster").PROFILES,
                      _cluster(pkg, name),
                      _cluster(pkg, name).type_counts))


# ---------------------------------------------------------------- cost model
@pytest.mark.parametrize("model", ["1.5B", "7B", "14B"])
def test_cost_models_match_reference(model):
    def case(pkg):
        cm, cl = core(pkg, "cost_model"), core(pkg, "cluster")
        spec = core(pkg, "model_spec").PAPER_MODELS[model]
        P = cm.LengthDistribution(mean_len=12288, prompt_len=512,
                                  max_len=32768)
        c = cl.paper_heterogeneous(8, 8)
        plan = cm.TrainPlan(stages=(
            cm.StageSpec("H800", dp=2, tp=4, n_layers=spec.n_layers // 2),
            cm.StageSpec("H20", dp=1, tp=8,
                         n_layers=spec.n_layers - spec.n_layers // 2)))
        rcs = [cm.replica_throughput(spec, cm.ReplicaConfig(t, tps), P)
               for t in ("H800", "H20") for tps in ((1,), (2,), (4, 4))]
        env = cm.EnvCostModel(mean_s=0.3, turns=3.0, workers=16,
                              overlap=0.25)
        return dict(
            train=cm.train_step_cost(spec, plan, tokens_per_step=2 ** 20),
            replicas=rcs,
            gen_time=[cm.GenTimeModel.from_replica_cost(rc, P) for rc in rcs
                      if rc.feasible],
            env=(env.stage_time(64.0), env.episode_gap_s(),
                 [env.replica_util(rc, P) for rc in rcs if rc.feasible],
                 env.sample_gaps(np.random.default_rng(3), 5)),
            sync=cm.weight_sync_cost(spec, c, c.devices_of_type("H800"),
                                     c.devices_of_type("H20")),
            per_token={p: cm.per_token_costs(spec, cl.PROFILES[p], P)
                       for p in cl.PROFILES},
            dist=(P.mean(), P.sample(np.random.default_rng(0), 6)))
    out = both(case)
    assert out["sync"] > 0


def test_cost_model_checks_profile_coverage_at_import():
    cm = core("repro_torch", "cost_model")
    for table in cm._EFF_TABLES.values():
        assert set(table) == set(core("repro_torch", "cluster").PROFILES)
    cm._assert_profile_coverage()
    assert cm.resolve_provider(None) is cm.ANALYTIC


# ------------------------------------------------------ phase (i): search
@pytest.mark.parametrize("model", ["1.5B", "14B"])
@pytest.mark.parametrize("which", ["H800", "H20", "all"])
def test_constrained_search_matches_reference(model, which):
    def case(pkg):
        c = core(pkg, "cluster").paper_heterogeneous(8, 8)
        devs = c.devices if which == "all" else c.devices_of_type(which)
        spec = core(pkg, "model_spec").PAPER_MODELS[model]
        return core(pkg, "constrained_search").constrained_search(
            spec, c, devs, tokens_per_step=2 ** 20)
    plan, cost = both(case)
    assert plan is not None


def test_exhaustive_search_matches_reference_on_a_small_cluster():
    def case(pkg):
        c = core(pkg, "cluster").Cluster.build([("H800", 2), ("H20", 2)])
        spec = core(pkg, "model_spec").PAPER_MODELS["1.5B"]
        return core(pkg, "constrained_search").exhaustive_search(
            spec, c, c.devices, tokens_per_step=2 ** 18)
    plan, cost = both(case)
    assert plan is not None


# --------------------------------------------------------- phase (ii): MILP
@pytest.mark.parametrize("devices", ["hetero-8+8", "h20-16", "H20-half"])
@pytest.mark.parametrize("solver", ["solve_rollout_milp",
                                    "solve_rollout_milp_bisection"])
def test_rollout_milp_matches_reference(devices, solver):
    def case(pkg):
        if devices == "H20-half":
            c = core(pkg, "cluster").paper_heterogeneous(8, 8)
            d_infer = c.devices_of_type("H20")[:4] + c.devices[:1]
        else:
            d_infer = _cluster(pkg, devices).devices
        spec = core(pkg, "model_spec").PAPER_MODELS["7B"]
        m = core(pkg, "milp")
        return (m.slice_node_widths(d_infer),
                getattr(m, solver)(spec, d_infer, _P(pkg),
                                   total_rollouts=512))
    _, res = both(case)
    counts = [a[1]["count"] for a in res[1]["plan"][1]["assignments"]]
    assert sum(counts) >= 1


def test_milp_uses_scipy_in_both_packages():
    assert core("repro_torch", "milp")._HAVE_SCIPY
    assert core("repro", "milp")._HAVE_SCIPY


def test_milp_with_env_stage_matches_reference():
    def case(pkg):
        c = core(pkg, "cluster").paper_heterogeneous(8, 8)
        env = core(pkg, "cost_model").EnvCostModel(mean_s=2.0, turns=4.0,
                                                   workers=8)
        spec = core(pkg, "model_spec").PAPER_MODELS["1.5B"]
        return core(pkg, "milp").solve_rollout_milp(
            spec, c.devices, _P(pkg), total_rollouts=256, env=env)
    both(case)


# ----------------------------------------------------------- graph partition
@pytest.mark.parametrize("window", [(0.3, 0.9), (0.5, 0.95), (0.1, 0.4),
                                    (0.62, 0.66)])
@pytest.mark.parametrize("engine", ["partition_exact", "partition_kl",
                                    "partition"])
def test_partition_matches_reference(window, engine):
    def case(pkg):
        gp = core(pkg, "graph_partition")
        c = core(pkg, "cluster").paper_heterogeneous(16, 24)
        part = getattr(gp, engine)(c, *window)
        extra = None
        if part is not None:
            extra = (gp.eq3_objective(c, part.train_devices,
                                      part.infer_devices),
                     gp.compute_fraction(c, part.train_devices))
        return part, extra, gp.ici_domains(c), gp._group_nodes(c)
    both(case)


def test_partition_exhaustive_matches_reference():
    def case(pkg):
        gp = core(pkg, "graph_partition")
        c = core(pkg, "cluster").paper_heterogeneous(8, 16)
        sub = gp.subcluster(c, c.devices[4:20])
        return gp.partition_exhaustive(c, 0.3, 0.9), sub
    part, _ = both(case)
    assert part is not None


# --------------------------------------------------------------- δ(η)
@pytest.mark.parametrize("eta,delta_max,rel_tol", [
    (0, 64, 0.05), (4, 64, 0.05), (2, 16, 0.2), (8, 8, 0.0), (3, 64, 1e-3)])
def test_adaptive_delta_matches_reference(eta, delta_max, rel_tol):
    def window(delta):   # per-step cost falls off like 1 + 4/δ
        return delta * (1.0 + 4.0 / delta) + math.sin(delta)

    def case(pkg):
        st = core(pkg, "staleness")
        cfg = st.StalenessConfig(eta=eta, delta_max=delta_max)
        return st.adaptive_delta(window, cfg, rel_tol=rel_tol)
    both(case)


# ---------------------------------------------------------- Algorithm 1
@pytest.mark.parametrize("cluster", sorted(CLUSTERS))
@pytest.mark.parametrize("model", ["1.5B", "7B", "14B"])
def test_schedule_matches_reference(cluster, model):
    def case(pkg):
        spec = core(pkg, "model_spec").PAPER_MODELS[model]
        plan = core(pkg, "scheduler").schedule(spec, _cluster(pkg, cluster))
        return plan, plan.describe(), plan.signature(), plan.objective
    plan, text, _, obj = both(case)
    assert math.isfinite(obj) and "σ:" in text and "τ:" in text


@pytest.mark.parametrize("variant", ["no-adapt", "bisection", "env", "eta0"])
def test_schedule_options_match_reference(variant):
    def case(pkg):
        kw = dict(staleness=core(pkg, "staleness").StalenessConfig(eta=2))
        if variant == "no-adapt":
            kw["adapt_delta"] = False
        elif variant == "bisection":
            kw.update(adapt_delta=False, milp_bisection=True)
        elif variant == "env":
            kw["env"] = core(pkg, "cost_model").EnvCostModel(
                mean_s=1.5, turns=3.0, workers=16)
        else:
            kw["staleness"] = core(pkg, "staleness").StalenessConfig(eta=0)
        spec = core(pkg, "model_spec").PAPER_MODELS["1.5B"]
        c = core(pkg, "cluster").paper_heterogeneous(8, 16)
        return core(pkg, "scheduler").schedule(spec, c, _P(pkg),
                                               _cfg(pkg, **kw))
    both(case)


@pytest.mark.parametrize("baseline", ["schedule_uniform",
                                      "schedule_without_search",
                                      "schedule_without_repartition"])
def test_scheduler_baselines_match_reference(baseline):
    def case(pkg):
        spec = core(pkg, "model_spec").PAPER_MODELS["1.5B"]
        # schedule_without_search prices each partition by exhaustive
        # search: a small cluster keeps it to seconds
        c = core(pkg, "cluster").Cluster.build([("H800", 4), ("H20", 4)])
        return getattr(core(pkg, "scheduler"), baseline)(
            spec, c, _P(pkg), _cfg(pkg, adapt_delta=False))
    plan = both(case)
    assert plan is not None and plan[1]["train_devices"]


@pytest.mark.parametrize("lost", ["h20-node", "h800-node", "half-h800"])
def test_reschedule_matches_reference(lost):
    def case(pkg):
        cl = core(pkg, "cluster")
        sched = core(pkg, "scheduler")
        spec = core(pkg, "model_spec").PAPER_MODELS["1.5B"]
        c = cl.paper_heterogeneous(16, 16)
        cfg = _cfg(pkg)
        plan = sched.schedule(spec, c, _P(pkg), cfg)
        if lost == "h20-node":
            keep = [d for d in c.devices if d.node != 3]
        elif lost == "h800-node":
            keep = [d for d in c.devices if d.node != 0]
        else:
            keep = c.devices[4:]
        survivors = cl.Cluster(devices=keep, cross_type_bw=c.cross_type_bw)
        new = sched.reschedule(spec, survivors, plan, _P(pkg), cfg,
                               reason="failure")
        return plan, new, new.describe()
    _, new, text = both(case)
    assert new[1]["plan_epoch"] == 1 and "replan:failure" in text


def test_schedule_slice_names_the_job_and_raises_when_infeasible():
    def case(pkg):
        sched = core(pkg, "scheduler")
        spec = core(pkg, "model_spec").PAPER_MODELS["7B"]
        c = core(pkg, "cluster").paper_heterogeneous(8, 8)
        plan = sched.schedule_slice(spec, c, _P(pkg), _cfg(pkg), job="jx")
        one_node = core(pkg, "cluster").paper_heterogeneous(0, 8)
        big = core(pkg, "model_spec").PAPER_MODELS["14B"]
        with pytest.raises(sched.InfeasibleScheduleError):
            sched.schedule_slice(big, one_node)
        # the single-job entry point goes through the pool, whose error
        # is typed per job
        with pytest.raises(core(pkg, "pool").PoolInfeasibleError):
            sched.schedule(big, one_node)
        return plan
    assert both(case)[1]["job"] == "jx"
