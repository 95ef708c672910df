"""The serving → scheduler loop of the port against the reference's:
``serve.feedback`` (``ServingCostModel``, ``fit_env_model``,
``fit_gen_time``) on the same inputs, a report measured on the port's
``PagedEngine`` (on the CPU) priced by both packages' schedulers, and
``launch.train --schedule``.  Results must be equal field for field,
floats bit for bit (``_plan_parity.plain``)."""
import dataclasses
import importlib

import numpy as np
import pytest

from _plan_parity import plain

PKGS = ("repro", "repro_torch")
ARCHS = ("qwen-distill-1.5b", "qwen-distill-7b", "qwen-distill-14b",
         "xlstm-1.3b")

# report fields: engine-level factors inside, above and below the clamp,
# a report without decode steps (falls back), prefix sharing below 1
REPORTS = {
    "measured": dict(slot_occupancy=0.62, g_eff=3.5, decode_steps=40),
    "above-ceil": dict(slot_occupancy=1.0, g_eff=8.0, decode_steps=7),
    "below-floor": dict(slot_occupancy=0.001, g_eff=0.5, decode_steps=3),
    "no-steps": dict(slot_occupancy=0.5, g_eff=4.0, decode_steps=0),
}


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def both(case):
    ref, port = (plain(case(pkg)) for pkg in PKGS)
    assert port == ref
    return ref


def _report(pkg, device_type, **kw):
    fields = dict(device_type=device_type, engine="paged",
                  tokens_per_sec=1234.5, slot_occupancy=0.5,
                  page_occupancy=0.7, batch_slots=32, decode_steps=10)
    fields.update(kw)
    return mod(pkg, "serve.feedback").EngineReport(**fields)


def _factors(pkg, provider):
    profiles = mod(pkg, "core.cluster").PROFILES
    return {name: [getattr(provider, f)(p) for f in (
        "train_mfu", "prefill_mfu", "decode_compute_eff",
        "decode_engine_eff", "hbm_eff", "prefill_g_eff")]
        for name, p in profiles.items()}


def _schedule(pkg, provider, model="1.5B"):
    spec = mod(pkg, "core.model_spec").PAPER_MODELS[model]
    c = mod(pkg, "core.cluster").paper_heterogeneous(8, 8)
    return mod(pkg, "core.scheduler").schedule(spec, c,
                                               cost_provider=provider)


# ------------------------------------------------------- ServingCostModel
@pytest.mark.parametrize("name", sorted(REPORTS))
@pytest.mark.parametrize("device_type", ["H20", "H800"])
def test_serving_cost_model_matches_reference(name, device_type):
    def case(pkg):
        fb = mod(pkg, "serve.feedback")
        rep = _report(pkg, device_type, **REPORTS[name])
        by_list = fb.ServingCostModel([rep])
        by_dict = fb.ServingCostModel({device_type: rep})
        plan = _schedule(pkg, by_list)
        return _factors(pkg, by_list), _factors(pkg, by_dict), plan, \
            plan.describe()
    factors, _, _, _ = both(case)
    rep = REPORTS[name]
    eff, g = factors[device_type][3], factors[device_type][5]
    if rep["decode_steps"] > 0:
        assert eff == min(0.95, max(0.01, rep["slot_occupancy"]))
        assert g == max(rep["g_eff"], 1.0)
    other = "H800" if device_type == "H20" else "H20"
    analytic = _factors("repro_torch",
                        mod("repro_torch", "core.cost_model").ANALYTIC)
    assert factors[other] == analytic[other]


def test_serving_cost_model_over_a_custom_fallback_matches_reference():
    def case(pkg):
        cm, fb = mod(pkg, "core.cost_model"), mod(pkg, "serve.feedback")
        inner = fb.ServingCostModel([_report(pkg, "H800", g_eff=2.0)])
        outer = fb.ServingCostModel([_report(pkg, "H20",
                                             slot_occupancy=0.41)],
                                    fallback=inner)
        return _factors(pkg, outer), _schedule(pkg, outer, "7B"), \
            cm.resolve_provider(outer) is outer
    both(case)


@pytest.mark.parametrize("model", ["1.5B", "14B"])
def test_no_report_plan_is_the_analytic_plan(model):
    def case(pkg):
        fb = mod(pkg, "serve.feedback")
        empty = _schedule(pkg, fb.ServingCostModel([]), model)
        analytic = _schedule(pkg, None, model)
        assert plain(empty) == plain(analytic)
        return empty
    both(case)


# ---------------------------------------------------------------- fits
@pytest.mark.parametrize("turns,gap,kw", [
    (1.0, 0.0, {}), (3.0, 0.0, {}), (1.0, 0.5, {}),
    (3.0, 0.4, {}), (2.5, 1.25, dict(workers=8, cv=0.8, overlap=0.3))])
def test_fit_env_model_matches_reference(turns, gap, kw):
    def case(pkg):
        rep = _report(pkg, "H20", turns_per_episode=turns, turn_gap_s=gap)
        env = mod(pkg, "serve.feedback").fit_env_model(rep, **kw)
        if env is None:
            return None
        return env, env.stage_time(32.0), env.episode_gap_s(), \
            env.sample_gaps(np.random.default_rng(1), 4)
    out = both(case)
    assert (out is None) == (turns <= 1.0 or gap <= 0.0)


def _samples(seed, n, distinct):
    rng = np.random.default_rng(seed)
    lens = rng.choice(np.arange(8, 8 + 16 * distinct, 16), size=n)
    t = 0.02 + 1e-3 * lens + 2e-6 * lens * (100 + lens / 2)
    return [(int(ln), float(x)) for ln, x in
            zip(lens, t * rng.uniform(0.95, 1.05, n))]


@pytest.mark.parametrize("seed,n,distinct,kw", [
    (0, 40, 6, {}), (1, 12, 3, dict(prompt_len=100.0)),
    (2, 30, 5, dict(prompt_len=64.0, g_eff=4.0, turns=3.0,
                    turn_gap_s=0.2)),
    (3, 10, 2, {}), (4, 1, 1, {})])
def test_fit_gen_time_matches_reference(seed, n, distinct, kw):
    samples = _samples(seed, n, distinct)

    def case(pkg):
        gt = mod(pkg, "serve.feedback").fit_gen_time(samples, **kw)
        if gt is None:
            return None
        return gt, [gt.duration(ln, prompt_len=100.0, tokens_per_sec=900.0,
                                mean_len=80.0) for ln in (16, 64, 256)], \
            gt.raw(64.0, 128.0)
    out = both(case)
    assert (out is None) == (len({ln for ln, _ in samples}) < 3)


# -------------------------------------------------- the engine's report
@pytest.fixture(scope="module")
def engine_stats():
    """GRPO groups through the port's paged engine on the CPU (smoke
    config, 3 tasks x group 4 through 8 slots): forks share each group's
    prompt, so g_eff > 1."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.tasks import MathTaskGenerator
    from repro_torch.models import transformer
    from repro_torch.rl.rollout import GenConfig
    from repro_torch.rl.weight_sync import WeightStore
    from repro_torch.serve import PagedEngine, ServeConfig

    cfg = get_smoke_config("qwen-distill-1.5b")
    store = WeightStore()
    store.publish(transformer.init(0, cfg, "cpu"))
    tasks = MathTaskGenerator(seed=0).batch(3)
    plen = max(len(t.prompt_ids) for t in tasks)
    eng = PagedEngine(cfg, store, GenConfig(max_new_tokens=12),
                      ServeConfig(max_slots=8, max_len=plen + 12),
                      device="cpu")
    eng.generate_groups(tasks, 4)
    return eng.stats


@pytest.mark.parametrize("device_type", ["H20", "H800"])
def test_port_engine_report_gives_the_reference_plan(engine_stats,
                                                     device_type):
    port_fb = mod("repro_torch", "serve.feedback")
    ref_fb = mod("repro", "serve.feedback")
    port_rep = port_fb.EngineReport.from_stats(engine_stats, device_type)
    assert port_rep.decode_steps > 0 and port_rep.g_eff > 1.0
    ref_rep = ref_fb.EngineReport(**dataclasses.asdict(port_rep))
    reps = {"repro": ref_rep, "repro_torch": port_rep}

    def case(pkg):
        model = mod(pkg, "serve.feedback").ServingCostModel([reps[pkg]])
        plans = [_schedule(pkg, model, m) for m in ("1.5B", "7B", "14B")]
        return reps[pkg], _factors(pkg, model), plans, \
            [p.describe() for p in plans]
    both(case)


def test_port_engine_samples_fit_like_the_reference(engine_stats):
    samples = list(engine_stats.gen_samples)
    assert len(samples) == 12

    def case(pkg):
        return mod(pkg, "serve.feedback").fit_gen_time(
            samples, prompt_len=30.0, g_eff=engine_stats.g_eff)
    both(case)


# ------------------------------------------------------ launch --schedule
@pytest.mark.parametrize("arch", ARCHS)
def test_paper_schedule_matches_reference(arch):
    from repro_torch.launch.train import paper_schedule

    def case(pkg):
        if pkg == "repro_torch":
            return paper_schedule(arch)
        spec = mod(pkg, "configs").get_config(arch).spec
        return mod(pkg, "core.scheduler").schedule(
            spec, mod(pkg, "core.cluster").paper_heterogeneous(8, 8))
    both(case)


def test_launcher_schedule_returns_the_reference_plan():
    from repro_torch.launch.train import run
    ref = mod("repro", "core.scheduler").schedule(
        mod("repro", "configs").get_config("qwen-distill-1.5b").spec,
        mod("repro", "core.cluster").paper_heterogeneous(8, 8))
    out = run(["--smoke", "--device", "cpu", "--schedule", "--steps", "1",
               "--quiet"])
    assert out["schedule"] == ref.describe()
    assert plain(out["plan"]) == plain(ref)
    assert len(out["steps"]) == 1
    plan = out["plan"]
    assert not set(plan.train_devices) & set(plan.infer_devices)
    assert len(plan.train_devices) + len(plan.infer_devices) <= 16
