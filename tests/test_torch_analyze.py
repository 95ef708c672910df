"""The port's trace analyzer (``repro_torch.obs.analyze``) and sequence
packing (``repro_torch.data.packing``) against the reference's.

``analyze_trace`` reads the same Chrome-trace dicts (a traced simulator
run of the reference, a multi-job run, a hand-made trace with overlapping
spans) into the same report, floats bit for bit; ``check_report``,
``summarize_metrics``, the human summaries and the CLI's exit codes and
output agree.  ``greedy_pack`` / ``pack_stats`` give the same assignment
on random lengths and worker counts."""
import importlib
import json

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


@pytest.fixture(scope="module")
def traces():
    """Chrome-trace dicts recorded by the reference package: a single-job
    run (with a registry), a multi-job run, and a hand-made one."""
    from repro.core.cluster import paper_heterogeneous
    from repro.core.cost_model import LengthDistribution
    from repro.core.model_spec import PAPER_MODELS
    from repro.core.pool import JobSpec, schedule_pool
    from repro.core.scheduler import SchedulerConfig, schedule
    from repro.obs import MetricsRegistry, Tracer
    from repro.sim import (AsyncRLSimulator, MultiJobSimulator,
                           MultiSimConfig, SimConfig)
    P = LengthDistribution(mean_len=1024, prompt_len=128)
    cfg = SchedulerConfig(tokens_per_step=2 ** 18, stable_iters=3,
                          max_iters=12, adapt_delta=False)
    plan = schedule(PAPER_MODELS["1.5B"], paper_heterogeneous(8, 8), P, cfg)
    single, mx = Tracer(), MetricsRegistry()
    AsyncRLSimulator(plan, P, SimConfig(
        n_steps=5, rollouts_per_step=32, eta=4, reward_cost_s=0.1,
        trace=single, metrics=mx)).run()
    pool = schedule_pool([JobSpec("a", PAPER_MODELS["1.5B"], P, cfg)],
                         paper_heterogeneous(8, 8))
    multi = Tracer()
    MultiJobSimulator(pool, MultiSimConfig(n_steps=3, rollouts_per_step=32,
                                           trace=multi)).run()
    hand = Tracer()
    hand.span("stage", "generation", "g", 0.0, 2.0, tokens=10)
    hand.span("stage", "generation", "g", 1.0, 2.0, tokens=10)
    hand.span("stage", "train", "t", 3.5, 0.5, tokens=64)
    hand.span("replica", "r0", "generate", 0.0, 3.0, tokens=30)
    hand.instant("stage", "sync", "publish", 4.0, version=2)
    return {"single": single.to_chrome(), "multi": multi.to_chrome(),
            "hand": hand.to_chrome(), "metrics": mx.snapshot()}


@pytest.mark.parametrize("name", ["single", "multi", "hand"])
def test_analyze_trace_matches_reference(traces, name):
    trace = json.loads(json.dumps(traces[name]))

    def case(pkg):
        an = mod(pkg, "obs.analyze")
        report = an.analyze_trace(trace)
        return (report, an.check_report(report, min_stages=2),
                an.check_report(report, min_stages=9, max_tput_err=0.0),
                an._human(report))
    ref, port = (plain(case(pkg)) for pkg in PKGS)
    assert port == ref
    if name == "single":
        assert ref[1] == [] and ref[0]["throughput"]["rel_err"] < 0.01


def test_summarize_metrics_matches_reference(traces):
    def case(pkg):
        an = mod(pkg, "obs.analyze")
        s = an.summarize_metrics(traces["metrics"])
        return s, an._human_metrics(s)
    ref, port = (plain(case(pkg)) for pkg in PKGS)
    assert port == ref


@pytest.mark.parametrize("argv", [["--min-stages", "2"],
                                  ["--min-stages", "99"],
                                  ["--json"],
                                  ["--metrics", "METRICS"],
                                  ["--metrics", "METRICS", "--no-trace"]])
def test_cli_matches_reference(traces, tmp_path, capsys, argv):
    tp, mp = tmp_path / "trace.json", tmp_path / "metrics.json"
    tp.write_text(json.dumps(traces["single"]))
    mp.write_text(json.dumps(traces["metrics"]))
    args = [str(mp) if a == "METRICS" else a for a in argv]
    if "--no-trace" in args:
        args = ["analyze"] + [a for a in args if a != "--no-trace"]
    else:
        args = ["analyze", str(tp)] + args
    out = {}
    for pkg in PKGS:
        rc = mod(pkg, "obs.analyze").main(list(args))
        out[pkg] = (rc, capsys.readouterr().out)
    assert out["repro_torch"] == out["repro"]
    assert out["repro"][0] == (1 if "99" in args else 0)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(1, 4096), min_size=0, max_size=64),
       st.integers(1, 9))
def test_greedy_pack_matches_reference(lengths, workers):
    def case(pkg):
        pk = mod(pkg, "data.packing")
        a = pk.greedy_pack(lengths, workers)
        return a, pk.pack_stats(lengths, a)
    ref, port = (plain(case(pkg)) for pkg in PKGS)
    assert port == ref
    assignment = ref[0]
    assert sorted(i for grp in assignment for i in grp) == \
        list(range(len(lengths)))
    assert ref[1][0] <= max(lengths, default=0) + sum(lengths) / workers


def test_greedy_pack_is_exported_like_reference():
    from repro.data import greedy_pack as ref
    from repro_torch.data import greedy_pack
    assert greedy_pack([5, 1, 4, 2], 2) == ref([5, 1, 4, 2], 2)
