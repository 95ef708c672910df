"""Parity of the port's continuous-batching ``PagedEngine`` with the JAX
package's, on the CPU.

Both engines serve a tiny dense config (``TINY`` of ``tests/test_serve.py``)
greedily in float32, with the same parameters (the JAX init, published to
each package's ``WeightStore``) and the same tasks, in five cases: ragged
prompts queued behind fewer slots than tasks, GRPO groups with forks and
copy-on-write, preemption under a small pool, radix resubmit plus
``resume``, and a weight swap at a segment boundary.  JAX runs with
``use_pallas`` off and on (the Pallas paged kernel in interpret mode).
Completions are identical and log-probs agree within 1e-4; the integer
metrics of ``_package`` are equal and its rates agree within 1e-9.  Also
here: ``_nucleus_filter`` on the same logits, the multi-turn driver, and
the launcher's ``--engine paged`` metric keys.
"""
import json
import sys

import jax
import numpy as np
import pytest
import torch

from repro.data.tasks import MathTaskGenerator as JaxTasks
from repro.launch import serve as jax_launch
from repro.models import transformer as jt
from repro.models.api import ModelConfig as JaxModelConfig
from repro.rl.agentic import EnvConfig as JaxEnvConfig
from repro.rl.agentic import MultiTurnDriver as JaxDriver
from repro.rl.agentic import SimToolEnv as JaxEnv
from repro.rl.rollout import GenConfig as JaxGenConfig
from repro.rl.weight_sync import WeightStore as JaxStore
from repro.serve import PagedEngine as JaxEngine
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve.engine import _nucleus_filter as jax_nucleus
from repro_torch.data.tasks import MathTaskGenerator, Tokenizer
from repro_torch.launch.serve import run
from repro_torch.models.api import ModelConfig
from repro_torch.rl.agentic import EnvConfig, MultiTurnDriver, SimToolEnv
from repro_torch.rl.rollout import GenConfig
from repro_torch.rl.weight_sync import WeightStore
from repro_torch.serve import PagedEngine, ServeConfig
from repro_torch.serve.engine import _nucleus_filter

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=64, vocab=Tokenizer().vocab_size,
            dtype="float32", remat=False)
INT_KEYS = ("decode_steps", "decode_slot_steps", "prefill_tokens",
            "prefill_tokens_shared", "forks", "cow_copies", "bt_uploads",
            "preemptions", "radix_hit_tokens", "weight_swaps", "versions")
RATE_KEYS = ("slot_occupancy", "page_occupancy", "shared_page_fraction",
             "prefix_hit_rate", "radix_hit_rate", "g_eff", "mean_len")


def _params(seed):
    return jt.init(jax.random.PRNGKey(seed), JaxModelConfig(**TINY))


def _publishing_on_first_fetch(base, later):
    """A store of class ``base`` that publishes ``later`` right after its
    first fetch, so the engine sees a newer version at its first segment
    boundary."""
    class Store(base):
        fetched = False

        def fetch(self, *a, **kw):
            out = super().fetch(*a, **kw)
            if not self.fetched:
                self.fetched = True
                self.publish(later)
            return out
    return Store()


def _resume(eng, Tasks):
    """Radix resubmit (the second identical prompt adopts cached pages),
    then a second turn through ``resume``."""
    task = Tasks(seed=29).sample()
    out = [eng.generate([task]), eng.generate([task])]
    n0 = eng.stats.completed
    eng.resume(out[0][0][0], [40, 41, 42, 43, 44, 45])
    eng.drain()
    return out + [eng.collect(n0)]


CASES = {
    "ragged_queue": dict(
        gen=dict(max_new_tokens=10, greedy=True),
        serve=dict(max_slots=2, max_len=64, page_size=8, prefill_chunk=8),
        drive=lambda eng, T: [eng.generate(T(seed=7).batch(5))]),
    "groups_cow": dict(
        gen=dict(max_new_tokens=12, greedy=True, eos_id=-1),
        serve=dict(max_slots=4, max_len=64, page_size=8, prefill_chunk=8),
        drive=lambda eng, T: [eng.generate_groups(T(seed=11).batch(2), 3)]),
    "preemption": dict(
        gen=dict(max_new_tokens=24, greedy=True, eos_id=-1),
        serve=dict(max_slots=2, max_len=56, page_size=8, prefill_chunk=8,
                   num_pages=1 + 7 + 2),
        drive=lambda eng, T: [eng.generate(T(seed=9).batch(2))]),
    "radix_resume": dict(
        gen=dict(max_new_tokens=12, greedy=True, eos_id=-1),
        serve=dict(max_slots=2, max_len=96, page_size=8, prefill_chunk=8,
                   radix=True),
        drive=_resume),
    "weight_swap": dict(
        gen=dict(max_new_tokens=12, segment=4, greedy=True),
        serve=dict(max_slots=3, max_len=64, page_size=8, prefill_chunk=8),
        drive=lambda eng, T: [eng.generate(T(seed=3).batch(3))],
        swap=True),
}


def _store(base, case):
    p1 = jax.tree_util.tree_map(np.asarray, _params(0))
    if case.get("swap"):
        store = _publishing_on_first_fetch(
            base, jax.tree_util.tree_map(np.asarray, _params(1)))
    else:
        store = base()
    store.publish(p1)
    return store


def _run_port(name):
    case = CASES[name]
    eng = PagedEngine(ModelConfig(**TINY), _store(WeightStore, case),
                      GenConfig(**case["gen"]), ServeConfig(**case["serve"]),
                      device="cpu")
    return case["drive"](eng, MathTaskGenerator), eng


def _run_jax(name, use_pallas):
    case = CASES[name]
    cfg = JaxModelConfig(**TINY).replace(use_pallas=use_pallas)
    eng = JaxEngine(cfg, _store(JaxStore, case), JaxGenConfig(**case["gen"]),
                    JaxServeConfig(**case["serve"]))
    return case["drive"](eng, JaxTasks), eng


@pytest.fixture(scope="module")
def port_runs():
    return {}


def _assert_same(got, want):
    for (tr, tm), (jr, jm) in zip(got, want):
        assert len(tr) == len(jr) > 0
        for a, b in zip(tr, jr):
            assert a.prompt_ids == b.prompt_ids
            assert a.completion_ids == b.completion_ids
            assert (a.version, a.group_id) == (b.version, b.group_id)
            np.testing.assert_allclose(a.behavior_logp, b.behavior_logp,
                                       atol=1e-4, rtol=0)
        for key in INT_KEYS:
            assert tm[key] == jm[key], key
        for key in RATE_KEYS:
            assert tm[key] == pytest.approx(jm[key], abs=1e-9), key


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_paged_engine_matches_jax(port_runs, name, use_pallas):
    if name not in port_runs:
        port_runs[name] = _run_port(name)
    got, teng = port_runs[name]
    want, jeng = _run_jax(name, use_pallas)
    assert len(got) == len(want)
    _assert_same(got, want)
    ts, js = vars(teng.stats), vars(jeng.stats)
    for key in ts:
        if key not in ("wall_time_s", "gen_samples"):
            assert ts[key] == pytest.approx(js[key], abs=1e-9), key
    assert teng.kv.pages_in_use + teng.kv.free_pages == teng.kv.num_pages - 1
    m = got[-1][1]
    if name == "groups_cow":
        assert m["forks"] >= 3 and m["cow_copies"] > 0
    elif name == "preemption":
        assert m["preemptions"] >= 1
    elif name == "radix_resume":
        assert got[1][1]["radix_hit_tokens"] > 0
        assert m["radix_hit_tokens"] > 0
    elif name == "weight_swap":
        assert m["weight_swaps"] == 1 and m["versions"] == [1, 2]
    elif name == "ragged_queue":
        assert len({len(r.prompt_ids) for r in got[0][0]}) > 1


def test_bt_upload_cache_copies_the_host_table():
    """The cached device table is a copy: a host edit is not visible on
    the device until the allocator's dirty flag forces an upload."""
    eng = PagedEngine(ModelConfig(**TINY), _store(WeightStore, {}),
                      GenConfig(max_new_tokens=4, greedy=True),
                      ServeConfig(max_slots=2, max_len=64, page_size=8),
                      device="cpu")
    eng.generate(MathTaskGenerator(seed=1).batch(1))
    assert eng._bt_dev is not None
    before = eng._bt_dev.clone()
    eng.kv.block_tables[0, 0] += 1
    torch.testing.assert_close(eng._bt_dev, before, rtol=0, atol=0)


def test_engine_runs_inside_and_outside_inference_mode():
    """fork -> COW -> decode works whether the caller runs the engine under
    ``torch.inference_mode()`` or not, on one engine, with the same
    tokens."""
    case = CASES["groups_cow"]
    eng = PagedEngine(ModelConfig(**TINY), _store(WeightStore, case),
                      GenConfig(**case["gen"]), ServeConfig(**case["serve"]),
                      device="cpu")
    tasks = MathTaskGenerator(seed=11).batch(2)
    with torch.inference_mode():
        r1, m1 = eng.generate_groups(tasks, 3)
    r2, m2 = eng.generate_groups(tasks, 3)
    assert m1["cow_copies"] > 0 and m2["cow_copies"] > 0
    assert [r.completion_ids for r in r1] == [r.completion_ids for r in r2]


@pytest.mark.parametrize("top_p", [0.3, 0.8, 0.95])
def test_nucleus_filter_matches_jax(top_p):
    logits = np.random.default_rng(0).standard_normal((4, 259)) * 3
    logits = logits.astype(np.float32)
    got = _nucleus_filter(torch.from_numpy(logits), top_p).numpy()
    want = np.asarray(jax_nucleus(jax.numpy.asarray(logits), top_p))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_array_equal(got[np.isfinite(got)],
                                  want[np.isfinite(want)])
    assert np.isfinite(got).sum(axis=-1).min() >= 1


def test_sampled_rows_stay_in_the_nucleus():
    """Non-greedy requests with their own top_p sample only kept tokens
    (the torch draws differ from JAX's; the support does not)."""
    eng = PagedEngine(ModelConfig(**TINY), _store(WeightStore, {}),
                      GenConfig(max_new_tokens=6),
                      ServeConfig(max_slots=2, max_len=64, page_size=8),
                      rng_seed=3, device="cpu")
    eng.submit(MathTaskGenerator(seed=2).batch(2), top_p=0.5,
               temperature=0.7)
    eng.drain()
    rollouts, m = eng.collect()
    assert len(rollouts) == 2 and m["decode_steps"] > 0
    for r in rollouts:
        assert all(0 <= t < TINY["vocab"] for t in r.completion_ids)
        assert np.all(r.behavior_logp <= 0) and np.isfinite(
            r.behavior_logp).all()


def test_multi_turn_driver_matches_jax():
    env = dict(turns=2, tool_tokens=6, max_new_per_turn=8, seed=5)
    gen = dict(max_new_tokens=8, greedy=True, eos_id=-1)
    serve = dict(max_slots=3, max_len=64, page_size=8, prefill_chunk=8,
                 radix=True)
    jeng = JaxEngine(JaxModelConfig(**TINY), _store(JaxStore, {}),
                     JaxGenConfig(**gen), JaxServeConfig(**serve))
    teng = PagedEngine(ModelConfig(**TINY), _store(WeightStore, {}),
                       GenConfig(**gen), ServeConfig(**serve), device="cpu")
    jep, jm = JaxDriver(jeng, JaxEnv(JaxEnvConfig(**env))).run(
        JaxTasks(seed=13).batch(3))
    tep, tm = MultiTurnDriver(teng, SimToolEnv(EnvConfig(**env))).run(
        MathTaskGenerator(seed=13).batch(3))
    assert set(tm) == set(jm)
    for key, value in jm.items():
        assert tm[key] == pytest.approx(value, abs=1e-9), key
    assert tm["radix_hit_tokens"] > 0 and tm["env_calls"] == 3
    for a, b in zip(tep, jep):
        assert len(a.turns) == len(b.turns) == 2
        assert a.history == b.history
        assert a.env_wait_s == pytest.approx(b.env_wait_s, abs=1e-12)


ARGV = ["--smoke", "--engine", "paged", "--greedy", "--batch", "3",
        "--slots", "2", "--max-new", "6"]


def test_launcher_paged_writes_the_reference_metric_keys(tmp_path,
                                                         monkeypatch):
    theirs, ours = tmp_path / "jax.json", tmp_path / "torch.json"
    monkeypatch.setattr(sys, "argv", ["serve"] + ARGV
                        + ["--quiet", "--metrics", str(theirs)])
    jax_launch.main()
    out = run(ARGV + ["--device", "cpu", "--quiet", "--metrics", str(ours)])
    want, got = (json.loads(p.read_text()) for p in (theirs, ours))
    for kind in ("counters", "gauges", "histograms"):
        assert set(got[kind]) == set(want[kind]), kind
    assert {"serve/slot_occupancy", "serve/page_occupancy"} <= set(
        got["gauges"]) and "serve/preemptions" in got["counters"]
    assert got["counters"]["serve/tokens"] == out["tokens"]
    assert got["counters"]["serve/requests"] == 3
    assert out["decode_slot_steps"] <= out["decode_steps"] * 2


def test_launcher_multi_turn_hits_the_radix_cache():
    out = run(ARGV + ["--device", "cpu", "--quiet", "--turns", "2",
                      "--page-size", "8"])
    assert out["turns"] == 2 and out["radix_hit_tokens"] > 0
    assert out["decode_steps"] > 0 and len(out["rollouts"]) == 3
