"""Parity of the port's static ``RolloutEngine`` and weight store with the
JAX package, on the CPU.

Both engines run greedy on the same tasks (``MathTaskGenerator(seed=1)``,
the port's own copy of the generator) with the same parameters, carried
over by ``params_from_jax``: completions are identical, behaviour log-probs
agree to 1e-4, and so do the versions, weight swaps and decode slot steps,
also under a publish that forces a swap at the first segment boundary.
"""
import jax
import numpy as np
import pytest
import torch

from repro.data.tasks import MathTaskGenerator as JaxTaskGenerator
from repro.models import transformer as jt
from repro.rl.rollout import GenConfig as JaxGenConfig
from repro.rl.rollout import RolloutEngine as JaxRolloutEngine
from repro.rl.weight_sync import WeightStore as JaxWeightStore
from repro.rl.weight_sync import dequantize_int8 as jax_dequantize
from repro.rl.weight_sync import quantize_int8 as jax_quantize
from repro.configs import get_smoke_config as jax_smoke_config
from repro_torch.configs import get_smoke_config
from repro_torch.data.tasks import MathTaskGenerator, Tokenizer
from repro_torch.rl.rollout import GenConfig, RolloutEngine
from repro_torch.rl.weight_sync import (WeightStore, dequantize_int8,
                                        quantize_int8, tree_bytes)

GEN = dict(max_new_tokens=20, segment=8, greedy=True)


def _cfgs():
    vocab = Tokenizer().vocab_size
    kw = dict(vocab=vocab, dtype="float32", remat=False)
    return (jax_smoke_config("qwen-distill-1.5b").replace(**kw),
            get_smoke_config("qwen-distill-1.5b").replace(**kw))


def _np_params(cfg, seed):
    return jax.tree_util.tree_map(np.asarray,
                                  jt.init(jax.random.PRNGKey(seed), cfg))


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


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    p1, p2 = _np_params(jcfg, 0), _np_params(jcfg, 1)
    tasks_j = JaxTaskGenerator(seed=1).batch(4)
    tasks_t = MathTaskGenerator(seed=1).batch(4)
    assert [t.prompt_ids for t in tasks_t] == [t.prompt_ids for t in tasks_j]
    assert len({len(t.prompt_ids) for t in tasks_t}) > 1   # padding is live
    return dict(jcfg=jcfg, tcfg=tcfg, p1=p1, p2=p2, tasks_j=tasks_j,
                tasks_t=tasks_t)


def _run_both(s, swap: bool, groups: int = 0):
    if swap:
        jstore = _publishing_on_first_fetch(JaxWeightStore, s["p2"])
        tstore = _publishing_on_first_fetch(WeightStore, s["p2"])
    else:
        jstore, tstore = JaxWeightStore(), WeightStore()
    jstore.publish(s["p1"])
    tstore.publish(s["p1"])
    jeng = JaxRolloutEngine(s["jcfg"], jstore, JaxGenConfig(**GEN))
    teng = RolloutEngine(s["tcfg"], tstore, GenConfig(**GEN), device="cpu")
    if groups:
        return (jeng.generate_groups(s["tasks_j"][:2], groups),
                teng.generate_groups(s["tasks_t"][:2], groups))
    return jeng.generate(s["tasks_j"]), teng.generate(s["tasks_t"])


@pytest.mark.parametrize("swap", [False, True])
def test_greedy_rollouts_match_jax(setup, swap):
    (jr, jm), (tr, tm) = _run_both(setup, swap)
    assert len(tr) == len(jr) == 4
    for a, b in zip(tr, jr):
        assert a.prompt_ids == b.prompt_ids
        assert a.completion_ids == b.completion_ids
        assert a.version == b.version
        assert a.group_id == b.group_id
        np.testing.assert_allclose(a.behavior_logp, b.behavior_logp,
                                   atol=1e-4, rtol=0)
    for key in ("weight_swaps", "versions", "decode_steps",
                "decode_slot_steps", "mean_len"):
        assert tm[key] == jm[key], key
    if swap:
        assert tm["weight_swaps"] == 1 and tm["versions"] == [1, 2]
        assert all(r.version == 1 for r in tr)      # the oldest version used


def test_generate_groups_matches_jax(setup):
    (jr, _), (tr, _) = _run_both(setup, swap=False, groups=3)
    assert [r.group_id for r in tr] == [r.group_id for r in jr] \
        == [0, 0, 0, 1, 1, 1]
    assert [r.completion_ids for r in tr] == [r.completion_ids for r in jr]


def test_int8_quantization_matches_jax():
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((7, 5)).astype(np.float32),
            "b": {"c": (rng.standard_normal(11) * 1e-3).astype(np.float32),
                  "z": np.zeros(4, np.float32)}}
    jq, js = jax_quantize(tree)
    tq, ts = quantize_int8(tree)
    for path in (("a",), ("b", "c"), ("b", "z")):
        j_q, j_s, t_q, t_s = jq, js, tq, ts
        for k in path:
            j_q, j_s, t_q, t_s = j_q[k], j_s[k], t_q[k], t_s[k]
        assert t_q.dtype == torch.int8
        np.testing.assert_array_equal(t_q.numpy(), np.asarray(j_q))
        np.testing.assert_array_equal(t_s.numpy(), np.asarray(j_s))
    jd = jax_dequantize(jq, js, dtype=np.float32)
    td = dequantize_int8(tq, ts, dtype=torch.float32)
    np.testing.assert_array_equal(td["a"].numpy(), np.asarray(jd["a"]))
    np.testing.assert_array_equal(td["b"]["c"].numpy(),
                                  np.asarray(jd["b"]["c"]))


def test_weight_store_versions_and_bytes(setup):
    store = WeightStore(keep_versions=2)
    for p in (setup["p1"], setup["p2"], setup["p1"]):
        v = store.publish(p)
    assert v == store.version == 3
    with pytest.raises(KeyError):
        store.fetch(1)                               # aged out
    tree, version = store.fetch()
    assert version == 3
    np.testing.assert_array_equal(tree["embed"].numpy(), setup["p1"]["embed"])
    n = sum(a.size for a in jax.tree_util.tree_leaves(setup["p1"]))
    assert tree_bytes(setup["p1"]) == store.payload_bytes(setup["p1"]) == 4 * n
    q = WeightStore(quantize=True)
    q.publish(setup["p1"])
    deq, _ = q.fetch(dtype=torch.float32)
    assert deq["embed"].dtype == torch.float32
    leaves = jax.tree_util.tree_leaves(setup["p1"])
    assert q.payload_bytes(setup["p1"]) == n + 4 * len(leaves)
