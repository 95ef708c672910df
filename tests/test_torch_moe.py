"""Parity of the port's MoE (``models/moe.py``) with the JAX package, on
the CPU, for both MoE configs (qwen3-moe-235b-a22b and grok-1-314b at
smoke size).

The port dispatches by index where the reference multiplies one-hot
tensors, so the tests hold the routing decision itself: for the same
tokens both pick the same experts, queue them at the same choice-major
positions and drop the same (token, choice) pairs at the default
``CAPACITY_FACTOR`` (1.25), and the outputs agree at 2e-5.  That holds
with a zero-padded last group (the pad tokens' equal gates pick the lower
experts first on both sides) and in decode at B = 8 with 32 experts,
where the capacity is 1.  Forward, prefill and decode logits agree with
the reference's at 2e-3 and their greedy tokens are identical; with the
factor raised to 100 (no drops) prefill and decode reproduce the forward,
as the reference's own test has it.  A ``RolloutEngine`` greedy run
matches the reference's engine token for token.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import moe as jmoe
from repro_torch.bridge import params_from_jax, to_tensor
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe as tmoe

F32_TOL = dict(atol=2e-5, rtol=2e-5)
LOGIT_TOL = dict(atol=2e-3, rtol=2e-3)
ARCHS = ["qwen3-moe-235b-a22b", "grok-1-314b"]


def _cfgs(arch, **kw):
    jcfg = jax_smoke_config(arch).replace(**kw)
    tcfg = get_smoke_config(arch).replace(**kw)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    return jcfg, tcfg


def _params(jcfg, seed=0):
    jparams = jmoe.init(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, tree, params_from_jax(tree, "cpu")


def _layer0(tree):
    return jax.tree_util.tree_map(lambda a: a[0], tree["layers"])


def _reference_routing(x, lp, cfg, capacity):
    """The reference's routing decision, ``repro/models/moe.py``
    ``_route_groups`` up to ``keep``: experts and keep mask [G, k, c]."""
    G, c, _ = x.shape
    E, k = cfg.n_experts, cfg.top_k
    logits = jnp.einsum("gcd,de->gce", x.astype(jnp.float32),
                        lp["router"].astype(jnp.float32))
    _, top_idx = lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    choice_mask = jax.nn.one_hot(jnp.moveaxis(top_idx, -1, 1), E,
                                 dtype=jnp.int32)
    flat = choice_mask.reshape(G, k * c, E)
    pos = jnp.sum(flat * (jnp.cumsum(flat, axis=1) - flat),
                  axis=-1).reshape(G, k, c)
    return np.asarray(jnp.moveaxis(top_idx, -1, 1)), np.asarray(pos < capacity)


def _hold_routing(xg, tree, jcfg, tcfg, capacity):
    """Same experts and keep mask on both sides; outputs within 2e-5.
    Returns the number of dropped choices."""
    lp = _layer0(tree)
    texp, _, _, tkeep = tmoe.route(torch.from_numpy(xg),
                                   jax.tree_util.tree_map(to_tensor, lp),
                                   tcfg, capacity)
    jexp, jkeep = _reference_routing(jnp.asarray(xg), lp, jcfg, capacity)
    np.testing.assert_array_equal(texp.numpy(), jexp)
    np.testing.assert_array_equal(tkeep.numpy(), jkeep)
    return int((~jkeep).sum())


@pytest.mark.parametrize("arch", ARCHS)
def test_route_groups_drops_the_same_choices(arch):
    jcfg, tcfg = _cfgs(arch)
    _, tree, _ = _params(jcfg)
    xg = np.random.default_rng(1).standard_normal(
        (2, 24, tcfg.d_model)).astype(np.float32)
    capacity = tmoe._capacity(24, tcfg)
    assert capacity == math.ceil(24 * tcfg.top_k * 1.25 / tcfg.n_experts)
    assert _hold_routing(xg, tree, jcfg, tcfg, capacity) > 0
    lp = _layer0(tree)
    got = tmoe._route_groups(torch.from_numpy(xg),
                             jax.tree_util.tree_map(to_tensor, lp), tcfg,
                             capacity)
    want = jmoe._route_groups(jnp.asarray(xg), lp, jcfg, capacity)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_with_a_padded_group(arch):
    """22 tokens in groups of 16: the second group holds 10 zero pad
    tokens, whose uniform gates tie and take capacity from the real ones."""
    jcfg, tcfg = _cfgs(arch, moe_group=16)
    _, tree, _ = _params(jcfg)
    x = np.random.default_rng(2).standard_normal(
        (2, 11, tcfg.d_model)).astype(np.float32)
    xg = np.concatenate([x.reshape(22, -1), np.zeros((10, tcfg.d_model),
                                                     np.float32)])
    capacity = tmoe._capacity(16, tcfg)
    assert _hold_routing(xg.reshape(2, 16, -1), tree, jcfg, tcfg,
                         capacity) > 0
    lp = _layer0(tree)
    got = tmoe.moe_ffn(torch.from_numpy(x),
                       jax.tree_util.tree_map(to_tensor, lp), tcfg)
    want = jmoe.moe_ffn(jnp.asarray(x), lp, jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def _run(mod, params, cfg, tokens, steps, tensor):
    """(prefill + greedy decode logits, fed tokens, forward logits)."""
    B, S = tokens.shape
    fwd = mod.forward(params, cfg, tensor(tokens))
    last, cache = mod.prefill(params, cfg, tensor(tokens), max_len=S + steps)
    step = (lambda p, c, t, pos: mod.decode_step(p, cfg, c, t, pos))
    if mod is jmoe:
        step = jax.jit(step)
    logits, out = [np.asarray(last)], []
    for t in range(steps):
        tok = np.argmax(logits[-1][:, :cfg.vocab], -1).astype(np.int32)
        out.append(tok)
        lg, cache = step(params, cache, tensor(tok),
                         tensor(np.full(B, S + t, np.int32)))
        logits.append(np.asarray(lg))
    return np.stack(logits), np.stack(out), np.asarray(fwd)


def _both(arch, B, S, steps, **kw):
    jcfg, tcfg = _cfgs(arch, **kw)
    jparams, tree, tparams = _params(jcfg, seed=1)
    toks = np.random.default_rng(3).integers(3, tcfg.vocab, (B, S)).astype(
        np.int32)
    with torch.inference_mode():
        got = _run(tmoe, tparams, tcfg, toks, steps,
                   lambda a: torch.from_numpy(a))
    want = _run(jmoe, jparams, jcfg, toks, steps, jnp.asarray)
    own = tmoe.init(0, tcfg, "cpu").tree()
    assert (jax.tree_util.tree_map(np.shape, tree)
            == jax.tree_util.tree_map(lambda t: tuple(t.shape), own))
    return tcfg, got, want


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_jax(arch):
    _, (lg, toks, fwd), (jlg, jtoks, jfwd) = _both(arch, 2, 12, 6)
    np.testing.assert_allclose(fwd, jfwd, **LOGIT_TOL)
    np.testing.assert_array_equal(toks, jtoks)
    np.testing.assert_allclose(lg, jlg, **LOGIT_TOL)


def test_decode_at_capacity_one():
    """B = 8 rows, 32 experts, top-2: ceil(8 * 2 * 1.25 / 32) = 1 slot per
    expert in a decode step, so most choices drop; both sides drop the
    same ones (the logits and greedy tokens agree)."""
    tcfg, (lg, toks, _), (jlg, jtoks, _) = _both(
        "qwen3-moe-235b-a22b", 8, 6, 4, n_experts=32)
    assert tmoe._capacity(8, tcfg) == 1
    jcfg, _ = _cfgs("qwen3-moe-235b-a22b", n_experts=32)
    _, tree, _ = _params(jcfg)
    xg = np.random.default_rng(5).standard_normal(
        (1, 8, tcfg.d_model)).astype(np.float32)
    assert _hold_routing(xg, tree, jcfg, tcfg, 1) > 0
    np.testing.assert_array_equal(toks, jtoks)
    np.testing.assert_allclose(lg, jlg, **LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_reproduce_forward_without_drops(arch,
                                                            monkeypatch):
    monkeypatch.setattr(tmoe, "CAPACITY_FACTOR", 100.0)
    jcfg, tcfg = _cfgs(arch)
    _, _, tparams = _params(jcfg, seed=2)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        3, tcfg.vocab, (2, 10)))
    with torch.inference_mode():
        full = tmoe.forward(tparams, tcfg, toks)
        lg, cache = tmoe.prefill(tparams, tcfg, toks[:, :6], max_len=10)
        np.testing.assert_allclose(lg.numpy(), full[:, 5].numpy(),
                                   **LOGIT_TOL)
        for i in range(6, 10):
            lg, cache = tmoe.decode_step(tparams, tcfg, cache, toks[:, i],
                                         torch.full((2,), i,
                                                    dtype=torch.int32))
            np.testing.assert_allclose(lg.numpy(), full[:, i].numpy(),
                                       **LOGIT_TOL)


def test_rollout_engine_greedy_matches_jax():
    from repro.data.tasks import MathTaskGenerator as JaxTasks
    from repro.rl.rollout import GenConfig as JaxGen
    from repro.rl.rollout import RolloutEngine as JaxEngine
    from repro.rl.weight_sync import WeightStore as JaxStore
    from repro_torch.data.tasks import MathTaskGenerator, Tokenizer
    from repro_torch.rl.rollout import GenConfig, RolloutEngine
    from repro_torch.rl.weight_sync import WeightStore

    jcfg, tcfg = _cfgs("qwen3-moe-235b-a22b", vocab=Tokenizer().vocab_size)
    _, tree, _ = _params(jcfg, seed=3)
    gen = dict(max_new_tokens=10, segment=4, greedy=True)
    jstore, tstore = JaxStore(), WeightStore()
    jstore.publish(tree)
    tstore.publish(tree)
    jr, _ = JaxEngine(jcfg, jstore, JaxGen(**gen)).generate(
        JaxTasks(seed=1).batch(4))
    tr, _ = RolloutEngine(tcfg, tstore, GenConfig(**gen),
                          device="cpu").generate(
        MathTaskGenerator(seed=1).batch(4))
    assert [r.completion_ids for r in tr] == [r.completion_ids for r in jr]
    for a, b in zip(tr, jr):
        np.testing.assert_allclose(a.behavior_logp, b.behavior_logp,
                                   atol=1e-4, rtol=0)
