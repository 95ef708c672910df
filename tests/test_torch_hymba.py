"""Parity of the port's Hymba (``models/hymba.py``) with the JAX package,
on the CPU.

The SSM scan: the reference evaluates each chunk with
``lax.associative_scan``, the port steps through it; ``ssm_chunkwise``
agrees at 2e-5 in float32 across chunk boundaries (chunks of 8 over 21
and over 150 steps, and the default chunk of 128 over 150) from a nonzero
carried state, final state included, and so does ``ssm_step``.  The
model (smoke size, window 16) runs forward, a 20-token prefill (the ring
holds its last 16 positions, the SSM state its carry) and 8 greedy decode
steps past the window from the JAX params: logits within 2e-3, caches
within 2e-5, greedy tokens identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import hymba as jhymba
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke_config
from repro_torch.models import hymba as thymba

F32_TOL = dict(atol=2e-5, rtol=2e-5)
LOGIT_TOL = dict(atol=2e-3, rtol=2e-3)
PROMPT, STEPS = 20, 8


def _ssm_inputs(seed, B, S, d, N):
    r = np.random.default_rng(seed)
    f = np.float32
    return dict(
        x=r.standard_normal((B, S, d)).astype(f),
        dt=np.log1p(np.exp(r.standard_normal((B, S, d)) - 1)).astype(f),
        A=-np.exp(r.standard_normal((d, N)) * 0.5).astype(f),
        Bm=r.standard_normal((B, S, N)).astype(f),
        Cm=r.standard_normal((B, S, N)).astype(f),
        D=r.standard_normal(d).astype(f),
        h0=r.standard_normal((B, d, N)).astype(f))


@pytest.mark.parametrize("S,chunk", [(21, 8), (150, 8), (150, 128)])
def test_ssm_chunkwise(S, chunk):
    a = _ssm_inputs(0, 2, S, 6, 4)
    y, h = thymba.ssm_chunkwise(**{k: torch.from_numpy(v)
                                   for k, v in a.items()}, chunk=chunk)
    jy, jh = jhymba.ssm_chunkwise(**{k: jnp.asarray(v)
                                     for k, v in a.items()}, chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **F32_TOL)


def test_ssm_step():
    a = _ssm_inputs(1, 3, 1, 6, 4)
    args = dict(x=a["x"][:, 0], dt=a["dt"][:, 0], A=a["A"],
                Bm=a["Bm"][:, 0], Cm=a["Cm"][:, 0], D=a["D"], h=a["h0"])
    y, h = thymba.ssm_step(**{k: torch.from_numpy(v)
                              for k, v in args.items()})
    jy, jh = jhymba.ssm_step(**{k: jnp.asarray(v) for k, v in args.items()})
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **F32_TOL)


@pytest.fixture(scope="module")
def runs():
    jcfg = jax_smoke_config("hymba-1.5b")
    tcfg = get_smoke_config("hymba-1.5b")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert PROMPT > tcfg.attn_window
    jparams = jhymba.init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tparams = params_from_jax(tree, "cpu")
    toks = np.random.default_rng(0).integers(
        3, tcfg.vocab, (2, PROMPT)).astype(np.int32)
    out = {"tree": tree, "cfg": tcfg}
    with torch.inference_mode():
        fwd = thymba.forward(tparams, tcfg, torch.from_numpy(toks).long())
        last, cache = thymba.prefill(tparams, tcfg, torch.from_numpy(toks),
                                     max_len=PROMPT + STEPS)
        pre = {k: v.clone().numpy() for k, v in cache.items()}
        logits, fed = [last.numpy()], []
        for t in range(STEPS):
            tok = np.argmax(logits[-1][:, :tcfg.vocab], -1).astype(np.int32)
            fed.append(tok)
            lg, cache = thymba.decode_step(
                tparams, tcfg, cache, torch.from_numpy(tok),
                torch.full((2,), PROMPT + t, dtype=torch.int32))
            logits.append(lg.numpy())
    out["port"] = (fwd.numpy(), pre, np.stack(logits), np.stack(fed))
    jfwd = jhymba.forward(jparams, jcfg, jnp.asarray(toks))
    jlast, jcache = jhymba.prefill(jparams, jcfg, jnp.asarray(toks),
                                   max_len=PROMPT + STEPS)
    jpre = {k: np.asarray(v) for k, v in jcache.items()}
    step = jax.jit(lambda p, c, t, pos: jhymba.decode_step(p, jcfg, c, t,
                                                           pos))
    logits, fed = [np.asarray(jlast)], []
    for t in range(STEPS):
        tok = np.argmax(logits[-1][:, :jcfg.vocab], -1).astype(np.int32)
        fed.append(tok)
        lg, jcache = step(jparams, jcache, jnp.asarray(tok),
                          jnp.full((2,), PROMPT + t, jnp.int32))
        logits.append(np.asarray(lg))
    out["jax"] = (np.asarray(jfwd), jpre, np.stack(logits), np.stack(fed))
    return out


def test_init_builds_the_reference_tree(runs):
    own = thymba.init(0, runs["cfg"], "cpu").tree()
    assert (jax.tree_util.tree_map(np.shape, runs["tree"])
            == jax.tree_util.tree_map(lambda t: tuple(t.shape), own))
    np.testing.assert_array_equal(own["layers"]["A_log"].numpy(),
                                  runs["tree"]["layers"]["A_log"])


def test_forward_logits(runs):
    np.testing.assert_allclose(runs["port"][0], runs["jax"][0], **LOGIT_TOL)


def test_prefill_cache_past_the_window(runs):
    got, want = runs["port"][1], runs["jax"][1]
    assert set(got) == set(want) == {"k", "v", "k_pos", "ssm"}
    np.testing.assert_array_equal(got["k_pos"], want["k_pos"])
    assert got["k_pos"].min() == PROMPT - runs["cfg"].attn_window
    for name in ("k", "v", "ssm"):
        assert got[name].shape == want[name].shape
        np.testing.assert_allclose(got[name], want[name], **F32_TOL)


def test_greedy_decode_past_the_window(runs):
    np.testing.assert_array_equal(runs["port"][3], runs["jax"][3])
    np.testing.assert_allclose(runs["port"][2], runs["jax"][2], **LOGIT_TOL)
