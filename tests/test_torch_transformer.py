"""Parity of ``repro_torch.models.transformer`` with the JAX transformer.

Parameters come from the JAX init and are carried over by
``params_from_jax``; the port runs on the CPU (plain attention).  The JAX
side runs with ``use_pallas=False`` and with ``use_pallas=True`` (the
Pallas kernels in interpret mode).  Logits agree to 1e-4 and 32 greedy
decode tokens are identical, on the smoke qwen-distill-1.5b config and on
a dense config with an 8-token sliding window (the SWA ring cache).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import transformer as jt
from repro.models.api import ModelConfig as JaxModelConfig
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke_config
from repro_torch.models import transformer as tt
from repro_torch.models.api import ModelConfig

ATOL = 1e-4
PROMPT = 12                    # > the SWA window: exercises the ring placement
STEPS = 32

SWA = dict(name="dense-swa8", family="dense", n_layers=2, d_model=32,
           n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64, vocab=128,
           attn_window=8, qkv_bias=True, dtype="float32", remat=False)


def _configs(name):
    if name == "swa8":
        return JaxModelConfig(**SWA), ModelConfig(**SWA)
    jcfg = jax_smoke_config(name)
    tcfg = get_smoke_config(name)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    return jcfg, tcfg


@pytest.fixture(scope="module", params=["qwen-distill-1.5b", "swa8"])
def case(request):
    jcfg, tcfg = _configs(request.param)
    jparams = jt.init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tparams = params_from_jax(tree, "cpu")
    # the port's own init has the reference's names and shapes
    own = tt.init(0, tcfg, "cpu").tree()
    assert (jax.tree_util.tree_map(np.shape, tree)
            == jax.tree_util.tree_map(lambda t: tuple(t.shape), own))
    tokens = np.random.default_rng(0).integers(
        3, tcfg.vocab, size=(2, PROMPT)).astype(np.int32)
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                tokens=tokens, memo={})


def _greedy(logits, vocab):
    return np.argmax(np.asarray(logits, np.float32)[:, :vocab], axis=-1)


def _port_run(case):
    """Port side, computed once per config: forward, prefill, decode."""
    if "port" not in case["memo"]:
        cfg, params = case["tcfg"], case["tparams"]
        toks = torch.from_numpy(case["tokens"]).long()
        with torch.inference_mode():
            fwd = tt.forward(params, cfg, toks).numpy()
            last, cache = tt.prefill(params, cfg, toks,
                                     max_len=PROMPT + STEPS)
            pre = {k: v.clone().numpy() for k, v in cache.items()}
            logits, out = [last.numpy()], []
            tok = torch.from_numpy(_greedy(last, cfg.vocab)).int()
            for t in range(STEPS):
                out.append(tok.numpy())
                pos = torch.full((2,), PROMPT + t, dtype=torch.int32)
                lg, cache = tt.decode_step(params, cfg, cache, tok, pos)
                logits.append(lg.numpy())
                tok = torch.from_numpy(_greedy(lg, cfg.vocab)).int()
        case["memo"]["port"] = (fwd, pre, np.stack(logits), np.stack(out))
    return case["memo"]["port"]


def _jax_run(case, use_pallas):
    key = ("jax", use_pallas)
    if key not in case["memo"]:
        cfg = case["jcfg"].replace(use_pallas=use_pallas)
        params, toks = case["jparams"], jnp.asarray(case["tokens"])
        fwd = np.asarray(jt.forward(params, cfg, toks))
        last, cache = jt.prefill(params, cfg, toks, max_len=PROMPT + STEPS)
        pre = {k: np.asarray(v) for k, v in cache.items()}
        step = jax.jit(lambda p, c, t, pos: jt.decode_step(p, cfg, c, t, pos))
        logits, out = [np.asarray(last)], []
        tok = jnp.asarray(_greedy(last, cfg.vocab), jnp.int32)
        for t in range(STEPS):
            out.append(np.asarray(tok))
            lg, cache = step(params, cache, tok,
                             jnp.full((2,), PROMPT + t, jnp.int32))
            logits.append(np.asarray(lg))
            tok = jnp.asarray(_greedy(lg, cfg.vocab), jnp.int32)
        case["memo"][key] = (fwd, pre, np.stack(logits), np.stack(out))
    return case["memo"][key]


@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_logits(case, use_pallas):
    got, want = _port_run(case)[0], _jax_run(case, use_pallas)[0]
    assert got.shape == (2, PROMPT, case["tcfg"].padded_vocab)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_logits_and_cache(case, use_pallas):
    _, got, got_logits, _ = _port_run(case)
    _, want, want_logits, _ = _jax_run(case, use_pallas)
    np.testing.assert_allclose(got_logits[0], want_logits[0], atol=ATOL,
                               rtol=0)
    np.testing.assert_array_equal(got["k_pos"], want["k_pos"])
    for name in ("k", "v"):
        assert got[name].shape == want[name].shape
        np.testing.assert_allclose(got[name], want[name], atol=ATOL, rtol=0)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_greedy_decode_32_tokens(case, use_pallas):
    _, _, got_logits, got_tokens = _port_run(case)
    _, _, want_logits, want_tokens = _jax_run(case, use_pallas)
    np.testing.assert_array_equal(got_tokens, want_tokens)
    np.testing.assert_allclose(got_logits, want_logits, atol=ATOL, rtol=0)
