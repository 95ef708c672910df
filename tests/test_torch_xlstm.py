"""Parity of ``repro_torch.models.xlstm`` with the JAX xLSTM.

Parameters come from the JAX init (smoke xlstm-1.3b config) and are
carried over by ``params_from_jax``; the port runs on the CPU, where
``mlstm_scan`` takes its plain chunkwise version.  The JAX side runs with
``use_pallas=False`` (``mlstm_chunkwise``) and ``use_pallas=True`` (the
Pallas scan in interpret mode).  The prompt is 70 tokens, so the scan
carries state across two chunks of 64 and pads the second.  Logits and
the prefill's (C, n, m) agree to 1e-4 and 32 greedy decode tokens are
identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import xlstm as jx
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import xlstm as tx
from repro_torch.models.api import get_model

ATOL = 1e-4
PROMPT = 70
STEPS = 32
ARCH = "xlstm-1.3b"


@pytest.fixture(scope="module")
def case():
    jcfg, tcfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jparams = jx.init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tparams = params_from_jax(tree, "cpu")
    # the port's own init has the reference's names, shapes and dtypes
    # (w_if / b_if stay float32 in a bfloat16 model)
    bf = tcfg.replace(dtype="bfloat16")
    own = tx.init(0, bf, "cpu").tree()
    jown = jax.tree_util.tree_map(
        np.asarray, jx.init(jax.random.PRNGKey(0), jcfg.replace(
            dtype="bfloat16")))
    assert (jax.tree_util.tree_map(lambda a: (a.shape, a.dtype.name), jown)
            == jax.tree_util.tree_map(
                lambda t: (tuple(t.shape), str(t.dtype).split(".")[1]), own))
    tokens = np.random.default_rng(0).integers(
        3, tcfg.vocab, size=(2, PROMPT)).astype(np.int32)
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                tokens=tokens, memo={})


def _greedy(logits, vocab):
    return np.argmax(np.asarray(logits, np.float32)[:, :vocab], axis=-1)


def _port_run(case):
    if "port" not in case["memo"]:
        cfg, params = case["tcfg"], case["tparams"]
        toks = torch.from_numpy(case["tokens"]).long()
        with torch.inference_mode():
            fwd = tx.forward(params, cfg, toks).numpy()
            last, cache = tx.prefill(params, cfg, toks,
                                     max_len=PROMPT + STEPS)
            pre = {k: v.clone().numpy() for k, v in cache.items()}
            logits, out = [last.numpy()], []
            tok = torch.from_numpy(_greedy(last, cfg.vocab)).int()
            for t in range(STEPS):
                out.append(tok.numpy())
                pos = torch.full((2,), PROMPT + t, dtype=torch.int32)
                lg, cache = tx.decode_step(params, cfg, cache, tok, pos)
                logits.append(lg.numpy())
                tok = torch.from_numpy(_greedy(lg, cfg.vocab)).int()
        case["memo"]["port"] = (fwd, pre, np.stack(logits), np.stack(out))
    return case["memo"]["port"]


def _jax_run(case, use_pallas):
    key = ("jax", use_pallas)
    if key not in case["memo"]:
        cfg = case["jcfg"].replace(use_pallas=use_pallas)
        params, toks = case["jparams"], jnp.asarray(case["tokens"])
        fwd = np.asarray(jx.forward(params, cfg, toks))
        if use_pallas:      # prefill and decode do not reach the kernel
            case["memo"][key] = (fwd,) + _jax_run(case, False)[1:]
            return case["memo"][key]
        last, cache = jx.prefill(params, cfg, toks, max_len=PROMPT + STEPS)
        pre = {k: np.asarray(v) for k, v in cache.items()}
        step = jax.jit(lambda p, c, t, pos: jx.decode_step(p, cfg, c, t, pos))
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


def test_registry_and_dispatch():
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.hd, cfg.vocab,
            cfg.tie_embeddings) == (48, 2048, 4, 512, 50304, False)
    assert get_model(cfg) is tx


@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_logits(case, use_pallas):
    got, want = _port_run(case)[0], _jax_run(case, use_pallas)[0]
    assert got.shape == (2, PROMPT, case["tcfg"].padded_vocab)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_prefill_logits_and_state(case):
    _, got, got_logits, _ = _port_run(case)
    _, want, want_logits, _ = _jax_run(case, False)
    np.testing.assert_allclose(got_logits[0], want_logits[0], atol=ATOL,
                               rtol=0)
    for name in ("C", "n", "m"):
        assert got[name].shape == want[name].shape
        np.testing.assert_allclose(got[name], want[name], atol=ATOL,
                                   rtol=ATOL)


def test_greedy_decode_32_tokens(case):
    _, _, got_logits, got_tokens = _port_run(case)
    _, _, want_logits, want_tokens = _jax_run(case, False)
    np.testing.assert_array_equal(got_tokens, want_tokens)
    np.testing.assert_allclose(got_logits, want_logits, atol=ATOL, rtol=0)


def test_remat_gives_the_same_gradient(case):
    """``cfg.remat`` recomputes each layer in the backward: same loss and
    gradients as without it."""
    toks = torch.from_numpy(case["tokens"]).long()
    grads = []
    for remat in (False, True):
        params = params_from_jax(case["tparams"].tree(), "cpu")
        params.requires_grad_(True)
        cfg = case["tcfg"].replace(remat=remat)
        loss = tx.forward(params, cfg, toks).square().mean()
        grads.append(torch.autograd.grad(loss, list(params.parameters())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
