"""Parity of the port's whisper (``models/whisper.py``) with the JAX
package, on the CPU, at smoke size (2 + 2 layers, 20 frames).

``sinusoids`` agrees with the reference at 2e-5 at smoke size and, at
whisper-small's 1500 x 768, within the fp32 rounding of the reference's
own angles; ``encode`` agrees at 2e-5; the
training forward, ``prefill`` (self K/V and every layer's cross K/V in
the cache) and 3 greedy decode steps, all with frames, agree at 2e-3
with identical greedy tokens (the decode positions come from
``sinusoids(C, d)[pos]``).  Without frames both packages refuse alike:
``prefill`` raises ``AssertionError`` in each, and so does each
package's ``RolloutEngine``, which passes none.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import whisper as jwhisper
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke_config
from repro_torch.models import whisper as twhisper

F32_TOL = dict(atol=2e-5, rtol=2e-5)
LOGIT_TOL = dict(atol=2e-3, rtol=2e-3)
PROMPT, STEPS = 6, 3


@pytest.mark.parametrize("length,channels", [(20, 48), (1500, 768)])
def test_sinusoids(length, channels):
    """Within 2e-5, or within the fp32 rounding of the reference's angle
    at the last position (length * 2^-24, twice for the two sides'
    different exp), whichever is larger."""
    atol = max(F32_TOL["atol"], 2 * length * 2.0 ** -24)
    np.testing.assert_allclose(
        twhisper.sinusoids(length, channels).numpy(),
        np.asarray(jwhisper.sinusoids(length, channels)), atol=atol, rtol=0)


def test_sinusoid_rows_are_the_table_rows():
    """``decode_step`` computes only the rows it reads: bit for bit the
    table's rows, and past the table the last row, as the reference's
    gather clamps."""
    C, d = 40, 48
    pos = np.array([0, 7, 39, 45], dtype=np.int32)
    got = twhisper.sinusoid_rows(torch.clamp(torch.from_numpy(pos),
                                             max=C - 1), d)
    np.testing.assert_array_equal(
        got.numpy(), twhisper.sinusoids(C, d).numpy()[np.minimum(pos, C - 1)])
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jwhisper.sinusoids(C, d)[jnp.asarray(pos)]),
        **F32_TOL)


@pytest.fixture(scope="module")
def case():
    jcfg = jax_smoke_config("whisper-small")
    tcfg = get_smoke_config("whisper-small")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jparams = jwhisper.init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    r = np.random.default_rng(0)
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tree=tree,
                tparams=params_from_jax(tree, "cpu"),
                tokens=r.integers(3, tcfg.vocab, (2, PROMPT)).astype(
                    np.int32),
                frames=r.standard_normal(
                    (2, tcfg.encoder_seq, tcfg.enc_dim)).astype(np.float32))


def test_init_builds_the_reference_tree(case):
    own = twhisper.init(0, case["tcfg"], "cpu").tree()
    assert (jax.tree_util.tree_map(np.shape, case["tree"])
            == jax.tree_util.tree_map(lambda t: tuple(t.shape), own))


def test_encode(case):
    with torch.inference_mode():
        got = twhisper.encode(case["tparams"], case["tcfg"],
                              torch.from_numpy(case["frames"]))
    want = jwhisper.encode(case["jparams"], case["jcfg"],
                           jnp.asarray(case["frames"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_forward_prefill_decode(case):
    tcfg, jcfg = case["tcfg"], case["jcfg"]
    toks, frames = case["tokens"], case["frames"]
    max_len = PROMPT + STEPS
    with torch.inference_mode():
        tp, tt, tf = (case["tparams"], torch.from_numpy(toks),
                      torch.from_numpy(frames))
        fwd = twhisper.forward(tp, tcfg, tt.long(), frames=tf).numpy()
        last, cache = twhisper.prefill(tp, tcfg, tt, max_len=max_len,
                                       frames=tf)
        pre = {k: v.clone().numpy() for k, v in cache.items()}
        logits, fed = [last.numpy()], []
        for t in range(STEPS):
            tok = np.argmax(logits[-1][:, :tcfg.vocab], -1).astype(np.int32)
            fed.append(tok)
            lg, cache = twhisper.decode_step(
                tp, tcfg, cache, torch.from_numpy(tok),
                torch.full((2,), PROMPT + t, dtype=torch.int32))
            logits.append(lg.numpy())
    jp = case["jparams"]
    jfwd = np.asarray(jwhisper.forward(jp, jcfg, jnp.asarray(toks),
                                       frames=jnp.asarray(frames)))
    jlast, jcache = jwhisper.prefill(jp, jcfg, jnp.asarray(toks),
                                     max_len=max_len,
                                     frames=jnp.asarray(frames))
    jpre = {k: np.asarray(v) for k, v in jcache.items()}
    step = jax.jit(lambda p, c, t, pos: jwhisper.decode_step(p, jcfg, c, t,
                                                             pos))
    jlogits, jfed = [np.asarray(jlast)], []
    for t in range(STEPS):
        tok = np.argmax(jlogits[-1][:, :jcfg.vocab], -1).astype(np.int32)
        jfed.append(tok)
        lg, jcache = step(jp, jcache, jnp.asarray(tok),
                          jnp.full((2,), PROMPT + t, jnp.int32))
        jlogits.append(np.asarray(lg))
    np.testing.assert_allclose(fwd, jfwd, **LOGIT_TOL)
    assert set(pre) == set(jpre) == {"k", "v", "k_pos", "xk", "xv"}
    np.testing.assert_array_equal(pre["k_pos"], jpre["k_pos"])
    for name in ("k", "v", "xk", "xv"):
        np.testing.assert_allclose(pre[name], jpre[name], **F32_TOL)
    np.testing.assert_array_equal(np.stack(fed), np.stack(jfed))
    np.testing.assert_allclose(np.stack(logits), np.stack(jlogits),
                               **LOGIT_TOL)


def test_both_packages_refuse_to_prefill_without_frames(case):
    toks = case["tokens"]
    with pytest.raises(AssertionError):
        jwhisper.prefill(case["jparams"], case["jcfg"], jnp.asarray(toks),
                         max_len=PROMPT + STEPS)
    with pytest.raises(AssertionError):
        twhisper.prefill(case["tparams"], case["tcfg"],
                         torch.from_numpy(toks), max_len=PROMPT + STEPS)


def test_both_rollout_engines_refuse_whisper(case):
    from repro.data.tasks import MathTaskGenerator as JaxTasks
    from repro.rl.rollout import GenConfig as JaxGen
    from repro.rl.rollout import RolloutEngine as JaxEngine
    from repro.rl.weight_sync import WeightStore as JaxStore
    from repro_torch.data.tasks import MathTaskGenerator
    from repro_torch.rl.rollout import GenConfig, RolloutEngine
    from repro_torch.rl.weight_sync import WeightStore

    jstore, tstore = JaxStore(), WeightStore()
    jstore.publish(case["tree"])
    tstore.publish(case["tree"])
    with pytest.raises(AssertionError):
        JaxEngine(case["jcfg"], jstore, JaxGen(max_new_tokens=2)).generate(
            JaxTasks(seed=1).batch(2))
    with pytest.raises(AssertionError):
        RolloutEngine(case["tcfg"], tstore, GenConfig(max_new_tokens=2),
                      device="cpu").generate(MathTaskGenerator(seed=1).batch(2))


def test_non_causal_attention_leaves_out_the_padded_keys():
    """Non-causal attention over more keys than one ``kv_chunk`` (whisper's
    1500 frames in chunks of 1024, here 20 in chunks of 16): the port's
    plain path equals the reference's oracle ``attention_ref`` (and so the
    flash kernel).  The reference's chunked jnp path also attends its 12
    zero pad keys there, a divergence the port does not copy."""
    from repro.kernels.flash_attention.ref import attention_ref
    from repro.models import blocks as jblocks
    from repro_torch.models import blocks as tblocks

    r = np.random.default_rng(7)
    q = r.standard_normal((2, 5, 4, 8)).astype(np.float32)
    k = r.standard_normal((2, 20, 4, 8)).astype(np.float32)
    v = r.standard_normal((2, 20, 4, 8)).astype(np.float32)
    qp = np.broadcast_to(np.arange(5, dtype=np.int32), (2, 5))
    kp = np.broadcast_to(np.arange(20, dtype=np.int32), (2, 20))
    kw = dict(causal=False, q_chunk=4, kv_chunk=16)
    got = tblocks.attention(*map(torch.from_numpy, (q, k, v)),
                            q_positions=torch.from_numpy(qp.copy()),
                            k_positions=torch.from_numpy(kp.copy()), **kw)
    want = attention_ref(*map(jnp.asarray, (q, k, v)), q_positions=qp,
                         k_positions=kp, causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    padded = jblocks.attention(*map(jnp.asarray, (q, k, v)), q_positions=qp,
                               k_positions=kp, **kw)
    assert np.abs(np.asarray(padded) - np.asarray(want)).max() > 1e-2
