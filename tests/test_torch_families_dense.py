"""Parity of the port's dense configs and VLM stub with the JAX package, on
the CPU.

Every config of the registry (the ten assigned architectures and the
paper's three) equals the reference's field for field, published and
smoke.  ``layer_norm`` and ``gelu_mlp`` hold to the reference's blocks at
2e-5.  qwen2.5-3b (QKV bias, tied embeddings), h2o-danube-1.8b (SWA 16 at
smoke size: a 20-token prompt fills the ring past its window and the
decode steps wrap it), starcoder2-15b (GELU MLP), yi-34b and internvl2-2b
(with patches) run forward, prefill and greedy decode from the JAX
params carried over by ``params_from_jax``: logits within 2e-3 (the
reference's model tolerance, ``tests/test_models.py``), caches within
2e-5 and the greedy tokens identical; the port's own ``init`` builds the
reference's tree.  A ``RolloutEngine`` greedy run of qwen2.5-3b matches
the reference's engine token for token.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import blocks as jblocks
from repro.models.api import get_model as jax_get_model
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.models import blocks as tblocks
from repro_torch.models.api import get_model

LOGIT_TOL = dict(atol=2e-3, rtol=2e-3)
F32_TOL = dict(atol=2e-5, rtol=2e-5)
PROMPT, STEPS = 20, 8
ARCHS = ["qwen2.5-3b", "h2o-danube-1.8b", "starcoder2-15b", "yi-34b",
         "internvl2-2b"]


# ------------------------------------------------------------------ configs
def test_registry_matches_the_reference():
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert tconfigs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    assert tconfigs.PAPER_ARCHS == jconfigs.PAPER_ARCHS
    assert len(tconfigs.list_archs()) == 13


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_config_field_for_field(arch):
    for tget, jget in ((tconfigs.get_config, jconfigs.get_config),
                       (tconfigs.get_smoke_config, jconfigs.get_smoke_config)):
        t, j = tget(arch), jget(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.hd, t.padded_vocab, t.enc_dim, t.sub_quadratic) == (
            j.hd, j.padded_vocab, j.enc_dim, j.sub_quadratic)
        assert dataclasses.asdict(t.spec) == dataclasses.asdict(j.spec)


# ------------------------------------------------------------------- blocks
def test_layer_norm():
    r = np.random.default_rng(0)
    x = (r.standard_normal((3, 5, 24)) * 3 + 1).astype(np.float32)
    scale = r.standard_normal(24).astype(np.float32)
    bias = r.standard_normal(24).astype(np.float32)
    got = tblocks.layer_norm(*map(torch.from_numpy, (x, scale, bias)))
    want = jblocks.layer_norm(*map(jnp.asarray, (x, scale, bias)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_gelu_mlp_is_the_tanh_form():
    r = np.random.default_rng(1)
    x = r.standard_normal((2, 7, 16)).astype(np.float32)
    p = {"w_up": r.standard_normal((16, 40)).astype(np.float32) * 0.5,
         "b_up": r.standard_normal(40).astype(np.float32),
         "w_down": r.standard_normal((40, 16)).astype(np.float32) * 0.2,
         "b_down": r.standard_normal(16).astype(np.float32)}
    got = tblocks.gelu_mlp(torch.from_numpy(x),
                           {k: torch.from_numpy(v) for k, v in p.items()})
    want = jblocks.gelu_mlp(jnp.asarray(x),
                            {k: jnp.asarray(v) for k, v in p.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


# ------------------------------------------------------------------- models
def _greedy(logits, vocab):
    return np.argmax(np.asarray(logits, np.float32)[:, :vocab], axis=-1)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    arch = request.param
    jcfg, tcfg = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(
        arch)
    jparams = jax_get_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    r = np.random.default_rng(0)
    extra = {}
    if tcfg.family == "vlm":
        extra["patches"] = r.standard_normal(
            (2, tcfg.encoder_seq, tcfg.enc_dim)).astype(np.float32)
    return dict(arch=arch, jcfg=jcfg, tcfg=tcfg, jparams=jparams, tree=tree,
                tparams=params_from_jax(tree, "cpu"), extra=extra,
                tokens=r.integers(3, tcfg.vocab, (2, PROMPT)).astype(
                    np.int32), memo={})


def _run(case, side):
    """forward logits, prefill cache, (prefill + decode) logits and the
    greedy tokens fed back, computed once per side."""
    if side in case["memo"]:
        return case["memo"][side]
    cfg = case["tcfg"] if side == "port" else case["jcfg"]
    vocab = cfg.vocab
    if side == "port":
        mod, params = get_model(cfg), case["tparams"]
        toks = torch.from_numpy(case["tokens"]).long()
        extra = {k: torch.from_numpy(v) for k, v in case["extra"].items()}
        with torch.inference_mode():
            fwd = mod.forward(params, cfg, toks, **extra).numpy()
            last, cache = mod.prefill(params, cfg, toks,
                                      max_len=PROMPT + STEPS, **extra)
            pre = {k: v.clone().numpy() for k, v in cache.items()}
            logits, out = [last.numpy()], []
            for t in range(STEPS):
                tok = _greedy(logits[-1], vocab)
                out.append(tok)
                lg, cache = mod.decode_step(
                    params, cfg, cache, torch.from_numpy(tok).int(),
                    torch.full((2,), PROMPT + t, dtype=torch.int32))
                logits.append(lg.numpy())
    else:
        mod, params = jax_get_model(cfg), case["jparams"]
        toks = jnp.asarray(case["tokens"])
        extra = {k: jnp.asarray(v) for k, v in case["extra"].items()}
        fwd = np.asarray(mod.forward(params, cfg, toks, **extra))
        last, cache = mod.prefill(params, cfg, toks, max_len=PROMPT + STEPS,
                                  **extra)
        pre = {k: np.asarray(v) for k, v in cache.items()}
        step = jax.jit(lambda p, c, t, pos: mod.decode_step(p, cfg, c, t,
                                                            pos))
        logits, out = [np.asarray(last)], []
        for t in range(STEPS):
            tok = _greedy(logits[-1], vocab)
            out.append(tok)
            lg, cache = step(params, cache, jnp.asarray(tok, jnp.int32),
                             jnp.full((2,), PROMPT + t, jnp.int32))
            logits.append(np.asarray(lg))
    case["memo"][side] = (fwd, pre, np.stack(logits), np.stack(out))
    return case["memo"][side]


def test_init_builds_the_reference_tree(case):
    own = get_model(case["tcfg"]).init(0, case["tcfg"], "cpu").tree()
    assert (jax.tree_util.tree_map(np.shape, case["tree"])
            == jax.tree_util.tree_map(lambda t: tuple(t.shape), own))
    assert (jax.tree_util.tree_map(lambda a: a.dtype.name, case["tree"])
            == jax.tree_util.tree_map(lambda t: str(t.dtype).split(".")[1],
                                      own))


def test_forward_logits(case):
    got, want = _run(case, "port")[0], _run(case, "jax")[0]
    assert got.shape == (2, PROMPT, case["tcfg"].padded_vocab)
    np.testing.assert_allclose(got, want, **LOGIT_TOL)


def test_prefill_cache(case):
    got, want = _run(case, "port")[1], _run(case, "jax")[1]
    assert set(got) == set(want) == {"k", "v", "k_pos"}
    np.testing.assert_array_equal(got["k_pos"], want["k_pos"])
    for name in ("k", "v"):
        assert got[name].shape == want[name].shape
        np.testing.assert_allclose(got[name], want[name], **F32_TOL)
    if case["tcfg"].attn_window is not None:
        # the prompt outran the window: the ring holds its last W positions
        assert PROMPT > case["tcfg"].attn_window
        assert got["k_pos"].min() == PROMPT - case["tcfg"].attn_window


def test_prefill_and_greedy_decode(case):
    _, _, got_logits, got_tokens = _run(case, "port")
    _, _, want_logits, want_tokens = _run(case, "jax")
    np.testing.assert_array_equal(got_tokens, want_tokens)
    np.testing.assert_allclose(got_logits, want_logits, **LOGIT_TOL)


def test_rollout_engine_greedy_matches_jax():
    from repro.data.tasks import MathTaskGenerator as JaxTasks
    from repro.rl.rollout import GenConfig as JaxGen
    from repro.rl.rollout import RolloutEngine as JaxEngine
    from repro.rl.weight_sync import WeightStore as JaxStore
    from repro_torch.data.tasks import MathTaskGenerator, Tokenizer
    from repro_torch.rl.rollout import GenConfig, RolloutEngine
    from repro_torch.rl.weight_sync import WeightStore

    kw = dict(vocab=Tokenizer().vocab_size)
    jcfg = jconfigs.get_smoke_config("qwen2.5-3b").replace(**kw)
    tcfg = tconfigs.get_smoke_config("qwen2.5-3b").replace(**kw)
    tree = jax.tree_util.tree_map(
        np.asarray, jax_get_model(jcfg).init(jax.random.PRNGKey(3), jcfg))
    gen = dict(max_new_tokens=12, segment=4, greedy=True)
    jstore, tstore = JaxStore(), WeightStore()
    jstore.publish(tree)
    tstore.publish(tree)
    jr, jm = JaxEngine(jcfg, jstore, JaxGen(**gen)).generate(
        JaxTasks(seed=1).batch(3))
    tr, tm = RolloutEngine(tcfg, tstore, GenConfig(**gen),
                           device="cpu").generate(
        MathTaskGenerator(seed=1).batch(3))
    assert [r.completion_ids for r in tr] == [r.completion_ids for r in jr]
    for a, b in zip(tr, jr):
        np.testing.assert_allclose(a.behavior_logp, b.behavior_logp,
                                   atol=1e-4, rtol=0)
    assert tm["decode_steps"] == jm["decode_steps"]


def test_the_new_modules_pull_in_no_jax():
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    code = ("import sys, repro_torch.models.moe, repro_torch.models.hymba, "
            "repro_torch.models.whisper, repro_torch.configs as c; "
            "[c.get_config(a) for a in c.list_archs()]; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]; print(bad); assert not bad")
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
