"""Parity of the port's GRPO update (``rl/grpo.py``) and AdamW
(``optim/adamw.py``) with the JAX package, on the CPU.

Inputs come from a numpy seed and go to both sides.  AdamW runs three
steps on a mixed tree (bfloat16 matrices, float32 vectors and a stacked
``[L, d]`` leaf, which the reference decays too); ``grpo_loss`` is held
with and without the decoupled proximal weight and the k3 KL term, and so
is its gradient; one ``make_train_step`` from the same params and batch
gives the same loss, metrics, ``grad_norm`` and new params for the dense
and the xLSTM smoke configs (the reference step trains with
``use_pallas=False``), the decoupled objective and the sequence-chunked
loss.  Tolerances are ``tests/test_kernels.py::_tol``: 2e-5 in float32,
5e-2 in bfloat16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.api import get_model as jax_get_model
from repro.optim import adamw as jadamw
from repro.rl import grpo as jgrpo
from repro_torch.bridge import params_from_jax, to_tensor
from repro_torch.configs import get_smoke_config
from repro_torch.optim import adamw as tadamw
from repro_torch.rl import grpo as tgrpo

TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=5e-2, rtol=5e-2)}


def _np(x):
    return np.asarray(x, np.float32)


def _close(got, want, dtype="float32"):
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


# ------------------------------------------------------------------ AdamW
def _mixed_tree(rng):
    return {
        "w": rng.standard_normal((6, 5)).astype(np.float32),
        "b": rng.standard_normal((5,)).astype(np.float32),
        "layers": {"norm": rng.standard_normal((3, 5)).astype(np.float32),
                   "wq": rng.standard_normal((3, 5, 4)).astype(np.float32)},
    }


def test_adamw_three_steps_on_a_mixed_tree():
    rng = np.random.default_rng(0)
    tree = _mixed_tree(rng)
    bf16 = {"w", "wq"}
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.asarray(x, jnp.bfloat16 if path[-1].key in bf16
                                    else jnp.float32), tree)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    cfg = dict(lr=1e-2, weight_decay=0.1, grad_clip=0.5)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), tadamw.AdamWConfig(**cfg)
    jstate, tstate = jadamw.adamw_init(jparams), tadamw.adamw_init(tparams)
    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32), tree)
        jparams, jstate, jm = jadamw.adamw_update(grads, jstate, jparams,
                                                  jcfg)
        by_name = dict(tadamw.named_leaves(
            jax.tree_util.tree_map(to_tensor, grads)))
        tm = tadamw.adamw_update(
            [by_name[n] for n, _ in tadamw.named_leaves(tparams)], tstate,
            tparams, tcfg)
        _close(tm["grad_norm"], jm["grad_norm"])
        assert tstate["count"] == int(jstate["count"]) == step + 1
        for name, p in tparams.named_parameters():
            path = name.split(".")
            want = jparams
            for k in path:
                want = want[k]
            assert str(p.dtype).endswith(str(want.dtype))
            _close(p.float(), want, "bfloat16" if path[-1] in bf16
                   else "float32")
            for mom in ("m", "v"):
                ref = jstate[mom]
                for k in path:
                    ref = ref[k]
                assert tstate[mom][name].dtype == torch.float32
                _close(tstate[mom][name], ref)


def test_schedules():
    for total, warmup in [(20, 5), (7, 0), (3, 10)]:
        for s in range(total + 3):
            step = jnp.asarray(s)
            np.testing.assert_allclose(
                tadamw.cosine_schedule(s, warmup=warmup, total=total),
                float(jadamw.cosine_schedule(step, warmup=warmup,
                                             total=total)),
                atol=1e-6)
            np.testing.assert_allclose(
                tadamw.linear_schedule(s, warmup=warmup, total=total),
                float(jadamw.linear_schedule(step, warmup=warmup,
                                             total=total)),
                atol=1e-6)


# ------------------------------------------------------------- GRPO loss
def _loss_inputs(seed, B=4, S=9, V=13):
    r = np.random.default_rng(seed)
    mask = np.zeros((B, S), np.float32)
    mask[:, 3:] = 1.0
    mask[1, 7:] = 0.0
    return dict(
        logits=r.standard_normal((B, S, V)).astype(np.float32),
        tokens=r.integers(0, V, (B, S)).astype(np.int32),
        behavior_logp=-r.random((B, S)).astype(np.float32) * 3,
        advantages=r.standard_normal(B).astype(np.float32),
        loss_mask=mask,
        prox_logp=-r.random((B, S)).astype(np.float32) * 3,
        ref_logp=-r.random((B, S)).astype(np.float32) * 3)


@pytest.mark.parametrize("decoupled,kl", [(False, 0.0), (True, 0.0),
                                          (False, 0.1), (True, 0.1)])
def test_grpo_loss_and_its_gradient(decoupled, kl):
    x = _loss_inputs(1)
    pos = ("logits", "tokens", "behavior_logp", "advantages", "loss_mask")

    def kw(d):
        return dict(clip_eps=0.2, kl_coef=kl, ref_logp=d["ref_logp"],
                    prox_logp=d["prox_logp"] if decoupled else None)

    j = {k: jnp.asarray(v) for k, v in x.items()}
    (jl, jm), jg = jax.value_and_grad(
        lambda lg: jgrpo.grpo_loss(lg, *(j[k] for k in pos[1:]), **kw(j)),
        has_aux=True)(j["logits"])
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    logits = t["logits"].requires_grad_()
    tl, tm = tgrpo.grpo_loss(logits, *(t[k] for k in pos[1:]), **kw(t))
    tl.backward()
    _close(tl.detach(), jl)
    assert set(tm) == set(jm)
    for k in jm:
        _close(tm[k], jm[k])
    _close(logits.grad, jg)


def test_group_advantages_and_token_logp():
    r = np.random.default_rng(2)
    rewards = r.random(12)
    groups = np.repeat(np.arange(3), 4)
    np.testing.assert_allclose(tgrpo.group_advantages(rewards, groups),
                               jgrpo.group_advantages(rewards, groups),
                               atol=1e-6)
    x = _loss_inputs(3)
    _close(tgrpo.token_logp_from_logits(torch.from_numpy(x["logits"]),
                                        torch.from_numpy(x["tokens"])),
           jgrpo.token_logp_from_logits(jnp.asarray(x["logits"]),
                                        jnp.asarray(x["tokens"])))


# ------------------------------------------------------------- train step
def _batch(cfg, seed, B=4, S=24):
    r = np.random.default_rng(seed)
    mask = np.zeros((B, S), np.float32)
    for i in range(B):
        mask[i, 6 + i:S - i] = 1.0
    return dict(
        tokens=r.integers(3, cfg.vocab, (B, S)).astype(np.int32),
        loss_mask=mask,
        behavior_logp=(-r.random((B, S)) * 3 * mask).astype(np.float32),
        advantages=r.standard_normal(B).astype(np.float32),
        prox_logp=(-r.random((B, S)) * 3 * mask).astype(np.float32))


CASES = {
    "dense": ("qwen-distill-1.5b", {}, False),
    "xlstm": ("xlstm-1.3b", {}, False),
    "dense-decoupled": ("qwen-distill-1.5b", {}, True),
    "dense-chunked-loss": ("qwen-distill-1.5b", {"loss_chunk": 8}, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(case):
    arch, extra, decoupled = CASES[case]
    jcfg = jax_smoke_config(arch).replace(**extra)
    tcfg = get_smoke_config(arch).replace(**extra)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    opt = dict(lr=1e-3)
    jparams = jax_get_model(jcfg).init(jax.random.PRNGKey(4), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    tparams.requires_grad_(True)
    batch = _batch(tcfg, 5)
    jstep = jax.jit(jgrpo.make_train_step(jcfg, jadamw.AdamWConfig(**opt),
                                          decoupled=decoupled))
    jnew, jstate, jm = jstep(jparams, jadamw.adamw_init(jparams),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    tstep = tgrpo.make_train_step(tcfg, tadamw.AdamWConfig(**opt),
                                  decoupled=decoupled)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbatch["tokens"] = tbatch["tokens"].long()
    tstate = tadamw.adamw_init(tparams)
    tnew, tstate, tm = tstep(tparams, tstate, tbatch)
    assert tnew is tparams and tstate["count"] == 1
    assert set(tm) == set(jm) == {"loss", "mean_ratio", "clip_frac",
                                  "entropy_proxy", "grad_norm"}
    assert float(jm["grad_norm"]) > 0
    for k in jm:
        _close(tm[k], jm[k])
    flat = dict(jax.tree_util.tree_flatten_with_path(jnew)[0])
    for path, want in flat.items():
        name = ".".join(p.key for p in path)
        _close(dict(tparams.named_parameters())[name].detach(), want)


@pytest.mark.parametrize("arch", ["qwen-distill-1.5b", "xlstm-1.3b"])
def test_train_step_after_a_frozen_forward(arch):
    """A forward while frozen must not leave grad-less layer views behind:
    after ``requires_grad_(True)`` the step equals that of params that
    never ran frozen (every layer leaf gets its gradient)."""
    from repro_torch.models.api import get_model
    cfg = get_smoke_config(arch)
    model = get_model(cfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 6).items()}
    batch["tokens"] = batch["tokens"].long()
    out = []
    for frozen_first in (False, True):
        params = model.init(7, cfg, device="cpu")
        if frozen_first:
            model.forward(params, cfg, batch["tokens"])
        params.requires_grad_(True)
        step = tgrpo.make_train_step(cfg, tadamw.AdamWConfig(lr=1e-3))
        _, _, m = step(params, tadamw.adamw_init(params), batch)
        out.append((m, dict(params.named_parameters())))
    (m0, p0), (m1, p1) = out
    assert float(m0["grad_norm"]) > 0
    assert float(m1["grad_norm"]) == float(m0["grad_norm"])
    for name in p0:
        torch.testing.assert_close(p1[name], p0[name], rtol=0, atol=0)
