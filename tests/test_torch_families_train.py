"""The GRPO train step of every newly ported family against the
reference's ``make_train_step``, on the CPU at smoke size.

Both sides take one step from the same params (the JAX init carried over
by ``params_from_jax``) and batch.  Each side's gradients are caught at
its ``adamw_update`` call inside its own ``make_train_step`` (the JAX one
under ``jit``), so the loss, the metrics, ``grad_norm`` and every leaf's
gradient are the train steps' own; all agree at 2e-5 (the reference's
float32 tolerance).  whisper's batch carries ``frames`` and internvl2's
``patches``: the step must pass them to the forward (whisper's forward
asserts them; without the patches internvl2's loss would differ), also
through the sequence-chunked loss.  Tied embeddings (qwen2.5-3b,
whisper) and QKV biases get their gradients like any leaf; MoE gets the
router's and every expert's.
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
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke_config
from repro_torch.optim import adamw as tadamw
from repro_torch.rl import grpo as tgrpo

TOL = dict(atol=2e-5, rtol=2e-5)
ARCHS = ["qwen2.5-3b", "h2o-danube-1.8b", "starcoder2-15b", "yi-34b",
         "internvl2-2b", "qwen3-moe-235b-a22b", "grok-1-314b", "hymba-1.5b",
         "whisper-small"]
# (arch, config overrides): every new family, and internvl2's patches
# through the sequence-chunked loss (two chunks of 10)
CASES = {arch: (arch, {}) for arch in ARCHS}
CASES["internvl2-2b-chunked-loss"] = ("internvl2-2b", {"loss_chunk": 10})


def _batch(cfg, seed, B=2, S=20):
    r = np.random.default_rng(seed)
    mask = np.zeros((B, S), np.float32)
    for i in range(B):
        mask[i, 5 + i:S - i] = 1.0
    batch = dict(
        tokens=r.integers(3, cfg.vocab, (B, S)).astype(np.int32),
        loss_mask=mask,
        behavior_logp=(-r.random((B, S)) * 3 * mask).astype(np.float32),
        advantages=r.standard_normal(B).astype(np.float32))
    if cfg.family == "encdec":
        batch["frames"] = r.standard_normal(
            (B, cfg.encoder_seq, cfg.enc_dim)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patches"] = r.standard_normal(
            (B, cfg.encoder_seq, cfg.enc_dim)).astype(np.float32)
    return batch


def _spy(update, caught):
    """``adamw_update`` that also hands over the gradients it was given."""
    def spy(grads, *a, **kw):
        caught.append(grads)
        return update(grads, *a, **kw)
    return spy


def _jax_step(jcfg, jparams, batch, opt, monkeypatch):
    caught = []

    def update(grads, state, params, cfg):
        new_params, new_state, m = jadamw.adamw_update(grads, state, params,
                                                       cfg)
        return new_params, new_state, dict(m, grads=grads)

    monkeypatch.setattr(jgrpo, "adamw_update", _spy(update, caught))
    step = jax.jit(jgrpo.make_train_step(jcfg, opt))
    _, _, m = step(jparams, jadamw.adamw_init(jparams),
                   {k: jnp.asarray(v) for k, v in batch.items()})
    grads = m.pop("grads")
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    return m, {".".join(p.key for p in path): np.asarray(g)
               for path, g in flat}


def _port_step(tcfg, tree, batch, opt, monkeypatch):
    caught = []
    monkeypatch.setattr(tgrpo, "adamw_update",
                        _spy(tadamw.adamw_update, caught))
    params = params_from_jax(tree, "cpu")
    params.requires_grad_(True)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbatch["tokens"] = tbatch["tokens"].long()
    _, _, m = tgrpo.make_train_step(tcfg, opt)(
        params, tadamw.adamw_init(params), tbatch)
    names = [n for n, _ in tadamw.named_leaves(params)]
    return m, dict(zip(names, (g.numpy() for g in caught[0])))


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_loss_metrics_and_gradients(case, monkeypatch):
    arch, extra = CASES[case]
    jcfg = jax_smoke_config(arch).replace(**extra)
    tcfg = get_smoke_config(arch).replace(**extra)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jparams = jax_get_model(jcfg).init(jax.random.PRNGKey(4), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    batch = _batch(tcfg, 5)
    jm, jgrads = _jax_step(jcfg, jparams, batch,
                           jadamw.AdamWConfig(lr=1e-3), monkeypatch)
    tm, tgrads = _port_step(tcfg, tree, batch, tadamw.AdamWConfig(lr=1e-3),
                            monkeypatch)
    assert set(tm) == set(jm) == {"loss", "mean_ratio", "clip_frac",
                                  "entropy_proxy", "grad_norm"}
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL,
                                   err_msg=k)
    assert float(jm["grad_norm"]) > 0
    assert set(tgrads) == set(jgrads)
    for name, want in jgrads.items():
        np.testing.assert_allclose(tgrads[name], want, **TOL, err_msg=name)
