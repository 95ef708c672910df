"""The port's checkpoints (``repro_torch.ckpt``) and the train launcher's
crash/resume, on the CPU.

The port keeps the reference's on-disk format, so each package reads what
the other wrote: a JAX checkpoint of smoke params and AdamW state after
one JAX train step loads into a port trainer (whose CPU logits then match
JAX's at 2e-5), and the reference's ``restore_checkpoint`` reads the
port's checkpoint as equal arrays in the JAX pytree's layout.  Round
trips are exact, bfloat16 leaves included (widened to float32 on disk).
A ``--crash-after 2`` launcher run exits 17, its ``--resume`` reaches
``--steps``, and its step-2 checkpoint equals an uninterrupted run's bit
for bit.
"""
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.api import get_model as jax_get_model
from repro.optim import adamw as jadamw
from repro.rl import grpo as jgrpo
from repro_torch.ckpt.checkpoint import (CheckpointManager, latest_step,
                                         load_trainer_state,
                                         restore_checkpoint, save_checkpoint,
                                         trainer_state)
from repro_torch.configs import get_smoke_config
from repro_torch.models import transformer
from repro_torch.models.params import Params
from repro_torch.optim.adamw import adamw_init, named_leaves
from repro_torch.rl.async_trainer import AsyncGRPOTrainer, TrainerConfig

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen-distill-1.5b"
SETUP = dict(vocab=259, dtype="float32", remat=False)


def _batch(cfg, seed, B=4, S=24):
    r = np.random.default_rng(seed)
    mask = np.zeros((B, S), np.float32)
    mask[:, 6:] = 1.0
    return dict(
        tokens=r.integers(3, cfg.vocab, (B, S)).astype(np.int32),
        loss_mask=mask,
        behavior_logp=(-r.random((B, S)) * 3 * mask).astype(np.float32),
        advantages=r.standard_normal(B).astype(np.float32))


def _trainer():
    return AsyncGRPOTrainer(get_smoke_config(ARCH).replace(**SETUP),
                            TrainerConfig(group_size=2, prompts_per_step=1),
                            device="cpu")


def test_checkpoint_roundtrip_and_gc(tmp_path):
    state = {"params": {"w": torch.arange(12.0).reshape(3, 4)},
             "version": 7}
    for step in (1, 2, 3, 4):
        save_checkpoint(tmp_path, step, state, keep=2)
    assert latest_step(tmp_path) == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step-00000003", "step-00000004"]
    meta = json.loads((tmp_path / "step-00000004" / "META.json").read_text())
    assert meta == {"step": 4, "keys": ["params", "version"]}
    step, got = restore_checkpoint(tmp_path, device="cpu")
    assert step == 4 and int(got["version"]) == 7
    assert torch.equal(got["params"]["w"], torch.arange(12.0).reshape(3, 4))
    step, got = restore_checkpoint(tmp_path, step=3, device="cpu")
    assert step == 3 and got["params"]["w"].device.type == "cpu"


def test_checkpoint_atomicity_no_partial(tmp_path, monkeypatch):
    save_checkpoint(tmp_path, 5, {"x": np.ones(3)})
    # a crashed tmp dir does not count as a checkpoint, and is swept
    (tmp_path / "tmp-6-deadbeef").mkdir()
    assert latest_step(tmp_path) == 5
    CheckpointManager(tmp_path, every=1)
    assert not (tmp_path / "tmp-6-deadbeef").exists()

    # a save that fails mid-write leaves no step and no tmp directory
    def boom(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(pickle, "dump", boom)
    with pytest.raises(OSError, match="disk full"):
        save_checkpoint(tmp_path, 6, {"x": np.ones(3)})
    monkeypatch.undo()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step-00000005"]
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path / "none", device="cpu")
    mgr = CheckpointManager(tmp_path / "m", every=2)
    assert mgr.restore_latest(device="cpu") is None
    assert mgr.maybe_save(1, lambda: {"x": np.ones(1)}) is None
    assert mgr.maybe_save(2, lambda: {"x": np.ones(1)}).name == \
        "step-00000002"


def test_restore_places_on_the_gpu_unless_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None legitimately means cuda")
    save_checkpoint(tmp_path, 1, {"x": np.ones(3)})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        restore_checkpoint(tmp_path)


def test_bf16_leaf_survives_the_float32_widening(tmp_path):
    gen = torch.Generator().manual_seed(0)
    w = (torch.randn(5, 7, generator=gen) * 3).to(torch.bfloat16)
    params = Params({"w": w.clone(), "b": torch.randn(7, generator=gen)})
    opt = adamw_init(params)
    for name, _ in named_leaves(params):
        opt["m"][name].normal_(generator=gen)
        opt["v"][name].uniform_(generator=gen)
    opt["count"] = 3
    save_checkpoint(tmp_path, 1, trainer_state(params, opt, 4))
    with open(tmp_path / "step-00000001" / "state.pkl", "rb") as f:
        raw = pickle.load(f)
    assert raw["params"]["w"].dtype == np.float32       # widened on disk
    assert raw["opt_state"]["count"].dtype == np.int32
    _, state = restore_checkpoint(tmp_path, device="cpu")
    fresh = Params({"w": torch.zeros(5, 7, dtype=torch.bfloat16),
                    "b": torch.zeros(7)})
    fresh_opt = adamw_init(fresh)
    load_trainer_state(state, fresh, fresh_opt)
    assert fresh["w"].dtype == torch.bfloat16
    assert torch.equal(fresh["w"].view(torch.int16), w.view(torch.int16))
    assert torch.equal(fresh["b"], params["b"])
    for key in ("m", "v"):
        for name in opt[key]:
            assert torch.equal(fresh_opt[key][name], opt[key][name])
    assert fresh_opt["count"] == 3 and int(state["version"]) == 4


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    """JAX smoke params and AdamW state after one JAX train step, written
    by the reference; the port's trainer loads them and its forward
    matches JAX's."""
    jcfg = jax_smoke_config(ARCH).replace(**SETUP)
    model = jax_get_model(jcfg)
    params = model.init(jax.random.PRNGKey(3), jcfg)
    step = jax.jit(jgrpo.make_train_step(jcfg, jadamw.AdamWConfig(lr=1e-3)))
    batch = {k: jnp.asarray(v) for k, v in _batch(jcfg, 1).items()}
    params, opt_state, _ = step(params, jadamw.adamw_init(params), batch)
    jckpt.save_checkpoint(tmp_path, 1, {"params": params,
                                        "opt_state": opt_state,
                                        "version": 2})
    tr = _trainer()
    n, state = restore_checkpoint(tmp_path, device="cpu")
    load_trainer_state(state, tr.params, tr.opt_state)
    assert n == 1 and tr.opt_state["count"] == 1
    flat = {".".join(k.key for k in path): np.asarray(x) for path, x in
            jax.tree_util.tree_flatten_with_path(opt_state["m"])[0]}
    assert set(flat) == set(tr.opt_state["m"])
    for name, x in flat.items():
        np.testing.assert_array_equal(tr.opt_state["m"][name].numpy(), x)
    tokens = _batch(jcfg, 2)["tokens"]
    want = np.asarray(model.forward(params, jcfg, jnp.asarray(tokens)))
    with torch.no_grad():
        got = transformer.forward(tr.params, tr.cfg,
                                  torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_port_checkpoint_reads_in_the_reference(tmp_path):
    """The port's trainer after one step, read back by the reference: the
    JAX pytree's structure and equal arrays."""
    tr = _trainer()
    tr.run(1, verbose=False)
    assert tr.opt_state["count"] == 1
    save_checkpoint(tmp_path, 1, trainer_state(tr.params, tr.opt_state,
                                               tr.store.version))
    step, state = jckpt.restore_checkpoint(tmp_path)
    assert step == 1 and int(state["version"]) == tr.store.version
    jcfg = jax_smoke_config(ARCH).replace(**SETUP)
    jparams = jax_get_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    want = jax.tree_util.tree_structure(jparams)
    assert jax.tree_util.tree_structure(state["params"]) == want
    jstate = jadamw.adamw_init(jparams)
    assert (jax.tree_util.tree_structure(state["opt_state"])
            == jax.tree_util.tree_structure(jstate))
    assert state["opt_state"]["count"].dtype == np.int32
    assert int(state["opt_state"]["count"]) == 1
    for name, p in named_leaves(tr.params):
        keys = name.split(".")
        for tree, live in ((state["params"], p),
                           (state["opt_state"]["m"], tr.opt_state["m"][name]),
                           (state["opt_state"]["v"], tr.opt_state["v"][name])):
            leaf = tree
            for k in keys:
                leaf = leaf[k]
            np.testing.assert_array_equal(leaf, live.detach().numpy())


def _launch(*argv, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--json", *argv], env=env, cwd=cwd,
        capture_output=True, text=True, timeout=300)


def test_crash_after_then_resume(tmp_path):
    crash, whole = tmp_path / "crash", tmp_path / "whole"
    out = _launch("--steps", "4", "--ckpt-dir", str(crash), "--ckpt-every",
                  "1", "--crash-after", "2", cwd=tmp_path)
    assert out.returncode == 17, out.stdout + out.stderr
    assert sorted(p.name for p in crash.iterdir()) == [
        "step-00000001", "step-00000002"]                # no tmp-*
    out = _launch("--steps", "4", "--resume", str(crash), cwd=tmp_path)
    assert out.returncode == 0, out.stdout + out.stderr
    logs = [json.loads(line) for line in out.stdout.splitlines()]
    assert logs[0]["resumed_step"] == 2
    assert logs[-1] == {"msg": "training complete", "resumed_from": 2,
                        "steps": 4}
    assert any(m.get("step") == 4 for m in logs)
    # the interrupted run's state at step 2 is an uninterrupted run's
    out = _launch("--steps", "2", "--ckpt-dir", str(whole), "--ckpt-every",
                  "2", cwd=tmp_path)
    assert out.returncode == 0, out.stdout + out.stderr
    a = jckpt.restore_checkpoint(crash, 2)[1]
    b = jckpt.restore_checkpoint(whole, 2)[1]
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb and len(la) > 3
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    # --resume with nothing to resume from fails loudly
    out = _launch("--steps", "1", "--resume", str(tmp_path / "none"),
                  cwd=tmp_path)
    assert out.returncode != 0 and "FileNotFoundError" in out.stderr
