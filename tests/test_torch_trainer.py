"""Parity of the port's async GRPO trainer (``rl/async_trainer.py``) and
its launcher with the JAX package, on the CPU.

Both trainers run the reference launcher's setup on the smoke configs
(vocab 259, float32, no remat, group 4 x 2 prompts, eta 2) for 2 steps,
from the same params (the JAX init, carried over and published on both
sides) with greedy rollouts (JAX sampling is not reproducible in torch):
xlstm-1.3b and qwen-distill-1.5b on the static engine, qwen-distill-1.5b
on the paged engine.  Rollout tokens, rewards, versions and buffer stats
are identical, and losses, metrics and ``grad_norm`` agree to 1e-4.  The
launcher runs each family on the CPU, and a paged engine refuses the ssm
family.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.staleness import StalenessConfig as JaxStalenessConfig
from repro.rl.async_trainer import AsyncGRPOTrainer as JaxTrainer
from repro.rl.async_trainer import TrainerConfig as JaxTrainerConfig
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke_config
from repro_torch.core.staleness import StalenessConfig
from repro_torch.launch.train import run
from repro_torch.optim.adamw import adamw_init
from repro_torch.rl.async_trainer import AsyncGRPOTrainer, TrainerConfig

SETUP = dict(vocab=259, dtype="float32", remat=False)
STEPS = 2


def _tc(cls, stale_cls, engine):
    return cls(group_size=4, prompts_per_step=2, engine=engine,
               staleness=stale_cls(eta=2, rollouts_per_step=8))


def _recording(trainer):
    """Greedy rollouts, and every scored rollout recorded."""
    trainer.engine.gen.greedy = True
    seen = []
    score = trainer.rewarder.score_batch
    trainer.rewarder.score_batch = lambda rs: (seen.extend(rs), score(rs))[1]
    return seen


@pytest.mark.parametrize("arch,engine", [("xlstm-1.3b", "static"),
                                         ("qwen-distill-1.5b", "static"),
                                         ("qwen-distill-1.5b", "paged")])
def test_trainer_matches_jax(arch, engine):
    jtr = JaxTrainer(jax_smoke_config(arch).replace(**SETUP),
                     _tc(JaxTrainerConfig, JaxStalenessConfig, engine))
    ttr = AsyncGRPOTrainer(get_smoke_config(arch).replace(**SETUP),
                           _tc(TrainerConfig, StalenessConfig, engine),
                           device="cpu")
    # the same params on both sides, published as the launcher's resume
    # does (version 2 on both)
    ttr.params = params_from_jax(
        jax.tree_util.tree_map(np.asarray, jtr.params), "cpu")
    ttr.params.requires_grad_(True)
    ttr.opt_state = adamw_init(ttr.params, ttr.tc.opt)
    for tr in (jtr, ttr):
        tr.store.publish(tr.params)
        tr.buffer.ctl.version = tr.store.version
    if engine == "paged":
        # the paged engine fetched version 1 when it was built: on the JAX
        # side those are the values just published, on the port's side its
        # own init; give it the same values under the same version
        ttr.engine._params = ttr.engine._fetch()[0]
    jseen, tseen = _recording(jtr), _recording(ttr)
    jhist = jtr.run(STEPS, verbose=False)
    thist = ttr.run(STEPS, verbose=False)

    assert len(tseen) == len(jseen) == 8 * STEPS
    for a, b in zip(tseen, jseen):
        assert a.prompt_ids == b.prompt_ids
        assert a.completion_ids == b.completion_ids
        assert (a.version, a.group_id) == (b.version, b.group_id)
        assert a.reward == b.reward
        np.testing.assert_allclose(a.behavior_logp, b.behavior_logp,
                                   atol=1e-4)
    assert len(thist) == len(jhist) == STEPS
    for a, b in zip(thist, jhist):
        assert set(a) == set(b)
        for k, v in b.items():
            np.testing.assert_allclose(a[k], v, atol=1e-4, rtol=1e-4,
                                       err_msg=k)
    assert ttr.store.version == jtr.store.version == 2 + STEPS
    assert ttr.buffer.stats() == jtr.buffer.stats()
    assert max(h["max_staleness"] for h in thist) <= 2


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "qwen-distill-1.5b"])
def test_launcher_on_cpu(arch, tmp_path):
    path = tmp_path / "metrics.json"
    out = run(["--smoke", "--device", "cpu", "--arch", arch, "--steps", "2",
               "--quiet", "--metrics", str(path)])
    assert out["device"] == "cpu" and len(out["steps"]) == 2
    assert out["version"] == 3 and out["produced"] == 2
    for m in out["steps"]:
        assert np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
        assert m["max_staleness"] <= out["eta"]
    assert path.exists() and "buffer/consumed" in path.read_text()


def test_trainer_params_are_trainable_outside_inference_mode():
    cfg = get_smoke_config("xlstm-1.3b").replace(**SETUP)
    with torch.inference_mode():
        tr = AsyncGRPOTrainer(cfg, TrainerConfig(group_size=2,
                                                 prompts_per_step=1),
                              device="cpu")
    assert all(p.requires_grad and not p.is_inference()
               for p in tr.params.parameters())
    with pytest.raises(ValueError, match="dense"):
        AsyncGRPOTrainer(cfg, TrainerConfig(engine="paged"), device="cpu")
