"""The port's launchers with every new family's ``--arch``, on the CPU.

``repro_torch.launch.serve.run`` serves each new arch's smoke config
through ``RolloutEngine`` (and the dense / vlm ones through
``PagedEngine``), and ``repro_torch.launch.train.run`` takes one
``AsyncGRPOTrainer`` step with each.  whisper-small is refused alike by
both packages' launchers: no engine passes frames, and whisper's
``prefill`` asserts them.
"""
import sys

import numpy as np
import pytest

from repro_torch.configs import get_smoke_config
from repro_torch.data.tasks import Tokenizer
from repro_torch.launch import serve, train

SERVED = ["qwen2.5-3b", "h2o-danube-1.8b", "starcoder2-15b", "yi-34b",
          "internvl2-2b", "qwen3-moe-235b-a22b", "grok-1-314b", "hymba-1.5b"]
PAGED = ["qwen2.5-3b", "h2o-danube-1.8b", "starcoder2-15b", "yi-34b",
         "internvl2-2b"]
VOCAB = Tokenizer().vocab_size


def _check_rollouts(out, batch, max_new):
    assert out["device"] == "cpu"
    assert len(out["rollouts"]) == batch
    for r in out["rollouts"]:
        assert 1 <= len(r.completion_ids) <= max_new
        assert all(0 <= t < VOCAB for t in r.completion_ids)
    assert out["tokens"] == sum(len(r.completion_ids)
                                for r in out["rollouts"])


@pytest.mark.parametrize("arch", SERVED)
def test_serve_launcher_static(arch):
    out = serve.run(["--smoke", "--device", "cpu", "--arch", arch,
                     "--greedy", "--quiet", "--batch", "2", "--max-new", "4"])
    _check_rollouts(out, 2, 4)


@pytest.mark.parametrize("arch", PAGED)
def test_serve_launcher_paged(arch):
    out = serve.run(["--smoke", "--device", "cpu", "--arch", arch,
                     "--engine", "paged", "--greedy", "--quiet",
                     "--batch", "2", "--max-new", "4", "--page-size", "8"])
    _check_rollouts(out, 2, 4)
    assert out["decode_steps"] >= 1


@pytest.mark.parametrize("arch", SERVED)
def test_train_launcher_one_step(arch):
    out = train.run(["--smoke", "--device", "cpu", "--arch", arch,
                     "--steps", "1", "--quiet"])
    assert out["device"] == "cpu" and len(out["steps"]) == 1
    assert out["n_layers"] == get_smoke_config(arch).n_layers
    (m,) = out["steps"]
    # rollouts from random weights often all score alike, which makes every
    # advantage (and so the gradient) zero: only finiteness is asked
    assert np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
    assert out["version"] == 2


def test_both_serve_launchers_refuse_whisper(monkeypatch):
    from repro.launch import serve as jserve
    argv = ["--smoke", "--arch", "whisper-small", "--greedy", "--quiet",
            "--batch", "2", "--max-new", "2"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with pytest.raises(AssertionError):
        jserve.main()
    with pytest.raises(AssertionError):
        serve.run(argv + ["--device", "cpu"])


def test_both_train_launchers_refuse_whisper(monkeypatch):
    from repro.launch import train as jtrain
    argv = ["--smoke", "--arch", "whisper-small", "--steps", "1", "--quiet"]
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    with pytest.raises(AssertionError):
        jtrain.main()
    with pytest.raises(AssertionError):
        train.run(argv + ["--device", "cpu"])
