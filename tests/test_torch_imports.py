"""The port stands alone: no module of ``repro_torch`` (nor ``chip_smoke.py``)
imports ``jax`` or ``repro``, importing the engines pulls in no JAX, and
entry points refuse to fall back to the CPU silently."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    assert path.exists(), path
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_rollout_import_pulls_in_no_jax():
    code = ("import sys, repro_torch.rl.rollout, repro_torch.launch.serve, "
            "repro_torch.serve, repro_torch.rl.agentic, "
            "repro_torch.launch.train, repro_torch.models.xlstm; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]; print(bad); assert not bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_need_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None legitimately means cuda")
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import run
    from repro_torch.models import transformer
    from repro_torch.rl.rollout import RolloutEngine
    from repro_torch.rl.weight_sync import WeightStore
    from repro_torch.serve import PagedEngine, PagedKVCache

    cfg = get_smoke_config("qwen-distill-1.5b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RolloutEngine(cfg, WeightStore())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        transformer.init(0, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(["--smoke", "--quiet"])
    store = WeightStore()
    store.publish(transformer.init(0, cfg, "cpu"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedEngine(cfg, store)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedKVCache(cfg, max_slots=2, max_len=16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(["--smoke", "--quiet", "--engine", "paged"])
    from repro_torch.launch.train import run as train
    from repro_torch.rl.async_trainer import AsyncGRPOTrainer
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AsyncGRPOTrainer(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(["--smoke", "--quiet", "--arch", "xlstm-1.3b"])
    assert RolloutEngine(cfg, WeightStore(), device="cpu").device.type == "cpu"
    assert PagedEngine(cfg, store, device="cpu").device.type == "cpu"
    out = run(["--smoke", "--quiet", "--engine", "paged", "--device", "cpu",
               "--batch", "1", "--max-new", "2"])
    assert out["device"] == "cpu" and out["tokens"] >= 1
