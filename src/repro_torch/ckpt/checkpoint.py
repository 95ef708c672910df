"""Atomic versioned checkpoints, the port of ``repro.ckpt.checkpoint``.

The on-disk format is the reference's, so either package reads what the
other wrote: ``<dir>/step-%08d/state.pkl`` (a pickled tree of host numpy
arrays) beside ``META.json`` (``{"step", "keys"}``).  A save writes into
``tempfile.mkdtemp(prefix="tmp-<step>-")``, fsyncs both files, renames
the directory to ``step-%08d`` (atomic on POSIX) and fsyncs the parent, so
a crash leaves either the whole checkpoint or none; ``tmp-*`` directories
of a save that crashed are swept on ``CheckpointManager`` init and after
every save, and only the ``keep`` newest checkpoints are kept.

Trees hold the reference's layout (``trainer_state``): ``params`` is the
nested dict of ``Params.tree()`` (the JAX pytree's names), ``opt_state``
is ``{"m": tree, "v": tree, "count": int32}``: the port keys AdamW moments
by dotted leaf name (``optim.adamw.named_leaves``), so they are nested on
save and flattened again on load.  numpy without ``ml_dtypes`` has no
bfloat16, so a bfloat16 tensor is written widened to float32 (exact);
``load_trainer_state`` casts each leaf back to the live tensor's dtype,
as the reference launcher's resume does with ``b.astype(a.dtype)``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
import shutil
import tempfile
import types
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.bridge import to_tensor
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.params import Params
from repro_torch.optim.adamw import named_leaves


def _to_host(tree: Any) -> Any:
    """The reference's ``tree_map(np.asarray)``: dicts, lists, tuples and
    namedtuples keep their structure (``None`` stays ``None``, ``Params``
    becomes its nested dict), tensors (bfloat16 widened to float32) and
    scalars become numpy arrays.  Any other object is pickled as it is, so
    a recovery snapshot's configs and plans come back as themselves; one
    that holds a tensor is refused, since it would be pickled on its
    device."""
    if isinstance(tree, Params):
        tree = tree.tree()
    if isinstance(tree, Mapping):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_host(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()
    if isinstance(tree, (np.ndarray, np.generic, int, float, complex, str,
                         bytes)):
        return np.asarray(tree)
    if _holds_tensor(tree, set()):
        raise TypeError(f"cannot checkpoint a {type(tree).__name__} that "
                        "holds a tensor: pass its tensors in a dict, list "
                        "or tuple")
    return tree


def _holds_tensor(obj: Any, seen: set) -> bool:
    """Whether a tensor is reachable through ``obj``'s containers and
    instance attributes (not through classes, modules or functions)."""
    if id(obj) in seen:
        return False
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return True
    if isinstance(obj, Mapping):
        items = obj.values()
    elif isinstance(obj, (list, tuple, set, frozenset)):
        items = obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        items = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    elif (hasattr(obj, "__dict__") and not isinstance(obj, type)
          and not isinstance(obj, types.ModuleType) and not callable(obj)):
        items = vars(obj).values()
    else:
        return False
    return any(_holds_tensor(v, seen) for v in items)


def _to_device(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, Mapping):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return to_tensor(tree).to(device)
    return tree


def _fsync_path(path: Path) -> None:
    """fsync a file or directory by path (directory fsync is what makes a
    just-renamed entry durable on POSIX)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_checkpoint(directory: str | Path, step: int, state: Dict,
                    keep: int = 3) -> Path:
    """Atomically persist ``state`` (a dict of trees) for ``step``."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=f"tmp-{step}-", dir=directory))
    try:
        with open(tmp / "state.pkl", "wb") as f:
            pickle.dump(_to_host(state), f, protocol=pickle.HIGHEST_PROTOCOL)
            f.flush()
            os.fsync(f.fileno())
        meta = {"step": step, "keys": sorted(state)}
        with open(tmp / "META.json", "w") as f:
            f.write(json.dumps(meta))
            f.flush()
            os.fsync(f.fileno())
        final = directory / f"step-{step:08d}"
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        # the rename is durable only once the parent's entry is
        _fsync_path(directory)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(directory, keep)
    return final


def _gc(directory: Path, keep: int) -> None:
    ckpts = sorted(p for p in directory.iterdir()
                   if p.name.startswith("step-"))
    for p in ckpts[:-keep]:
        shutil.rmtree(p, ignore_errors=True)
    sweep_tmp(directory)


def sweep_tmp(directory: str | Path) -> List[Path]:
    """Remove the ``tmp-*`` directories of saves that crashed mid-write
    (never renamed to ``step-*``, so they would leak forever)."""
    directory = Path(directory)
    if not directory.exists():
        return []
    stale = sorted(p for p in directory.iterdir()
                   if p.is_dir() and p.name.startswith("tmp-"))
    for p in stale:
        shutil.rmtree(p, ignore_errors=True)
    return stale


def latest_step(directory: str | Path) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [int(p.name.split("-")[1]) for p in directory.iterdir()
             if p.name.startswith("step-") and (p / "META.json").exists()]
    return max(steps) if steps else None


def read_checkpoint(directory: str | Path, step: Optional[int] = None
                    ) -> Tuple[int, Dict]:
    """Load a checkpoint (the latest unless ``step``) as written:
    ``(step, state)`` with host numpy arrays, as the reference's restore
    returns it.  Raises ``FileNotFoundError`` when there is none."""
    directory = Path(directory)
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    # only checkpoints this program (or the reference) wrote are read
    with open(directory / f"step-{step:08d}" / "state.pkl", "rb") as f:
        return step, pickle.load(f)


def restore_checkpoint(directory: str | Path, step: Optional[int] = None,
                       device: DeviceLike = None) -> Tuple[int, Dict]:
    """``read_checkpoint`` with every array a tensor on ``device``
    (default: the GPU; no silent CPU fallback)."""
    dev = resolve_device(device)
    step, state = read_checkpoint(directory, step)
    return step, _to_device(state, dev)


class CheckpointManager:
    """A directory, a cadence and a keep policy."""

    def __init__(self, directory: str | Path, every: int = 50, keep: int = 3):
        self.directory = Path(directory)
        self.every = every
        self.keep = keep
        sweep_tmp(self.directory)

    def maybe_save(self, step: int, state_fn: Callable[[], Dict]
                   ) -> Optional[Path]:
        if step % self.every != 0:
            return None
        return save_checkpoint(self.directory, step, state_fn(),
                               keep=self.keep)

    def restore_latest(self, device: DeviceLike = None
                       ) -> Optional[Tuple[int, Dict]]:
        if latest_step(self.directory) is None:
            return None
        return restore_checkpoint(self.directory, device=device)


# ----------------------------------------------------- the trainer's state
def _nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """``{"layers.attn.wq": x}`` -> ``{"layers": {"attn": {"wq": x}}}``."""
    out: Dict[str, Any] = {}
    for name, x in flat.items():
        *path, leaf = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = x
    return out


def _leaf(tree: Mapping[str, Any], name: str) -> Any:
    for key in name.split("."):
        tree = tree[key]
    return tree


def trainer_state(params: Params, opt_state: Dict, version: int) -> Dict:
    """What the launcher saves, in the reference's layout: ``params`` (the
    nested tree), ``opt_state`` (``m`` / ``v`` nested the same way,
    ``count`` an int32 scalar) and the store's weight ``version``."""
    return {"params": params.tree(),
            "opt_state": {"m": _nest(opt_state["m"]),
                          "v": _nest(opt_state["v"]),
                          "count": np.asarray(opt_state["count"], np.int32)},
            "version": version}


@torch.no_grad()
def load_trainer_state(state: Dict, params: Params, opt_state: Dict) -> None:
    """Copy a restored ``trainer_state`` (either package's) into a live
    trainer's ``params`` and AdamW ``opt_state`` in place, each leaf cast
    to the live tensor's dtype; the step count becomes an int."""
    saved_m, saved_v = state["opt_state"]["m"], state["opt_state"]["v"]
    for name, p in named_leaves(params):
        for live, saved in ((p, _leaf(state["params"], name)),
                            (opt_state["m"][name], _leaf(saved_m, name)),
                            (opt_state["v"][name], _leaf(saved_v, name))):
            src = to_tensor(saved)
            if tuple(src.shape) != tuple(live.shape):
                raise ValueError(f"checkpoint leaf {name}: shape "
                                 f"{tuple(src.shape)}, live "
                                 f"{tuple(live.shape)}")
            live.copy_(src.to(live.device, live.dtype))
    opt_state["count"] = int(state["opt_state"]["count"])
