"""``Params``: an ``nn.Module`` holding a nested parameter tree.

The tree keeps the reference's pytree names (``layers/attn/wq`` becomes the
state-dict key ``layers.attn.wq``), and ``params["layers"]["attn"]["wq"]``
reads like the JAX dict, so the block functions take either.  Leaves are
frozen (``requires_grad=False``); the trainer's copy, which the GRPO step
differentiates and AdamW updates in place, is made trainable with
``requires_grad_()``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Mapping

from torch import nn


class Params(nn.Module):
    def __init__(self, tree: Mapping[str, Any]):
        super().__init__()
        for name, leaf in tree.items():
            if isinstance(leaf, Mapping):
                self.add_module(name, Params(leaf))
            else:
                self.register_parameter(
                    name, nn.Parameter(leaf, requires_grad=False))

    def __getitem__(self, name: str):
        if name in self._parameters:
            return self._parameters[name]
        if name in self._modules:
            return self._modules[name]
        raise KeyError(name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def keys(self) -> Iterator[str]:
        yield from self._parameters
        yield from self._modules

    def tree(self) -> Dict[str, Any]:
        """The nested dict of tensors (what ``WeightStore.publish`` takes)."""
        return {k: (self[k].tree() if isinstance(self[k], Params)
                    else self[k].data) for k in self.keys()}


def tree_map(fn: Callable, tree: Any) -> Any:
    """Map ``fn`` over the leaves of a nested dict (or ``Params``)."""
    if isinstance(tree, Params):
        tree = tree.tree()
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def _unbind(tree: Any) -> Any:
    if isinstance(tree, Params):
        return {k: _unbind(tree[k]) for k in tree.keys()}
    from repro_torch.parallel.local import replicate_dim
    return replicate_dim(tree, 0).unbind(0)


def _pick(parts: Any, i: int) -> Any:
    if isinstance(parts, dict):
        return {k: _pick(v, i) for k, v in parts.items()}
    return parts[i]


def layer_views(params: Params, name: str = "layers") -> list:
    """Per-layer views of the stacked tree ``name`` (the same nested
    names, leaves indexed on their leading ``[L]`` axis).  Views share
    storage, so in-place updates stay visible.  Each leaf is split with one
    ``unbind``, whose backward stacks the L layer gradients once (indexing
    layer by layer would give every layer a zero-filled gradient of the
    whole stack to sum: L^2 traffic).  Trainable params build them per
    call, so each forward's views belong to its own autograd graph; frozen
    params keep the views they built first, until a leaf is made
    trainable."""
    trainable = any(p.requires_grad for p in params.parameters())
    key = f"_views_{name}"
    views = params.__dict__.pop(key, None)
    if views is None or trainable:
        parts = _unbind(params[name])
        n = next(iter(params[name].parameters())).shape[0]
        views = [_pick(parts, i) for i in range(n)]
    if not trainable:
        params.__dict__[key] = views
    return views
