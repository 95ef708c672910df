"""``Params``: an ``nn.Module`` holding a nested parameter tree.

The tree keeps the reference's pytree names (``layers/attn/wq`` becomes the
state-dict key ``layers.attn.wq``), and ``params["layers"]["attn"]["wq"]``
reads like the JAX dict, so the block functions take either.
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
