"""Versioned weight store + int8 quantized transport, the port of
``repro.rl.weight_sync``.

``WeightStore`` keeps host (CPU) copies of each published version
(copy-on-publish); rollout engines fetch by version at segment boundaries
and move the fetched tree to their device once per fetch.  Trees are
nested dicts of tensors (or numpy arrays, or a ``Params`` module).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.bridge import to_tensor
from repro_torch.models.params import tree_leaves, tree_map


# --------------------------------------------------------- int8 quantization
def _quantize(x: Any) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = to_tensor(x).float()
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_int8(tree: Any) -> Tuple[Any, Any]:
    """Per-tensor symmetric int8: returns (q_tree, scale_tree)."""
    pairs = tree_map(_quantize, tree)
    qs = tree_map(lambda t: t[0], pairs)
    ss = tree_map(lambda t: t[1], pairs)
    return qs, ss


def _zip_map(fn, a: Any, b: Any) -> Any:
    if isinstance(a, dict):
        return {k: _zip_map(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def dequantize_int8(qs: Any, ss: Any, dtype=torch.bfloat16) -> Any:
    return _zip_map(lambda q, s: (q.float() * s).to(dtype), qs, ss)


def tree_bytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size()
               for t in map(to_tensor, tree_leaves(tree)))


# --------------------------------------------------------------- weight store
class WeightStore:
    """Versioned publish/fetch store.

    ``publish()`` is what the trainer calls after each optimizer step;
    ``fetch()`` is what rollout engines call at interruption points.
    Unquantized fetch returns what was published (as host tensors).
    """

    def __init__(self, quantize: bool = False, keep_versions: int = 2):
        self.quantize = quantize
        self.keep = keep_versions
        self._lock = threading.Lock()
        self._store: Dict[int, Any] = {}
        self._version = 0

    @property
    def version(self) -> int:
        return self._version

    def publish(self, params: Any) -> int:
        with self._lock:
            self._version += 1
            if self.quantize:
                self._store[self._version] = quantize_int8(params)
            else:
                self._store[self._version] = tree_map(
                    lambda x: to_tensor(x).detach().to("cpu", copy=True),
                    params)
            for v in list(self._store):
                if v <= self._version - self.keep:
                    del self._store[v]
            return self._version

    def fetch(self, version: Optional[int] = None,
              dtype=None) -> Tuple[Any, int]:
        with self._lock:
            v = self._version if version is None else version
            item = self._store[v]
        if self.quantize:
            qs, ss = item
            return dequantize_int8(qs, ss, dtype or torch.bfloat16), v
        return item, v

    def payload_bytes(self, params: Any) -> int:
        """Bytes on the wire per sync (int8 + fp32 scales when quantized)."""
        if not self.quantize:
            return tree_bytes(params)
        leaves = [to_tensor(x) for x in tree_leaves(params)]
        return sum(t.numel() for t in leaves) + 4 * len(leaves)
