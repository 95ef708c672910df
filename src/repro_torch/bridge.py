"""Carry a JAX parameter pytree over to the port.

The port keeps the reference's names, shapes and ``[d_in, d_out]``
orientation, so the conversion is a copy per leaf: no transposes, no
renames.  bfloat16 leaves (numpy dtype ``bfloat16`` from ``ml_dtypes``)
are reinterpreted bit for bit, so nothing of JAX is imported here.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.params import Params, tree_map


def to_tensor(x: Any) -> torch.Tensor:
    """numpy array (any dtype the reference uses, bfloat16 included) or
    tensor -> CPU tensor holding the same values."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_jax(tree: Mapping[str, Any], device=None) -> Params:
    """Tree of numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``)
    or of host tensors (a ``WeightStore`` version) -> ``Params`` on
    ``device`` with the same names, shapes and dtypes."""
    dev = resolve_device(device)
    return Params(tree_map(lambda x: to_tensor(x).to(dev), tree))
