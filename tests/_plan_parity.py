"""Structural equality of scheduler results across the two packages.

``plain(x)`` turns a result of either package (plans, clusters, costs,
records; dataclasses, enums, numpy scalars, nested containers) into
builtins tagged with each class's name, so that a plan of
``repro.core`` and one of ``repro_torch.core`` compare with ``==``: the
same device lists, the same σ/τ and every float bit for bit.  Fields
named ``wall_time_s`` (the scheduler's own runtime) are left out.
"""
import dataclasses
import enum

import numpy as np

SKIP = frozenset({"wall_time_s"})


def plain(x):
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: plain(getattr(x, f.name))
                 for f in dataclasses.fields(x) if f.name not in SKIP})
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.value)
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items() if k not in SKIP}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.tolist())
    if isinstance(x, np.generic):
        return x.item()
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if hasattr(x, "__dict__"):          # e.g. a CostProvider
        return (type(x).__name__, plain(vars(x)))
    raise TypeError(f"plain: no rule for {type(x).__name__}")
