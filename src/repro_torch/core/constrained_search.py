"""§4.2.1 — constrained search for the model-training plan σ, the port's
copy of ``repro.core.constrained_search``.

Search space pruning follows the paper:
  * TP and DP blocks must be homogeneous (same device type) — cross-type
    traffic only crosses pipeline-stage boundaries.
  * TP is confined to one machine (NVLink/ICI domain).
  * Layers are split across pipeline stages proportional to each stage's
    effective compute (Metis-style load balancing).

The search enumerates, per device type present in D_T, the (tp, pp_t) grid and
derives dp; stage layer counts are balanced by effective FLOPS; every candidate
is priced with ``train_step_cost`` and the feasible minimum wins.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

from .cluster import Cluster, Device, PROFILES
from .cost_model import (CostProvider, StageSpec, TrainCost, TrainPlan,
                         resolve_provider, train_step_cost)
from .model_spec import ModelSpec

_POW2 = (1, 2, 4, 8, 16)


def _layer_split(spec: ModelSpec, weights: Sequence[float]) -> List[int]:
    """Allocate spec.n_layers across stages ∝ weights, ≥1 each, exact total."""
    n = spec.n_layers
    k = len(weights)
    total = sum(weights)
    raw = [max(1.0, n * w / total) for w in weights]
    out = [int(x) for x in raw]
    # distribute the remainder to largest fractional parts
    rem = n - sum(out)
    fracs = sorted(range(k), key=lambda i: raw[i] - out[i], reverse=True)
    i = 0
    while rem != 0 and k > 0:
        j = fracs[i % k]
        if rem > 0:
            out[j] += 1
            rem -= 1
        elif out[j] > 1:
            out[j] -= 1
            rem += 1
        i += 1
    return out


def _type_block_options(profile_name: str, n_devices: int) -> List[Tuple[int, int, int]]:
    """(tp, pp, dp) options for one homogeneous block of ``n_devices``."""
    prof = PROFILES[profile_name]
    opts = []
    for tp in _POW2:
        if tp > prof.devices_per_node or tp > n_devices:
            continue
        for pp in _POW2:
            if tp * pp > n_devices:
                continue
            dp = n_devices // (tp * pp)
            if dp < 1:
                continue
            opts.append((tp, pp, dp))
    return opts


def constrained_search(
    spec: ModelSpec,
    cluster: Cluster,
    d_train: Sequence[Device],
    *,
    tokens_per_step: float,
    seq_len: float = 8192.0,
    microbatch_options: Sequence[int] = (4, 8, 16, 32),
    cost_provider: Optional[CostProvider] = None,
) -> Tuple[Optional[TrainPlan], TrainCost]:
    """Return (σ, C_T-per-step).  σ is None when no feasible plan exists."""
    provider = resolve_provider(cost_provider)
    by_type: Dict[str, int] = {}
    for d in d_train:
        by_type[d.type_name] = by_type.get(d.type_name, 0) + 1
    if not by_type:
        return None, TrainCost(0, 0, 0, 0, 0, math.inf, 0, False, "empty pool")

    type_names = sorted(by_type)   # deterministic order
    per_type_opts = {t: _type_block_options(t, by_type[t]) for t in type_names}

    best_plan: Optional[TrainPlan] = None
    best_cost: Optional[TrainCost] = None

    for combo in itertools.product(*(per_type_opts[t] for t in type_names)):
        # one (tp, pp, dp) choice per device type; stages = concatenated blocks
        stage_protos: List[Tuple[str, int, int]] = []   # (type, dp, tp) per stage
        ok = True
        for t, (tp, pp, dp) in zip(type_names, combo):
            if dp * tp * pp == 0:
                ok = False
                break
            for _ in range(pp):
                stage_protos.append((t, dp, tp))
        if not ok or not stage_protos:
            continue
        if len(stage_protos) > spec.n_layers:
            continue
        # layers ∝ effective stage FLOPS
        weights = [
            dp * tp * PROFILES[t].flops * provider.train_mfu(PROFILES[t])
            for (t, dp, tp) in stage_protos
        ]
        layers = _layer_split(spec, weights)
        for mb in microbatch_options:
            stages = tuple(
                StageSpec(profile_name=t, dp=dp, tp=tp, n_layers=nl)
                for (t, dp, tp), nl in zip(stage_protos, layers)
            )
            plan = TrainPlan(stages=stages, microbatches=mb)
            cost = train_step_cost(spec, plan, tokens_per_step=tokens_per_step,
                                   seq_len=seq_len, cost_provider=provider)
            if not cost.feasible:
                continue
            if best_cost is None or cost.total < best_cost.total:
                best_plan, best_cost = plan, cost

    if best_plan is None:
        return None, TrainCost(0, 0, 0, 0, 0, math.inf, 0, False,
                               "no feasible σ for pool " + str(by_type))
    return best_plan, best_cost


def exhaustive_search(
    spec: ModelSpec,
    cluster: Cluster,
    d_train: Sequence[Device],
    *,
    tokens_per_step: float,
    seq_len: float = 8192.0,
    cost_provider: Optional[CostProvider] = None,
) -> Tuple[Optional[TrainPlan], TrainCost]:
    """Unconstrained baseline used by Table 5: also enumerates cross-type
    TP/DP blocks (which the constrained search prunes) and all microbatch
    choices, exploding the candidate count."""
    provider = resolve_provider(cost_provider)
    by_type: Dict[str, int] = {}
    for d in d_train:
        by_type[d.type_name] = by_type.get(d.type_name, 0) + 1
    type_names = sorted(by_type)

    best_plan, best_cost = constrained_search(
        spec, cluster, d_train, tokens_per_step=tokens_per_step,
        seq_len=seq_len, cost_provider=provider)

    # Cross-type "mixed" stages: emulate by evaluating every split of each
    # type's devices across 1..4 stages and every interleaving order — this is
    # the exponential space the paper's constraint avoids.  We bound it for
    # tractability but still visit orders of magnitude more candidates.
    def splits(n: int, k: int):
        if k == 1:
            yield (n,)
            return
        for first in range(0, n + 1):
            for rest in splits(n - first, k - 1):
                yield (first,) + rest

    for k in (1, 2, 3, 4):
        per_type_splits = [list(splits(by_type[t], k)) for t in type_names]
        for combo in itertools.product(*per_type_splits):
            for stage_idx_perm in itertools.permutations(range(k)):
                stage_protos = []
                ok = True
                for si in stage_idx_perm:
                    for tname, split in zip(type_names, combo):
                        n = split[si]
                        if n == 0:
                            continue
                        tp = min(8, n)
                        while tp > 1 and n % tp:
                            tp //= 2
                        dp = n // tp
                        if dp * tp != n:
                            ok = False
                        stage_protos.append((tname, dp, tp))
                if not ok or not stage_protos or len(stage_protos) > spec.n_layers:
                    continue
                weights = [dp * tp * PROFILES[t].flops
                           * provider.train_mfu(PROFILES[t])
                           for (t, dp, tp) in stage_protos]
                layers = _layer_split(spec, weights)
                for mb in (2, 4, 8, 16, 32, 64):
                    stages = tuple(StageSpec(t, dp, tp, nl)
                                   for (t, dp, tp), nl in zip(stage_protos, layers))
                    plan = TrainPlan(stages=stages, microbatches=mb)
                    cost = train_step_cost(spec, plan,
                                           tokens_per_step=tokens_per_step,
                                           seq_len=seq_len,
                                           cost_provider=provider)
                    if cost.feasible and (best_cost is None
                                          or cost.total < best_cost.total):
                        best_plan, best_cost = plan, cost
    return best_plan, best_cost
