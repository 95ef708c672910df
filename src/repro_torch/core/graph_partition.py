"""§4.3 — cost-guided graph partition of the device graph, the port's copy
of ``repro.core.graph_partition``.

Bisect G = (D, E) into (D_T, D_I) maximizing Eq. (3):

    (aggregate link bw inside D_T) / (aggregate link bw of D)
  + (aggregate HBM bw of D_I)      / (aggregate HBM bw of D)

subject to   γ_L ≤ (compute of D_T)/(compute of D) ≤ γ_H.

Partitions move whole *nodes* (machines): splitting an NVLink/ICI domain
between pools wastes its intra-node bandwidth and complicates placement, and
the paper's plans are node-granular in practice.

Two engines:
  * ``partition_exact`` — exploits node symmetry (all nodes of the same device
    type are interchangeable): the objective depends only on per-type node
    counts, so we enumerate count vectors — exact and O(Π_t nodes_t).
  * ``partition_kl``    — Kernighan–Lin-style local moves/swaps for general
    asymmetric topologies (and the Table-5 "w/o repartition" baseline where we
    replace it with brute-force subset enumeration).
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .cluster import Cluster, Device


@dataclass
class PartitionResult:
    train_devices: List[Device]
    infer_devices: List[Device]
    objective: float
    gamma_actual: float
    engine: str


def _group_nodes(cluster: Cluster) -> Dict[str, List[List[Device]]]:
    """nodes-by-type: {type: [list of devices per node]}"""
    by_node: Dict[int, List[Device]] = {}
    for d in cluster.devices:
        by_node.setdefault(d.node, []).append(d)
    out: Dict[str, List[List[Device]]] = {}
    for node, devs in sorted(by_node.items()):
        out.setdefault(devs[0].type_name, []).append(devs)
    return out


def ici_domains(cluster: Cluster) -> List[List[Device]]:
    """Whole ICI domains (machines) in deterministic (type, node) order.

    This is the unit of movement everywhere in the scheduling stack: the γ
    repartition moves domains between D_T and D_I *within* a job, and the
    pool arbitration (core/pool.py) moves domains between jobs' slices.
    """
    groups = _group_nodes(cluster)
    return [n for t in sorted(groups) for n in groups[t]]


def subcluster(cluster: Cluster, devices: Sequence[Device]) -> Cluster:
    """A job's slice as a Cluster: node ids and link model preserved, so the
    per-slice partition/search phases see the same topology the devices
    actually have."""
    return Cluster(devices=sorted(devices, key=lambda d: d.index),
                   cross_type_bw=cluster.cross_type_bw)


def eq3_objective(cluster: Cluster, d_train: Sequence[Device],
                  d_infer: Sequence[Device]) -> float:
    total_link = cluster.aggregate_link_bw(cluster.devices)
    total_hbm = cluster.total_hbm_bw()
    link_frac = (cluster.aggregate_link_bw(list(d_train)) / total_link
                 if total_link > 0 else 0.0)
    hbm_frac = (cluster.total_hbm_bw(list(d_infer)) / total_hbm
                if total_hbm > 0 else 0.0)
    return link_frac + hbm_frac


def compute_fraction(cluster: Cluster, d_train: Sequence[Device]) -> float:
    tot = cluster.total_flops()
    return cluster.total_flops(list(d_train)) / tot if tot > 0 else 0.0


def partition_exact(
    cluster: Cluster,
    gamma_lo: float,
    gamma_hi: float,
) -> Optional[PartitionResult]:
    """Exact Eq. 3 under node symmetry; returns None if the γ window admits no
    node-granular partition (caller should widen the window)."""
    groups = _group_nodes(cluster)
    type_names = sorted(groups)
    node_lists = [groups[t] for t in type_names]
    counts = [len(nl) for nl in node_lists]

    best: Optional[PartitionResult] = None
    for combo in itertools.product(*(range(c + 1) for c in counts)):
        d_train: List[Device] = []
        d_infer: List[Device] = []
        for nl, k in zip(node_lists, combo):
            for i, node in enumerate(nl):
                (d_train if i < k else d_infer).extend(node)
        if not d_train or not d_infer:
            continue
        g = compute_fraction(cluster, d_train)
        if not (gamma_lo - 1e-9 <= g <= gamma_hi + 1e-9):
            continue
        obj = eq3_objective(cluster, d_train, d_infer)
        if best is None or obj > best.objective:
            best = PartitionResult(d_train, d_infer, obj, g, "exact-symmetric")
    return best


def partition_kl(
    cluster: Cluster,
    gamma_lo: float,
    gamma_hi: float,
    *,
    max_passes: int = 8,
) -> Optional[PartitionResult]:
    """KL-style refinement with node-granular moves and swaps.  Start from a
    greedy seed (highest-HBM-bandwidth nodes → D_I until γ satisfied)."""
    groups = _group_nodes(cluster)
    nodes: List[List[Device]] = [n for t in sorted(groups) for n in groups[t]]
    if len(nodes) < 2:
        return None
    total_flops = cluster.total_flops()

    # seed: sort nodes by HBM-bw/FLOP ratio; most bandwidth-rich go to inference
    ranked = sorted(range(len(nodes)),
                    key=lambda i: (nodes[i][0].profile.hbm_bw /
                                   max(nodes[i][0].profile.flops, 1.0)),
                    reverse=True)
    in_train = [True] * len(nodes)
    for i in ranked:
        flops_t = sum(sum(d.profile.flops for d in nodes[j])
                      for j in range(len(nodes)) if in_train[j])
        if flops_t / total_flops > gamma_hi:
            in_train[i] = False
        else:
            break

    def build() -> Tuple[List[Device], List[Device]]:
        tr, inf = [], []
        for flag, node in zip(in_train, nodes):
            (tr if flag else inf).extend(node)
        return tr, inf

    def score() -> Tuple[float, float, bool]:
        tr, inf = build()
        if not tr or not inf:
            return -math.inf, 0.0, False
        g = compute_fraction(cluster, tr)
        ok = gamma_lo - 1e-9 <= g <= gamma_hi + 1e-9
        return eq3_objective(cluster, tr, inf), g, ok

    # repair seed into the γ window by single moves
    for _ in range(len(nodes)):
        _, g, ok = score()
        if ok:
            break
        move_to_train = g < gamma_lo
        cands = [i for i, f in enumerate(in_train) if f != move_to_train]
        if not cands:
            break
        i = min(cands, key=lambda i: sum(d.profile.flops for d in nodes[i]))
        in_train[i] = move_to_train

    best_obj, _, ok = score()
    if not ok:
        return None
    improved = True
    passes = 0
    while improved and passes < max_passes:
        improved = False
        passes += 1
        # single moves
        for i in range(len(nodes)):
            in_train[i] = not in_train[i]
            obj, _, ok = score()
            if ok and obj > best_obj + 1e-12:
                best_obj, improved = obj, True
            else:
                in_train[i] = not in_train[i]
        # pairwise swaps across the cut
        for i in range(len(nodes)):
            for j in range(len(nodes)):
                if in_train[i] and not in_train[j]:
                    in_train[i], in_train[j] = False, True
                    obj, _, ok = score()
                    if ok and obj > best_obj + 1e-12:
                        best_obj, improved = obj, True
                    else:
                        in_train[i], in_train[j] = True, False
    tr, inf = build()
    _, g, _ = score()
    return PartitionResult(tr, inf, best_obj, g, "kl")


def partition(
    cluster: Cluster,
    gamma_lo: float,
    gamma_hi: float,
    *,
    exact_node_limit: int = 4096,
) -> Optional[PartitionResult]:
    """Dispatch: exact symmetric enumeration when tractable, else KL."""
    groups = _group_nodes(cluster)
    space = 1
    for t in groups:
        space *= len(groups[t]) + 1
    if space <= exact_node_limit:
        res = partition_exact(cluster, gamma_lo, gamma_hi)
        if res is not None:
            return res
    return partition_kl(cluster, gamma_lo, gamma_hi)


def partition_exhaustive(
    cluster: Cluster,
    gamma_lo: float = 0.0,
    gamma_hi: float = 1.0,
) -> Optional[PartitionResult]:
    """Brute-force over all node subsets — the Table 5 '(w/o Repartition)'
    baseline.  Exponential; only call on small clusters."""
    groups = _group_nodes(cluster)
    nodes = [n for t in sorted(groups) for n in groups[t]]
    best: Optional[PartitionResult] = None
    for mask in range(1, (1 << len(nodes)) - 1):
        tr, inf = [], []
        for i, node in enumerate(nodes):
            (tr if (mask >> i) & 1 else inf).extend(node)
        g = compute_fraction(cluster, tr)
        if not (gamma_lo <= g <= gamma_hi):
            continue
        obj = eq3_objective(cluster, tr, inf)
        if best is None or obj > best.objective:
            best = PartitionResult(tr, inf, obj, g, "exhaustive")
    return best
