"""Greedy sequence packing (§4.2.1 workload assignment), the port's copy
of ``repro.data.packing``.

For each training batch, sequences are assigned to the DP worker with the
minimum current token count (the paper's greedy strategy, inherited from
AReaL).  Used both by the runtime trainer (to balance DP shards) and by the
scheduler's cost model (balanced-token assumption).
"""
from __future__ import annotations

import heapq
from typing import List, Sequence, Tuple


def greedy_pack(lengths: Sequence[int], n_workers: int
                ) -> List[List[int]]:
    """Assign sequence indices to workers, minimizing the max token load.

    Returns worker → list of sequence indices.  Longest-first greedy onto
    the least-loaded worker (LPT scheduling — 4/3-approximation).
    """
    assert n_workers >= 1
    order = sorted(range(len(lengths)), key=lambda i: -lengths[i])
    heap: List[Tuple[int, int]] = [(0, w) for w in range(n_workers)]
    heapq.heapify(heap)
    out: List[List[int]] = [[] for _ in range(n_workers)]
    for i in order:
        load, w = heapq.heappop(heap)
        out[w].append(i)
        heapq.heappush(heap, (load + lengths[i], w))
    return out


def pack_stats(lengths: Sequence[int], assignment: List[List[int]]
               ) -> Tuple[int, float]:
    """(max_load, imbalance = max/mean)."""
    loads = [sum(lengths[i] for i in grp) for grp in assignment]
    mx = max(loads) if loads else 0
    mean = sum(loads) / len(loads) if loads else 0.0
    return mx, (mx / mean if mean else 1.0)
