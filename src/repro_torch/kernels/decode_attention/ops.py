"""Flash decode: the hand-written Hopper kernel and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention/kernel.py
::flash_decode``.  The CUDA source is ``kernels/csrc/flash_decode.cu``; its
header says what bounds it on the H100 (HBM: cache bytes / 3.35 TB/s) and
what the design does about that: the cache is split across ``_num_splits``
blocks per (row, KV head), whose fp32 partials merge in the same launch
(``csrc/split_decode.cuh``).  The count comes from one rule for K3 and K2,
fed by the card's SMs and the blocks of the body launched that an SM
holds (``_resident``, the occupancy query of the C entry).

``decode_attention`` takes ``[B, H, D]`` and returns ``[B, H, D]`` as the
JAX entry point does.  On a CPU tensor it runs ``decode_attention_ref``; on
a CUDA tensor it launches the kernel (or raises) and counts the launch in
``decode_attention.launches`` and, per block body, in
``decode_attention.launches_by_variant``: ``_decode_body`` names the body
(on aligned tensors at D = 64, 80 or 128 the tensor cores: ``"mma"`` for
bfloat16, ``"tf32x3"`` for float32, each product three TF32 products of
hi / lo splits; ``"core"``, the CUDA cores, otherwise) and the C entry
launches that one or refuses.  The kernel needs no padding of D or C (the
TPU wrapper padded D to 128 and C to ``block_c``), and takes any group of
``G = H / Hkv`` query heads in one launch, as ``_head_groups`` cuts
them: groups of up to ``GROUP_LIMIT[body]`` heads, 8 on the CUDA-core
body (each head's float32 accumulators in a lane's registers) and on the
float32 tensor-core body (rows 8..15 of its m16 tile carry the lo halves
of the split operands) and 16 on the bf16 tensor-core body (all 16 rows
of its m16 tile, so each K/V tile is read from HBM once for G <= 16, as
the TPU kernel reads it once for its G heads) where the one-group launch
fills the card or its K/V read dominates; elsewhere (short rows on idle
SMs) the bf16 tensor-core body keeps
groups of 8, which measured faster there.
Launches are also counted by the head groups the C entry was given, in
``decode_attention.launches_by_groups``.

A cache split on its head dim (each rank holds ``Dl = D / m`` of every
head's dims) runs as two passes, ``csrc/decode_hd.cu``: ``decode_scores``
(the slice's partial scaled q . k, float32 ``[B, H, C]``), summed over the
ranks by the caller, then ``decode_softmax_pv`` (K3's masks, the softmax
and p . v on the slice).  They have no limit on D, so ``decode_attention``
runs D > 256 as the two passes over one slice.  Each pass has two bodies,
chosen by ``_variant``: ``"ring"`` (cp.async rings of shared-memory
stages, pass 1 on persistent blocks, pass 2 a ring a warp, the products
on the tensor cores: bf16 ``mma.sync``, float32 three TF32 ``mma.sync``
of hi / lo splits) wherever 16-byte copies fit, and ``"simt"`` (the first
design's CUDA-core bodies) for the rest, such as a slice of 5 dims.
``_scores_geometry`` and ``_pv_geometry`` size the ring's launches.  Each
pass counts its launches in ``decode_scores.launches`` /
``decode_softmax_pv.launches`` and, per body, in
``.launches_by_variant``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional

import torch

from .. import _build, tuning
from .ref import (decode_attention_ref, decode_scores_ref,
                  decode_softmax_pv_ref)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# query heads a block serves, by body (split_decode.cuh kMaxG, kMmaMaxG)
GROUP_LIMIT = {"core": 8, "mma": 16, "tf32x3": 8}
TILE = 16              # cache slots per tile (split_decode.cuh kTile)
MIN_SPLIT_TILES = 8    # tiles a split holds at least, by default
# splits a (row, KV head, head group) takes at most, by body; past
# EVERY_COUNT only multiples of MERGE_UNROLL (whole rounds of the merge)
MAX_SPLITS = {"mma": 16, "core": 64, "tf32x3": 16}
EVERY_COUNT = 16
WARPS, THREADS = 4, 128     # a block of split_decode.cuh (kWarps, kThreads)
# the split rule's cost model (_num_splits), fit to sweeps of every split
# count on the H100 (PERF.md; each body in its own dtype, the CUDA-core
# body in float32), in a tile step: the time a walker (WALKERS) takes for
# one tile.  By body: the tiles a block walks at once (each warp of the
# bf16 tensor-core body its own, every WARPS-th tile of the split, and
# each pair of warps of the float32 one; the CUDA-core body's row groups
# each tile together); the share of the blocks an SM holds that streams
# at full rate (1: the CUDA-core body
# never streams faster than its blocks walk); a block's own cost (its
# prologue and finish); and a merge's cost per round of dependent reads
# of the partials (the split loop unrolled MERGE_UNROLL deep), beside a
# fixed MERGE_STEPS.  A 16-row block's second softmax row a lane costs a
# tile as much as WIDE_DIMS more head dims would.  FULL_RATE_BLOCKS caps
# the blocks an SM holds as the rule counts them: two blocks of the
# float32 tensor-core body on one SM (D 64) walk no faster than one
# (its float32 split sweep, PERF.md §6).
WALKERS = {"mma": WARPS, "core": 1, "tf32x3": WARPS}
STREAM_SHARE = {"mma": 0.4, "core": 1.0, "tf32x3": 1.0}
BLOCK_STEPS = {"mma": 0.0, "core": 4.0, "tf32x3": 8.0}
MERGE_READ_STEPS = {"mma": 0.5, "core": 0.2, "tf32x3": 0.3}
FULL_RATE_BLOCKS = {"tf32x3": 1}
MERGE_STEPS = 4.0
MERGE_UNROLL = 4
WIDE_DIMS = 32
LONG_TILES = 64        # tiles a SM walks from which one head group of 16
                       # pays on the tensor cores (_head_groups)
N_SM = 132             # the H100's SMs
MAX_D = 256            # K3's kernel (split_decode.cuh kMaxD)
MMA_DIMS = (64, 80, 128)   # the tensor-core bodies' head dims
# split_decode.cuh kBodyCore / kBodyMma / kBodyTf32x3
BODIES = {"core": 0, "mma": 1, "tf32x3": 2}
PV_TILE = 32           # slots a tile of decode_softmax_pv (decode_hd.cu)
PV_CHUNK = 64          # dims a block of decode_softmax_pv serves
MIN_PV_TILES = 4       # tiles a split of decode_softmax_pv holds at least
PV_WAVES = 8           # blocks per SM decode_softmax_pv aims for
# the ring bodies of the two passes (decode_hd.cu)
RING_K_STAGE = 16384   # bytes of K a pass-1 stage holds at most
RING_PV_STAGE = 6144   # bytes a pass-2 stage holds at most with 32 slots
RING_MAX_TILE = 512    # slots a pass-1 tile holds at most
# pass 1's ring by element size (decode_hd.cu): stages of a block's ring,
# the blocks an SM holds at most (bf16 256 threads, float32 128), and the
# tiles an SM should have at least (fewer halve the tile)
SCORES_STAGES = {2: 3, 4: 2}
SCORES_BLOCKS = {2: 2, 4: 4}
SCORES_FILL = {2: 0.5, 4: 4}
RING_PV_BLOCKS = 4     # pass-2 blocks an SM holds at most (registers)
PV_WARPS, PV_STAGES = 4, 3      # pass 2: warps a block, stages a warp
MIN_RING_TILES = 2 * PV_WARPS   # tiles a pass-2 split holds at least
UNIT_ROWS, UNIT_DIMS = 16, 64   # heads and dims of a pass-2 unit
MAX_SMEM = 231424      # dynamic shared memory a ring block asks for at most
SM_SMEM = 233472       # shared memory of an SM (228 KB)
SMEM_RESERVED = 1024   # of it, reserved per resident block

__all__ = ["decode_attention", "decode_attention_ref", "decode_scores",
           "decode_scores_ref", "decode_softmax_pv", "decode_softmax_pv_ref"]


def _num_splits(B: int, Hkv: int, tiles: int, n_sm: int, resident: int,
                min_tiles: int, rows: int, D: int, body: str = "mma") -> int:
    """Blocks per (row, KV head), K3's and K2's split rule: a pure function
    of the launch's ``B * Hkv`` (row, KV head or head group) pairs, the
    ``tiles`` of TILE slots a row walks, the card's ``n_sm`` SMs, the
    blocks of the body launched that an SM holds at once (``resident``,
    ``_resident`` on the card, counted as at most
    ``FULL_RATE_BLOCKS[body]``), the least tiles of a split, the heads a
    block serves (``rows``), D and the block ``body``.

    It takes the count of least modelled cost, in tile steps: a split of
    ``ceil(tiles / n)`` tiles costs a block that many over the tiles it
    walks at once (``WALKERS[body]``), plus its own cost
    (``BLOCK_STEPS[body]``), once per wave of ``resident`` blocks an SM
    (the grid beyond them waits); but the SMs stream no faster than
    ``STREAM_SHARE[body]`` of the blocks they hold, each walking its tiles
    at full rate (a block of more than 8 heads doing a tile's work of D +
    WIDE_DIMS head dims), so the launch costs at least its tiles over
    that; and a split pays its merge, MERGE_STEPS, plus
    ``MERGE_READ_STEPS[body]`` for each round of the last block's reads of
    the partials: ``n // MERGE_UNROLL + n % MERGE_UNROLL`` rounds (the
    split loop unrolled MERGE_UNROLL deep) for each of the ``ceil(rows *
    D / THREADS)`` elements a thread merges.  The constants come from
    sweeps of every split count on the H100 (``tools/decode_groups_ab.py
    --splits``, PERF.md).  At most ``MAX_SPLITS[body]`` splits (past
    EVERY_COUNT a multiple of MERGE_UNROLL), and every split at least
    ``min_tiles`` tiles."""
    if min_tiles < 1:
        raise ValueError(f"min_tiles = {min_tiles}: a split walks at least "
                         "one tile")
    if resident < 1:
        raise ValueError(f"resident = {resident}: an SM holds no block")
    pairs = B * Hkv
    resident = min(resident, FULL_RATE_BLOCKS.get(body, resident))
    work = 1.0 + WIDE_DIMS / D if rows > GROUP_LIMIT["core"] else 1.0
    walkers = WALKERS[body]
    stream = pairs * tiles * work / (walkers * STREAM_SHARE[body] * resident
                                     * n_sm)
    merged = -(-rows * D // THREADS)
    best, best_n = None, 1
    for n in range(1, max(1, min(tiles // min_tiles, MAX_SPLITS[body])) + 1):
        if n > EVERY_COUNT and n % MERGE_UNROLL:
            continue
        steps = -(-(-(-tiles // n)) // walkers)
        waves = -(-pairs * n // (resident * n_sm))
        cost = max((steps + BLOCK_STEPS[body]) * waves, stream)
        if n > 1:
            rounds = n // MERGE_UNROLL + n % MERGE_UNROLL
            cost += MERGE_STEPS + MERGE_READ_STEPS[body] * merged * rounds
        if best is None or cost < best:
            best, best_n = cost, n
    return best_n


def _wave_splits(B: int, units: int, C: int, n_sm: int, waves: float,
                 min_tiles: int, tile: int) -> int:
    """Splits of ``decode_softmax_pv`` (the second pass of a head-dim
    split): the whole waves of ``waves`` blocks an SM that fit
    (``B * units * n <= waves * n_sm``), every split at least
    ``min_tiles`` tiles of ``tile`` slots long."""
    tiles = -(-C // tile)
    want = math.floor(waves * n_sm / (B * units))
    return max(1, min(want, tiles // min_tiles))


def _decode_body(dtype: torch.dtype, D: int, aligned: bool) -> str:
    """The block body of ``csrc/split_decode.cuh`` that serves a launch
    (K3's and K2's): at D = 64, 80 or 128 when ``aligned`` (k and v
    16-byte aligned, q 4-byte aligned, ``_aligned``) the tensor cores,
    ``"mma"`` (``decode_block_mma``) for bfloat16 and ``"tf32x3"``
    (``decode_block_tf32x3``, three TF32 products of hi / lo splits) for
    float32; else ``"core"`` (``decode_block``, the CUDA cores).  The
    wrappers pass it to the C entry, whose ``dispatch`` refuses a
    tensor-core body where it cannot serve."""
    if D in MMA_DIMS and aligned:
        if dtype == torch.bfloat16:
            return "mma"
        if dtype == torch.float32:
            return "tf32x3"
    return "core"


def _aligned(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    return (k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0
            and q.data_ptr() % 4 == 0)


def _cut(G: int, ng: int):
    """(NG, Gc): G heads cut into ``ng`` groups of Gc = ceil(G / ng)
    heads, NG rounded so that no group is empty (the last may hold
    fewer)."""
    gc = -(-G // max(1, min(int(ng), G)))
    return -(-G // gc), gc


def _head_groups(G: int, body: str, blocks: Optional[int] = None,
                 n_sm: int = N_SM, tiles: int = 0):
    """(NG, Gc): the head groups a launch on ``body`` cuts G query heads
    per KV head into, one block per group and split (``_cut``).  The one
    rule: K3's and K2's wrappers pass NG to the C entry, which refuses a
    group its body cannot serve, and size their scratch, tickets and
    splits by it; ``decode_hd.cu``'s CUDA-core passes take ``"core"``'s.

    Groups hold up to ``GROUP_LIMIT[body]`` heads: 8 on the CUDA-core
    body; on the tensor-core body 16 (both halves of the m16 tile, so one
    group for G <= 16 reads each K/V tile once) where the one-group
    launch fills the card, its grid ``blocks`` (B * Hkv * n_split) at
    least ``n_sm``, or where the K/V read dominates, its ``tiles`` (B *
    Hkv * the tiles a row walks) at least LONG_TILES a SM; elsewhere 8
    (the 8-row instance): a 16-row block walks each tile more slowly, and
    with SMs idle and short rows the second group's reread costs less
    than that (PERF.md §6, G > 8).  Without ``blocks``, the body's widest
    groups."""
    limit = GROUP_LIMIT[body]
    if (blocks is not None and blocks < n_sm
            and tiles < LONG_TILES * n_sm):
        limit = min(limit, GROUP_LIMIT["core"])
    return _cut(G, -(-G // limit))


def _launch_groups(B: int, G: int, Hkv: int, D: int, C: int, n_sm: int,
                   resident, min_tiles: int, body: str):
    """The head groups ``_head_groups`` gives a launch on ``body`` over C
    slots, from its grid at one group (``_num_splits`` over the (row, KV
    head) pairs, with the blocks an SM holds of the body's widest group,
    ``resident(Gc)``) and the tiles its rows walk."""
    tiles = -(-C // TILE)
    widest = _head_groups(G, body)[1]
    one = _num_splits(B, Hkv, tiles, n_sm, resident(widest), min_tiles,
                      widest, D, body)
    return _head_groups(G, body, B * Hkv * one, n_sm, B * Hkv * tiles)


def _launch_splits(B: int, H: int, Hkv: int, D: int, C: int, n_sm: int,
                   resident, min_split_tiles: Optional[int] = None,
                   body: str = "mma", groups=None) -> int:
    """The split count ``decode_attention`` launches with over C slots:
    ``_num_splits`` over the head groups ``groups`` (by default
    ``_launch_groups``'s for ``body``), the blocks an SM holds of the body
    at those groups (``resident(Gc)``) and the resolved
    ``min_split_tiles`` knob."""
    min_tiles = tuning.resolve("decode_attention", "min_split_tiles",
                               min_split_tiles)
    if groups is None:
        groups = _launch_groups(B, H // Hkv, Hkv, D, C, n_sm, resident,
                                min_tiles, body)
    return _num_splits(B, Hkv * groups[0], -(-C // TILE), n_sm,
                       resident(groups[1]), min_tiles, groups[1], D,
                       body)


# the blocks an SM of the H100 holds of the tensor-core body by D, in a
# group of 8 rows or of 16 alike: what flash_decode_resident and
# paged_flash_decode_resident return there (chip_smoke.py checks them);
# the CPU models of the card (autotune.space) count with them
H100_RESIDENT = {64: 4, 80: 3, 128: 2}
# and of the float32 tensor-core body (8 warps, a float32 ring of 3 half
# tiles each: 114 KB at D 64, 126 KB at D 80, 212 KB at D 128), at any
# group
H100_RESIDENT_TF32X3 = {64: 2, 80: 1, 128: 1}


def _h100_resident(D: int, body: str = "mma"):
    """``resident(Gc)`` of a tensor-core body (``"mma"`` or ``"tf32x3"``)
    at D on the H100, from H100_RESIDENT or H100_RESIDENT_TF32X3, for the
    models that count a launch off the card."""
    table = H100_RESIDENT_TF32X3 if body == "tf32x3" else H100_RESIDENT
    return lambda gc: table[D]


_RESIDENT: Dict[tuple, int] = {}   # per (entry, device, instantiation)


def _resident(entry: str, device: torch.device, dtype: torch.dtype,
              D: int, body: str, aligned: bool):
    """``resident(Gc)``: the blocks an SM of ``device`` holds at once of
    the kernel that the C entry ``entry`` (``"flash_decode"`` or
    ``"paged_flash_decode"``) launches for ``dtype``, D, ``body``, the
    pointers' alignment and a head group of Gc heads, as the card's
    occupancy query gives it (``<entry>_resident``), cached per device and
    instantiation.  A failed query raises."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()

    def blocks(gc: int) -> int:
        key = (entry, index, dtype, D, body, bool(aligned), gc)
        n = _RESIDENT.get(key)
        if n is None:
            lib = _build.load(entry)
            fn = getattr(lib, f"{entry}_resident")
            if fn.argtypes is None:
                fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
            out = ctypes.c_int(0)
            _build.check(lib, entry, fn(gc, 1, D, _DTYPES[dtype],
                                        BODIES[body], int(bool(aligned)),
                                        index, ctypes.addressof(out)))
            if out.value < 1:
                raise RuntimeError(f"{entry}_resident: {out.value} blocks "
                                   f"an SM for {dtype} D={D} {body} "
                                   f"Gc={gc}")
            n = _RESIDENT[key] = out.value
        return n
    return blocks


# per device: the merge tickets, one int32 per (row, KV head, head group),
# zeroed once at creation; every launch leaves its counters at 0 again
_COUNTERS: Dict[torch.device, torch.Tensor] = {}


def _counters(device: torch.device, n: int) -> torch.Tensor:
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[device] = torch.zeros(max(n, 256), dtype=torch.int32,
                                              device=device)
    return buf


def _split_scratch(B: int, Hkv: int, groups, D: int, n_split: int,
                   device: torch.device):
    """The merge scratch of a launch with ``n_split`` splits, per (row, KV
    head, head group) of ``groups = (NG, Gc)`` (``_head_groups`` for the
    body launched): the fp32 partials ``(acc, m, l)`` and the tickets;
    ``(None,) * 3`` for one split."""
    if n_split == 1:
        return None, None, None
    ng, gc = groups
    blocks = B * Hkv * ng
    return (torch.empty(blocks * n_split * gc * D, dtype=torch.float32,
                        device=device),
            torch.empty(blocks * n_split * gc * 2, dtype=torch.float32,
                        device=device),
            _counters(device, blocks))


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_decode")
    fn = lib.flash_decode
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


_SMS: Dict[int, int] = {}   # per device index: its SMs


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    n = _SMS.get(index)
    if n is None:
        n = _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return n


def decode_attention(
    q: torch.Tensor,          # [B, H, D]
    k: torch.Tensor,          # [B, C, Hkv, D]
    v: torch.Tensor,          # [B, C, Hkv, D]
    q_pos: torch.Tensor,      # [B] int32
    k_pos: torch.Tensor,      # [B, C] int32
    *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    min_split_tiles: Optional[int] = None,
    return_lse: bool = False,
):
    """One decode token over the KV cache.  Returns [B, H, D], and with
    ``return_lse`` also each head's log-sum-exp float32 [B, H] (the same
    launch writes it; ``ref.merge_lse`` merges launches over disjoint runs
    of the cache, as a context split over ranks needs).

    ``min_split_tiles=None`` resolves through ``kernels.tuning`` (default
    MIN_SPLIT_TILES); the launch's split count is left in
    ``decode_attention.last_n_split``."""
    # on meta the plain version gives only its shapes (the dry-run)
    if q.device.type in ("cpu", "meta"):
        return decode_attention_ref(q, k, v, q_pos, k_pos, window=window,
                                    scale=scale, return_lse=return_lse)
    if not q.is_cuda:
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    B, H, D = q.shape
    _, C, Hkv, _ = k.shape
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != D
            or tuple(q_pos.shape) != (B,) or tuple(k_pos.shape) != (B, C)):
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} q_pos "
                         f"{tuple(q_pos.shape)} k_pos {tuple(k_pos.shape)}")
    if H % Hkv:
        raise ValueError(f"decode_attention: H={H} Hkv={Hkv} (needs "
                         f"H % Hkv == 0)")
    for t in (k, v, q_pos, k_pos):
        if t.device != q.device:
            raise ValueError("decode_attention: inputs on different devices")
    if k.dtype != q.dtype or v.dtype != q.dtype or q.dtype not in _DTYPES:
        raise ValueError(f"decode_attention: dtypes q {q.dtype} k {k.dtype} "
                         f"v {v.dtype} (float32 or bfloat16, all equal)")
    if q_pos.dtype != torch.int32 or k_pos.dtype != torch.int32:
        raise ValueError("decode_attention: q_pos and k_pos must be int32")
    if not all(t.is_contiguous() for t in (q, k, v, q_pos, k_pos)):
        raise ValueError("decode_attention: inputs must be contiguous")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if D > MAX_D:
        # the two passes of a head-dim split, over one slice
        if return_lse:
            raise ValueError(f"decode_attention: return_lse at D={D} > "
                             f"{MAX_D}")
        return decode_softmax_pv(decode_scores(q, k, scale=scale), v, q_pos,
                                 k_pos, window=window)
    aligned = _aligned(q, k, v)
    body = _decode_body(q.dtype, D, aligned)
    n_sm = _sm_count(q.device)
    resident = _resident("flash_decode", q.device, q.dtype, D, body,
                         aligned)
    min_tiles = tuning.resolve("decode_attention", "min_split_tiles",
                               min_split_tiles)
    groups = _launch_groups(B, H // Hkv, Hkv, D, C, n_sm, resident,
                            min_tiles, body)
    n_split = _launch_splits(B, H, Hkv, D, C, n_sm, resident, min_tiles,
                             body, groups)
    o, lse, groups = _launch(q, k, v, q_pos, k_pos, window, scale, n_split,
                             body, groups[0], return_lse)
    _count(decode_attention, body, groups, n_split)
    return (o, lse) if return_lse else o


def _count(wrapper, body: str, groups, n_split: int) -> None:
    """Count one launch of K3's or K2's ``wrapper`` on ``body`` in the
    head groups ``(NG, Gc)`` its C entry was given with ``n_split``
    splits: in all, by body, by NG and by split count; leave its split
    count and groups on it."""
    ng = groups[0]
    wrapper.launches += 1
    wrapper.launches_by_variant[body] += 1
    wrapper.launches_by_groups[ng] = wrapper.launches_by_groups.get(ng, 0) + 1
    wrapper.launches_by_splits[n_split] = (
        wrapper.launches_by_splits.get(n_split, 0) + 1)
    wrapper.last_n_split = n_split
    wrapper.last_groups = tuple(groups)


def _launch(q, k, v, q_pos, k_pos, window, scale, n_split, body, ng,
            return_lse=False):
    """One launch of ``flash_decode.cu`` with the given split count, body
    (``"mma"``, ``"tf32x3"`` or ``"core"``) and ``ng`` head groups
    (``_cut``), on inputs ``decode_attention`` has checked; not counted
    (chip_smoke.py times the CUDA-core body and other groups through it).
    Returns ``(o, lse or None, (NG, Gc))``, the groups as the C entry was
    given them."""
    B, H, D = q.shape
    C, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    groups = _cut(G, ng)
    o = torch.empty_like(q)
    lse = (torch.empty((B, H), dtype=torch.float32, device=q.device)
           if return_lse else None)
    scratch = _split_scratch(B, Hkv, groups, D, n_split, q.device)
    lib = _lib()
    err = lib.flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
        k_pos.data_ptr(), o.data_ptr(),
        0 if lse is None else lse.data_ptr(),
        *(0 if t is None else t.data_ptr() for t in scratch),
        B, C, Hkv, G, groups[0], D, n_split,
        -1 if window is None else int(window), float(scale),
        _DTYPES[q.dtype], BODIES[body], q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "flash_decode", err)
    return o, lse, groups


decode_attention.launches = 0
decode_attention.launches_by_variant = {"mma": 0, "tf32x3": 0, "core": 0}
decode_attention.launches_by_groups = {}     # head groups NG -> launches
decode_attention.launches_by_splits = {}     # n_split -> launches
decode_attention.last_n_split = None
decode_attention.last_groups = None          # (NG, Gc) of the last launch


# ------------------------------------------------- a head-dim-split cache
def _odd16(n_bytes: int) -> int:
    """A staged row of ``n_bytes``: an odd number of 16-byte pieces
    (decode_hd.cu ``odd16``), so 8 rows read together meet no bank
    conflict."""
    return 16 * ((n_bytes // 16) | 1)


def _scores_row(n_bytes: int, es: int) -> int:
    """A staged row of pass 1's ring (decode_hd.cu ``scores_row``): bf16
    ``_odd16``; float32 64 mod 128 bytes, so the two rows whose float4
    pieces a quarter warp reads meet no bank conflict."""
    if es == 2:
        return _odd16(n_bytes)
    return n_bytes + (192 - n_bytes % 128) % 128


@functools.lru_cache(maxsize=256)
def _scores_geometry(B: int, C: int, H: int, Hkv: int, Dl: int, es: int,
                     n_sm: int = N_SM) -> Optional[Dict[str, int]]:
    """Pass 1's ring launch: ``tile`` slots a tile (a power of two, 16 to
    RING_MAX_TILE, the most whose K rows fit RING_K_STAGE bytes, halved
    while the rows' tiles number fewer than ``SCORES_FILL[es]`` an SM),
    ``SCORES_STAGES[es]`` stages of ``smem`` bytes in all, and ``blocks``
    persistent blocks (as many an SM as fit, at most
    ``SCORES_BLOCKS[es]``, never more than the tiles).  bf16: 3 stages,
    2 blocks an SM (4 stages measured no faster on the H100), tiles
    halved below half a tile an SM; float32: 2 stages and up to 4 blocks
    an SM of half the threads, which measured faster than 3 stages in 2
    blocks on its longer products, and tiles halved below 4 an SM (short
    rows ran faster in more, smaller tiles).  None where no ring fits a
    block's shared memory."""
    slot = Hkv * Dl * es
    tile = 16
    while tile < RING_MAX_TILE and 2 * tile * slot <= RING_K_STAGE:
        tile *= 2
    while tile > 16 and B * -(-C // tile) < SCORES_FILL[es] * n_sm:
        tile //= 2
    smem = SCORES_STAGES[es] * (H * _scores_row(Dl * es, es)
                                + tile * _scores_row(slot, es))
    for per_sm in range(SCORES_BLOCKS[es], 0, -1):
        if smem <= MAX_SMEM and per_sm * (smem + SMEM_RESERVED) <= SM_SMEM:
            return dict(tile=tile, smem=smem,
                        blocks=min(B * -(-C // tile), per_sm * n_sm))
    return None


@functools.lru_cache(maxsize=256)
def _pv_geometry(B: int, C: int, H: int, Hkv: int, Dl: int, es: int,
                 n_sm: int = N_SM) -> Optional[Dict[str, int]]:
    """Pass 2's ring launch.  A block serves one unit (KV head, group of
    <= 16 heads, chunk of <= 64 dims) of a split of a row, ``gy`` units a
    row; each of its PV_WARPS warps walks its own tiles of ``tile`` slots
    (32 where a stage of them holds at most RING_PV_STAGE bytes, else 16)
    through its own ring of PV_STAGES stages; ``smem`` bytes a block;
    ``blocks_per_sm`` the blocks an SM holds (the waves ``_wave_splits``
    fills).  None where no ring fits."""
    G = H // Hkv
    gy = Hkv * -(-G // UNIT_ROWS) * -(-Dl // UNIT_DIMS)
    gr, dw = min(G, UNIT_ROWS), min(Dl, UNIT_DIMS)

    def stage(tile):
        return gr * (tile + 8) * 4 + tile * _odd16(dw * es)

    tile = 32 if stage(32) <= RING_PV_STAGE else 16
    smem = max(PV_WARPS * PV_STAGES * stage(tile),
               PV_WARPS * UNIT_ROWS * (dw + 2) * 4)
    if smem > MAX_SMEM:
        return None
    return dict(gy=gy, tile=tile, smem=smem,
                blocks_per_sm=max(1, min(RING_PV_BLOCKS,
                                         SM_SMEM // (smem + SMEM_RESERVED))))


def _variant(dtype: torch.dtype, Dl: int, tensors, fits: bool = True) -> str:
    """The body that serves a pass: ``"ring"`` (float32 or bfloat16) where
    16-byte copies reach every row piece (``Dl`` elements of ``dtype`` a
    multiple of 16 bytes, each tensor 16-byte aligned with every stride
    but the last a multiple of 16 bytes) and its ring ``fits`` a block;
    else ``"simt"``."""
    es = torch.finfo(dtype).bits // 8
    if dtype not in _DTYPES or not fits or (Dl * es) % 16:
        return "simt"
    for t in tensors:
        if t.data_ptr() % 16 or any((st * es) % 16 for st in t.stride()[:-1]):
            return "simt"
    return "ring"


def _hd_lib() -> ctypes.CDLL:
    lib = _build.load("decode_hd")
    fn = lib.decode_scores
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 5
                       + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn = lib.decode_softmax_pv
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 3
                       + [ctypes.c_int] * 10 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        # the ring bodies: the same, with their geometry in NG's place
        fn = lib.decode_scores_ring
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 5
                       + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn = lib.decode_softmax_pv_ring
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 3
                       + [ctypes.c_int] * 10 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _on_card(name: str, *tensors: torch.Tensor) -> bool:
    """False for CPU and meta tensors (the plain version runs; on meta it
    gives only its shapes, as the dry-run needs), True for CUDA ones;
    raises for any other device or for tensors on different devices."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: inputs on different devices")
    if dev.type in ("cpu", "meta"):
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    return True


def _last_dim_dense(name: str, *tensors: torch.Tensor) -> None:
    """The kernels take any strides but a unit one on the last dim (a
    slice of the head dim of a whole cache is such a view)."""
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError(f"{name}: the last dim must be contiguous")


def decode_scores(
    q: torch.Tensor,          # [B, H, Dl]
    k: torch.Tensor,          # [B, C, Hkv, Dl]
    *,
    scale: float,
) -> torch.Tensor:
    """Pass 1 of the decode over a head-dim slice: ``scale * q . k`` over
    the slice, float32 ``[B, H, C]``, no mask.  The caller sums it over
    the slices (an all-reduce over the ranks that hold them) and hands the
    sum to ``decode_softmax_pv``."""
    B, H, Dl = q.shape
    Bk, C, Hkv, Dk = k.shape
    if Bk != B or Dk != Dl or H % Hkv:
        raise ValueError(f"decode_scores: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} (needs H % Hkv == 0)")
    if k.dtype != q.dtype or q.dtype not in _DTYPES:
        raise ValueError(f"decode_scores: dtypes q {q.dtype} k {k.dtype} "
                         "(float32 or bfloat16, both equal)")
    if not _on_card("decode_scores", q, k):
        return decode_scores_ref(q, k, scale=scale)
    _last_dim_dense("decode_scores", q, k)
    variant = _scores_variant(q, k)
    s = _launch_scores(q, k, scale, variant)
    decode_scores.launches += 1
    decode_scores.launches_by_variant[variant] += 1
    return s


def _scores_variant(q: torch.Tensor, k: torch.Tensor) -> str:
    """Pass 1's body: the ring where 16-byte copies reach every row piece
    and its ring fits a block (``_variant``), in either dtype."""
    B, H, Dl = q.shape
    _, C, Hkv, _ = k.shape
    geo = _scores_geometry(B, C, H, Hkv, Dl, q.element_size(),
                           _sm_count(q.device))
    return _variant(q.dtype, Dl, (q, k), geo is not None)


def _launch_scores(q: torch.Tensor, k: torch.Tensor, scale: float,
                   variant: str) -> torch.Tensor:
    """Pass 1's ``variant`` body on CUDA tensors that ``decode_scores``
    has checked; not counted (the wrapper counts, and ``chip_smoke.py``
    holds each body to the plain version through it)."""
    B, H, Dl = q.shape
    _, C, Hkv, _ = k.shape
    if variant == "ring":
        geo = _scores_geometry(B, C, H, Hkv, Dl, q.element_size(),
                               _sm_count(q.device))
        if geo is None or _variant(q.dtype, Dl, (q, k)) != "ring":
            raise ValueError(f"decode_scores: the ring body does not take "
                             f"q {tuple(q.shape)} k {tuple(k.shape)}")
    s = torch.empty((B, H, C), dtype=torch.float32, device=q.device)
    head = (q.data_ptr(), k.data_ptr(), s.data_ptr(), q.stride(0),
            q.stride(1), k.stride(0), k.stride(1), k.stride(2), B, C, Hkv,
            H // Hkv, Dl)
    tail = (float(scale), _DTYPES[q.dtype], q.device.index or 0,
            torch.cuda.current_stream(q.device).cuda_stream)
    lib = _hd_lib()
    if variant == "ring":
        name = "decode_scores_ring"
        err = lib.decode_scores_ring(*head, geo["tile"], geo["blocks"],
                                     *tail)
    else:
        name = "decode_scores"
        err = lib.decode_scores(*head, _head_groups(H // Hkv, "core")[0],
                                *tail)
    _build.check(lib, name, err)
    return s


def decode_softmax_pv(
    s: torch.Tensor,          # [B, H, C] float32, summed over the slices
    v: torch.Tensor,          # [B, C, Hkv, Dl]
    q_pos: torch.Tensor,      # [B] int32
    k_pos: torch.Tensor,      # [B, C] int32
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Pass 2 of the decode over a head-dim slice: K3's masks on the
    summed scores, the float32 softmax and p . v on the slice of V;
    ``[B, H, Dl]`` in v's dtype, 0 for a head that attends no slot.  The
    launch's split count is left in ``decode_softmax_pv.last_n_split``."""
    B, H, C = s.shape
    Bv, Cv, Hkv, Dl = v.shape
    if ((Bv, Cv) != (B, C) or H % Hkv or tuple(q_pos.shape) != (B,)
            or tuple(k_pos.shape) != (B, C)):
        raise ValueError(f"decode_softmax_pv: shapes s {tuple(s.shape)} v "
                         f"{tuple(v.shape)} q_pos {tuple(q_pos.shape)} "
                         f"k_pos {tuple(k_pos.shape)} (needs H % Hkv == 0)")
    if s.dtype != torch.float32 or v.dtype not in _DTYPES:
        raise ValueError(f"decode_softmax_pv: dtypes s {s.dtype} v "
                         f"{v.dtype} (s float32, v float32 or bfloat16)")
    if q_pos.dtype != torch.int32 or k_pos.dtype != torch.int32:
        raise ValueError("decode_softmax_pv: q_pos and k_pos must be int32")
    if not _on_card("decode_softmax_pv", s, v, q_pos, k_pos):
        return decode_softmax_pv_ref(s, v, q_pos, k_pos, window=window)
    _last_dim_dense("decode_softmax_pv", v)
    if not all(t.is_contiguous() for t in (s, q_pos, k_pos)):
        raise ValueError("decode_softmax_pv: s, q_pos and k_pos must be "
                         "contiguous")
    variant = _variant(v.dtype, Dl, (v,), _pv_geometry(
        B, C, H, Hkv, Dl, v.element_size(), _sm_count(v.device)) is not None)
    o, n_split = _launch_softmax_pv(s, v, q_pos, k_pos, window, variant)
    decode_softmax_pv.launches += 1
    decode_softmax_pv.launches_by_variant[variant] += 1
    decode_softmax_pv.last_n_split = n_split
    return o


def _launch_softmax_pv(s: torch.Tensor, v: torch.Tensor,
                       q_pos: torch.Tensor, k_pos: torch.Tensor,
                       window: Optional[int], variant: str,
                       n_split: Optional[int] = None):
    """Pass 2's ``variant`` body on CUDA tensors that ``decode_softmax_pv``
    has checked, with ``n_split`` splits (None: the body's own count);
    returns ``(o, n_split)``, not counted."""
    B, H, C = s.shape
    _, _, Hkv, Dl = v.shape
    G = H // Hkv
    n_sm = _sm_count(s.device)
    if variant == "ring":
        geo = _pv_geometry(B, C, H, Hkv, Dl, v.element_size(), n_sm)
        if geo is None or _variant(v.dtype, Dl, (v,)) != "ring":
            raise ValueError(f"decode_softmax_pv: the ring body does not "
                             f"take v {tuple(v.shape)}")
    o = torch.empty((B, H, Dl), dtype=v.dtype, device=v.device)
    if variant == "ring":
        # whole waves of the blocks an SM holds, >= 2 tiles a warp
        if n_split is None:
            n_split = _wave_splits(B, geo["gy"], C, n_sm,
                                   geo["blocks_per_sm"], MIN_RING_TILES,
                                   geo["tile"])
        scratch = _ring_scratch(B, geo["gy"], n_split, v.device)
    else:
        ND = -(-Dl // PV_CHUNK)     # chunks of dims, a block each
        # a block walks its tiles one at a time, so an SM needs several
        # (PV_WAVES) to keep HBM busy; about 4 fit an SM at once, so the
        # count is rounded down to whole waves
        groups = _head_groups(G, "core")    # the CUDA-core body's
        if n_split is None:
            n_split = _wave_splits(B, Hkv * ND * groups[0], C, n_sm,
                                   PV_WAVES, MIN_PV_TILES, PV_TILE)
        scratch = _split_scratch(B, Hkv * ND, groups, PV_CHUNK, n_split,
                                 v.device)
    head = (s.data_ptr(), v.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(),
            o.data_ptr(), *(0 if t is None else t.data_ptr() for t in scratch),
            v.stride(0), v.stride(1), v.stride(2), B, C, Hkv, G, Dl, n_split,
            -1 if window is None else int(window))
    tail = (_DTYPES[v.dtype], v.device.index or 0,
            torch.cuda.current_stream(v.device).cuda_stream)
    lib = _hd_lib()
    if variant == "ring":
        name = "decode_softmax_pv_ring"
        err = lib.decode_softmax_pv_ring(*head, geo["tile"], *tail)
    else:
        name = "decode_softmax_pv"
        err = lib.decode_softmax_pv(*head, groups[0], *tail)
    _build.check(lib, name, err)
    return o, n_split


def _ring_scratch(B: int, gy: int, n_split: int, device: torch.device):
    """The ring body's merge scratch: per (row, unit) and split, fp32 acc
    [16, 64] and (m, l) [16, 2], and the tickets; ``(None,) * 3`` for one
    split."""
    if n_split == 1:
        return None, None, None
    blocks = B * gy * n_split * UNIT_ROWS
    return (torch.empty(blocks * UNIT_DIMS, dtype=torch.float32,
                        device=device),
            torch.empty(blocks * 2, dtype=torch.float32, device=device),
            _counters(device, B * gy))


decode_scores.launches = 0
decode_scores.launches_by_variant = {"ring": 0, "simt": 0}
decode_softmax_pv.launches = 0
decode_softmax_pv.launches_by_variant = {"ring": 0, "simt": 0}
decode_softmax_pv.last_n_split = None
