"""Search spaces of the port's kernels for the autotuner.

One ``KernelSpace`` per kernel: the knobs its wrapper reads
(``kernels.tuning.BUILTIN_DEFAULTS``) with their candidate values, the
shape buckets to sweep, and analytic models of the work one launch of
the port's bfloat16 kernel executes, knob by knob: FLOPs, bytes and grid
steps counted from the launch parameters the wrapper derives from the
knob (K1's tile walk ``_tile_plan``, K3's and K2's split count, K4's
chunks of its two passes), so padding and per-split merges show up as
executed work the tuner trades against.

``feasible`` is decided by the wrapper's own limits and the card's shared
memory per block (each kernel's layout at that D), not by a TPU VMEM
budget.  The bf16 kernels modelled here are the tensor-core ones: K1 at
D 64 / 128, K3 and K2 at D 64 / 128, K4 at D 64..512.

Buckets: one batch and one head layout per kernel, sizes from the main
path's shape to the long shape of the kernel table, so that
``CostDB.interpolated_time`` interpolates along one axis:

* K1: qwen-distill-1.5b's 12 / 2 heads at D 128, B 4, S 160 / 1024 / 4096
  (the kernel table's long shape is B 4 x 4096);
* K3 and K2: the same heads, B 32, C 256 / 2048 / 8192 (every slot valid);
* K4: xlstm-1.3b's 4 heads at D 512, B 8, S 160 / 4096.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch

from ..kernels.decode_attention import ops as decode_ops
from ..kernels.flash_attention import ops as flash_ops
from ..kernels.paged_attention import ops as paged_ops
from ..kernels.ssm_scan import ops as scan_ops

BF16 = 2
F32 = 4
SMEM_PER_BLOCK = 227 * 1024      # Hopper's opt-in shared memory per block
N_SM = decode_ops.N_SM           # the H100's SMs, which the split rule fills


@dataclass(frozen=True)
class ShapeBucket:
    """One point of the sweep grid; ``size`` is the bucket's interpolation
    coordinate (the dimension the cost scales with — sequence/cache len)."""

    name: str
    dims: Tuple[Tuple[str, int], ...]

    @property
    def d(self) -> Dict[str, int]:
        return dict(self.dims)

    @property
    def size(self) -> int:
        d = self.d
        return d.get("S") or d.get("C") or 0

    @staticmethod
    def make(name: str, **dims: int) -> "ShapeBucket":
        return ShapeBucket(name=name, dims=tuple(sorted(dims.items())))


def _cdiv(n: int, m: int) -> int:
    return -(-n // m)


@dataclass
class KernelSpace:
    name: str
    knobs: Dict[str, Sequence[int]]
    shapes: List[ShapeBucket]
    tiny_shapes: List[ShapeBucket]
    tiny_knobs: Dict[str, Sequence[int]]

    def configs(self, tiny: bool = False) -> List[Dict[str, int]]:
        knobs = self.tiny_knobs if tiny else self.knobs
        names = sorted(knobs)
        return [dict(zip(names, vals))
                for vals in itertools.product(*(knobs[n] for n in names))]

    def buckets(self, tiny: bool = False) -> List[ShapeBucket]:
        return self.tiny_shapes if tiny else self.shapes

    # --- analytic models (overridden per kernel below) ---------------------
    def flops(self, shape: ShapeBucket, cfg: Dict[str, int]) -> float:
        """FLOPs the kernel executes, padding included."""
        raise NotImplementedError

    def useful_flops(self, shape: ShapeBucket) -> float:
        """FLOPs the math needs (the kernel table's bound counts these)."""
        raise NotImplementedError

    def bytes_moved(self, shape: ShapeBucket, cfg: Dict[str, int]) -> float:
        """Bytes the kernel's blocks read and write, scratch included."""
        raise NotImplementedError

    def smem_bytes(self, shape: ShapeBucket, cfg: Dict[str, int]) -> int:
        raise NotImplementedError

    def grid_steps(self, shape: ShapeBucket, cfg: Dict[str, int]) -> int:
        raise NotImplementedError

    def fits_wrapper(self, shape: ShapeBucket, cfg: Dict[str, int]) -> bool:
        raise NotImplementedError

    def launch_key(self, shape: ShapeBucket, cfg: Dict[str, int]) -> Tuple:
        """The parameters the wrapper launches with under ``cfg``: configs
        with the same key launch the same kernel the same way."""
        raise NotImplementedError

    def feasible(self, shape: ShapeBucket, cfg: Dict[str, int],
                 device_type: str) -> bool:
        """The wrapper takes the launch and its layout fits a block's
        shared memory (every device type here is a Hopper card or is
        priced for the port's Hopper kernels)."""
        return (self.fits_wrapper(shape, cfg)
                and self.smem_bytes(shape, cfg) <= SMEM_PER_BLOCK)


# ------------------------------------------------------------ flash attention
class FlashAttentionSpace(KernelSpace):
    """K1, causal [B, S, H, D] self-attention on the tensor-core kernel
    (``csrc/flash_attention_fwd_sm90.cu``): one block per ROWS packed
    (position, head) rows of a (b, KV head), walking KEYS-key tiles.  Its
    tiles are compile-time constants, so the space has one config."""

    def _walk(self, shape: ShapeBucket) -> int:
        """Key tiles the blocks of one (b, KV head) visit."""
        d = shape.d
        return sum(len(tiles) for _, _, tiles in flash_ops._tile_plan(
            d["S"], d["S"], d["H"] // d["Hkv"], True, None))

    def flops(self, shape, cfg):
        d = shape.d
        # every visited tile is a ROWS x KEYS score tile, QK^T + PV
        return (4.0 * d["B"] * d["Hkv"] * self._walk(shape)
                * cfg["rows"] * cfg["keys"] * d["D"])

    def useful_flops(self, shape):
        d = shape.d
        return 4.0 * d["B"] * d["H"] * d["D"] * d["S"] * (d["S"] + 1) / 2.0

    def bytes_moved(self, shape, cfg):
        d = shape.d
        # q read and o written once; each visited tile's K and V rows
        return BF16 * d["D"] * (2.0 * d["B"] * d["S"] * d["H"]
                                + 2.0 * d["B"] * d["Hkv"] * self._walk(shape)
                                * cfg["keys"])

    def smem_bytes(self, shape, cfg):
        # Layout<D>: the Q tile and a 3-stage ring of K and V tiles
        chunks = shape.d["D"] // 64
        return (cfg["rows"] * 128 * chunks
                + 2 * 3 * cfg["keys"] * 128 * chunks + 1024)

    def grid_steps(self, shape, cfg):
        d = shape.d
        return d["B"] * d["Hkv"] * self._walk(shape)

    def launch_key(self, shape, cfg):
        return (cfg["rows"], cfg["keys"])

    def fits_wrapper(self, shape, cfg):
        d = shape.d
        return (d["H"] % d["Hkv"] == 0
                and flash_ops._variant(torch.bfloat16, d["D"]) == "wgmma"
                and (cfg["rows"], cfg["keys"]) == (flash_ops.ROWS,
                                                   flash_ops.KEYS))


# ------------------------------------------------------------ split decode
class _SplitDecodeSpace(KernelSpace):
    """K3 and K2: one-token GQA decode on ``csrc/split_decode.cuh``'s
    tensor-core body, the cache cut into ``n_split`` runs of whole tiles
    per (row, KV head, head group), whose fp32 partials merge in the
    launch."""

    def n_split(self, shape: ShapeBucket, cfg: Dict[str, int]) -> int:
        raise NotImplementedError

    def launch_key(self, shape, cfg):
        return (self.n_split(shape, cfg), cfg.get("page_size"))

    def _groups(self, shape, cfg):
        """(NG, Gc): the head groups the wrapper launches the shape in."""
        raise NotImplementedError

    def _slots(self, shape):
        """Slots a row's splits walk: its tiles, the last one padded."""
        return _cdiv(shape.d["C"], decode_ops.TILE) * decode_ops.TILE

    def flops(self, shape, cfg):
        d = shape.d
        ng, gc = self._groups(shape, cfg)
        return 4.0 * d["B"] * d["Hkv"] * ng * gc * d["D"] * self._slots(shape)

    def useful_flops(self, shape):
        d = shape.d
        return 4.0 * d["B"] * d["H"] * d["D"] * d["C"]

    def bytes_moved(self, shape, cfg):
        d = shape.d
        ng, gc = self._groups(shape, cfg)
        blocks = d["B"] * d["Hkv"] * ng
        n = self.n_split(shape, cfg)
        kv = 2.0 * BF16 * blocks * self._slots(shape) * d["D"]
        qo = 2.0 * BF16 * d["B"] * d["H"] * d["D"]
        # each split writes its (acc, m, l) partial and the last reads all
        merge = 2.0 * F32 * blocks * n * gc * (d["D"] + 2) if n > 1 else 0.0
        return kv + qo + merge + self._index_bytes(shape, cfg)

    def _index_bytes(self, shape, cfg) -> float:
        raise NotImplementedError

    def smem_bytes(self, shape, cfg):
        # split_decode.cuh::mma_smem_bytes: 4 warps x 3 stages of K and V
        # tiles, or the merge's partials, whichever is larger
        d = shape.d
        _, gc = self._groups(shape, cfg)
        stages = 4 * 3 * 2 * decode_ops.TILE * (2 * d["D"] + 16)
        merge = F32 * 4 * gc * (d["D"] + 2) + 16
        return max(stages, merge)

    def grid_steps(self, shape, cfg):
        d = shape.d
        ng, _ = self._groups(shape, cfg)
        return d["B"] * d["Hkv"] * ng * self.n_split(shape, cfg)

    def fits_wrapper(self, shape, cfg):
        d = shape.d
        return d["H"] % d["Hkv"] == 0 and d["D"] in (64, 128)


class DecodeAttentionSpace(_SplitDecodeSpace):
    """K3 over the dense cache [B, C, Hkv, D], every slot valid."""

    def n_split(self, shape, cfg):
        d = shape.d
        return decode_ops._launch_splits(
            d["B"], d["H"], d["Hkv"], d["D"], d["C"], N_SM,
            decode_ops._h100_resident(d["D"]), cfg["min_split_tiles"])

    def _groups(self, shape, cfg):
        d = shape.d
        return decode_ops._launch_groups(
            d["B"], d["H"] // d["Hkv"], d["Hkv"], d["D"], d["C"], N_SM,
            decode_ops._h100_resident(d["D"]), cfg["min_split_tiles"], "mma")

    def _index_bytes(self, shape, cfg):
        d = shape.d
        ng, _ = self._groups(shape, cfg)
        # k_pos of every walked slot, per block; q_pos
        return F32 * (d["B"] * d["Hkv"] * ng * self._slots(shape) + d["B"])


class PagedAttentionSpace(_SplitDecodeSpace):
    """K2 over a paged pool [P, page, Hkv, D] through block tables of
    ``ceil(C / page)`` pages, every row's length C.  The page size decides
    the table width, which decides the split count (``_paged_splits``
    counts over the table's reach, no longest length given); the kernel
    walks 16-slot tiles whatever the page."""

    def _maxp(self, shape, cfg):
        return _cdiv(shape.d["C"], cfg["page_size"])

    def n_split(self, shape, cfg):
        d = shape.d
        return paged_ops._paged_splits(
            d["B"], d["Hkv"], d["D"], self._maxp(shape, cfg),
            cfg["page_size"], None, N_SM, decode_ops._h100_resident(d["D"]),
            d["H"] // d["Hkv"], cfg["min_split_tiles"])

    def _groups(self, shape, cfg):
        d = shape.d
        return paged_ops._paged_groups(
            d["B"], d["H"] // d["Hkv"], d["Hkv"], d["D"],
            self._maxp(shape, cfg), cfg["page_size"], None, N_SM,
            decode_ops._h100_resident(d["D"]), cfg["min_split_tiles"], "mma")

    def _index_bytes(self, shape, cfg):
        d = shape.d
        return F32 * d["B"] * (self._maxp(shape, cfg) + 1)   # tables, lengths


# ---------------------------------------------------------------- mLSTM scan
class SsmScanSpace(KernelSpace):
    """K4 on the tensor-core kernel (``csrc/mlstm_scan_sm90.cu``) at
    [B, S, H, D]: an intra-chunk pass (one block per row) and a carry pass
    (grid (B*H, D / 64)), both over ``ceil(S / chunk)`` chunks of a 64-row
    tile whose steps past the chunk are zero-filled, so a chunk below 64
    executes a whole tile's products for fewer steps."""

    T = scan_ops.MAX_CHUNK       # rows of the kernels' tile
    DV = 64                      # value columns a carry block owns

    def _chunks(self, shape, cfg):
        return _cdiv(shape.d["S"], cfg["chunk"])

    def flops(self, shape, cfg):
        d = shape.d
        T, D = self.T, d["D"]
        # q k^T and P v (T^2 D each), q C and the C update (T D^2 each)
        return (d["B"] * d["H"] * self._chunks(shape, cfg)
                * (4.0 * T * T * D + 4.0 * T * D * D))

    def useful_flops(self, shape):
        d = shape.d
        T, D = self.T, d["D"]
        return (d["B"] * d["H"] * _cdiv(d["S"], T)
                * (4.0 * T * T * D + 4.0 * T * D * D))

    def bytes_moved(self, shape, cfg):
        d = shape.d
        S, D, T = d["S"], d["D"], self.T
        nc = self._chunks(shape, cfg)
        carry_blocks = D // self.DV
        scratch = nc * (2 * T * T * BF16 + 4 * T * F32)   # P planes, scalars
        per_row = (2 * S * D * BF16 + 2 * S * F32         # intra: q, k, gates
                   + scratch                               # intra writes
                   + carry_blocks * (2 * S * D * BF16 + scratch)
                   + S * D * BF16                          # carry: v
                   + S * D * BF16)                         # h
        return float(d["B"] * d["H"] * per_row)

    def smem_bytes(self, shape, cfg):
        D, T, pad = shape.d["D"], self.T, 8
        ld_qk, ld_p = D + pad, T + pad
        intra = 2 * T * ld_qk * BF16 + F32 * (D + 9 * T + 4)
        carry = (2 * T * ld_qk * BF16 + 3 * T * ld_p * BF16
                 + F32 * (4 * 32 * 32 + 4 * T))
        return max(intra, carry)

    def grid_steps(self, shape, cfg):
        d = shape.d
        return (d["B"] * d["H"] * self._chunks(shape, cfg)
                * (1 + d["D"] // self.DV))

    def launch_key(self, shape, cfg):
        return (cfg["chunk"],)

    def fits_wrapper(self, shape, cfg):
        d = shape.d
        return (1 <= cfg["chunk"] <= scan_ops.MAX_CHUNK
                and scan_ops._variant(torch.bfloat16, d["D"]) == "mma"
                and d["B"] * d["H"] <= 65535)


FLASH_ATTENTION = FlashAttentionSpace(
    name="flash_attention",
    knobs={"rows": (flash_ops.ROWS,), "keys": (flash_ops.KEYS,)},
    tiny_knobs={"rows": (flash_ops.ROWS,), "keys": (flash_ops.KEYS,)},
    shapes=[ShapeBucket.make(f"b4_s{s}_h12_kv2_d128",
                             B=4, S=s, H=12, Hkv=2, D=128)
            for s in (160, 1024, 4096)],
    tiny_shapes=[ShapeBucket.make("b4_s160_h12_kv2_d128",
                                  B=4, S=160, H=12, Hkv=2, D=128)],
)

_SPLIT_TILES = (1, 2, 4, 8, 16, 32, 64)

DECODE_ATTENTION = DecodeAttentionSpace(
    name="decode_attention",
    knobs={"min_split_tiles": _SPLIT_TILES},
    tiny_knobs={"min_split_tiles": (4, 8, 16, 32)},
    shapes=[ShapeBucket.make(f"b32_c{c}_h12_kv2_d128",
                             B=32, C=c, H=12, Hkv=2, D=128)
            for c in (256, 2048, 8192)],
    tiny_shapes=[ShapeBucket.make("b32_c256_h12_kv2_d128",
                                  B=32, C=256, H=12, Hkv=2, D=128)],
)

PAGED_ATTENTION = PagedAttentionSpace(
    name="paged_attention",
    knobs={"page_size": (16, 64, 128, 256), "min_split_tiles": _SPLIT_TILES},
    tiny_knobs={"page_size": (64, 128), "min_split_tiles": (8, 16)},
    shapes=[ShapeBucket.make(f"b32_c{c}_h12_kv2_d128",
                             B=32, C=c, H=12, Hkv=2, D=128)
            for c in (256, 2048, 8192)],
    tiny_shapes=[ShapeBucket.make("b32_c256_h12_kv2_d128",
                                  B=32, C=256, H=12, Hkv=2, D=128)],
)

SSM_SCAN = SsmScanSpace(
    name="ssm_scan",
    knobs={"chunk": (16, 32, 64)},
    tiny_knobs={"chunk": (32, 64)},
    shapes=[ShapeBucket.make(f"b8_s{s}_h4_d512", B=8, S=s, H=4, D=512)
            for s in (160, 4096)],
    tiny_shapes=[ShapeBucket.make("b8_s160_h4_d512",
                                  B=8, S=160, H=4, D=512)],
)

SPACES: Dict[str, KernelSpace] = {
    s.name: s for s in (FLASH_ATTENTION, DECODE_ATTENTION, PAGED_ATTENTION,
                        SSM_SCAN)
}
