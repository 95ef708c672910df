"""Roofline terms of a traced sharded program (the dry-run profile), the
port of ``repro.launch.roofline``.

Three terms per (arch × shape × mesh), in seconds:

  compute    = FLOPs_per_rank / peak_FLOP/s
  memory     = bytes_per_rank / HBM_bw
  collective = wire_bytes_per_rank / link_bw

Sources: ``OpCounter``, a dispatch mode under DTensor that sees each
rank's local ops on the meta device: FLOPs from torch's flop formulas
(``torch.utils.flop_counter``), bytes as each op's inputs read once and
outputs written once (views move nothing), and the functional
collectives DTensor issues, with their wire bytes estimated from the
result shapes and group sizes as ``parse_collectives`` does for XLA's HLO
text.  In eager PyTorch every op is its own kernel, so the bytes are the
traffic the port generates, not a fused estimate.  Whether the counter
reports per-rank or global numbers is calibrated once per process over a
known sharded matmul (``calibrate_cost_analysis``), as the reference
calibrates XLA's ``cost_analysis``.

``parse_collectives`` and its helpers are kept for parity on the
reference's HLO strings; the port never emits HLO.

Hardware constants: NVIDIA H100 SXM5 data sheet (the card is
``NVIDIA H100 80GB HBM3, 700 W``): dense bf16 989 TFLOP/s, HBM3
3.35 TB/s, NVLink 450 GB/s per direction.  Every term is modelled from
these figures, not measured.
"""
from __future__ import annotations

import json
import re
from dataclasses import asdict, dataclass, field
from typing import Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

HARDWARE = "NVIDIA H100 80GB HBM3, 700 W (SXM5 data sheet)"
PEAK_FLOPS = 989e12        # dense bf16 per card
HBM_BW = 3.35e12           # bytes/s per card
LINK_BW = 4.5e11           # bytes/s per card, NVLink, one direction

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_COLL_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute")


def _shape_bytes(dtype: str, dims: str) -> int:
    b = _DTYPE_BYTES.get(dtype)
    if b is None:
        return 0
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * b


def _line_result_bytes(line: str, op: str) -> int:
    """Sum shape bytes on the LHS of '=' (handles tuple results)."""
    lhs = line.split(f" {op}")[0]
    if "=" in lhs:
        lhs = lhs.split("=", 1)[1]
    return sum(_shape_bytes(dt, dims) for dt, dims in _SHAPE_RE.findall(lhs))


def _group_size(line: str) -> Optional[int]:
    m = re.search(r"replica_groups=\{\{([\d,]+)\}", line)
    if m:
        return len(m.group(1).split(","))
    m = re.search(r"replica_groups=\[(\d+),(\d+)\]", line)
    if m:                       # iota v2 form: [num_groups, group_size]
        return int(m.group(2))
    return None


@dataclass
class CollectiveStats:
    counts: Dict[str, int] = field(default_factory=dict)
    result_bytes: Dict[str, int] = field(default_factory=dict)
    wire_bytes: Dict[str, float] = field(default_factory=dict)

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.wire_bytes.values())


def parse_collectives(hlo_text: str) -> CollectiveStats:
    """Scan optimized HLO for collectives; estimate per-device wire bytes.

    Ring estimates per op (shapes are per-partition):
      all-reduce       2·(g−1)/g · result   (reduce-scatter + all-gather)
      all-gather       (g−1)/g · result     (result = gathered buffer)
      reduce-scatter   (g−1)·result         (input = g · result)
      all-to-all       (g−1)/g · result
      collective-permute  result
    """
    st = CollectiveStats()
    for line in hlo_text.splitlines():
        stripped = line.strip()
        for op in _COLL_OPS:
            # match `op(`, `op-start(` but not `-done(`
            if f" {op}(" in stripped or f" {op}-start(" in stripped:
                rb = _line_result_bytes(stripped,
                                        op + ("-start" if f" {op}-start(" in
                                              stripped else ""))
                g = _group_size(stripped) or 2
                if op == "all-reduce":
                    wb = 2.0 * (g - 1) / g * rb
                elif op == "all-gather":
                    wb = (g - 1) / g * rb
                elif op == "reduce-scatter":
                    wb = (g - 1) * rb
                elif op == "all-to-all":
                    wb = (g - 1) / g * rb
                else:
                    wb = float(rb)
                st.counts[op] = st.counts.get(op, 0) + 1
                st.result_bytes[op] = st.result_bytes.get(op, 0) + rb
                st.wire_bytes[op] = st.wire_bytes.get(op, 0.0) + wb
                break
    return st


# ------------------------------------------------------- the op counter
_FUNCOL = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "wait_tensor"}


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(t) for t in x)
    return 0


def _pg_size(name) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


class OpCounter(TorchDispatchMode):
    """Per-rank FLOPs, bytes and collectives of the plain (local) ops on
    the meta device run inside the mode.  Ops on DTensors are handed back to DTensor
    (``NotImplemented``) so that the mode sees the local ops and the
    collectives it lowers them to, as ``CommDebugMode`` does."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.coll = CollectiveStats()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out      # DTensor's shape propagation, not a rank's op
        if not _on_meta(args, out):
            return out      # DTensor's own host bookkeeping
        packet = func._overloadpacket
        name = packet.__name__
        if name in _FUNCOL:
            op = _FUNCOL[name]
            rb = _tensor_bytes(out)
            g = _pg_size(args[-1])
            wb = _wire_bytes(op, rb, g)
            c = self.coll
            c.counts[op] = c.counts.get(op, 0) + 1
            c.result_bytes[op] = c.result_bytes.get(op, 0) + rb
            c.wire_bytes[op] = c.wire_bytes.get(op, 0.0) + wb
            return out
        if packet in self._flops:
            self.flops += float(self._flops[packet](*args, **kwargs,
                                                    out_val=out))
        if name not in _FREE and not _is_view(func):
            self.bytes += (sum(_tensor_bytes(a) for a in args)
                           + _tensor_bytes(out))
        return out


def _on_meta(args, out) -> bool:
    """Whether the op touches a meta tensor (the traced ranks' tensors;
    DTensor plans its redistributions on small host tensors)."""
    def hit(x):
        if isinstance(x, torch.Tensor):
            return x.is_meta
        if isinstance(x, (list, tuple)):
            return any(hit(t) for t in x)
        return False
    return hit(out) or any(hit(a) for a in args)


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _wire_bytes(op: str, rb: float, g: int) -> float:
    """Ring estimates per op, as ``parse_collectives`` makes them."""
    if op == "all-reduce":
        return 2.0 * (g - 1) / g * rb
    if op in ("all-gather", "all-to-all"):
        return (g - 1) / g * rb
    if op == "reduce-scatter":
        return float((g - 1) * rb)
    return float(rb)


_CALIBRATION: Dict[str, float] = {}


def calibrate_cost_analysis(mesh) -> float:
    """Determine whether ``OpCounter`` reports per-rank or global FLOPs.

    Counts a known matmul sharded over every rank of ``mesh`` (meta
    tensors, nothing runs); returns reported_flops / global_flops.
    ~1.0 → global semantics; ~1/n_ranks → per-rank semantics.  Cached per
    process and mesh size.
    """
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.device_mesh import DeviceMesh
    n = mesh.size()
    key = f"factor/{n}"
    if key in _CALIBRATION:
        return _CALIBRATION[key]
    flat = DeviceMesh(mesh.device_type, mesh.mesh.flatten(),
                      mesh_dim_names=("x",))
    dim = 512
    true_flops = 2 * dim ** 3
    meta = torch.device("meta")
    a = distribute_tensor(torch.empty(dim, dim, device=meta), flat,
                          [Shard(0)])
    b = distribute_tensor(torch.empty(dim, dim, device=meta), flat,
                          [Replicate()])
    with OpCounter() as oc:
        a @ b
    factor = oc.flops / true_flops if true_flops else 1.0
    _CALIBRATION[key] = factor
    return factor


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    hlo_gflops_per_dev: float
    hlo_gbytes_per_dev: float
    wire_gbytes_per_dev: float
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_gflops: float          # 6·N·D (train) / 2·N·B (decode), global
    useful_flops_ratio: float    # MODEL / (HLO_global)
    collectives: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)
    memory_per_dev_gb: Optional[float] = None
    notes: str = ""

    def to_json(self) -> Dict:
        return asdict(self)


def build_roofline(
    *, arch: str, shape: str, mesh_name: str, n_devices: int,
    cost: Dict, hlo_text: str, model_flops: float,
    mem_per_dev_bytes: Optional[float], calib_factor: float,
    mix_correction_flops: float = 0.0,
    collectives_override: Optional[Dict] = None,
    n_calib: Optional[int] = None,
) -> Roofline:
    """The reference's roofline from a cost dict (``flops``, ``bytes
    accessed``).  ``n_calib`` is the world the calibration ran over (the
    mesh's size; default ``n_devices``), where the reference reads
    ``len(jax.devices())``.  The port's own dry-run passes
    ``mix_correction_flops=0``: its eager trace counts every loop trip."""
    flops_reported = float(cost.get("flops", 0.0))
    bytes_reported = float(cost.get("bytes accessed", 0.0))
    n_calib = n_calib or n_devices
    per_device = calib_factor < 2.0 / n_calib
    if per_device:
        flops_dev = flops_reported
        bytes_dev = bytes_reported
    else:
        flops_dev = flops_reported / n_devices
        bytes_dev = bytes_reported / n_devices
    flops_dev += mix_correction_flops / n_devices

    coll = parse_collectives(hlo_text)
    if collectives_override is not None:
        coll = CollectiveStats(counts=collectives_override["counts"],
                               result_bytes={},
                               wire_bytes=collectives_override["wire_bytes"])
    wire_dev = coll.total_wire_bytes

    t_c = flops_dev / PEAK_FLOPS
    t_m = bytes_dev / HBM_BW
    t_l = wire_dev / LINK_BW
    terms = {"compute": t_c, "memory": t_m, "collective": t_l}
    bottleneck = max(terms, key=terms.get)

    global_flops = flops_dev * n_devices
    ratio = model_flops / global_flops if global_flops > 0 else 0.0
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, n_devices=n_devices,
        hlo_gflops_per_dev=flops_dev / 1e9,
        hlo_gbytes_per_dev=bytes_dev / 1e9,
        wire_gbytes_per_dev=wire_dev / 1e9,
        t_compute=t_c, t_memory=t_m, t_collective=t_l,
        bottleneck=bottleneck, model_gflops=model_flops / 1e9,
        useful_flops_ratio=ratio,
        collectives={k: v / 1e9 for k, v in coll.wire_bytes.items()},
        counts=coll.counts,
        memory_per_dev_gb=(mem_per_dev_bytes / 1e9
                           if mem_per_dev_bytes is not None else None),
    )


def model_flops_for_cell(cfg, shape_spec) -> float:
    """Analytic MODEL_FLOPS for one cell (global, per lowered program):
    train: 6·N_active·tokens;  prefill: 2·N_active·tokens;
    decode: 2·N_active·batch (one token each)."""
    spec = cfg.spec
    n_act = spec.params(active_only=True)
    if shape_spec.kind == "train":
        return 6.0 * n_act * shape_spec.global_batch * shape_spec.seq_len
    if shape_spec.kind == "prefill":
        return 2.0 * n_act * shape_spec.global_batch * shape_spec.seq_len
    return 2.0 * n_act * shape_spec.global_batch


# ------------------------------------------------- loop-trip flop correction
def _avg_causal_ctx(S: int, window: Optional[int]) -> float:
    """Mean attended context per query under causal (+optional SWA) mask."""
    W = min(window, S) if window else S
    # sum_{t=0..S-1} min(t, W) / S
    full = W * (W - 1) / 2.0 + (S - W) * W
    return full / S


def loop_flop_correction(cfg, shape_spec) -> float:
    """Global FLOPs executed inside chunked sequence loops that XLA's cost
    analysis under-counts (while bodies are visited once, not per trip).

    Returns  mix_total · multiplier · (1 − 1/trips)  summed over the
    sequence-mixing mechanisms of the architecture.  multiplier = 4 for
    training (fwd + remat recompute + ~2× backward), 1 for fwd-only.
    """
    kind = shape_spec.kind
    S = shape_spec.seq_len
    B = shape_spec.global_batch
    mult = 4.0 if kind == "train" else 1.0
    total = 0.0

    def attn_term(n_layers, S_q, ctx_len, kv_window, causal=True,
                  kv_cache=False):
        # 4·H·hd·ctx flops per query token per layer (QK^T + PV, fwd)
        if kv_cache:
            # single-token decode lowers UNCHUNKED (blocks.attention Sq==1
            # fast path) — no loop, fully counted by cost_analysis
            return 0.0
        ctx = (_avg_causal_ctx(S_q, kv_window) if causal else ctx_len)
        tokens = B * S_q
        trips = max(1, -(-int(ctx_len) // cfg.kv_chunk))
        flops = 4.0 * cfg.n_heads * cfg.hd * ctx * tokens * n_layers
        return flops * (1.0 - 1.0 / trips)

    fam = cfg.family
    if fam in ("dense", "vlm", "moe"):
        if kind == "decode":
            total += attn_term(cfg.n_layers, 1, S, cfg.attn_window,
                               kv_cache=True)
        else:
            total += attn_term(cfg.n_layers, S, S, cfg.attn_window)
    elif fam == "encdec":
        if kind == "decode":
            total += attn_term(cfg.n_layers, 1, S, None, kv_cache=True)
            total += attn_term(cfg.n_layers, 1, cfg.encoder_seq, None,
                               kv_cache=True)   # cross
        else:
            total += attn_term(cfg.n_layers, S, S, None)
            total += attn_term(cfg.n_layers, S, cfg.encoder_seq, None,
                               causal=False)    # cross
            total += attn_term(cfg.n_encoder_layers, cfg.encoder_seq,
                               cfg.encoder_seq, None, causal=False)
    elif fam == "ssm":
        # chunked mLSTM: per chunk ≈ 6·T²·D + 4·T·D² flops per (b, h, layer)
        T = 64
        D = cfg.hd
        if kind == "decode":
            return 0.0   # single recurrent step, no loop
        nch = max(1, -(-S // T))
        per_bh = nch * (6.0 * T * T * D + 4.0 * T * D * D)
        total += per_bh * B * cfg.n_heads * cfg.n_layers * (1 - 1.0 / nch)
    elif fam == "hybrid":
        if kind == "decode":
            total += attn_term(cfg.n_layers, 1, S, cfg.attn_window,
                               kv_cache=True)
        else:
            total += attn_term(cfg.n_layers, S, S, cfg.attn_window)
            Tc = 128
            nch = max(1, -(-S // Tc))
            ssm = 10.0 * B * S * cfg.d_model * cfg.ssm_state * cfg.n_layers
            total += ssm * (1 - 1.0 / nch)
    return total * mult
