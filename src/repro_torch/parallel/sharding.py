"""Sharding rules: param-path → spec → DTensor placements, per family.

The port of ``repro.parallel.sharding``.  Megatron-style tensor
parallelism over the "model" axis:

  embed          [V, d]        → P("model", None)        (vocab-sharded)
  lm_head        [d, V]        → P(None, "model")
  attn wq/wk/wv  [L, d, H·hd]  → P(None, None, "model")  (head dim)
  attn wo        [L, H·hd, d]  → P(None, "model", None)
  ffn  up/gate   [L, d, f]     → P(None, None, "model")
  ffn  down      [L, f, d]     → P(None, "model", None)
  MoE experts    [L, E, d, f]  → E over "model" (EP, qwen3) or f over
                                 "model" (grok — 8 experts don't divide 16)
  norms / gates / routers      → replicated

A spec (``P``) has one entry per tensor dim: ``None``, an axis name or a
tuple of axis names, exactly the reference's ``PartitionSpec`` entries
(a one-name tuple reads as the name, as JAX normalises it).  ``named``
turns a spec into DTensor placements on a ``DeviceMesh``: a dim sharded
over ("pod", "data") becomes ``Shard(d)`` on both mesh dims, which DTensor
splits in mesh-dim order, pod-major, as GSPMD does.  ``distribute`` places
a tree.

Uneven dims (yi's 56 heads, hymba's 25) are legal: GSPMD pads the last
shard, DTensor splits with ``torch.chunk`` sizes (the first shards are
the larger); ``local_max_shape`` is the largest rank's local shape.

Batch dims shard over ("pod","data").  Decode caches shard batch over
data axes and the *head-dim* (hd) over "model" — hd is a multiple of 16
for every assigned arch, unlike kv-head counts.

Optimizer states: same spec as the param, then ZeRO-1-extended over the
data axes on the largest still-unsharded, evenly-divisible dim.

Trees are the port's ``Params`` modules or nested dicts whose leaves have
a ``shape`` (tensors, meta tensors or shape records); path names are the
tree's keys.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

from repro_torch.models.api import ModelConfig
from repro_torch.models.params import Params
from .mesh import axis_names, axis_size, data_axes, model_axis


class P(tuple):
    """A partition spec: one entry per tensor dim."""

    def __new__(cls, *entries):
        norm = []
        for e in entries:
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                e = e[0] if len(e) == 1 else (e or None)
            norm.append(e)
        return super().__new__(cls, norm)

    def __reduce__(self):
        return (P, tuple(self))

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


# ------------------------------------------------------------------- helpers
def _is_tree(x) -> bool:
    return isinstance(x, (Params, Mapping))


def map_with_path(fn, tree: Any, path: Tuple[str, ...] = ()) -> Any:
    """``fn(path names, leaf)`` over a ``Params`` / nested dict; returns
    the nested dict of results."""
    if _is_tree(tree):
        return {k: map_with_path(fn, tree[k], path + (str(k),))
                for k in tree.keys()}
    return fn(path, tree)


def tree_map2(fn, a: Any, b: Any) -> Any:
    """``fn(leaf_a, leaf_b)`` over two trees of the same keys (``a`` may
    hold specs, which are tuples and so leaves)."""
    if _is_tree(a):
        return {k: tree_map2(fn, a[k], b[k]) for k in a.keys()}
    return fn(a, b)


def flat(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """The leaves keyed by dotted path, as ``optim.adamw`` keys its state."""
    out: Dict[str, Any] = {}
    if _is_tree(tree):
        for k in tree.keys():
            out.update(flat(tree[k], f"{prefix}{k}."))
        return out
    out[prefix.rstrip(".")] = tree
    return out


def _stacked(names: Tuple[str, ...]) -> bool:
    return "layers" in names or "enc_layers" in names


def _pad(spec_tail: Tuple, ndim: int, stacked: bool) -> P:
    """Prepend the layer axis (None) for stacked params; sanity-fit ndim."""
    tail = list(spec_tail)
    if stacked:
        tail = [None] + tail
    while len(tail) < ndim:
        tail = [None] + tail
    return P(*tail[:ndim])


def _ndim(leaf) -> int:
    return len(tuple(leaf.shape))


# ------------------------------------------------------------- param pspecs
def param_spec(names: Tuple[str, ...], ndim: int, cfg: ModelConfig,
               mdl: Optional[str]) -> P:
    """Sharding rule for one parameter identified by its path names."""
    if mdl is None:
        return P(*([None] * ndim))
    st = _stacked(names)
    leaf = names[-1]
    parent = names[-2] if len(names) > 1 else ""

    if leaf == "embed":
        return P(mdl, None)
    if leaf == "lm_head":
        return P(None, mdl)
    if leaf in ("patch_proj", "frame_proj"):
        return P(*([None] * ndim))

    # MoE experts: [L, E, d, f] / [L, E, f, d]
    if parent == "experts":
        ep = cfg.moe_shard == "expert"
        if leaf in ("w_gate", "w_up"):
            return _pad(((mdl if ep else None), None,
                         (None if ep else mdl)), ndim, st)
        if leaf == "w_down":
            return _pad(((mdl if ep else None), (None if ep else mdl),
                         None), ndim, st)
    if leaf == "router":
        return _pad((None, None), ndim, st)

    # attention / generic projections
    if leaf in ("wq", "wk", "wv", "w_gate", "w_up", "ssm_in", "w_dt"):
        return _pad((None, mdl), ndim, st)
    if leaf in ("wo", "w_down", "w_out", "ssm_out"):
        return _pad((mdl, None), ndim, st)
    if leaf in ("bq", "bk", "bv", "b_up", "b_dt"):
        return _pad((mdl,), ndim, st)
    if leaf in ("A_log", "Dskip"):
        return _pad((mdl,) + (None,) * 1 if leaf == "A_log" else (mdl,),
                    ndim, st)
    # everything else (norms, biases, gates w_if/b_if, w_B/w_C, skips)
    return P(*([None] * ndim))


def param_pspecs(params_shape: Any, cfg: ModelConfig, mesh: Any,
                 fsdp: Optional[bool] = None):
    """Nested dict of ``P`` matching a params tree.  With ``fsdp``
    (default: cfg.fsdp_params) every param is additionally sharded over
    the data axes on its largest unsharded divisible dim (ZeRO-3; serving:
    fully-sharded stationary weights); DTensor all-gathers them where an
    op needs the whole dim."""
    mdl = model_axis(mesh) if cfg.shard_mode == "tp" else None
    fsdp = cfg.fsdp_params if fsdp is None else fsdp

    def rule(path, leaf):
        spec = param_spec(path, _ndim(leaf), cfg, mdl)
        if fsdp:
            spec = zero_extend(spec, tuple(leaf.shape), mesh,
                               include_model=(cfg.shard_mode == "dp"))
        return spec

    return map_with_path(rule, params_shape)


# --------------------------------------------------------------- batch specs
def batch_pspecs(specs: Mapping[str, Any], mesh: Any,
                 include_model: bool = False) -> Dict[str, P]:
    """Shard the leading batch dim over the data axes (when divisible);
    with ``include_model`` (pure-DP mode) the model axis joins them."""
    dax = data_axes(mesh)
    if include_model and model_axis(mesh):
        dax = dax + (model_axis(mesh),)
    n = axis_size(mesh, dax)

    out = {}
    for k, v in specs.items():
        nd = _ndim(v)
        if nd >= 1 and v.shape[0] % n == 0 and v.shape[0] >= n:
            out[k] = P(dax, *([None] * (nd - 1)))
        else:
            out[k] = P(*([None] * nd))
    return out


# --------------------------------------------------------------- cache specs
def cache_spec(names: Tuple[str, ...], shape: Tuple[int, ...],
               cfg: ModelConfig, mesh: Any) -> P:
    """Decode-cache sharding: batch over data axes, head-dim over model."""
    dax = data_axes(mesh)
    n = axis_size(mesh, dax)
    mdl = model_axis(mesh)
    leaf = names[-1]

    def bdim(size):   # shard a batch dim only when it divides evenly
        return dax if (size % n == 0 and size >= n) else None

    if leaf in ("k", "v", "xk", "xv"):      # [L, B, C, Hkv, hd]
        L, B, C, Hkv, hd = shape
        if cfg.cache_shard == "heads":
            return P(None, bdim(B), None, mdl, None)
        if cfg.cache_shard == "ctx":
            return P(None, bdim(B), mdl, None, None)
        return P(None, bdim(B), None, None,
                 mdl if hd % axis_size(mesh, mdl) == 0 else None)
    if leaf == "k_pos":                     # [B, C]
        return P(bdim(shape[0]), None)
    if leaf == "C":                         # xlstm matrix state [L,B,H,D,D]
        return P(None, bdim(shape[1]), None, None, mdl)
    if leaf == "n":                         # [L,B,H,D]
        return P(None, bdim(shape[1]), None, mdl)
    if leaf == "m":                         # [L,B,H]
        return P(None, bdim(shape[1]), None)
    if leaf == "ssm":                       # hymba [L,B,d,N]
        return P(None, bdim(shape[1]), mdl, None)
    return P(*([None] * len(shape)))


def cache_pspecs(cache_shape: Any, cfg: ModelConfig, mesh: Any):
    def rule(path, leaf):
        return cache_spec(path, tuple(leaf.shape), cfg, mesh)
    return map_with_path(rule, cache_shape)


# ------------------------------------------------------------ optimizer ZeRO
def zero_extend(spec: P, shape: Tuple[int, ...], mesh: Any,
                include_model: bool = False) -> P:
    """ZeRO-1: additionally shard an optimizer-state tensor over the data
    axes (+ the model axis in pure-DP mode), on the largest dim not already
    sharded that divides evenly."""
    dax = data_axes(mesh)
    if include_model and model_axis(mesh):
        dax = dax + (model_axis(mesh),)
    if not dax:
        return spec
    n = axis_size(mesh, dax)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    best, best_size = None, 0
    for i, (e, s) in enumerate(zip(entries, shape)):
        if e is None and s % n == 0 and s >= n and s > best_size:
            best, best_size = i, s
    if best is None:
        return spec
    entries[best] = dax
    return P(*entries)


def opt_state_pspecs(params_shape: Any, cfg: ModelConfig, mesh: Any):
    """Specs for AdamW m/v trees: param spec + ZeRO extension."""
    base = param_pspecs(params_shape, cfg, mesh, fsdp=False)
    inc = cfg.shard_mode == "dp"
    return tree_map2(
        lambda spec, leaf: zero_extend(spec, tuple(leaf.shape), mesh,
                                       include_model=inc),
        base, params_shape)


# ------------------------------------------------------ specs → placements
def _entry_axes(e) -> Tuple[str, ...]:
    if e is None:
        return ()
    return (e,) if isinstance(e, str) else tuple(e)


def placements(spec: P, mesh: Any) -> tuple:
    """One spec → DTensor placements on ``mesh`` (one per mesh dim).  A
    dim over several axes is ``Shard(d)`` on each of them; their order in
    the spec must be the mesh's, which is the order DTensor splits in."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, e in enumerate(spec):
        idx = [names.index(a) for a in _entry_axes(e)]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec!r}: axes of dim {d} are not in "
                             f"mesh order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec!r}: axis {names[i]!r} "
                                 "shards two dims")
            out[i] = Shard(d)
    return tuple(out)


def named(tree_specs: Any, mesh: Any) -> Any:
    """Spec tree → placements tree (the reference's ``NamedSharding``)."""
    if isinstance(tree_specs, P):
        return placements(tree_specs, mesh)
    return {k: named(v, mesh) for k, v in tree_specs.items()}


def local_max_shape(shape: Tuple[int, ...], spec: P, mesh: Any
                    ) -> Tuple[int, ...]:
    """The largest rank's local shape under ``spec`` (``torch.chunk``
    split sizes: ceil at each mesh dim in turn)."""
    out = list(shape)
    for d, e in enumerate(spec):
        for a in _entry_axes(e):
            n = axis_size(mesh, a)
            out[d] = -(-out[d] // n)
    return tuple(out)


def local_bytes(tree: Any, specs: Any, mesh: Any) -> int:
    """Bytes the largest rank holds of ``tree`` placed by ``specs``."""
    total = 0
    spec_of = flat(specs)
    for k, leaf in flat(tree).items():
        n = 1
        for s in local_max_shape(tuple(leaf.shape), spec_of[k], mesh):
            n *= s
        total += n * leaf.dtype.itemsize
    return total


def distribute(tree: Any, specs: Any, mesh: Any) -> Any:
    """Place a tree as ``specs`` say: each leaf becomes a DTensor over
    ``mesh`` (``distribute_tensor``: rank 0's values, split).  A ``Params``
    comes back as a ``Params`` of DTensor parameters with the same
    ``requires_grad``; a dict as a dict."""
    from torch.distributed.tensor import distribute_tensor

    def put(leaf, spec):
        return distribute_tensor(leaf.detach(), mesh, placements(spec, mesh))

    if isinstance(tree, Params):
        trainable = any(p.requires_grad for p in tree.parameters())
        out = Params(tree_map2(lambda s, x: put(x, s), specs, tree))
        if trainable:
            out.requires_grad_()
        return out
    return tree_map2(lambda s, x: put(x, s), specs, tree)
