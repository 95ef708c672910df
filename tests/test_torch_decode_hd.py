"""K3's decode over a cache split on its head dim: the two passes
(``decode_scores``, then ``decode_softmax_pv`` on the scores summed over
the slices) against the JAX package, on the CPU.

A model axis of m cuts q, k and v on their last dim into m slices, as
``cache_shard="hd"`` places the cache.  Pass 1 runs per slice, the scores
are summed (in place of the all-reduce over ranks), pass 2 runs per slice
and the outputs are concatenated.  The same numpy inputs, made from a seed,
go through JAX's ``repro.kernels.decode_attention.ref.decode_attention_ref``
over the whole head dim.  Tolerance: 2e-5 in float32
(``tests/test_kernels.py::_tol``).  Each pass has two CUDA bodies (the
cp.async "ring" and the first design's "simt"); the pure-Python parts
around them are tested here: the ring launches' geometry
(``_scores_geometry``, ``_pv_geometry``), ``_variant``'s choice of body,
and the refusal of bad inputs at a slice either body takes.  The CUDA
kernels are held to the plain versions on the card by the ``gpu`` test
below (both bodies) and by ``chip_smoke.py``; the ``gpu`` test imports no
JAX, so on a card without JAX::

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu \\
        tests/test_torch_decode_hd.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import ops
from repro_torch.kernels.decode_attention.ops import (
    PV_TILE, _wave_splits, decode_attention, decode_attention_ref,
    decode_scores, decode_scores_ref, decode_softmax_pv,
    decode_softmax_pv_ref)
from repro_torch.parallel import local

EMPTY = -(2 ** 30)
TOL = dict(atol=2e-5, rtol=2e-5)


def _case(B, C, H, Hkv, D, window, seed):
    """Rows attend from 0 to C slots: row 0 none, row 1 a prefix, row 2
    (with a window) a ring past the window, the rest a ragged prefix."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, C, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, C, Hkv, D)).astype(np.float32)
    slot = np.arange(C)
    q_pos = np.array([C - 1] + [(C * (b + 1)) // (B + 1)
                                for b in range(1, B)], np.int32)
    k_pos = np.where(slot[None] <= q_pos[:, None], slot[None], EMPTY)
    k_pos[0] = EMPTY                          # attends nothing
    if window is not None and B > 2:
        qp = 3 * C + 5                        # a ring, wrapped 3 times
        q_pos[2] = qp
        k_pos[2] = qp - ((qp - slot) % C)
    return q, k, v, q_pos, k_pos.astype(np.int32)


def _slices(x, m):
    return [t.contiguous() for t in torch.from_numpy(x).chunk(m, dim=-1)]


def _hd_decode(q, k, v, q_pos, k_pos, m, window):
    """The two plain passes over m slices of the head dim, summed."""
    D = q.shape[-1]
    qp, kp = torch.from_numpy(q_pos), torch.from_numpy(k_pos)
    s = sum(decode_scores_ref(a, b, scale=D ** -0.5)
            for a, b in zip(_slices(q, m), _slices(k, m)))
    return torch.cat([decode_softmax_pv_ref(s, c, qp, kp, window=window)
                      for c in _slices(v, m)], dim=-1)


def _jax_ref(q, k, v, q_pos, k_pos, window):
    import jax.numpy as jnp
    from repro.kernels.decode_attention.ref import decode_attention_ref as ref
    return np.asarray(ref(*(jnp.asarray(a) for a in (q, k, v, q_pos,
                                                      k_pos)),
                          window=window), np.float32)


@pytest.mark.parametrize("D,m", [(128, 1), (128, 2), (128, 4), (80, 16)])
@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("G", [1, 6, 12])
def test_passes_over_head_dim_slices_equal_jax(G, window, D, m):
    """G 6 is the 1.5B's group, 12 starcoder2's (two head groups of the
    kernels); D 80 over 16 slices is h2o-danube over a model axis of 16
    (Dl = 5).  Row 0 attends nothing and reads 0."""
    Hkv = 2
    args = _case(4, 40, G * Hkv, Hkv, D, window, seed=G * 100 + D + m)
    got = _hd_decode(*args, m, window)
    want = _jax_ref(*args, window)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not got[0].any()


def test_split_hd_runs_the_two_passes_in_order(monkeypatch):
    """``parallel.local._decode_split_hd`` is pass 1, the all-reduce over
    its groups (none here: one rank), then pass 2, and equals JAX's
    decode over the whole head dim."""
    calls = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(ops, "decode_scores",
                        spy("scores", ops.decode_scores))
    monkeypatch.setattr(ops, "decode_softmax_pv",
                        spy("softmax_pv", ops.decode_softmax_pv))
    q, k, v, q_pos, k_pos = _case(3, 24, 12, 2, 32, 8, seed=7)
    t = [torch.from_numpy(a) for a in (q, k, v, q_pos, k_pos)]
    got = local._decode_split_hd(*t, 8, 32 ** -0.5, [])
    assert calls == ["scores", "softmax_pv"]
    np.testing.assert_allclose(got.numpy(), _jax_ref(q, k, v, q_pos, k_pos,
                                                     8), **TOL)


def test_wrappers_run_the_plain_versions_on_cpu_and_meta():
    """A CPU tensor takes the plain version and counts no launch; a meta
    tensor (the dry-run) gets the plain version's shapes and dtypes."""
    q, k, v, q_pos, k_pos = (torch.from_numpy(a) for a in
                             _case(3, 20, 6, 2, 16, None, seed=3))
    before = (decode_scores.launches, decode_softmax_pv.launches)
    s = decode_scores(q, k, scale=0.25)
    torch.testing.assert_close(s, decode_scores_ref(q, k, scale=0.25),
                               rtol=0, atol=0)
    o = decode_softmax_pv(s, v, q_pos, k_pos, window=4)
    torch.testing.assert_close(
        o, decode_softmax_pv_ref(s, v, q_pos, k_pos, window=4),
        rtol=0, atol=0)
    meta = dict(device="meta")
    s = decode_scores(q.to(**meta).bfloat16(), k.to(**meta).bfloat16(),
                      scale=0.25)
    assert s.is_meta and s.shape == (3, 6, 20) and s.dtype == torch.float32
    o = decode_softmax_pv(s, v.to(**meta).bfloat16(), q_pos.to(**meta),
                          k_pos.to(**meta))
    assert o.is_meta and o.shape == (3, 6, 16) and o.dtype == torch.bfloat16
    assert (decode_scores.launches, decode_softmax_pv.launches) == before


def _bad(name, Dl=8):
    """(function, args, kwargs, message) of an input each wrapper
    refuses, at a slice of ``Dl`` dims."""
    q = torch.zeros(2, 6, Dl)
    k = torch.zeros(2, 5, 2, Dl)
    s = torch.zeros(2, 6, 5)
    qp = torch.zeros(2, dtype=torch.int32)
    kp = torch.zeros(2, 5, dtype=torch.int32)
    sc = dict(scale=1.0)
    return {
        "scores rows": (decode_scores, (q, k[:1]), sc, "shapes"),
        "scores dims": (decode_scores, (q, k[..., :Dl // 2]), sc, "shapes"),
        "scores groups": (decode_scores, (q[:, :5], k), sc, "H % Hkv"),
        "scores dtypes": (decode_scores, (q, k.bfloat16()), sc, "dtypes"),
        "scores float16": (decode_scores, (q.half(), k.half()), sc,
                           "dtypes"),
        "scores devices": (decode_scores, (q, k.to("meta")), sc,
                           "different devices"),
        "pv slots": (decode_softmax_pv, (s[:, :, :4], k, qp, kp), {},
                     "shapes"),
        "pv groups": (decode_softmax_pv, (s[:, :5], k, qp, kp), {},
                      "H % Hkv"),
        "pv q_pos shape": (decode_softmax_pv, (s, k, qp[:1], kp), {},
                           "shapes"),
        "pv k_pos shape": (decode_softmax_pv, (s, k, qp, kp[:, :4]), {},
                           "shapes"),
        "pv scores bf16": (decode_softmax_pv, (s.bfloat16(), k, qp, kp), {},
                           "dtypes"),
        "pv float16": (decode_softmax_pv, (s, k.half(), qp, kp), {},
                       "dtypes"),
        "pv q_pos int64": (decode_softmax_pv, (s, k, qp.long(), kp), {},
                           "int32"),
        "pv k_pos int64": (decode_softmax_pv, (s, k, qp, kp.long()), {},
                           "int32"),
        "pv devices": (decode_softmax_pv, (s, k, qp.to("meta"), kp), {},
                       "different devices"),
    }[name]


@pytest.mark.parametrize("name", [
    "scores rows", "scores dims", "scores groups", "scores dtypes",
    "scores float16", "scores devices", "pv slots", "pv groups",
    "pv q_pos shape", "pv k_pos shape", "pv scores bf16", "pv float16",
    "pv q_pos int64", "pv k_pos int64", "pv devices"])
def test_wrappers_refuse_bad_inputs(name):
    fn, args, kwargs, msg = _bad(name)
    with pytest.raises(ValueError, match=msg):
        fn(*args, **kwargs)


BAD = ["scores rows", "scores dims", "scores groups", "scores dtypes",
       "scores float16", "scores devices", "pv slots", "pv groups",
       "pv q_pos shape", "pv k_pos shape", "pv scores bf16", "pv float16",
       "pv q_pos int64", "pv k_pos int64", "pv devices"]


@pytest.mark.parametrize("name", BAD)
@pytest.mark.parametrize("Dl,body", [(8, "ring"), (5, "simt")])
def test_wrappers_refuse_bad_inputs_for_either_body(name, Dl, body):
    """The wrappers check their inputs before they choose a body: the same
    refusals at a slice that pass 2's ring body takes (8 dims of float32,
    32 bytes) and at one that only PR 22's body takes (5 dims, 20 bytes)."""
    q, k = torch.zeros(2, 6, Dl), torch.zeros(2, 5, 2, Dl)
    assert ops._variant(q.dtype, Dl, (q, k)) == body
    fn, args, kwargs, msg = _bad(name, Dl)
    with pytest.raises(ValueError, match=msg):
        fn(*args, **kwargs)


def test_ring_launches_refuse_what_the_ring_cannot_take(monkeypatch):
    """Launching the ring body on a slice that 16-byte copies cannot reach
    (5 dims) raises before anything reaches the card."""
    monkeypatch.setattr(ops, "_sm_count", lambda device: 132)
    q, k = torch.zeros(2, 6, 5), torch.zeros(2, 5, 2, 5)
    s = torch.zeros(2, 6, 5)
    pos = torch.zeros(2, dtype=torch.int32)
    kp = torch.zeros(2, 5, dtype=torch.int32)
    with pytest.raises(ValueError, match="ring body does not take"):
        ops._launch_scores(q, k, 1.0, "ring")
    with pytest.raises(ValueError, match="ring body does not take"):
        ops._launch_softmax_pv(s, k, pos, kp, None, "ring")


def _view(shape, dtype, offset=0, pad=0):
    """A view of ``shape`` inside a larger buffer: its last dim padded by
    ``pad`` elements and its start moved by ``offset`` elements."""
    whole = torch.zeros(*shape[:-1], shape[-1] + pad, dtype=dtype)
    flat = torch.zeros(whole.numel() + offset, dtype=dtype)
    return flat[offset:].view(whole.shape)[..., :shape[-1]]


@pytest.mark.parametrize("dtype,Dl,offset,pad,fits,want", [
    (torch.bfloat16, 64, 0, 0, True, "ring"),      # m = 2 at D 128
    (torch.bfloat16, 8, 0, 0, True, "ring"),       # m = 16: 16 bytes
    (torch.float32, 8, 0, 0, True, "ring"),        # 32 bytes
    (torch.float32, 4, 0, 0, True, "ring"),        # 16 bytes
    (torch.bfloat16, 4, 0, 0, True, "simt"),       # 8 bytes
    (torch.bfloat16, 5, 0, 0, True, "simt"),       # danube at m = 16
    (torch.float32, 5, 0, 0, True, "simt"),
    (torch.bfloat16, 64, 64, 64, True, "ring"),    # a slice of D 128
    (torch.bfloat16, 64, 1, 0, True, "simt"),      # start not aligned
    (torch.bfloat16, 64, 0, 4, True, "simt"),      # row stride 136 bytes
    (torch.float32, 8, 4, 4, True, "ring"),        # 16-byte steps
    (torch.float32, 8, 2, 0, True, "simt"),
    (torch.bfloat16, 64, 0, 0, False, "simt"),     # no ring fits a block
])
def test_variant_choice(dtype, Dl, offset, pad, fits, want):
    """``_variant`` takes the ring body exactly where 16-byte copies reach
    every row piece: Dl elements a multiple of 16 bytes, every tensor
    16-byte aligned with every stride but the last a multiple of 16 bytes,
    and a ring that fits; the first design's body otherwise.  Both
    passes' rings take both dtypes (``_scores_variant`` is this rule)."""
    q = _view((2, 6, Dl), dtype, offset, pad)
    k = _view((2, 5, 2, Dl), dtype, offset, pad)
    assert ops._variant(dtype, Dl, (q, k), fits) == want
    assert ops._variant(torch.float16, Dl, (q, k), fits) == "simt"


SHAPES = [(64, 8192, 12, 2, 64), (64, 8192, 12, 2, 8), (32, 161, 12, 2, 64),
          (32, 161, 12, 2, 8), (4, 700, 48, 4, 64), (8, 300, 12, 2, 384),
          (1, 1, 6, 2, 8), (3, 40, 64, 4, 16), (2, 5000, 56, 8, 128)]


@pytest.mark.parametrize("es", [2, 4])
@pytest.mark.parametrize("B,C,H,Hkv,Dl", SHAPES)
def test_scores_geometry(B, C, H, Hkv, Dl, es):
    """Pass 1's ring: a power-of-two tile of 16 to RING_MAX_TILE slots, the
    most whose K rows fit RING_K_STAGE bytes, halved while the rows' tiles
    number fewer than SCORES_FILL[es] an SM (bf16 half, float32 4);
    SCORES_STAGES[es] stages of rows padded
    by ``_scores_row`` inside a block's shared memory; persistent blocks,
    as many an SM as fit up to SCORES_BLOCKS[es] (bf16 2, float32 4),
    never more than the tiles."""
    geo = ops._scores_geometry(B, C, H, Hkv, Dl, es, 132)
    slot = Hkv * Dl * es
    stages = ops.SCORES_STAGES[es]
    if geo is None:                 # even the stages of 16 slots overflow
        assert stages * (H * ops._scores_row(Dl * es, es)
                         + 16 * ops._scores_row(slot, es)) > ops.MAX_SMEM
        return
    tile, smem, blocks = geo["tile"], geo["smem"], geo["blocks"]
    assert tile in (16, 32, 64, 128, 256, 512)
    assert tile == 16 or tile * slot <= ops.RING_K_STAGE
    bigger = 2 * tile
    fill = ops.SCORES_FILL[es] * 132
    assert (bigger > ops.RING_MAX_TILE or bigger * slot > ops.RING_K_STAGE
            or B * -(-C // bigger) < fill)
    assert tile == 16 or B * -(-C // tile) >= fill
    stage = (H * ops._scores_row(Dl * es, es)
             + tile * ops._scores_row(slot, es))
    assert smem == stages * stage <= ops.MAX_SMEM
    tiles = B * -(-C // tile)
    per_sm = max(n for n in range(1, ops.SCORES_BLOCKS[es] + 1)
                 if n == 1 or n * (smem + ops.SMEM_RESERVED) <= ops.SM_SMEM)
    assert blocks == min(tiles, per_sm * 132) >= 1
    if (B, C, Dl, es) == (64, 8192, 64, 2):        # m = 2, bf16
        assert (tile, blocks) == (64, 264)
    if (B, C, Dl, es) == (64, 8192, 8, 2):         # m = 16, bf16
        assert (tile, blocks) == (512, 264)
    if (B, C, Dl, es) == (32, 161, 64, 2):         # the main shape
        assert (tile, blocks) == (64, 96)
    if (B, C, Dl, es) == (64, 8192, 64, 4):        # m = 2, float32
        assert (tile, blocks) == (32, 528)
    if (B, C, Dl, es) == (64, 8192, 8, 4):         # m = 16, float32
        assert (tile, blocks) == (256, 528)
    if (B, C, Dl, es) in ((32, 161, 64, 4), (32, 161, 8, 4)):
        assert (tile, blocks) == (16, 352)         # the main shape, float32


@pytest.mark.parametrize("es", [2, 4])
@pytest.mark.parametrize("B,C,H,Hkv,Dl", SHAPES)
def test_pv_geometry(B, C, H, Hkv, Dl, es):
    """Pass 2's ring: a block a unit (KV head, <= 16 heads, <= 64 dims) of
    a split of a row; 32-slot tiles a warp where a stage of them holds at
    most RING_PV_STAGE bytes, else 16; the block's rings of PV_STAGES
    stages inside its shared memory; and the split count filling whole
    waves of the blocks an SM holds, with >= 2 tiles a warp."""
    G = H // Hkv
    geo = ops._pv_geometry(B, C, H, Hkv, Dl, es, 132)
    gy, tile = geo["gy"], geo["tile"]
    assert gy == Hkv * -(-G // 16) * -(-Dl // 64)
    dw = min(Dl, 64)
    assert (dw * es // 16) <= 32                    # a lane's V pieces
    stage = lambda t: min(G, 16) * (t + 8) * 4 + t * ops._odd16(dw * es)
    assert (tile == 32) == (stage(32) <= ops.RING_PV_STAGE)
    assert geo["smem"] >= ops.PV_WARPS * ops.PV_STAGES * stage(tile)
    assert geo["smem"] <= ops.MAX_SMEM
    bps = geo["blocks_per_sm"]
    assert 1 <= bps <= ops.RING_PV_BLOCKS
    assert bps == 1 or bps * (geo["smem"] + ops.SMEM_RESERVED) <= ops.SM_SMEM
    n = _wave_splits(B, gy, C, 132, bps, ops.MIN_RING_TILES, tile)
    tiles = -(-C // tile)
    assert 1 <= n <= max(1, tiles // ops.MIN_RING_TILES)
    if 1 < n < tiles // ops.MIN_RING_TILES:
        assert B * gy * n <= bps * 132 < B * gy * (n + 1)
    if (B, C, Dl, es) == (64, 8192, 64, 2):        # m = 2, bf16
        assert (gy, tile, bps, n) == (2, 32, 3, 3)
    if (B, C, Dl, es) == (64, 8192, 8, 2):         # m = 16, bf16
        assert (gy, tile, bps, n) == (2, 32, 4, 4)


def test_pv_splits():
    """Pass 2's split count (``_wave_splits`` over PV_TILE-slot tiles,
    rounded down to whole waves): at least one split, never more than the
    tiles, every split at least MIN_PV_TILES tiles by default, and as many
    as fit PV_WAVES blocks per SM where the row has the tiles; other waves
    give as many as fit them."""
    def pv_splits(B, rows, C, waves=ops.PV_WAVES):
        return _wave_splits(B, rows, C, 132, waves, ops.MIN_PV_TILES,
                            PV_TILE)

    for B, rows, C in [(32, 2, 161), (64, 2, 8192), (1, 2, 8192),
                       (1, 1, 1), (8, 4, 4096), (3, 16, 40)]:
        tiles = -(-C // PV_TILE)
        n = pv_splits(B, rows, C)
        assert 1 <= n <= max(1, tiles // ops.MIN_PV_TILES)
        if 1 < n < tiles // ops.MIN_PV_TILES:
            assert B * rows * n <= ops.PV_WAVES * 132 < B * rows * (n + 1)
        for waves in (1, 3, 10 ** 6):
            assert pv_splits(B, rows, C, waves) == max(1, min(
                waves * 132 // (B * rows), tiles // ops.MIN_PV_TILES))
    assert pv_splits(32, 2, 161) == 1 and pv_splits(64, 2, 8192) == 8


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_passes_on_the_card(dtype):
    """Both bodies of each pass against the plain versions and K3 over the
    whole head dim: G 6 and 12, slices Dl 64 / 16 / 8 / 5 taken as views of
    the whole cache (strided), a window over a ring, an empty row, one
    split and splits forced to 3; the wrappers take the ring body where
    16-byte copies fit, in either dtype (Dl 5 takes the other); pass 2's
    bodies also at the forced count through their
    launcher (``_launch_softmax_pv(..., n_split)``).  And K3's wrapper at
    D 384 (through the passes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    tol = (dict(atol=5e-2, rtol=5e-2) if dtype == torch.bfloat16 else TOL)
    es = torch.finfo(dtype).bits // 8
    for G, D, m, window, force in [(6, 128, 2, None, None),
                                   (6, 128, 8, 8, 3), (12, 128, 16, None, 3),
                                   (4, 80, 16, 8, None)]:
        Hkv = 2
        t = [torch.from_numpy(a).cuda() for a in
             _case(4, 300, G * Hkv, Hkv, D, window, seed=G + m)]
        q, k, v = (x.to(dtype) for x in t[:3])
        qp, kp = t[3], t[4]
        fits = (D // m * es) % 16 == 0
        want = {"scores": "ring" if fits else "simt",
                "pv": "ring" if fits else "simt"}
        before = (dict(decode_scores.launches_by_variant),
                  dict(decode_softmax_pv.launches_by_variant))
        s = sum(decode_scores(a, b, scale=D ** -0.5) for a, b in
                zip(q.chunk(m, -1), k.chunk(m, -1)))
        o = torch.cat([decode_softmax_pv(s, c, qp, kp, window=window)
                       for c in v.chunk(m, -1)], -1)
        bodies = {"wrappers": (s, o)}
        # each pass's bodies launched directly (not counted), pass 2 at
        # the forced split count
        for body in dict.fromkeys((want["pv"], "simt")):
            sb = sum(ops._launch_scores(a, b, D ** -0.5,
                                        "simt" if body == "simt"
                                        else want["scores"])
                     for a, b in zip(q.chunk(m, -1), k.chunk(m, -1)))
            ob = torch.cat([ops._launch_softmax_pv(sb, c, qp, kp, window,
                                                   body, force)[0]
                            for c in v.chunk(m, -1)], -1)
            bodies[body] = (sb, ob)
        for name, fn in (("scores", decode_scores),
                         ("pv", decode_softmax_pv)):
            got = fn.launches_by_variant
            base = before[0] if name == "scores" else before[1]
            assert got[want[name]] - base[want[name]] == m
        s_ref = sum(decode_scores_ref(a, b, scale=D ** -0.5) for a, b in
                    zip(q.chunk(m, -1), k.chunk(m, -1)))
        want = decode_attention_ref(q, k, v, qp, kp, window=window)
        whole = decode_attention(q, k, v, qp, kp, window=window)
        for body, (sb, ob) in bodies.items():
            torch.testing.assert_close(sb, s_ref, **TOL)
            torch.testing.assert_close(ob.float(), want.float(), **tol)
            torch.testing.assert_close(ob.float(), whole.float(), **tol)
            assert not ob[0].any()
    q, k, v, qp, kp = _case(3, 200, 12, 2, 384, None, seed=384)
    q, k, v = (torch.from_numpy(x).cuda().to(dtype) for x in (q, k, v))
    qp, kp = torch.from_numpy(qp).cuda(), torch.from_numpy(kp).cuda()
    before = (decode_attention.launches, decode_scores.launches)
    got = decode_attention(q, k, v, qp, kp)
    assert (decode_attention.launches, decode_scores.launches) == (
        before[0], before[1] + 1)
    torch.testing.assert_close(
        got.float(), decode_attention_ref(q, k, v, qp, kp).float(), **tol)
