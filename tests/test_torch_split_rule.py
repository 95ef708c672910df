"""K3's and K2's one split rule on the CPU: the counts it gives at the
serve and smoke shapes, K2's count over the host's longest length, and
the paged decode step that hands that length down, against the JAX
package.

The rule (``decode_attention.ops._num_splits``) is a pure function of the
launch's (row, KV head or head group) pairs, the tiles a row walks, the
card's SMs, the blocks of the body that an SM holds, the least tiles of a
split, the heads a block serves and D.  On the card the wrappers take the
blocks an SM holds from the occupancy query (``ops._resident``); here they
are given as the H100's numbers (``ops.H100_RESIDENT``: 4 / 3 / 2 blocks
of the tensor-core body at D 64 / 80 / 128), and ``chip_smoke.py`` holds
the card's launches to the counts pinned here (``PINNED_SPLITS``).
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jt
from repro.models.api import ModelConfig as JaxModelConfig
from repro.serve import model as jm
from repro_torch.bridge import params_from_jax
from repro_torch.kernels.decode_attention import ops
from repro_torch.kernels.paged_attention import ops as pops
from repro_torch.models.api import ModelConfig
from repro_torch.serve import model as tm

ROOT = Path(__file__).resolve().parents[1]
N_SM = 132

# name -> (kernel, B, H, Hkv, D, slots or (maxp, page, window, max_len)),
# and the (head groups, n_split) the rule gives on the H100
PINNED = {
    "whisper-small cross": (("K3", 8, 12, 12, 64, 1500), ((1, 1), 4)),
    "h2o-danube-1.8b ring": (("K3", 4, 32, 8, 80, 4096), ((1, 4), 8)),
    "h2o-danube-1.8b window=4096": (("K2", 4, 32, 8, 80, (36, 128, 4096,
                                                         None)),
                                    ((1, 4), 8)),
    "1.5B paged step": (("K2", 32, 12, 2, 128, (2, 128, None, 161)),
                        ((1, 6), 1)),
    "1.5B paged step, no length": (("K2", 32, 12, 2, 128,
                                    (2, 128, None, None)), ((1, 6), 1)),
    "1.5B static B=8": (("K3", 8, 12, 2, 128, 65), ((1, 6), 1)),
    "1.5B static B=32": (("K3", 32, 12, 2, 128, 161), ((1, 6), 1)),
    "1.5B B=64 x 8192": (("K3", 64, 12, 2, 128, 8192), ((1, 6), 1)),
    "1.5B paged B=64 x 8192": (("K2", 64, 12, 2, 128, (64, 128, None,
                                                        8192)), ((1, 6), 1)),
    "G 12 serve": (("K3", 8, 48, 4, 128, 65), ((2, 6), 1)),
    "G 12 main": (("K3", 32, 48, 4, 128, 161), ((2, 6), 1)),
    "G 12 long": (("K3", 64, 48, 4, 128, 8192), ((1, 12), 1)),
    "G 16 serve": (("K3", 8, 64, 4, 128, 65), ((2, 8), 1)),
    "G 16 main": (("K3", 32, 64, 4, 128, 161), ((2, 8), 1)),
    "G 16 B=32 x 2048": (("K3", 32, 64, 4, 128, 2048), ((1, 16), 1)),
    "G 16 paged long": (("K2", 64, 64, 4, 128, (64, 128, None, None)),
                        ((1, 16), 1)),
    "G 12 B=1 x 8192": (("K3", 1, 48, 4, 128, 8192), ((2, 6), 12)),
}


# the CUDA-core body in float32, 3 blocks an SM at D 128 (the H100's
# query): the kernel phases' sweep shapes in chip_smoke.py (K3's (B, H,
# Hkv, D, C), K2's (B, H, Hkv, D, page, pages), K2 given the longest
# length the 1.5B main shape reaches, else every row full) -> n_split
CORE_RESIDENT = 3
CORE_PINNED = {
    ("flash_decode", (32, 12, 2, 128, 161)): 1,
    ("flash_decode", (8, 12, 2, 128, 8192)): 24,
    ("flash_decode", (64, 12, 2, 128, 8192)): 3,
    ("paged_flash_decode", (32, 12, 2, 128, 128, 2)): 2,
    ("paged_flash_decode", (8, 12, 2, 128, 128, 64)): 24,
    ("paged_flash_decode", (64, 12, 2, 128, 128, 64)): 3}
# and the float32 tensor-core body (3xTF32, which float32 at D 64 / 80 /
# 128 takes), one block an SM at D 128 (the H100's query,
# ``ops.H100_RESIDENT_TF32X3``), at the same shapes
TF32X3_PINNED = {
    ("flash_decode", (32, 12, 2, 128, 161)): 1,
    ("flash_decode", (8, 12, 2, 128, 8192)): 8,
    ("flash_decode", (64, 12, 2, 128, 8192)): 1,
    ("paged_flash_decode", (32, 12, 2, 128, 128, 2)): 1,
    ("paged_flash_decode", (8, 12, 2, 128, 128, 64)): 8,
    ("paged_flash_decode", (64, 12, 2, 128, 128, 64)): 1}


def _count(kernel, B, H, Hkv, D, where, body="mma", res=None):
    res = res or ops._h100_resident(D)
    if kernel == "K3":
        groups = ops._launch_groups(B, H // Hkv, Hkv, D, where, N_SM, res, 8,
                                    body)
        return groups, ops._launch_splits(B, H, Hkv, D, where, N_SM, res,
                                          None, body, groups)
    maxp, page, window, max_len = where
    groups = pops._paged_groups(B, H // Hkv, Hkv, D, maxp, page, window,
                                N_SM, res, None, body, max_len)
    return groups, pops._paged_splits(B, Hkv, D, maxp, page, window, N_SM,
                                      res, H // Hkv, None, body, groups,
                                      max_len)


@pytest.mark.parametrize("name", sorted(PINNED))
def test_pinned_counts_at_the_serve_shapes(name):
    launch, want = PINNED[name]
    assert _count(*launch) == want


@pytest.mark.parametrize("name,shape", sorted(CORE_PINNED))
def test_pinned_float32_counts_on_the_cuda_core_body(name, shape):
    """In float32 the CUDA-core body walks each tile with the whole block,
    so it splits further than the tensor-core body at the same shape (the
    1.5B 32-slot step 2 splits, B 64 x 8192 3: one resident wave of 384
    blocks; B 8 x 8192 24)."""
    res = lambda gc: CORE_RESIDENT    # noqa: E731
    if name == "flash_decode":
        B, H, Hkv, D, C = shape
        got = _count("K3", B, H, Hkv, D, C, "core", res)
    else:
        B, H, Hkv, D, page, maxp = shape
        max_len = 161 if maxp == 2 else maxp * page
        got = _count("K2", B, H, Hkv, D, (maxp, page, None, max_len), "core",
                     res)
    assert got == ((1, H // Hkv), CORE_PINNED[name, shape])


@pytest.mark.parametrize("name,shape", sorted(TF32X3_PINNED))
def test_pinned_float32_counts_on_the_tensor_core_body(name, shape):
    """float32 at D 128 on the 3xTF32 body: its 8 warps walk a tile in
    halves, one block an SM, so the rule keeps one split wherever the
    (row, KV head) pairs are 64 or more and the rows short (the 1.5B
    serve and paged steps, B 64 x 8192), and splits B 8 x 8192 in 8; it
    counts the blocks an SM holds at most as ``FULL_RATE_BLOCKS``."""
    res = ops._h100_resident(128, "tf32x3")
    assert res(6) == ops.H100_RESIDENT_TF32X3[128] == 1
    if name == "flash_decode":
        B, H, Hkv, D, C = shape
        got = _count("K3", B, H, Hkv, D, C, "tf32x3", res)
    else:
        B, H, Hkv, D, page, maxp = shape
        max_len = 161 if maxp == 2 else maxp * page
        got = _count("K2", B, H, Hkv, D, (maxp, page, None, max_len),
                     "tf32x3", res)
    assert got == ((1, H // Hkv), TF32X3_PINNED[name, shape])
    # two resident blocks count as one
    assert _count("K3", 8, 12, 2, 64, 8192, "tf32x3", lambda gc: 2) == \
        _count("K3", 8, 12, 2, 64, 8192, "tf32x3", lambda gc: 1)


def test_smoke_pins_the_same_counts():
    """``chip_smoke.py`` holds the card's launches to these counts."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert set(smoke.PINNED_SPLITS) <= set(PINNED)
    for name, n_split in smoke.PINNED_SPLITS.items():
        assert PINNED[name][1][1] == n_split, name
    assert smoke.CORE_PINNED_SPLITS == CORE_PINNED
    assert smoke.TF32X3_PINNED_SPLITS == TF32X3_PINNED


@pytest.mark.parametrize("B,G,Hkv,D,maxp,page,window", [
    (32, 6, 2, 128, 2, 128, None), (8, 6, 2, 128, 64, 128, None),
    (4, 4, 8, 80, 36, 128, 4096), (3, 12, 4, 64, 40, 16, None),
    (1, 16, 4, 128, 512, 16, 1000), (64, 6, 2, 128, 64, 128, None),
])
def test_paged_count_with_the_longest_length_is_k3s(B, G, Hkv, D, maxp,
                                                    page, window):
    """K2 given the host's longest length counts as K3 over ``min(reach,
    max_len rounded up to a page)`` slots; without it, as K3 over the
    reach (the table's width, or the window)."""
    H = G * Hkv
    res = ops._h100_resident(D)
    reach = maxp * page if window is None else min(maxp * page, window)

    def k3(C):
        return _count("K3", B, H, Hkv, D, C)

    assert _count("K2", B, H, Hkv, D, (maxp, page, window, None)) == \
        k3(reach)
    for max_len in (1, page - 1, page, page + 1, 5 * page + 3, reach,
                    maxp * page, 10 ** 6):
        span = min(reach, -(-max_len // page) * page)
        assert _count("K2", B, H, Hkv, D, (maxp, page, window,
                                           max_len)) == k3(span)
        assert pops._span(maxp, page, window, max_len) == span
    # the count moves only when the longest row crosses a page
    assert _count("K2", B, H, Hkv, D, (maxp, page, window, page + 1)) == \
        _count("K2", B, H, Hkv, D, (maxp, page, window, 2 * page))
    assert res(G) == ops.H100_RESIDENT[D]


BASE = dict(family="dense", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
            d_ff=64, vocab=128, qkv_bias=True, dtype="float32", remat=False)
CONFIGS = {"dense": dict(name="dense", **BASE),
           "swa6": dict(name="swa6", head_dim=8, attn_window=6, **BASE)}
PAGE, MAXP, SLOTS = 4, 4, 3


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_paged_decode_step_with_the_hint_matches_jax(name):
    """The port's ``paged_decode_step`` given the host's longest length
    (the engine's ``max(pos) + 1``), or a shorter one, gives the JAX
    package's logits and pools (1e-4) over three decode steps of two
    active slots and an inactive one."""
    jcfg = JaxModelConfig(**CONFIGS[name])
    tcfg = ModelConfig(**CONFIGS[name])
    jparams = jt.init(jax.random.PRNGKey(1), jcfg)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             "cpu")
    rng = np.random.default_rng(3)
    tables = rng.permutation(np.arange(1, 1 + SLOTS * MAXP)).astype(
        np.int32).reshape(SLOTS, MAXP)
    shape = (tcfg.n_layers, 1 + SLOTS * MAXP, PAGE, tcfg.n_kv_heads,
             tcfg.hd)
    pools = rng.standard_normal((2,) + shape).astype(np.float32)
    active = np.array([1, 1, 0], np.int32)
    step = jax.jit(lambda p, k, v, bt, tok, pos, act:
                   jm.paged_decode_step(p, jcfg, k, v, bt, tok, pos, act))
    for hint in ("longest", "short"):
        kp, vp = (torch.from_numpy(x.copy()) for x in pools)
        jk, jv = (jnp.asarray(x) for x in pools)
        for t in range(3):
            pos = np.array([9 + t, 6 + 2 * t, 0], np.int32)
            tok = rng.integers(3, 128, SLOTS).astype(np.int32)
            max_len = int(pos.max()) + 1 if hint == "longest" else 1
            with torch.no_grad():
                lg, kp, vp = tm.paged_decode_step(
                    params, tcfg, kp, vp, torch.from_numpy(tables),
                    torch.from_numpy(tok), torch.from_numpy(pos),
                    torch.from_numpy(active), max_len=max_len)
            jl, jk, jv = step(jparams, jk, jv, jnp.asarray(tables),
                              jnp.asarray(tok), jnp.asarray(pos),
                              jnp.asarray(active))
            np.testing.assert_allclose(lg.numpy()[:2], np.asarray(jl)[:2],
                                       atol=1e-4, rtol=0)
        np.testing.assert_allclose(kp.numpy()[:, 1:], np.asarray(jk)[:, 1:],
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(vp.numpy()[:, 1:], np.asarray(jv)[:, 1:],
                                   atol=1e-4, rtol=0)


def test_engine_hands_k2_the_longest_length(monkeypatch):
    """``PagedEngine`` gives every layer's K2 call the longest of the
    step's lengths, from the positions it uploads (nothing read back):
    ``max_len == max(lengths)`` at every call."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.tasks import MathTaskGenerator
    from repro_torch.models import transformer
    from repro_torch.rl.rollout import GenConfig
    from repro_torch.rl.weight_sync import WeightStore
    from repro_torch.serve import PagedEngine, ServeConfig

    seen = []
    real = tm.paged_decode_attention

    def spy(q, kp, vp, tables, lengths, *, window=None, max_len=None):
        seen.append((max_len, int(lengths.max())))
        return real(q, kp, vp, tables, lengths, window=window,
                    max_len=max_len)

    monkeypatch.setattr(tm, "paged_decode_attention", spy)
    cfg = get_smoke_config("qwen-distill-1.5b")
    store = WeightStore()
    store.publish(transformer.init(0, cfg, "cpu"))
    tasks = MathTaskGenerator(seed=0).batch(2)
    engine = PagedEngine(cfg, store, GenConfig(max_new_tokens=5, greedy=True),
                         ServeConfig(max_slots=4, max_len=64), device="cpu")
    engine.generate_groups(tasks, 2)
    assert len(seen) >= cfg.n_layers * 4
    assert all(m == longest for m, longest in seen)
