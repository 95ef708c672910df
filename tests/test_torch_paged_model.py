"""Parity of the port's paged forward passes with the JAX package, on the
CPU, and the attention dispatch that keeps the paged prefill off the
flash kernel.

The same parameters (JAX init, carried over by ``params_from_jax``), the
same pools, tables and tokens go through ``paged_prefill_chunk`` and
``paged_decode_step`` of both packages: two sequences are prefilled in
chunks (so chunks with ``p0 > 0`` run, and the last chunk of the second
one has pad rows past its table), then three decode steps run with a
third, inactive slot.  JAX runs with ``use_pallas`` off (gather +
masked attention) and on (the Pallas paged kernel, interpret mode).
Logits agree within 1e-4 and so do the pools (the null page 0 aside,
which holds unobservable pad writes).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jt
from repro.models.api import ModelConfig as JaxModelConfig
from repro.serve import model as jm
from repro_torch.bridge import params_from_jax, to_tensor
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import blocks
from repro_torch.models import transformer as tt
from repro_torch.models.api import ModelConfig
from repro_torch.serve import model as tm

ATOL = 1e-4
BASE = dict(family="dense", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
            d_ff=64, vocab=128, qkv_bias=True, dtype="float32", remat=False)
CONFIGS = {"dense": dict(name="dense", **BASE),
           "swa6": dict(name="swa6", head_dim=8, attn_window=6, **BASE)}
PAGE, MAXP, SLOTS = 4, 4, 3
PROMPTS = {0: (10, 4), 1: (13, 6)}     # slot: (prompt length, chunk)
STEPS = 3


def _script(seed=0):
    """Tables, prompts and teacher-forced decode tokens, from a seed."""
    rng = np.random.default_rng(seed)
    ids = rng.permutation(np.arange(1, 1 + SLOTS * MAXP)).astype(np.int32)
    tables = ids.reshape(SLOTS, MAXP)
    prompts = {s: rng.integers(3, 128, n).astype(np.int32)
               for s, (n, _) in PROMPTS.items()}
    decode = rng.integers(3, 128, (STEPS, SLOTS)).astype(np.int32)
    return tables, prompts, decode


def _chunks(slot):
    n, chunk = PROMPTS[slot]
    for p0 in range(0, n, chunk):
        toks = np.zeros(chunk, np.int32)
        toks[:min(chunk, n - p0)] = _script()[1][slot][p0:p0 + chunk]
        yield p0, toks


def _run_port(cfg, tree):
    params = params_from_jax(tree, "cpu")
    tables, _, decode = _script()
    shape = (cfg.n_layers, 1 + SLOTS * MAXP, PAGE, cfg.n_kv_heads, cfg.hd)
    kp, vp = torch.zeros(shape), torch.zeros(shape)
    out = []
    with torch.no_grad():
        for slot in PROMPTS:
            for p0, toks in _chunks(slot):
                lg, kp, vp = tm.paged_prefill_chunk(
                    params, cfg, kp, vp, torch.from_numpy(tables[slot]),
                    torch.from_numpy(toks), p0)
                out.append(lg.numpy())
        bt = torch.from_numpy(tables)
        active = torch.tensor([1, 1, 0], dtype=torch.int32)
        for t in range(STEPS):
            pos = torch.tensor([PROMPTS[0][0] + t, PROMPTS[1][0] + t, 0],
                               dtype=torch.int32)
            lg, kp, vp = tm.paged_decode_step(
                params, cfg, kp, vp, bt, torch.from_numpy(decode[t]), pos,
                active)
            out.append(lg.numpy())
    return out, kp.numpy(), vp.numpy()


def _run_jax(cfg, params):
    tables, _, decode = _script()
    shape = (cfg.n_layers, 1 + SLOTS * MAXP, PAGE, cfg.n_kv_heads, cfg.hd)
    kp, vp = jnp.zeros(shape), jnp.zeros(shape)
    prefill = jax.jit(lambda p, k, v, row, toks, p0:
                      jm.paged_prefill_chunk(p, cfg, k, v, row, toks, p0))
    step = jax.jit(lambda p, k, v, bt, tok, pos, act:
                   jm.paged_decode_step(p, cfg, k, v, bt, tok, pos, act))
    out = []
    for slot in PROMPTS:
        for p0, toks in _chunks(slot):
            lg, kp, vp = prefill(params, kp, vp, jnp.asarray(tables[slot]),
                                 jnp.asarray(toks), jnp.int32(p0))
            out.append(np.asarray(lg))
    active = jnp.asarray([1, 1, 0], jnp.int32)
    for t in range(STEPS):
        pos = jnp.asarray([PROMPTS[0][0] + t, PROMPTS[1][0] + t, 0],
                          jnp.int32)
        lg, kp, vp = step(params, kp, vp, jnp.asarray(tables),
                          jnp.asarray(decode[t]), pos, active)
        out.append(np.asarray(lg))
    return out, np.asarray(kp), np.asarray(vp)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def case(request):
    jcfg = JaxModelConfig(**CONFIGS[request.param])
    tcfg = ModelConfig(**CONFIGS[request.param])
    jparams = jt.init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams,
                port=_run_port(tcfg, tree))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_paged_prefill_and_decode_match_jax(case, use_pallas):
    got, gk, gv = case["port"]
    want, wk, wv = _run_jax(case["jcfg"].replace(use_pallas=use_pallas),
                            case["jparams"])
    n_prefill = sum(len(list(_chunks(s))) for s in PROMPTS)
    assert n_prefill == 6 and len(got) == len(want) == n_prefill + STEPS
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape
        # decode rows of the inactive slot are garbage in both packages
        rows = slice(0, 2) if i >= n_prefill else slice(None)
        np.testing.assert_allclose(a[rows], b[rows], atol=ATOL, rtol=0,
                                   err_msg=f"call {i}")
    np.testing.assert_allclose(gk[:, 1:], wk[:, 1:], atol=ATOL, rtol=0)
    np.testing.assert_allclose(gv[:, 1:], wv[:, 1:], atol=ATOL, rtol=0)


def test_pad_rows_past_the_table_go_to_the_null_page(case):
    """The last chunk of slot 1 covers positions 12..17 with maxp * page =
    16: its pad rows 16 and 17 go to the null page instead of aliasing
    onto the last real page, whose slot 0 keeps position 12's K/V (the
    same as when that chunk is one unpadded token)."""
    cfg = case["tcfg"]
    params = params_from_jax(
        jax.tree_util.tree_map(np.asarray, case["jparams"]), "cpu")
    row = torch.from_numpy(_script()[0][1])
    prompt = _script()[1][1]
    shape = (cfg.n_layers, 1 + SLOTS * MAXP, PAGE, cfg.n_kv_heads, cfg.hd)
    pools = []
    for last in (np.r_[prompt[12:], np.zeros(5, np.int32)], prompt[12:]):
        kp, vp = torch.zeros(shape), torch.zeros(shape)
        with torch.no_grad():
            for p0, toks in ((0, prompt[:6]), (6, prompt[6:12]), (12, last)):
                tm.paged_prefill_chunk(params, cfg, kp, vp, row,
                                       torch.from_numpy(toks), p0)
        pools.append(kp)
    padded, exact = pools
    page = int(row[-1])
    # equal up to float32 rounding of the wider chunk; an aliased pad row
    # would overwrite the slot with another token's K
    torch.testing.assert_close(padded[:, page, 0], exact[:, page, 0],
                               rtol=0, atol=1e-5)
    assert exact[:, 0].abs().sum() == 0 and padded[:, 0, :2].abs().sum() > 0


def _record_flash(monkeypatch):
    """Treat every tensor as a CUDA tensor in the attention dispatch, and
    record (instead of launching) every call that reaches the flash
    kernel; the recorder returns the plain version's result."""
    calls = []
    route = blocks.flash_route

    def as_cuda(on_cuda, *args):
        return route(True, *args)

    def record(q, k, v, causal=True, window=None, scale=None):
        calls.append(tuple(q.shape))
        return flash_ops.flash_attention_ref(q, k, v, causal, window, scale)

    monkeypatch.setattr(blocks, "flash_route", as_cuda)
    monkeypatch.setattr(flash_ops, "flash_attention", record)
    return calls


def test_dispatch_paged_prefill_never_takes_the_flash_kernel(case,
                                                             monkeypatch):
    """Static prefill selects K1 once per layer; the paged prefill (its
    positions start at p0 and its unwritten slots carry -2^30) never does,
    so its logits stay those of the masked path."""
    cfg, tree = case["tcfg"], jax.tree_util.tree_map(np.asarray,
                                                     case["jparams"])
    params = params_from_jax(tree, "cpu")
    calls = _record_flash(monkeypatch)
    toks = torch.from_numpy(_script()[1][0][None].astype(np.int64))
    with torch.no_grad():
        tt.prefill(params, cfg, toks, max_len=16)
    assert len(calls) == cfg.n_layers
    calls.clear()
    got, _, _ = _run_port(cfg, tree)
    assert calls == []
    for a, b in zip(got, case["port"][0]):
        np.testing.assert_array_equal(a, b)


def test_flash_route_needs_declared_contiguous_positions():
    kv_len = torch.ones(1)
    assert blocks.flash_route(True, 8, None, True)
    assert not blocks.flash_route(True, 8, None, False)   # paged prefill
    assert not blocks.flash_route(False, 8, None, True)   # CPU tensor
    assert not blocks.flash_route(True, 1, None, True)    # one query
    assert not blocks.flash_route(True, 8, kv_len, True)  # ragged kv_len


def test_pools_are_updated_in_place(case):
    """The returned pools are the arguments, written in place."""
    cfg = case["tcfg"]
    params = params_from_jax(
        jax.tree_util.tree_map(np.asarray, case["jparams"]), "cpu")
    shape = (cfg.n_layers, 1 + SLOTS * MAXP, PAGE, cfg.n_kv_heads, cfg.hd)
    kp, vp = torch.zeros(shape), torch.zeros(shape)
    tables = to_tensor(_script()[0])
    with torch.no_grad():
        _, k2, v2 = tm.paged_prefill_chunk(params, cfg, kp, vp, tables[0],
                                           torch.arange(3, 7), 0)
        assert k2 is kp and v2 is vp and kp.abs().sum() > 0
        _, k3, v3 = tm.paged_decode_step(
            params, cfg, kp, vp, tables, torch.tensor([5, 6, 7]),
            torch.tensor([4, 0, 0], dtype=torch.int32),
            torch.tensor([1, 0, 0], dtype=torch.int32))
        assert k3 is kp and v3 is vp
