#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout, one GPU

Phases (any failure exits non-zero before the result line):

1. Set-up: print the card (``nvidia-smi`` name and power limit), turn TF32
   off for float32 matmuls and convolutions, and build every kernel of
   ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a (in parallel).
2. Kernels against their plain PyTorch versions on the card, in float32
   and bfloat16 at ``_tol`` (2e-5 / 5e-2): the CPU test sweep, the main
   path's shapes (H=12, Hkv=2, D=128; prefill at B=8 and B=32 over the
   math-prompt length, decode at B=8 and B=32 over the caches of the
   32- and 128-token rollouts of phase 3; paged decode at 32 slots over
   pages of 128 with mixed lengths up to prompt + 128 and shuffled
   tables, plus the permuted, poisoned, absurd-id and empty-row cases)
   and one long shape each.  K1 has two kernels (``_variant``): every
   bfloat16 case runs the tensor-core kernel through the wrapper (its
   launch counted by variant) and the CUDA-core kernel through its C
   entry, over a sweep of D 64 / 128, groups of 1, 5, 6, 7 and 8 heads,
   Sq 2..160, windows 9 / 200, Sq != Sk and non-causal, and a case whose
   rows at positions >= 47 attend nothing and must read 0.  K3 adds
   n_split forced to 1, 2 and 7 over 8192 slots with one valid, a window
   that empties the early splits, ring layouts over 1 and 4 splits,
   groups of 5..8, D 64 / 128 and C not a multiple of the tile, and is
   timed at n_split 1, 2, 4, 8 and the default at B=32 and B=8, 64 over
   8192 slots.  K2, on the same split-cache kernels, gets the same split
   cases over the paged layout (pages of 4 / 16 / 128) and the same split
   sweep.  K4 has two kernels (``_variant``): the tensor-core kernel
   (bfloat16 at D 64..512) runs through the wrapper at the CPU sweep's
   shapes widened to D 64 / 128 / 256 and at D 512 (train, prefill and
   long shapes), the CUDA-core kernel through its C entry beside it, both
   with the final carry.  GQA groups: K3 and K2 at G = 7 and 5 (the
   7B / 14B configs, 28 / 4 and 40 / 8 heads) and above 8, G = 12 (48 / 4,
   starcoder2-15b) and 16 (64 / 4), D = 128, at one split and at splits
   forced above 1, one launch a call; K1 prefill at the 7B / 14B head
   counts; bf16 times at G = 12 / 16.  Times
   (CUDA events, median of 20 launches, L2 flushed before each) for the
   kernel, its plain version and ``scaled_dot_product_attention`` as a
   yardstick (for the paged kernel over the pre-gathered dense cache: the
   gather is not timed), and K1's and K4's CUDA-core kernels in bfloat16
   beside their tensor-core ones, beside the least time the card could
   take for the same work, at the B=32 shapes and the long shapes.
3. Full-width serve.  Static engine: ``repro_torch.launch.serve.run`` with
   the reference launcher's own setup (qwen-distill-1.5b, float32,
   tokenizer vocab, B=8, 32 new tokens, greedy), then a timed
   ``RolloutEngine.generate`` on the published config (bfloat16, vocab
   151936, B=32, 128 new tokens, greedy).  Paged engine: ``run`` with
   ``--engine paged`` (8 requests through 4 slots, 32 new tokens), the
   same as 2-turn radix episodes over pages of 16 (the radix cache must
   hit), and a timed ``PagedEngine.generate_groups`` on the published
   config (8 tasks x group 8 through 32 slots, 128 new tokens, greedy).
   Each kernel's launch counter is set to 0 just before each run; after
   it the static runs must read exactly 28 flash launches per prefill, 28
   flash-decode launches per decode step and no paged launch, and the
   paged runs exactly 28 paged launches per decode step and no other (the
   paged prefill takes the masked path); serve.run (float32) launches only
   K1's CUDA-core kernel and the bfloat16 generate only its tensor-core
   kernel.  Profiled ``generate`` and ``generate_groups`` calls then split
   a decode step into device busy time and idle share (torch.profiler
   trace), and report the device busy time before the first decode kernel
   (weight fetch and prefill).  The scheduler on the card's measurements:
   the timed ``generate_groups`` run's ``EngineStats`` as an
   ``EngineReport`` filed under the H800 profile (decode steps > 0, g_eff
   > 1), whose ``ServingCostModel`` must give the clipped measured slot
   occupancy and g_eff for H800 and the analytic factors for H20; MILP
   plans of qwen-distill-1.5B / 7B / 14B on 8 H800 + 8 H20 (and 1.5B on
   16 H800) beside the analytic ones, with the scheduler's wall time on
   the card's host, and ``fit_gen_time`` over the run's samples.
   Training: ``repro_torch.launch.train`` at
   full width with the launcher's setup (float32: xlstm-1.3b 3 steps, its
   scans all on K4's CUDA-core kernel; qwen 2 steps with ``--schedule``,
   whose plan must split 16 devices into disjoint D_T / D_I with finite
   positive gamma, C_T and C_I), then timed and
   profiled GRPO steps of xlstm-1.3b on the published config (bfloat16,
   remat): 2 x 48 scan launches a step, all on the tensor-core kernel.
   The launcher's qwen run writes ``--trace``: the Chrome JSON must load
   and hold a produce span per produce, a train_step span per step and a
   publish instant per publish.  qwen-distill-1.5b's published config
   (bfloat16, vocab 151936, remat) takes a GRPO step in float32 and in
   bfloat16 from the same weights (losses within 5e-2), then timed and
   profiled bf16 steps: 2 x 28 K1 launches a step, all on the
   tensor-core kernel.  Checkpoints: ``launch.train --smoke
   --crash-after 2`` in a fresh process on the card exits 17 and its
   ``--resume`` finishes; qwen's launcher setup at full width and 2
   layers saves after 2 steps and restores into a fresh trainer bit for
   bit, then takes a third step.  qwen-distill-7B and -14B on their
   published configs (bfloat16, random init on the card, published and
   freed before the engines fetch) through ``RolloutEngine.generate`` and
   ``PagedEngine.generate_groups`` (pool sized from the free memory), B=8,
   32 new tokens, greedy, with exact launch counts.
4. Card against CPU, teacher-forced: the full width cut to 4 layers in
   float32, same params on both, 2 prompts.  Static: prefill + 8 decode
   steps fed the CPU's greedy tokens.  Paged: prefill in chunks of 16 over
   pages of 16 (so chunks with p0 > 0 run) + 8 paged decode steps with an
   inactive third slot.  Logits agree within 1e-3 of max |logit|.  xlstm:
   forward, prefill carry and 8 decode steps (its scans on the CUDA-core
   kernel); one train step of each family, loss and grad_norm within 1e-3.
   The 7B and 14B at full width cut to 2 layers, static path as above.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                 # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12,           # fp32 outside the tensor cores
              "bfloat16": 989e12}         # dense bf16 tensor cores
TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=5e-2, rtol=5e-2)}
# the reference's own tolerances for the mLSTM scan (tests/test_kernels.py)
MLSTM_TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
             "bfloat16": dict(atol=5e-2, rtol=5e-2)}
ARCH = "qwen-distill-1.5b"
EMPTY = -(2 ** 30)
CARD = {}          # nvidia-smi name and power limit, printed beside numbers


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ phase 1
def setup():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch next to {Path(__file__).name}: run it from "
             "the root of a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    CARD["card"] = smi.stdout.strip().splitlines()[0]
    say(CARD["card"])
    say(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    say(f"built {sorted(libs)} with {' '.join(_build.FLAGS)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in sorted(libs):
        for line in _build.build_log(name).splitlines():
            if ("ptxas info" in line and "Used" in line) or "spill" in line:
                say(f"  {name}: {line.split('ptxas info    :')[-1].strip()}")


# ------------------------------------------------------------------ phase 2
def _max_err(got, want):
    return float((got.float() - want.float()).abs().max())


def _check(name, got, want, dtype, shape, stats, tols=TOL):
    import torch
    torch.cuda.synchronize()
    tol = tols[dtype]
    err = _max_err(got, want)
    bound = tol["atol"] + tol["rtol"] * float(want.float().abs().max())
    finite = bool(torch.isfinite(got.float()).all())
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name} {shape} {dtype}: shape/dtype {tuple(got.shape)} "
             f"{got.dtype} != {tuple(want.shape)} {want.dtype}")
    close = torch.allclose(got.float(), want.float(), **tol)
    stats["checks"] += 1
    stats["max_abs_err"] = max(stats["max_abs_err"], err)
    if not (close and finite):
        fail(f"{name} {shape} {dtype}: max |kernel - plain| = {err:.3e} "
             f"(allowed {bound:.3e}), finite={finite}")


def _time_ms(fn, flush, reps=20):
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def _bound_ms(n_bytes, flops, dtype):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _rand(shape, dtype, gen):
    import torch
    return torch.randn(shape, generator=gen, device="cuda").to(
        getattr(torch, dtype))


def flash_case(B, Sq, Sk, H, Hkv, D, dtype, gen):
    q = _rand((B, Sq, H, D), dtype, gen)
    k = _rand((B, Sk, Hkv, D), dtype, gen)
    v = _rand((B, Sk, Hkv, D), dtype, gen)
    return q, k, v


def flash_work(B, Sq, Sk, H, Hkv, D, causal, window, itemsize):
    """(bytes, FLOPs) this call needs: each input read and the output
    written once; 4*D FLOPs per attended (query, key) pair."""
    pairs = 0
    for i in range(Sq):
        hi = min(i + 1, Sk) if causal else Sk
        lo = max(0, i - window + 1) if window is not None else 0
        pairs += max(0, hi - lo)
    n_bytes = itemsize * D * (2 * B * Sq * H + 2 * B * Sk * Hkv)
    return n_bytes, 4.0 * D * H * B * pairs


def decode_case(B, H, Hkv, D, C, valid, dtype, gen):
    import torch
    q = _rand((B, H, D), dtype, gen)
    k = _rand((B, C, Hkv, D), dtype, gen)
    v = _rand((B, C, Hkv, D), dtype, gen)
    q_pos = torch.as_tensor(valid, dtype=torch.int32, device="cuda") - 1
    slot = torch.arange(C, dtype=torch.int32, device="cuda")[None]
    k_pos = torch.where(slot <= q_pos[:, None], slot,
                        torch.full_like(slot, EMPTY)).contiguous()
    return q, k, v, q_pos.contiguous(), k_pos


def decode_work(B, H, Hkv, D, C, valid, itemsize):
    n_bytes = itemsize * D * (2 * B * H + 2 * B * C * Hkv) + 4 * B * (1 + C)
    return n_bytes, 4.0 * D * H * sum(valid)


def paged_case(B, H, Hkv, D, page, maxp, lens, dtype, gen):
    """Random pool of B * maxp + 1 pages, shuffled block tables, given
    lengths."""
    import torch
    P = B * maxp + 1
    q = _rand((B, H, D), dtype, gen)
    kp = _rand((P, page, Hkv, D), dtype, gen)
    vp = _rand((P, page, Hkv, D), dtype, gen)
    ids = torch.randperm(P - 1, generator=gen, device="cuda") + 1
    bt = ids[:B * maxp].reshape(B, maxp).to(torch.int32).contiguous()
    lengths = torch.as_tensor(lens, dtype=torch.int32, device="cuda")
    return q, kp, vp, bt, lengths


def paged_work(B, H, Hkv, D, page, maxp, lens, itemsize):
    """(bytes, FLOPs) of one paged decode call without a window: q read
    and o written once, the K/V rows of the attended slots read once,
    tables and lengths."""
    attended = sum(min(n, maxp * page) for n in lens)
    n_bytes = (itemsize * D * (2 * B * H + 2 * Hkv * attended)
               + 4 * B * (maxp + 1))
    return n_bytes, 4.0 * D * H * attended


def paged_kernel_phase(prompt_len, new_tokens):
    """Hold the paged flash-decode kernel to its plain version; time the
    main-path and long shapes.  Returns its record of the result line."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import _num_splits, _sm_count
    from repro_torch.kernels.paged_attention.ops import (
        _paged_splits, paged_decode_attention, paged_decode_attention_ref)

    gen = torch.Generator(device="cuda").manual_seed(1)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    stats = {"checks": 0, "max_abs_err": 0.0}
    timings = {}

    def check(what, got, want, dtype, shape):
        _check("paged_flash_decode", got, want, dtype, shape, stats)
        say(f"  paged_flash_decode {shape} {what} {dtype}: ok, max err "
            f"{_max_err(got, want):.2e}")

    # the CPU test sweep, with and without a window
    for shape in [(1, 2, 2, 8, 4, 2), (2, 4, 2, 16, 8, 4),
                  (2, 8, 1, 64, 16, 3), (3, 6, 3, 20, 8, 5)]:
        B, H, Hkv, D, page, maxp = shape
        for window in (None, 7):
            for dtype in ("float32", "bfloat16"):
                lens = torch.randint(1, page * maxp + 1, (B,), generator=gen,
                                     device="cuda").tolist()
                args = paged_case(*shape, lens, dtype, gen)
                check(f"window={window}",
                      paged_decode_attention(*args, window=window),
                      paged_decode_attention_ref(*args, window=window),
                      dtype, shape)
    shape = (2, 4, 2, 16, 8, 3)
    B, H, Hkv, D, page, maxp = shape
    for dtype in ("float32", "bfloat16"):
        q, kp, vp, bt, lens = paged_case(*shape, [11, 24], dtype, gen)
        base = paged_decode_attention(q, kp, vp, bt, lens)
        # the pool permuted and the tables following it: the same output
        P = kp.shape[0]
        perm = torch.cat([torch.zeros(1, dtype=torch.long, device="cuda"),
                          torch.randperm(P - 1, generator=gen,
                                         device="cuda") + 1])
        inv = torch.argsort(perm)
        check("permuted", paged_decode_attention(
            q, kp[inv].contiguous(), vp[inv].contiguous(),
            perm[bt.long()].to(torch.int32).contiguous(), lens), base,
            dtype, shape)
        # huge garbage in the null page and the dead slots: the clean
        # pool's answer
        want = paged_decode_attention_ref(q, kp, vp, bt, lens)
        kq, vq = kp.clone(), vp.clone()
        kq[0], vq[0] = 1e6, -1e6
        for b in range(B):
            for slot in range(int(lens[b]), maxp * page):
                pid = int(bt[b, slot // page])
                kq[pid, slot % page], vq[pid, slot % page] = 1e6, -1e6
        check("poisoned", paged_decode_attention(q, kq, vq, bt, lens),
              want, dtype, shape)
        # absurd ids past the page a row needs: clamped and masked
        absurd = bt.clone()
        absurd[:, 1:] = 10 ** 6
        short = torch.tensor([1, 5], dtype=torch.int32, device="cuda")
        check("absurd ids", paged_decode_attention(q, kp, vp, absurd, short),
              paged_decode_attention_ref(q, kp, vp, absurd.clamp(0, P - 1),
                                         short), dtype, shape)
        # a row with nothing to attend to gives 0
        empty = torch.tensor([0, 7], dtype=torch.int32, device="cuda")
        got = paged_decode_attention(q, kp, vp, bt, empty)
        check("empty row", got,
              paged_decode_attention_ref(q, kp, vp, bt, empty), dtype, shape)
        if bool(got[0].any()):
            fail("paged_flash_decode: a row of length 0 is not 0")

    # K3's split cases over the paged layout, n_split forced through
    # _num_splits.force (shared by both kernels): most splits empty (one
    # valid slot of 8192), a window that empties the early splits, pages of
    # 4 / 16 / 128 (tiles spanning pages), groups of 5..8 heads at D 64 /
    # 128 with and without a window
    pcases = [((2, 12, 2, 128, 16, 512), None, n, "one") for n in (1, 2, 7)]
    pcases += [((4, 12, 2, 128, 16, 63), 100, n, "full") for n in (None, 5)]
    pcases += [((3, 12, 2, 128, page, -(-1000 // page)), None, None,
                "ragged") for page in (4, 16, 128)]
    pcases += [((3, 2 * G, 2, D, 8, 10), w, n, "ragged")
               for G in (5, 6, 7, 8) for D in (64, 128)
               for w, n in [(None, None), (30, 3)]]
    try:
        for shape, window, force, kind in pcases:
            B, H, Hkv, D, page, maxp = shape
            C = maxp * page
            lens = ([C] * B if kind == "full" else [1] * B if kind == "one"
                    else [max(1, C * (b + 1) // (B + 1)) for b in range(B)])
            _num_splits.force = force
            for dtype in ("float32", "bfloat16"):
                args = paged_case(*shape, lens, dtype, gen)
                n_split = _paged_splits(B, Hkv, maxp, page, window,
                                        args[0].dtype, D, _sm_count(
                                            args[0].device))
                check(f"window={window} n_split={n_split} {kind}",
                      paged_decode_attention(*args, window=window),
                      paged_decode_attention_ref(*args, window=window),
                      dtype, shape)
    finally:
        _num_splits.force = None

    # the main path (32 slots, pages of 128, lengths up to prompt + 128)
    # and the long shape
    cap = prompt_len + new_tokens
    main = (32, 12, 2, 128, 128, -(-cap // 128))
    long = (64, 12, 2, 128, 128, 64)
    main_lens = torch.randint(prompt_len, cap + 1, (32,), generator=gen,
                              device="cuda").tolist()
    for shape in (main, long):
        B, H, Hkv, D, page, maxp = shape
        lens = main_lens if shape == main else [8192] * B
        for dtype in ("float32", "bfloat16"):
            args = paged_case(*shape, lens, dtype, gen)
            check("lengths " + ("mixed" if shape == main else "8192"),
                  paged_decode_attention(*args),
                  paged_decode_attention_ref(*args), dtype, shape)
            if dtype != "bfloat16":
                continue
            q, kp, vp, bt, lengths = args
            C = maxp * page
            kd, vd = (x[bt.long()].reshape(B, C, Hkv, D).transpose(1, 2)
                      .contiguous() for x in (kp, vp))
            mask = (torch.arange(C, device="cuda")[None]
                    < lengths[:, None])[:, None, None]
            qt = q[:, :, None]
            n_bytes, flops = paged_work(*shape, lens, q.element_size())
            bound, by = _bound_ms(n_bytes, flops, dtype)
            timings[shape] = dict(
                ms=_time_ms(lambda: paged_decode_attention(*args), flush),
                plain_ms=_time_ms(lambda: paged_decode_attention_ref(*args),
                                  flush),
                library_ms=_time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kd, vd, attn_mask=mask, enable_gqa=True), flush),
                bound_ms=bound, bound_by=by,
                n_split=_paged_splits(B, Hkv, maxp, page, None, q.dtype, D,
                                      _sm_count(q.device)))
            del kd, vd
            torch.cuda.synchronize()
    for shape, t in timings.items():
        say(f"  time paged {shape} bfloat16: kernel {t['ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}), plain "
            f"{t['plain_ms']:.4f} ms, sdpa over the pre-gathered cache "
            f"(gather not timed) {t['library_ms']:.4f} ms, n_split "
            f"{t['n_split']}")

    # the split count against time: n_split forced, and the default
    split_sweep = {}
    try:
        for shape in (main, (8, 12, 2, 128, 128, 64), long):
            B, H, Hkv, D, page, maxp = shape
            lens = main_lens if shape == main else [8192] * B
            for dtype in ("float32", "bfloat16"):
                args = paged_case(*shape, lens, dtype, gen)
                row = {}
                for force in (1, 2, 4, 8, None):
                    _num_splits.force = force
                    n = _paged_splits(B, Hkv, maxp, page, None,
                                      args[0].dtype, D,
                                      _sm_count(args[0].device))
                    key = "default" if force is None else str(n)
                    row[key] = dict(n_split=n, ms=_time_ms(
                        lambda: paged_decode_attention(*args), flush))
                split_sweep[f"{dtype} {shape}"] = row
                say(f"  time paged {shape} {dtype} by n_split: "
                    + ", ".join(f"{key} {r['ms']:.4f} ms" if key != "default"
                                else f"default ({r['n_split']}) "
                                     f"{r['ms']:.4f} ms"
                                for key, r in row.items()))
                del args
                torch.cuda.synchronize()
    finally:
        _num_splits.force = None
    say(f"kernels: paged_flash_decode holds to its plain version at every "
        f"shape ({stats['checks']} checks)")
    return dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/paged_flash_decode.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:116",
        max_abs_err=stats["max_abs_err"], checks=stats["checks"],
        library="scaled_dot_product_attention over the pre-gathered dense "
                "cache (gather not timed)",
        **timings[main], long=dict(shape=long, **timings[long]),
        split_sweep=split_sweep)


def gqa_phase(prompt_len, new_tokens):
    """K3 and K2 at the GQA groups of the repo's configs, G = 7 (7B,
    28 / 4), 5 (14B, 40 / 8), 12 (starcoder2-15b, 48 / 4) and 16
    (qwen3-moe, 64 / 4), D = 128, in float32 and bfloat16 at one split and
    at splits forced above 1 (above G = 8 the head groups must keep their
    merge tickets apart), held to the plain versions; K1 prefill at the 7B
    and 14B head counts; bf16 times at G = 12 and 16 at the main and long
    shapes.  Returns {kernel: record part}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import (
        _head_groups, _num_splits, _sm_count, _waves, decode_attention,
        decode_attention_ref)
    from repro_torch.kernels.flash_attention.ops import (
        _variant, flash_attention, flash_attention_ref)
    from repro_torch.kernels.paged_attention.ops import (
        _paged_splits, paged_decode_attention, paged_decode_attention_ref)

    gen = torch.Generator(device="cuda").manual_seed(6)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    stats = {name: {"checks": 0, "max_abs_err": 0.0} for name in
             ("flash_attention_fwd", "flash_decode", "paged_flash_decode")}
    groups = [(28, 4), (40, 8), (48, 4), (64, 4)]

    def once(wrapper, name, call, want, dtype, shape, what):
        before = wrapper.launches
        got = call()
        if wrapper.launches != before + 1:
            fail(f"{name} {shape} {dtype}: {wrapper.launches - before} "
                 "launches for one call")
        _check(name, got, want(), dtype, shape, stats[name])
        say(f"  {name} {shape} {what} {dtype}: ok, max err "
            f"{stats[name]['max_abs_err']:.2e}")

    for H, Hkv in groups[:2]:
        shape = (8, prompt_len, prompt_len, H, Hkv, 128)
        for dtype in ("float32", "bfloat16"):
            q, k, v = flash_case(*shape, dtype, gen)
            variant = _variant(q.dtype, 128)
            n = flash_attention.launches_by_variant[variant]
            once(flash_attention, "flash_attention_fwd",
                 lambda: flash_attention(q, k, v),
                 lambda: flash_attention_ref(q, k, v), dtype, shape,
                 f"({variant})")
            if flash_attention.launches_by_variant[variant] != n + 1:
                fail(f"flash_attention {shape} {dtype}: not on {variant}")
    try:
        for H, Hkv in groups:
            G = H // Hkv
            for B, C, forces in [(8, prompt_len + 32, (1, 3)),
                                 (4, 8192, (1, 4))]:
                valid = [max(1, C * (b + 1) // B) for b in range(B)]
                for force in forces:
                    _num_splits.force = force
                    for dtype in ("float32", "bfloat16"):
                        shape = (B, H, Hkv, 128, C)
                        q, k, v, q_pos, k_pos = decode_case(*shape, valid,
                                                            dtype, gen)
                        once(decode_attention, "flash_decode",
                             lambda: decode_attention(q, k, v, q_pos, k_pos),
                             lambda: decode_attention_ref(q, k, v, q_pos,
                                                          k_pos),
                             dtype, shape, f"G={G} n_split={force}")
                        del q, k, v
                        page = 128
                        maxp = -(-C // page)
                        pshape = (B, H, Hkv, 128, page, maxp)
                        args = paged_case(*pshape, valid, dtype, gen)
                        once(paged_decode_attention, "paged_flash_decode",
                             lambda: paged_decode_attention(*args),
                             lambda: paged_decode_attention_ref(*args),
                             dtype, pshape, f"G={G} n_split={force}")
                        del args
                        torch.cuda.synchronize()
    finally:
        _num_splits.force = None

    # bf16 times at G = 12 and 16: the main path's shape and the long one
    timings = {"flash_decode": {}, "paged_flash_decode": {}}
    for H, Hkv in groups[2:]:
        G = H // Hkv
        for B, C in [(32, prompt_len + new_tokens), (64, 8192)]:
            shape = (B, H, Hkv, 128, C)
            valid = [C] * B
            q, k, v, q_pos, k_pos = decode_case(*shape, valid, "bfloat16",
                                                gen)
            qt = q[:, :, None]
            kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
            mask = ((k_pos >= 0) & (k_pos <= q_pos[:, None]))[:, None, None]
            bound, by = _bound_ms(*decode_work(*shape, valid, 2), "bfloat16")
            timings["flash_decode"][f"G={G} {shape}"] = dict(
                ms=_time_ms(lambda: decode_attention(q, k, v, q_pos, k_pos),
                            flush),
                plain_ms=_time_ms(lambda: decode_attention_ref(
                    q, k, v, q_pos, k_pos), flush),
                library_ms=_time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True), flush),
                bound_ms=bound, bound_by=by,
                n_split=_num_splits(B, Hkv * _head_groups(G)[0], C,
                                    _sm_count(q.device),
                                    waves=_waves(q.dtype, 128)),
                head_groups=_head_groups(G)[0])
            del q, k, v, kt, vt
            page = 128
            maxp = -(-C // page)
            pshape = (B, H, Hkv, 128, page, maxp)
            args = paged_case(*pshape, valid, "bfloat16", gen)
            qp, kp, vp, bt, lengths = args
            kd, vd = (x[bt.long()].reshape(B, maxp * page, Hkv, 128)
                      .transpose(1, 2).contiguous() for x in (kp, vp))
            pmask = (torch.arange(maxp * page, device="cuda")[None]
                     < lengths[:, None])[:, None, None]
            pt = qp[:, :, None]
            bound, by = _bound_ms(*paged_work(*pshape, valid, 2), "bfloat16")
            timings["paged_flash_decode"][f"G={G} {pshape}"] = dict(
                ms=_time_ms(lambda: paged_decode_attention(*args), flush),
                plain_ms=_time_ms(lambda: paged_decode_attention_ref(*args),
                                  flush),
                library_ms=_time_ms(lambda: F.scaled_dot_product_attention(
                    pt, kd, vd, attn_mask=pmask, enable_gqa=True), flush),
                bound_ms=bound, bound_by=by,
                n_split=_paged_splits(B, Hkv, maxp, page, None, qp.dtype,
                                      128, _sm_count(qp.device), G),
                head_groups=_head_groups(G)[0])
            del args, qp, kp, vp, kd, vd
            torch.cuda.synchronize()
    for name, rows in timings.items():
        for key, t in rows.items():
            say(f"  time {name} {key} bfloat16: kernel {t['ms']:.4f} ms, "
                f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}), plain "
                f"{t['plain_ms']:.4f} ms, sdpa {t['library_ms']:.4f} ms, "
                f"n_split {t['n_split']}, head groups {t['head_groups']} "
                f"({CARD['card']})")
    say("kernels: K1 at the 7B / 14B head counts, K3 and K2 at G = 5, 7, "
        "12, 16 hold to their plain versions ("
        + ", ".join(f"{k} {v['checks']} checks" for k, v in stats.items())
        + "), one launch a call")
    return {name: dict(stats[name], **({"times_bf16": timings[name]}
                                       if name in timings else {}))
            for name in stats}


def mlstm_case(B, S, H, D, dtype, gen):
    import torch
    q, k, v = (_rand((B, S, H, D), dtype, gen) for _ in range(3))
    ig = torch.randn((B, S, H), generator=gen, device="cuda")
    fg = torch.randn((B, S, H), generator=gen, device="cuda") + 2.0
    return q, k, v, ig, fg


def mlstm_plain(q, k, v, ig, fg, chunk, return_state=False):
    """The plain chunkwise version on the model layout, with the
    wrapper's own padding and flattening."""
    from repro_torch.kernels.ssm_scan.ref import mlstm_chunkwise_ref
    B, S, H, D = q.shape

    def flat(x):
        return x.movedim(2, 1).reshape(B * H, S, *x.shape[3:])

    out = mlstm_chunkwise_ref(*(flat(x) for x in (q, k, v, ig, fg)),
                              chunk, return_state)
    h, state = out if return_state else (out, None)
    h = h.reshape(B, H, S, D).movedim(1, 2)
    if not return_state:
        return h
    C, n, m = state
    return h, (C.reshape(B, H, D, D), n.reshape(B, H, D), m.reshape(B, H))


def mlstm_work(B, S, H, D, chunk, itemsize):
    """(bytes, FLOPs) of one scan: q/k/v read and h written once over the
    padded length, the float32 gates; per chunk and row 4 T^2 D + 4 T D^2
    FLOPs (q k^T, scores v, q C, the C update).  ``q n_t`` needs no
    ``[T, D]`` product: it is the row sum of the weighted scores plus
    ``e^(a - m) q n``."""
    Sp = -(-S // chunk) * chunk
    BH = B * H
    n_bytes = itemsize * 4 * BH * Sp * D + 4 * 2 * BH * Sp
    return n_bytes, BH * (Sp // chunk) * (4.0 * chunk ** 2 * D
                                          + 4.0 * chunk * D ** 2)


def _pass_ms(fn, names, reps=5):
    """Device ms per call of each kernel of ``fn`` whose name holds one of
    ``names`` (torch.profiler, ``reps`` calls, L2 not flushed)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {name: sum(e.device_time_total for e in prof.key_averages()
                      if name in e.key) / reps / 1e3 for name in names}


def _simt_scan(q, k, v, ig, fg, chunk, return_state=False):
    """K4's CUDA-core kernel (csrc/mlstm_scan.cu) through its C entry,
    whatever the dtype, on the model layout with the wrapper's padding and
    flattening: the wrapper sends bfloat16 at D in MMA_D to the tensor-core
    kernel, so this is how the phase holds the older design to the plain
    version in bfloat16 too, and times it beside the new one.  Not counted
    as a launch."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssm_scan import ops

    def flat(q, k, v, ig, fg, chunk, return_state):
        BH, S, D = q.shape
        h = torch.empty_like(q)
        state = ops._empty_state(BH, D, q.device) if return_state else None
        lib = ops._lib("simt")
        err = lib.mlstm_scan(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ig.data_ptr(),
            fg.data_ptr(), h.data_ptr(), *ops._state_ptrs(state), BH, S, D,
            chunk, 1.0 / math.sqrt(D), ops._DTYPES[q.dtype],
            q.device.index or 0,
            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(lib, "mlstm_scan", err)
        return (h, state) if return_state else h

    B, _, H, D = q.shape
    out = ops._on_flat(flat, q, k, v, ig, fg, chunk, return_state)
    if not return_state:
        return out
    h, (C, n, m) = out
    return h, (C.reshape(B, H, D, D), n.reshape(B, H, D), m.reshape(B, H))


def ssm_kernel_phase(train_len):
    """Hold both mLSTM scan kernels (K4: ``_variant`` picks "mma" for bf16
    at D in MMA_D, "simt" otherwise) to the plain chunkwise version in
    float32 and bfloat16, the final carry included; time the main-path and
    long shapes, the CUDA-core kernel in bf16 beside the tensor-core one.
    Returns its record of the result line."""
    import torch
    from repro_torch.kernels.ssm_scan.ops import _variant, mlstm_scan

    gen = torch.Generator(device="cuda").manual_seed(2)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    stats = {"checks": 0, "max_abs_err": 0.0}
    timings = {}
    chunk = 64

    def check(what, got, want, dtype, shape):
        _check("mlstm_scan", got, want, dtype, shape, stats, MLSTM_TOL)
        say(f"  mlstm_scan {shape} {what} {dtype}: ok, max err "
            f"{_max_err(got, want):.2e}")

    # the CPU test sweep (B, S, H, D, chunk), S = 50 the padding path, and
    # the same at the D the tensor-core kernel is built for; then the
    # xlstm-1.3b train batch of the launcher (8 x 4 heads, S 160 padded to
    # 192), its prefill (S 33) and a long shape
    main = (8, train_len, 4, 512, chunk)
    prefill = (8, 33, 4, 512, chunk)
    long = (4, 4096, 4, 512, chunk)
    sweep = [(1, 16, 1, 8, 8), (2, 50, 4, 16, 16), (1, 64, 2, 32, 32)]
    sweep += [(B, S, H, D, T) for (B, S, H, _, T), D in
              zip(sweep, (64, 128, 256))]
    with_state = (prefill, main, (2, 50, 4, 16, 16), (2, 50, 4, 128, 16))
    for shape in sweep + [main, prefill, long]:
        B, S, H, D, T = shape
        for dtype in ("float32", "bfloat16"):
            args = mlstm_case(B, S, H, D, dtype, gen)
            variant = _variant(args[0].dtype, D)
            before = dict(mlstm_scan.launches_by_variant)
            got = mlstm_scan(*args, chunk=T)
            if (mlstm_scan.launches_by_variant[variant]
                    != before[variant] + 1):
                fail(f"mlstm_scan {shape} {dtype}: variant counts {before} "
                     f"-> {mlstm_scan.launches_by_variant}, expected one "
                     f"{variant} launch")
            want = mlstm_plain(*args, T)
            check(f"h ({variant})", got, want, dtype, shape)
            if variant == "mma":
                check("h (simt)", _simt_scan(*args, T), want, dtype, shape)
            del got, want
            if shape in with_state:
                h_ref, ref = mlstm_plain(*args, T, return_state=True)
                runs = {variant: mlstm_scan(*args, chunk=T,
                                            return_state=True)}
                if variant == "mma":
                    runs["simt"] = _simt_scan(*args, T, return_state=True)
                for name, (h, state) in runs.items():
                    check(f"h with state ({name})", h, h_ref, dtype, shape)
                    for part, got, want in zip("Cnm", state, ref):
                        check(f"final {part} ({name})", got, want, dtype,
                              shape)
                del runs, h_ref, ref
            if shape in (main, long):
                if dtype == "bfloat16" and variant != "mma":
                    fail(f"mlstm_scan {shape} bf16 took {variant}")
                n_bytes, flops = mlstm_work(B, S, H, D, T,
                                            args[0].element_size())
                bound, by = _bound_ms(n_bytes, flops, dtype)
                t = dict(
                    ms=_time_ms(lambda: mlstm_scan(*args, chunk=T), flush),
                    plain_ms=_time_ms(lambda: mlstm_plain(*args, T), flush),
                    library_ms=None, bound_ms=bound, bound_by=by,
                    variant=variant)
                if variant == "mma":
                    t["simt_ms"] = _time_ms(lambda: _simt_scan(*args, T),
                                            flush)
                    t["passes_ms"] = _pass_ms(lambda: mlstm_scan(
                        *args, chunk=T), ("mlstm_intra", "mlstm_carry"))
                timings[(shape, dtype)] = t
            del args
            torch.cuda.synchronize()
    for (shape, dtype), t in timings.items():
        extra = (f", CUDA-core kernel {t['simt_ms']:.4f} ms, by pass "
                 + ", ".join(f"{k} {v:.4f} ms" for k, v in
                             t["passes_ms"].items())
                 if "simt_ms" in t else "")
        say(f"  time mlstm_scan {shape} {dtype} ({t['variant']}): kernel "
            f"{t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}), plain {t['plain_ms']:.4f} ms, no single "
            f"PyTorch call{extra}")
    say(f"kernels: mlstm_scan (both kernels) holds to its plain version at "
        f"every shape ({stats['checks']} checks)")
    return dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/mlstm_scan_sm90.cu",
        sources={"mma": "src/repro_torch/kernels/csrc/mlstm_scan_sm90.cu",
                 "simt": "src/repro_torch/kernels/csrc/mlstm_scan.cu"},
        replaces="src/repro/kernels/ssm_scan/kernel.py:87",
        max_abs_err=stats["max_abs_err"], checks=stats["checks"],
        library="none: no single PyTorch call computes the mLSTM scan",
        **timings[(main, "bfloat16")],
        float32=timings[(main, "float32")],
        long=dict(shape=long, **timings[(long, "bfloat16")]),
        long_float32=timings[(long, "float32")])


def flash_grad_phase():
    """K1's autograd backward on the card: dq/dk/dv of the kernel route
    against the plain route's, in float32 and bfloat16."""
    import torch
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_ref)

    gen = torch.Generator(device="cuda").manual_seed(3)
    stats = {"checks": 0, "max_abs_err": 0.0}
    for shape, window in [((2, 40, 40, 4, 2, 16), None),
                          ((2, 33, 33, 4, 4, 24), 9),
                          ((8, 160, 160, 12, 2, 128), None)]:
        for dtype in ("float32", "bfloat16"):
            q, k, v = flash_case(*shape, dtype, gen)
            do = _rand(q.shape, dtype, gen)
            grads = []
            for fn in (flash_attention, flash_attention_ref):
                xs = [x.clone().requires_grad_() for x in (q, k, v)]
                fn(*xs, True, window).backward(do)
                grads.append([x.grad for x in xs])
            for name, got, want in zip(("dq", "dk", "dv"), *grads):
                _check("flash_attention backward", got, want, dtype, shape,
                       stats)
            say(f"  flash_attention backward {shape} window={window} "
                f"{dtype}: ok, max err {stats['max_abs_err']:.2e}")
    return stats


def _simt_flash(q, k, v, causal, window):
    """K1's CUDA-core kernel (csrc/flash_attention_fwd.cu) through its C
    entry, whatever the dtype: the wrapper sends bfloat16 at D = 64 or 128
    to the tensor-core kernel, so this is how the sweep holds the older
    design to the plain version in bfloat16 too, and how the phase times
    it beside the new one.  Not counted as a launch."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops

    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lib = ops._lib("simt")
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Sq, Sk,
        H, Hkv, D, int(causal), -1 if window is None else int(window),
        1.0 / math.sqrt(D), ops._DTYPES[q.dtype], q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "flash_attention_fwd", err)
    return o


def kernels_phase(prompt_len, new_tokens):
    """Hold K1 (both kernels) and K3 to their plain versions over the
    sweeps; time the main-path and long shapes.  Returns the per-kernel
    records of the result line."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import (
        _num_splits, _sm_count, _waves, decode_attention,
        decode_attention_ref)
    from repro_torch.kernels.flash_attention.ops import (
        _variant, flash_attention, flash_attention_ref)

    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    fstats = {"checks": 0, "max_abs_err": 0.0}
    dstats = {"checks": 0, "max_abs_err": 0.0}
    timings = {}

    # -- flash attention (K1)
    # serve.run (B=8, float32) and the timed generate (B=32, bfloat16)
    serve_f = (8, prompt_len, prompt_len, 12, 2, 128)
    main_f = (32, prompt_len, prompt_len, 12, 2, 128)
    long_f = (4, 4096, 4096, 12, 2, 128)
    # rows at positions >= 47 attend nothing (keys < 32, window 16)
    masked_f = (2, 96, 32, 8, 2, 128)
    shapes = [((2, 33, 65, 4, 4, 24), m) for m in
              [(True, None), (True, 9), (False, None)]]
    shapes += [((2, 40, 40, 4, 2, 16), (True, 9)),
               ((1, 24, 24, 4, 1, 8), (True, None)),
               ((1, 128, 128, 8, 2, 64), (True, 20)),
               (masked_f, (True, 16)),
               (serve_f, (True, None)), (main_f, (True, None)),
               (long_f, (True, None))]
    # the tensor-core sweep: D 64 / 128, groups of 1 and of the
    # 1.5B / 7B / 14B configs (6, 7, 5) and 8; lengths around the 128-row
    # tile (G = 6, Sq = 22 is 132 rows); windows; Sq != Sk; non-causal
    sweep = []
    for D in (64, 128):
        for G in (1, 5, 6, 7, 8):
            sweep += [((2, S, S, 2 * G, 2, D), (True, None))
                      for S in (2, 22, 33, 65, 100, 160)]
            sweep += [((2, 100, 100, 2 * G, 2, D), m)
                      for m in [(True, 9), (True, 200), (False, None)]]
            sweep += [((2, 33, 65, 2 * G, 2, D), m)
                      for m in [(True, None), (False, None)]]
    for shape, (causal, window) in shapes + sweep:
        B, Sq, Sk, H, Hkv, D = shape
        errs = []
        for dtype in ("float32", "bfloat16"):
            q, k, v = flash_case(*shape, dtype, gen)
            variant = _variant(q.dtype, D)
            before = dict(flash_attention.launches_by_variant)
            got = flash_attention(q, k, v, causal, window)
            after = flash_attention.launches_by_variant
            if after[variant] != before[variant] + 1:
                fail(f"flash_attention {shape} {dtype}: variant counts "
                     f"{before} -> {after}, expected one {variant} launch")
            want = flash_attention_ref(q, k, v, causal, window)
            outs = {variant: got}
            if variant == "wgmma":
                outs["simt"] = _simt_flash(q, k, v, causal, window)
            for name, out in outs.items():
                _check(f"flash_attention_fwd ({name})", out, want, dtype,
                       shape, fstats)
                errs.append(f"{dtype} {name} {_max_err(out, want):.2e}")
                if shape == masked_f and bool(out[:, 47:].abs().max() != 0):
                    fail(f"flash_attention_fwd ({name}) {shape} {dtype}: "
                         "rows that attend nothing are not 0")
            del got, want, outs
            if shape in (main_f, long_f):
                if dtype == "bfloat16" and variant != "wgmma":
                    fail(f"flash_attention {shape} bf16 took {variant}")
                qt, kt, vt = (x.transpose(1, 2).contiguous()
                              for x in (q, k, v))
                n_bytes, flops = flash_work(*shape, causal, window,
                                            q.element_size())
                bound, by = _bound_ms(n_bytes, flops, dtype)
                t = dict(
                    ms=_time_ms(lambda: flash_attention(q, k, v, causal,
                                                        window), flush),
                    plain_ms=_time_ms(lambda: flash_attention_ref(
                        q, k, v, causal, window), flush),
                    library_ms=_time_ms(lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, enable_gqa=True), flush),
                    bound_ms=bound, bound_by=by, variant=variant)
                if variant == "wgmma":
                    t["simt_ms"] = _time_ms(lambda: _simt_flash(
                        q, k, v, causal, window), flush)
                timings[("flash", shape, dtype)] = t
            del q, k, v
            torch.cuda.synchronize()
        if (shape, (causal, window)) in shapes or shape[3:] == (12, 2, 128):
            say(f"  flash_attention_fwd {shape} causal={causal} "
                f"window={window}: ok, max err " + ", ".join(errs))
    say(f"  flash_attention_fwd tensor-core sweep: {len(sweep)} shapes, "
        "both kernels in bf16 and the CUDA-core kernel in f32 hold to the "
        "plain version; rows that attend nothing read 0")

    # -- flash decode (K3)
    serve_d = (8, 12, 2, 128, prompt_len + 32)
    main_d = (32, 12, 2, 128, prompt_len + new_tokens)
    long_d = (64, 12, 2, 128, 8192)
    # (shape, window, forced n_split, valid lengths: "full", "one" or
    # ragged)
    dcases = [((2, 4, 2, 16, 24), w, None, "ragged") for w in (None, 8)]
    dcases += [((2, 8, 1, 64, 40), 8, None, "ragged"),
               ((3, 6, 3, 20, 17), None, None, "ragged"),
               ((4, 4, 2, 16, 40), 6, None, "ragged"),
               (serve_d, None, None, "full"), (main_d, None, None, "full"),
               (long_d, None, None, "full")]
    # most splits empty: one valid slot of 8192, n_split forced
    dcases += [((2, 12, 2, 128, 8192), None, n, "one") for n in (1, 2, 7)]
    # a window that empties the early splits
    dcases += [((4, 12, 2, 128, 1000), 100, n, "full") for n in (None, 5)]
    # groups of 5..8 heads, D 64 / 128, C not a multiple of the tile
    dcases += [((3, 2 * G, 2, D, 77), w, n, "ragged")
               for G in (5, 6, 7, 8) for D in (64, 128)
               for w, n in [(None, None), (30, 3)]]
    try:
        for shape, window, force, lens in dcases:
            B, H, Hkv, D, C = shape
            valid = ([C] * B if lens == "full" else [1] * B if lens == "one"
                     else [max(1, (C * (b + 1)) // (B + 1))
                           for b in range(B)])
            _num_splits.force = force
            for dtype in ("float32", "bfloat16"):
                q, k, v, q_pos, k_pos = decode_case(*shape, valid, dtype,
                                                    gen)
                n_split = _num_splits(B, Hkv, C, _sm_count(q.device),
                                      waves=_waves(q.dtype, D), force=force)
                got = decode_attention(q, k, v, q_pos, k_pos, window=window)
                want = decode_attention_ref(q, k, v, q_pos, k_pos,
                                            window=window)
                _check("flash_decode", got, want, dtype, shape, dstats)
                say(f"  flash_decode {shape} window={window} n_split="
                    f"{n_split} {lens} {dtype}: ok, max err "
                    f"{_max_err(got, want):.2e}")
                if shape in (main_d, long_d):
                    qt = q[:, :, None]                   # [B, H, 1, D]
                    kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
                    mask = ((k_pos >= 0) & (k_pos <= q_pos[:, None]))[
                        :, None, None]
                    n_bytes, flops = decode_work(*shape, valid,
                                                 q.element_size())
                    bound, by = _bound_ms(n_bytes, flops, dtype)
                    timings[("decode", shape, dtype)] = dict(
                        ms=_time_ms(lambda: decode_attention(
                            q, k, v, q_pos, k_pos, window=window), flush),
                        plain_ms=_time_ms(lambda: decode_attention_ref(
                            q, k, v, q_pos, k_pos, window=window), flush),
                        library_ms=_time_ms(
                            lambda: F.scaled_dot_product_attention(
                                qt, kt, vt, attn_mask=mask, enable_gqa=True),
                            flush),
                        bound_ms=bound, bound_by=by, n_split=n_split)
                del q, k, v, got, want
                torch.cuda.synchronize()
        # SWA ring layouts: valid slots wrap around the ring (row 0) or
        # are a prefix (row 1); C = 16 (one tile) and C = 64 over 4 splits
        for C, qp, window, force, D in [(16, 20, 10, None, 16),
                                        (64, 100, 40, 4, 128)]:
            ring_pos = [[qp - ((qp - s) % C) for s in range(C)],
                        [s if s < 5 else EMPTY for s in range(C)]]
            _num_splits.force = force
            for dtype in ("float32", "bfloat16"):
                q, k, v, _, _ = decode_case(2, 12, 2, D, C, [C, C], dtype,
                                            gen)
                q_pos = torch.tensor([qp, 4], dtype=torch.int32,
                                     device="cuda")
                k_pos = torch.tensor(ring_pos, dtype=torch.int32,
                                     device="cuda")
                got = decode_attention(q, k, v, q_pos, k_pos, window=window)
                want = decode_attention_ref(q, k, v, q_pos, k_pos,
                                            window=window)
                _check("flash_decode", got, want, dtype, "ring", dstats)
                say(f"  flash_decode ring C={C} D={D} window={window} n_split="
                    f"{force or 1} {dtype}: ok, max err "
                    f"{_max_err(got, want):.2e}")
        # the split count against time: n_split forced, and the default
        split_sweep = {}
        for shape in (main_d, (8, 12, 2, 128, 8192), long_d):
            B, H, Hkv, D, C = shape
            for dtype in ("float32", "bfloat16"):
                q, k, v, q_pos, k_pos = decode_case(*shape, [C] * B, dtype,
                                                    gen)
                row = {}
                for force in (1, 2, 4, 8, None):
                    _num_splits.force = force
                    n = _num_splits(B, Hkv, C, _sm_count(q.device),
                                    waves=_waves(q.dtype, D), force=force)
                    key = "default" if force is None else str(n)
                    row[key] = dict(n_split=n, ms=_time_ms(
                        lambda: decode_attention(q, k, v, q_pos, k_pos),
                        flush))
                split_sweep[f"{dtype} {shape}"] = row
                say(f"  time flash_decode {shape} {dtype} by n_split: "
                    + ", ".join(f"{key} {r['ms']:.4f} ms" if key != "default"
                                else f"default ({r['n_split']}) "
                                     f"{r['ms']:.4f} ms"
                                for key, r in row.items()))
                del q, k, v
                torch.cuda.synchronize()
    finally:
        _num_splits.force = None

    for (kind, shape, dtype), t in sorted(timings.items(), key=str):
        extra = "".join(f", {key} {t[key]}" for key in ("variant", "n_split")
                        if key in t)
        if "simt_ms" in t:
            extra += f", CUDA-core kernel {t['simt_ms']:.4f} ms"
        say(f"  time {kind} {shape} {dtype}: kernel {t['ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}), plain "
            f"{t['plain_ms']:.4f} ms, sdpa {t['library_ms']:.4f} ms{extra}")
    say("kernels: both hold to their plain versions at every shape "
        f"({fstats['checks']} flash, {dstats['checks']} decode checks)")
    flash = timings[("flash", main_f, "bfloat16")]
    records = {
        "flash_attention_fwd": dict(
            route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention_fwd_sm90.cu",
            sources={"wgmma": "src/repro_torch/kernels/csrc/"
                              "flash_attention_fwd_sm90.cu",
                     "simt": "src/repro_torch/kernels/csrc/"
                             "flash_attention_fwd.cu"},
            replaces="src/repro/kernels/flash_attention/kernel.py:118",
            max_abs_err=fstats["max_abs_err"], checks=fstats["checks"],
            **flash,
            float32=timings[("flash", main_f, "float32")],
            long=dict(shape=long_f, **timings[("flash", long_f, "bfloat16")]),
            long_float32=timings[("flash", long_f, "float32")]),
        "flash_decode": dict(
            route="cuda",
            source="src/repro_torch/kernels/csrc/flash_decode.cu",
            replaces="src/repro/kernels/decode_attention/kernel.py:90",
            max_abs_err=dstats["max_abs_err"], checks=dstats["checks"],
            **timings[("decode", main_d, "bfloat16")],
            float32=timings[("decode", main_d, "float32")],
            long=dict(shape=long_d, **timings[("decode", long_d, "bfloat16")]),
            long_float32=timings[("decode", long_d, "float32")],
            split_sweep=split_sweep),
    }
    return records


# ------------------------------------------------------------------ phase 3
def _wrappers():
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import paged_decode_attention
    from repro_torch.kernels.ssm_scan.ops import mlstm_scan
    return {"flash_attention_fwd": flash_attention,
            "flash_decode": decode_attention,
            "paged_flash_decode": paged_decode_attention,
            "mlstm_scan": mlstm_scan}


def _reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0
        for variant in getattr(fn, "launches_by_variant", {}):
            fn.launches_by_variant[variant] = 0


def _scan_variants():
    """K4's launches by kernel since the last _reset_counts()."""
    return dict(_wrappers()["mlstm_scan"].launches_by_variant)


def _expect_variants(what, want):
    """K1's launches by kernel since the last _reset_counts()."""
    got = dict(_wrappers()["flash_attention_fwd"].launches_by_variant)
    if got != want:
        fail(f"{what}: flash_attention launches by kernel {got}, expected "
             f"{want}")
    say(f"{what}: flash_attention launches by kernel {got}")
    return got


def _read_counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


def _expect_counts(what, n_layers, decode_steps, counts):
    """The static path: one flash launch per layer for its prefill, one
    flash-decode launch per layer per decode step, no paged launch."""
    want = {"flash_attention_fwd": n_layers,
            "flash_decode": n_layers * decode_steps, "paged_flash_decode": 0,
            "mlstm_scan": 0}
    if counts != want or decode_steps < 1:
        fail(f"{what}: kernel launches {counts}, expected {want} (one "
             f"prefill, {decode_steps} decode steps)")
    say(f"{what}: launches flash_attention_fwd="
        f"{counts['flash_attention_fwd']} flash_decode="
        f"{counts['flash_decode']} paged_flash_decode=0 mlstm_scan=0 (= "
        f"{n_layers} per prefill, {n_layers} per decode step x "
        f"{decode_steps} steps)")


def _expect_paged_counts(what, n_layers, decode_steps, counts):
    """The paged path: one paged launch per layer per decode step and no
    other (its chunked prefill takes the masked path, not the flash
    kernel)."""
    want = {"flash_attention_fwd": 0, "flash_decode": 0,
            "paged_flash_decode": n_layers * decode_steps, "mlstm_scan": 0}
    if counts != want or decode_steps < 1:
        fail(f"{what}: kernel launches {counts}, expected {want} "
             f"({decode_steps} decode steps)")
    say(f"{what}: launches paged_flash_decode="
        f"{counts['paged_flash_decode']} (= {n_layers} per decode step x "
        f"{decode_steps} steps), flash_attention_fwd=0, flash_decode=0, "
        "mlstm_scan=0")


def _check_rollouts(what, rollouts, vocab, max_new):
    import numpy as np
    for r in rollouts:
        ids = np.asarray(r.completion_ids)
        if not (1 <= len(ids) <= max_new) or ids.min() < 0 or ids.max() >= vocab:
            fail(f"{what}: completion ids out of range: {r.completion_ids}")
        lp = np.asarray(r.behavior_logp)
        if lp.shape != ids.shape or not np.isfinite(lp).all() or lp.max() > 1e-6:
            fail(f"{what}: behavior_logp not finite log-probs: {lp}")


def serve_phase():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tasks import MathTaskGenerator
    from repro_torch.launch.serve import run
    from repro_torch.models import transformer
    from repro_torch.rl.rollout import GenConfig, RolloutEngine
    from repro_torch.rl.weight_sync import WeightStore

    n_layers = get_config(ARCH).n_layers
    # (a) the launcher, as a user calls it
    _reset_counts()
    out = run(["--arch", ARCH, "--batch", "8", "--max-new", "32", "--greedy"])
    counts = _read_counts()
    _expect_counts("serve.run", n_layers, out["decode_steps"], counts)
    variants = {"serve.run": _expect_variants(
        "serve.run", {"simt": n_layers, "wgmma": 0})}
    _check_rollouts("serve.run", out["rollouts"], 259, 32)
    say(f"serve.run: {out['tokens']} tokens in {out['seconds']:.3f} s "
        f"({out['tok_per_s']:.1f} tok/s, host clock, weight fetch included)")
    serve_counts = counts

    # (b) timed generate on the published config
    cfg = get_config(ARCH)
    store = WeightStore()
    store.publish(transformer.init(0, cfg, "cuda"))
    tasks = MathTaskGenerator(seed=0).batch(32)
    engine = RolloutEngine(cfg, store, GenConfig(max_new_tokens=4,
                                                 greedy=True), device="cuda")
    engine.generate(tasks)                       # warm-up (shapes, cuBLAS)
    engine.gen = GenConfig(max_new_tokens=128, greedy=True)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    rollouts, m = engine.generate(tasks)
    dt = time.perf_counter() - t0
    counts = _read_counts()
    _expect_counts("generate bf16 B=32", cfg.n_layers, m["decode_steps"],
                   counts)
    variants["generate"] = _expect_variants(
        "generate bf16 B=32", {"simt": 0, "wgmma": cfg.n_layers})
    _check_rollouts("generate bf16 B=32", rollouts, cfg.vocab, 128)
    n_tok = sum(len(r.completion_ids) for r in rollouts)
    gen = dict(tokens=n_tok, seconds=dt, tok_per_s=n_tok / dt,
               gen_tok_per_s=n_tok / (m["prefill_s"] + m["decode_s"]),
               fetch_ms=m["fetch_s"] * 1e3, prefill_ms=m["prefill_s"] * 1e3,
               decode_ms_per_step=m["decode_s"] * 1e3 / m["decode_steps"],
               decode_steps=m["decode_steps"],
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    say(f"generate bf16 B=32 max_new=128: {n_tok} tokens in {dt:.3f} s = "
        f"{gen['tok_per_s']:.1f} tok/s ({gen['gen_tok_per_s']:.1f} tok/s "
        f"without the weight fetch); fetch {gen['fetch_ms']:.1f} ms, prefill "
        f"{gen['prefill_ms']:.2f} ms, decode {gen['decode_ms_per_step']:.3f} "
        f"ms/step over {m['decode_steps']} steps (host clock)")
    engine.gen = GenConfig(max_new_tokens=9, greedy=True)
    gen["profile"] = profile_decode(lambda: engine.generate(tasks),
                                    "decode_(mma_)?kernel<.*DenseRows",
                                    "generate")
    gen["flash_launches_by_variant"] = variants
    del engine, store
    torch.cuda.empty_cache()
    return serve_counts, gen


class SpanClock:
    """A duck-typed tracer for ``PagedEngine``: host-clock spans summed by
    name.  ``decode_step`` ends after the sampled tokens reach the host, so
    it holds the step's device time; a prefill chunk that does not finish
    its prompt ends unsynchronised."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.total, self.count = {}, {}

    def now(self):
        return time.perf_counter()

    def span(self, group, track, name, t0, dur, **kw):
        self.total[name] = self.total.get(name, 0.0) + dur
        self.count[name] = self.count.get(name, 0) + 1

    def begin(self, *a, **kw):
        pass

    end = instant = counter = begin


def paged_serve_phase():
    """The paged engine at full width: the launcher (single- and
    multi-turn), then a timed GRPO ``generate_groups`` on the published
    config and a profiled one.  Returns (paged launches of the launcher's
    run, summary, the timed run's measurements for the scheduler: its
    ``EngineStats``, mean prompt length and tokens per second)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tasks import MathTaskGenerator
    from repro_torch.launch.serve import run
    from repro_torch.models import transformer
    from repro_torch.rl.rollout import GenConfig
    from repro_torch.rl.weight_sync import WeightStore
    from repro_torch.serve import PagedEngine, ServeConfig

    n_layers = get_config(ARCH).n_layers
    # (a) the launcher: 8 requests through 4 slots (queueing, eviction)
    argv = ["--arch", ARCH, "--engine", "paged", "--batch", "8", "--slots",
            "4", "--max-new", "32", "--greedy", "--quiet"]
    _reset_counts()
    out = run(argv)
    counts = _read_counts()
    _expect_paged_counts("serve.run --engine paged", n_layers,
                         out["decode_steps"], counts)
    _check_rollouts("serve.run --engine paged", out["rollouts"], 259, 32)
    say(f"serve.run --engine paged: {out['tokens']} tokens in "
        f"{out['seconds']:.3f} s ({out['tok_per_s']:.1f} tok/s, host clock, "
        f"weight fetch included), {out['decode_steps']} decode steps, slot "
        f"occupancy {out['slot_occupancy']:.3f}, page occupancy "
        f"{out['page_occupancy']:.3f}, preemptions {out['preemptions']}")
    launches = counts["paged_flash_decode"]

    # (b) two-turn episodes through the radix cache, over pages of 16 so
    # that a turn's history fills whole pages the next turn can adopt
    _reset_counts()
    out = run(argv + ["--radix", "--turns", "2", "--page-size", "16"])
    counts = _read_counts()
    _expect_paged_counts("serve.run --engine paged --turns 2", n_layers,
                         out["decode_steps"], counts)
    _check_rollouts("serve.run --turns 2", out["rollouts"], 259, 32)
    if out["radix_hit_tokens"] <= 0:
        fail(f"serve.run --turns 2: radix_hit_tokens = "
             f"{out['radix_hit_tokens']}, expected > 0")
    say(f"serve.run --engine paged --radix --turns 2 --page-size 16: "
        f"radix_hit_tokens {out['radix_hit_tokens']}, radix hit rate "
        f"{out['radix_hit_rate']:.3f}, prefill tokens {out['prefill_tokens']}")

    # (c) timed GRPO groups on the published config
    cfg = get_config(ARCH)
    store = WeightStore()
    store.publish(transformer.init(0, cfg, "cuda"))
    tasks = MathTaskGenerator(seed=0).batch(8)
    plen = max(len(t.prompt_ids) for t in tasks)
    clock = SpanClock()
    engine = PagedEngine(cfg, store, GenConfig(max_new_tokens=4, greedy=True),
                         ServeConfig(max_slots=32, max_len=plen + 128),
                         tracer=clock, device="cuda")
    engine.generate_groups(tasks[:2], 8)         # warm-up (shapes, cuBLAS)
    engine.gen = GenConfig(max_new_tokens=128, greedy=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    clock.reset()
    before = copy.deepcopy(engine.stats)
    _reset_counts()
    t0 = time.perf_counter()
    rollouts, m = engine.generate_groups(tasks, 8)
    dt = time.perf_counter() - t0
    counts = _read_counts()
    measured = dict(stats=_stats_since(before, engine.stats),
                    prompt_len=sum(len(t.prompt_ids) for t in tasks)
                    / len(tasks))
    what = "generate_groups bf16 8 tasks x 8 slots=32"
    _expect_paged_counts(what, cfg.n_layers, m["decode_steps"], counts)
    _check_rollouts(what, rollouts, cfg.vocab, 128)
    if len(rollouts) != 64 or m["forks"] < 1 or m["cow_copies"] < 1:
        fail(f"{what}: {len(rollouts)} rollouts, forks {m['forks']}, "
             f"cow_copies {m['cow_copies']}: expected 64, >= 1, >= 1")
    n_tok = sum(len(r.completion_ids) for r in rollouts)
    steps = clock.count["decode_step"]
    summary = dict(
        tokens=n_tok, seconds=dt, tok_per_s=n_tok / dt,
        decode_steps=m["decode_steps"],
        decode_ms_per_step=clock.total["decode_step"] * 1e3 / steps,
        prefill_ms=clock.total.get("prefill_chunk", 0.0) * 1e3,
        prefill_chunks=clock.count.get("prefill_chunk", 0),
        prefill_tokens=m["prefill_tokens"],
        prefill_tokens_shared=m["prefill_tokens_shared"],
        forks=m["forks"], cow_copies=m["cow_copies"],
        bt_uploads=m["bt_uploads"], preemptions=m["preemptions"],
        slot_occupancy=m["slot_occupancy"],
        page_occupancy=m["page_occupancy"],
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    measured["tok_per_s"] = summary["tok_per_s"]
    say(f"{what} max_new=128: {n_tok} tokens in {dt:.3f} s = "
        f"{summary['tok_per_s']:.1f} tok/s; decode "
        f"{summary['decode_ms_per_step']:.3f} ms/step over {steps} steps, "
        f"prefill {summary['prefill_ms']:.2f} ms in "
        f"{summary['prefill_chunks']} chunks (host clock); forks "
        f"{m['forks']}, cow_copies {m['cow_copies']}, bt_uploads "
        f"{m['bt_uploads']}, slot occupancy {m['slot_occupancy']:.3f}, page "
        f"occupancy {m['page_occupancy']:.3f}, peak memory "
        f"{summary['peak_mem_gib']:.2f} GiB")
    summary["model_step_ms"] = model_step_ms(engine._params, cfg,
                                             plen + 128)
    say("decode step without the engine (host clock, synchronised, median "
        "of 10, B=32, context " + str(plen + 128) + "): " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in summary["model_step_ms"].items()))
    engine.gen = GenConfig(max_new_tokens=9, greedy=True)
    summary["profile"] = profile_decode(
        lambda: engine.generate_groups(tasks[:4], 8),
        "decode_(mma_)?kernel<.*PagedRows", "generate_groups")
    del engine, store
    torch.cuda.empty_cache()
    return launches, summary, measured


def _stats_since(base, now):
    """The ``EngineStats`` of the engine calls made after ``base`` (a copy
    of the stats taken before them)."""
    fields = {}
    for f in dataclasses.fields(now):
        a, b = getattr(base, f.name), getattr(now, f.name)
        if f.name == "max_slots":
            fields[f.name] = b
        elif f.name == "gen_samples":
            fields[f.name] = list(b[len(a):])
        else:
            fields[f.name] = b - a
    return type(now)(**fields)


def schedule_feedback_phase(measured):
    """The serving -> scheduler loop on the card's own measurements: the
    timed ``generate_groups`` run of ``paged_serve_phase`` (8 tasks x
    group 8 through 32 slots, copy-on-write forks) as an ``EngineReport``,
    priced by ``ServingCostModel`` and scheduled by Algorithm 1 for the
    paper's three models on its 8 H800 + 8 H20 cluster, beside the
    analytic plans; and ``fit_gen_time`` over the run's per-request
    samples.  The report is filed under the H800 profile: the scheduler
    has no H100 profile, and the H800 is the same GH100 die with the same
    80 GB of HBM3 and a cut NVLink.  Only the engine-level factors (slot
    occupancy, g_eff) come from the report; the roofline constants stay
    the paper's.  Returns a summary."""
    from repro_torch.configs import get_config
    from repro_torch.core import milp
    from repro_torch.core.cluster import (PROFILES, paper_heterogeneous,
                                          paper_homogeneous_h800)
    from repro_torch.core.cost_model import ANALYTIC
    from repro_torch.core.scheduler import schedule
    from repro_torch.serve.feedback import (EngineReport, ServingCostModel,
                                            fit_gen_time)

    if not milp._HAVE_SCIPY:
        fail("scipy.optimize.milp is missing: the rollout plans would be "
             "the greedy fallback's, not the MILP's")
    stats = measured["stats"]
    report = EngineReport.from_stats(stats, "H800",
                                     tokens_per_sec=measured["tok_per_s"])
    if report.decode_steps <= 0 or not report.g_eff > 1.0:
        fail(f"EngineReport from the card: decode_steps "
             f"{report.decode_steps}, g_eff {report.g_eff}: expected > 0 "
             "and > 1 (GRPO forks share each group's prompt)")
    say(f"EngineReport of the card ({CARD['card']}) filed as H800 (the "
        f"same GH100 die and 80 GB HBM3; only slot occupancy and g_eff are "
        f"taken from it, the roofline constants stay the paper's): "
        f"slot_occupancy {report.slot_occupancy:.4f}, g_eff "
        f"{report.g_eff:.4f}, prefix_hit_rate {report.prefix_hit_rate:.4f}, "
        f"page_occupancy {report.page_occupancy:.4f}, decode_steps "
        f"{report.decode_steps}, {report.tokens_per_sec:.1f} tok/s")
    model = ServingCostModel([report])
    h800, h20 = PROFILES["H800"], PROFILES["H20"]
    want_eff = min(0.95, max(0.01, stats.slot_occupancy))
    if model.decode_engine_eff(h800) != want_eff:
        fail(f"ServingCostModel.decode_engine_eff(H800) = "
             f"{model.decode_engine_eff(h800)}, expected the clipped "
             f"measured slot occupancy {want_eff}")
    if model.prefill_g_eff(h800) != max(stats.g_eff, 1.0):
        fail(f"ServingCostModel.prefill_g_eff(H800) = "
             f"{model.prefill_g_eff(h800)}, expected {max(stats.g_eff, 1.0)}")
    factors = ("train_mfu", "prefill_mfu", "decode_compute_eff",
               "decode_engine_eff", "hbm_eff", "prefill_g_eff")
    for f in factors:
        if getattr(model, f)(h20) != getattr(ANALYTIC, f)(h20):
            fail(f"ServingCostModel.{f}(H20) = {getattr(model, f)(h20)}, "
                 f"expected the analytic {getattr(ANALYTIC, f)(h20)}")
    summary = dict(slot_occupancy=report.slot_occupancy, g_eff=report.g_eff,
                   decode_steps=report.decode_steps,
                   decode_engine_eff_h800=model.decode_engine_eff(h800),
                   prefill_g_eff_h800=model.prefill_g_eff(h800), plans={})

    def line(plan):
        return (f"gamma {plan.gamma:.4f} C_T {plan.cost_train:.2f} s C_I "
                f"{plan.cost_infer:.2f} s tau {plan.rollout_plan.describe()}")

    cases = [(arch, "paper_heterogeneous(8, 8)", paper_heterogeneous(8, 8))
             for arch in ("qwen-distill-1.5b", "qwen-distill-7b",
                          "qwen-distill-14b")]
    # on an all-H800 cluster the rollouts run on H800, so the report
    # reaches the MILP's replica prices
    cases.append(("qwen-distill-1.5b", "paper_homogeneous_h800(16)",
                  paper_homogeneous_h800(16)))
    for arch, where, cluster in cases:
        spec = get_config(arch).spec
        plan = schedule(spec, cluster, cost_provider=model)
        base = schedule(spec, cluster)
        for name, p in (("measured", plan), ("analytic", base)):
            _check_plan(f"{arch} on {where} ({name})", p, len(cluster))
        say(f"schedule {arch} on {where}: measured {line(plan)}; analytic "
            f"{line(base)}; scheduler wall time {plan.wall_time_s * 1e3:.1f} "
            f"ms / {base.wall_time_s * 1e3:.1f} ms (the card's host)")
        summary["plans"][f"{arch} {where}"] = dict(
            measured=dict(gamma=plan.gamma, cost_train=plan.cost_train,
                          cost_infer=plan.cost_infer,
                          tau=plan.rollout_plan.describe(),
                          wall_time_s=plan.wall_time_s),
            analytic=dict(gamma=base.gamma, cost_train=base.cost_train,
                          cost_infer=base.cost_infer,
                          tau=base.rollout_plan.describe(),
                          wall_time_s=base.wall_time_s))
    samples = list(stats.gen_samples)
    distinct = len({n for n, _ in samples})
    fit = fit_gen_time(samples, prompt_len=measured["prompt_len"])
    if fit is None and distinct >= 3:
        fail(f"fit_gen_time returned None over {len(samples)} samples with "
             f"{distinct} distinct lengths")
    if fit is None:
        say(f"fit_gen_time: None ({len(samples)} samples, {distinct} "
            "distinct completion lengths: it needs 3)")
    else:
        say(f"fit_gen_time over {len(samples)} samples ({distinct} distinct "
            f"lengths, prompt {measured['prompt_len']:.1f}): a {fit.a:.6g} "
            f"s/token, b {fit.b:.6g} s/token^2, t_prefill "
            f"{fit.t_prefill:.6g} s")
    summary["gen_time"] = (None if fit is None else dict(
        a=fit.a, b=fit.b, t_prefill=fit.t_prefill))
    summary["gen_samples"] = dict(n=len(samples), distinct=distinct)
    return summary


def _check_plan(what, plan, n_devices):
    """A plan's device sets are disjoint and within the cluster, and its
    gamma and costs are finite and positive."""
    d_t, d_i = set(plan.train_devices), set(plan.infer_devices)
    if not d_t or not d_i or d_t & d_i or len(d_t) + len(d_i) > n_devices:
        fail(f"{what}: D_T {sorted(d_t)} and D_I {sorted(d_i)} are not "
             f"disjoint non-empty sets of at most {n_devices} devices")
    for key in ("gamma", "cost_train", "cost_infer"):
        v = getattr(plan, key)
        if not (math.isfinite(v) and v > 0):
            fail(f"{what}: {key} = {v}, expected finite and positive")


def big_serve_phase(arch):
    """``arch`` (qwen-distill-7b or -14b) on its published config
    (bfloat16, full vocab, depth and width; random init on the card) served
    through both engines, B = 8, 32 new tokens, greedy: the weights are
    made on the card, published to the host store and freed before the
    first fetch, so the card never holds two copies.  Static: one warm-up
    call, then a timed ``RolloutEngine.generate`` (exact K1 / K3 launches,
    all K1 on the tensor-core kernel).  Paged: the pool sized from the free
    memory left after the engine's fetch (at least the worst case of its 8
    slots, or the phase fails), a warm-up, then a timed
    ``PagedEngine.generate_groups`` of 2 tasks x group 8 through 8 slots
    (exact K2 launches).  Returns the summary."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tasks import MathTaskGenerator
    from repro_torch.models import transformer
    from repro_torch.rl.rollout import GenConfig, RolloutEngine
    from repro_torch.rl.weight_sync import WeightStore, tree_bytes
    from repro_torch.serve import PagedEngine, ServeConfig

    cfg = get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init(0, cfg, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    store = WeightStore()
    t0 = time.perf_counter()
    store.publish(params)
    publish_s = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    weights = tree_bytes(store.fetch()[0])
    out = dict(params=n_params, weight_gib=weights / 2 ** 30,
               init_s=init_s, publish_s=publish_s,
               init_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    tasks = MathTaskGenerator(seed=0).batch(8)
    plen = max(len(t.prompt_ids) for t in tasks)

    # static engine
    torch.cuda.reset_peak_memory_stats()
    engine = RolloutEngine(cfg, store, GenConfig(max_new_tokens=2,
                                                 greedy=True), device="cuda")
    engine.generate(tasks)                       # warm-up (shapes, cuBLAS)
    engine.gen = GenConfig(max_new_tokens=32, greedy=True)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    rollouts, m = engine.generate(tasks)
    dt = time.perf_counter() - t0
    what = f"{arch} generate bf16 B=8"
    counts = _read_counts()
    _expect_counts(what, cfg.n_layers, m["decode_steps"], counts)
    _expect_variants(what, {"simt": 0, "wgmma": cfg.n_layers})
    _check_rollouts(what, rollouts, cfg.vocab, 32)
    n_tok = sum(len(r.completion_ids) for r in rollouts)
    out["static"] = dict(
        tokens=n_tok, seconds=dt, tok_per_s=n_tok / dt,
        gen_tok_per_s=n_tok / (m["prefill_s"] + m["decode_s"]),
        fetch_ms=m["fetch_s"] * 1e3, prefill_ms=m["prefill_s"] * 1e3,
        decode_ms_per_step=m["decode_s"] * 1e3 / m["decode_steps"],
        decode_steps=m["decode_steps"], launches=counts,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    s = out["static"]
    say(f"{what} max_new=32: {n_tok} tokens in {dt:.3f} s = "
        f"{s['tok_per_s']:.1f} tok/s ({s['gen_tok_per_s']:.1f} without the "
        f"weight fetch); fetch {s['fetch_ms']:.1f} ms ({out['weight_gib']:.2f}"
        f" GiB, pageable host copy), prefill {s['prefill_ms']:.2f} ms, decode "
        f"{s['decode_ms_per_step']:.3f} ms/step over {m['decode_steps']} "
        f"steps (host clock); peak memory {s['peak_mem_gib']:.2f} GiB")
    del engine, rollouts
    torch.cuda.empty_cache()

    # paged engine: the pool from the memory left after its own fetch
    torch.cuda.reset_peak_memory_stats()
    free, total = torch.cuda.mem_get_info()
    page, slots, max_len = 128, 8, plen + 32
    per_page = 2 * cfg.n_layers * page * cfg.n_kv_heads * cfg.hd * 2
    headroom = 8 * 2 ** 30                # activations, logits, scratch
    num_pages = int((free - weights - headroom) // per_page)
    worst = 1 + slots * -(-max_len // page)
    if num_pages < worst:
        fail(f"{arch} paged: {free / 2 ** 30:.1f} GiB free leaves "
             f"{num_pages} pages of {per_page / 2 ** 20:.1f} MiB after "
             f"{weights / 2 ** 30:.1f} GiB of weights: fewer than the "
             f"{worst} the engine needs")
    clock = SpanClock()
    t0 = time.perf_counter()
    engine = PagedEngine(cfg, store, GenConfig(max_new_tokens=2, greedy=True),
                         ServeConfig(max_slots=slots, max_len=max_len,
                                     page_size=page, num_pages=num_pages),
                         tracer=clock, device="cuda")
    torch.cuda.synchronize()
    fetch_s = time.perf_counter() - t0
    if engine.kv.num_pages != num_pages:
        fail(f"{arch} paged: pool of {engine.kv.num_pages} pages, asked "
             f"for {num_pages}")
    engine.generate_groups(tasks[:1], 2)         # warm-up
    engine.gen = GenConfig(max_new_tokens=32, greedy=True)
    torch.cuda.synchronize()
    clock.reset()
    _reset_counts()
    t0 = time.perf_counter()
    rollouts, m = engine.generate_groups(tasks[:2], 8)
    dt = time.perf_counter() - t0
    what = f"{arch} generate_groups bf16 2 tasks x 8 slots=8"
    counts = _read_counts()
    _expect_paged_counts(what, cfg.n_layers, m["decode_steps"], counts)
    _check_rollouts(what, rollouts, cfg.vocab, 32)
    if len(rollouts) != 16 or m["forks"] < 1:
        fail(f"{what}: {len(rollouts)} rollouts, forks {m['forks']}: "
             "expected 16, >= 1")
    n_tok = sum(len(r.completion_ids) for r in rollouts)
    steps = clock.count["decode_step"]
    out["paged"] = dict(
        tokens=n_tok, seconds=dt, tok_per_s=n_tok / dt,
        decode_steps=m["decode_steps"],
        decode_ms_per_step=clock.total["decode_step"] * 1e3 / steps,
        prefill_ms=clock.total.get("prefill_chunk", 0.0) * 1e3,
        prefill_chunks=clock.count.get("prefill_chunk", 0),
        fetch_ms=fetch_s * 1e3, num_pages=num_pages,
        pool_gib=num_pages * per_page / 2 ** 30, forks=m["forks"],
        launches=counts,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    p = out["paged"]
    say(f"{what} max_new=32: {n_tok} tokens in {dt:.3f} s = "
        f"{p['tok_per_s']:.1f} tok/s; decode {p['decode_ms_per_step']:.3f} "
        f"ms/step over {steps} steps, prefill {p['prefill_ms']:.2f} ms in "
        f"{p['prefill_chunks']} chunks (host clock); engine build with the "
        f"weight fetch {p['fetch_ms']:.1f} ms; pool {num_pages} pages of "
        f"{page} ({p['pool_gib']:.2f} GiB, sized from {free / 2 ** 30:.2f} "
        f"GiB free), forks {m['forks']}; peak memory {p['peak_mem_gib']:.2f} "
        "GiB")
    del engine, rollouts, store
    torch.cuda.empty_cache()
    return out


def model_step_ms(params, cfg, context):
    """Host-clock time of one decode step of the model alone (no engine,
    no sampling), synchronised, median of 10: the paged step over 32
    active slots with pages of 128, and the static step over a dense
    B=32 cache, both at ``context`` positions and with the same params.
    What the engine's decode step takes beyond the paged one is the
    engine's own host work."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.serve.model import paged_decode_step

    B, page = 32, 128
    maxp = -(-context // page)
    shape = (cfg.n_layers, 1 + B * maxp, page, cfg.n_kv_heads, cfg.hd)
    kp = torch.zeros(shape, dtype=cfg.tdtype, device="cuda")
    vp = torch.zeros_like(kp)
    tables = torch.arange(1, 1 + B * maxp, dtype=torch.int32,
                          device="cuda").reshape(B, maxp)
    token = torch.arange(B, dtype=torch.int32, device="cuda") + 3
    pos = torch.full((B,), context - 1, dtype=torch.int32, device="cuda")
    active = torch.ones(B, dtype=torch.int32, device="cuda")
    cache = transformer.init_cache(cfg, batch=B, max_len=context,
                                   device="cuda")
    steps = {
        "paged_decode_step": lambda: paged_decode_step(
            params, cfg, kp, vp, tables, token, pos, active),
        "transformer.decode_step": lambda: transformer.decode_step(
            params, cfg, cache, token, pos)}
    out = {}
    with torch.no_grad():
        for name, fn in steps.items():
            times = []
            for i in range(13):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                if i >= 3:
                    times.append((time.perf_counter() - t0) * 1e3)
            out[name] = statistics.median(times)
    return out


def _trace_kernels(prof, name):
    """(start, end, name) of every kernel in a torch.profiler trace, sorted
    by start; the trace is kept in build/."""
    path = ROOT / "build" / f"trace_{name}.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                  for e in json.loads(path.read_text())["traceEvents"]
                  if e.get("cat") == "kernel")


def _busy(kernels, lo, per):
    """Over the window from ``lo`` to the last kernel's end: the union of
    kernel intervals (device busy time), the idle share and the six
    largest kernels by summed time, each divided by ``per``."""
    hi = max(k[1] for k in kernels)
    busy, end, by_name = 0.0, lo, {}
    for s, e, kname in kernels:
        if e <= lo:
            continue
        s = max(s, lo)
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        short = kname.replace("(anonymous namespace)::", "")
        short = re.split(r"[<(]", short.replace("void ", "", 1))[0]
        short = short.split("::")[-1][:48]
        by_name[short] = by_name.get(short, 0.0) + (e - s)
    window = hi - lo
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(window_ms=window / 1e3 / per, busy_ms=busy / 1e3 / per,
                idle_share=1.0 - busy / window,
                top_kernels_ms={k: v / 1e3 / per for k, v in top})


def profile_decode(call, kernel, name):
    """Where a decode step's time goes, from a torch.profiler trace of one
    ``call`` (which returns rollouts and metrics): over the decode window
    (the first ``kernel`` to the last kernel), the union of kernel
    intervals is the device's busy time and the rest its idle share.  The
    profiler adds host overhead, so the idle share is an upper bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, m = call()
        torch.cuda.synchronize()
    kernels = _trace_kernels(prof, name)
    # K2 and K3 are instances of the same split-cache kernels: the layout
    # (DenseRows, PagedRows) in the name tells them apart
    mine = [k for k in kernels if re.search(rf"\b{kernel}", k[2])]
    if not mine:
        say(f"profile {name}: the trace holds no {kernel}: device busy "
            "share not measured")
        return None
    starts = [k[0] for k in mine]
    b = _busy(kernels, starts[0], m["decode_steps"])
    out = dict(decode_steps=m["decode_steps"],
               window_ms_per_step=b["window_ms"],
               busy_ms_per_step=b["busy_ms"], idle_share=b["idle_share"],
               kernel_ms_per_step=sum(e - s for s, e, _ in mine) / 1e3
               / m["decode_steps"],
               top_kernels_ms_per_step=b["top_kernels_ms"])
    say(f"profile {name} (torch.profiler, {m['decode_steps']} decode steps): "
        f"{out['window_ms_per_step']:.3f} ms/step, device busy "
        f"{out['busy_ms_per_step']:.3f} ms/step, idle share "
        f"{out['idle_share']:.3f}; the decode kernel "
        f"{out['kernel_ms_per_step']:.4f} ms/step; top kernels ms/step "
        + ", ".join(f"{k} {v:.3f}" for k, v in
                    out["top_kernels_ms_per_step"].items()))
    # before the first decode kernel: the weight fetch and the prefill
    pre = [k for k in kernels if k[0] < starts[0]]
    if pre:
        b = _busy(pre, pre[0][0], 1)
        out["before_decode"] = dict(window_ms=b["window_ms"],
                                    busy_ms=b["busy_ms"],
                                    top_kernels_ms=b["top_kernels_ms"])
        say(f"profile {name}, before the first decode kernel (weight fetch "
            f"+ prefill): {b['window_ms']:.3f} ms, device busy "
            f"{b['busy_ms']:.3f} ms; top kernels ms "
            + ", ".join(f"{k} {v:.3f}" for k, v in
                        b["top_kernels_ms"].items()))
    return out


# ------------------------------------------------------------ phase 3, train
def _expect_train_counts(what, family, n_layers, out, counts):
    """One launcher run: every produce prefills once and every train step
    runs one forward.  xlstm: one scan launch per layer for each, nothing
    else (its decode has no kernel).  Dense: one flash launch per layer
    for each, one flash-decode launch per layer per decode step."""
    passes = out["produced"] + len(out["steps"])
    want = dict.fromkeys(counts, 0)
    if family == "ssm":
        want["mlstm_scan"] = n_layers * passes
    else:
        want["flash_attention_fwd"] = n_layers * passes
        want["flash_decode"] = n_layers * out["decode_steps"]
    if counts != want:
        fail(f"{what}: kernel launches {counts}, expected {want} "
             f"({out['produced']} produce calls, {len(out['steps'])} train "
             f"steps, {out['decode_steps']} decode steps)")
    say(f"{what}: launches " + " ".join(f"{k}={v}" for k, v in
                                        counts.items())
        + f" (= {n_layers} per prefill x {out['produced']} + {n_layers} per "
        f"train step x {len(out['steps'])}"
        + ("" if family == "ssm" else
           f"; {n_layers} flash_decode per decode step x "
           f"{out['decode_steps']}") + ")")


def train_phase():
    """``repro_torch.launch.train`` at full width with the reference
    launcher's setup (float32, tokenizer vocab, no remat, group 4 x 2
    prompts, eta 2): 3 steps of xlstm-1.3b, 2 of qwen-distill-1.5b.
    Returns {arch: (launch counts, summary)}."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import run

    results = {}
    trace = ROOT / "build" / "trace_train_run.json"
    trace.parent.mkdir(exist_ok=True)
    for arch, steps in (("xlstm-1.3b", 3), (ARCH, 2)):
        family = get_config(arch).family
        torch.cuda.reset_peak_memory_stats()
        argv = ["--arch", arch, "--steps", str(steps), "--quiet"]
        if arch == ARCH:
            argv += ["--trace", str(trace), "--schedule"]
        _reset_counts()
        out = run(argv)
        counts = _read_counts()
        what = f"train.run " + " ".join(argv[:4])
        _expect_train_counts(what, family, out["n_layers"], out, counts)
        if "--schedule" in argv:
            if not out["schedule"]:
                fail(f"{what} --schedule: run() returned no plan")
            _check_plan(f"{what} --schedule", out["plan"], 16)
            say(f"{what} --schedule plan (8 H800 + 8 H20):\n"
                + out["schedule"])
        scan_variants = _scan_variants()
        if scan_variants != {"simt": counts["mlstm_scan"], "mma": 0}:
            fail(f"{what}: mlstm_scan launches by kernel {scan_variants}, "
                 "expected every one on the CUDA-core kernel (float32)")
        hist = out["steps"]
        if len(hist) != steps or out["produced"] != steps:
            fail(f"{what}: {len(hist)} steps from {out['produced']} produce "
                 f"calls, expected {steps} of each")
        # every step: finite numbers, the eta bound, and one publish (the
        # store starts at version 1, the initial publish)
        for i, m in enumerate(hist):
            if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
                fail(f"{what}: step {i + 1} loss {m['loss']} grad_norm "
                     f"{m['grad_norm']}")
            if m["max_staleness"] > out["eta"] or m["version"] != i + 2:
                fail(f"{what}: step {i + 1} max staleness "
                     f"{m['max_staleness']} (eta {out['eta']}), version "
                     f"{m['version']} (expected {i + 2})")
        if out["buffer"]["max_staleness"] > out["eta"]:
            fail(f"{what}: buffer {out['buffer']} breaks eta {out['eta']}")
        # a step whose groups all scored alike has zero advantages, so a
        # zero loss and gradient; the run as a whole must move the weights
        if not any(m["grad_norm"] > 0 for m in hist):
            fail(f"{what}: every step had a zero gradient")
        if "--trace" in argv:
            spans = _check_trace(what, trace, out)
        summary = dict(
            seconds=out["seconds"],
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            steps=[{k: m[k] for k in (
                "loss", "grad_norm", "mean_ratio", "clip_frac", "reward",
                "max_staleness", "version", "produce_s", "train_s",
                "fetch_s", "prefill_s", "decode_s", "decode_steps")}
                for m in hist])
        for i, m in enumerate(hist):
            say(f"{what} step {i + 1}: loss {m['loss']:.5f} grad_norm "
                f"{m['grad_norm']:.4f} reward {m['reward']:.3f} staleness "
                f"max {m['max_staleness']} version {m['version']}; produce "
                f"{m['produce_s']:.3f} s (fetch {m['fetch_s'] * 1e3:.1f} ms, "
                f"prefill {m['prefill_s'] * 1e3:.1f} ms, decode "
                f"{m['decode_s'] * 1e3 / max(m['decode_steps'], 1):.2f} ms "
                f"per step over {m['decode_steps']}), train step "
                f"{m['train_s'] * 1e3:.1f} ms (host clock)")
        if "--trace" in argv:
            summary["trace_spans_ms"] = spans
        say(f"{what}: {out['seconds']:.2f} s, peak memory "
            f"{summary['peak_mem_gib']:.2f} GiB, buffer {out['buffer']}")
        results[arch] = (counts, summary, scan_variants)
        del out
        torch.cuda.empty_cache()
    return results


def _check_trace(what, path, out):
    """The Chrome trace ``--trace`` wrote: it loads, and holds one
    stage/generation/produce span per produce, one stage/train/train_step
    span per step and one publish instant per publish (one a step).
    Returns the spans' summed ms by name."""
    doc = json.loads(Path(path).read_text())
    evs = doc["traceEvents"]
    lanes = {}
    for e in evs:
        if e["ph"] == "M" and e["name"] == "process_name":
            lanes[e["pid"]] = e["args"]["name"]
    tracks = {(e["pid"], e["tid"]): (lanes[e["pid"]], e["args"]["name"])
              for e in evs if e["ph"] == "M" and e["name"] == "thread_name"}
    count, total = {}, {}
    for e in evs:
        if e["ph"] in ("X", "i"):
            key = (*tracks[(e["pid"], e["tid"])], e["name"], e["ph"])
            count[key] = count.get(key, 0) + 1
            total[e["name"]] = total.get(e["name"], 0.0) + e.get("dur", 0) / 1e3
    steps = len(out["steps"])
    want = {("stage", "generation", "produce", "X"): out["produced"],
            ("stage", "train", "train_step", "X"): steps,
            ("stage", "sync", "publish", "i"): steps}
    got = {k: count.get(k, 0) for k in want}
    if got != want:
        fail(f"{what}: trace {path} holds {count}, expected {want}")
    say(f"{what}: trace {path.name} loads; "
        + ", ".join(f"{'/'.join(k[:3])} x{v}" for k, v in got.items())
        + f" ({len(evs)} events; spans ms "
        + ", ".join(f"{k} {v:.1f}" for k, v in total.items() if v) + ")")
    return total


def _train_batch(cfg, B, S, prompt, device, seed=0):
    """A GRPO batch of random tokens: the first ``prompt`` positions are the
    prompt, the rest the response the loss covers."""
    import torch
    gen = torch.Generator(device="cpu").manual_seed(seed)
    mask = torch.zeros((B, S))
    mask[:, prompt:] = 1.0
    batch = dict(
        tokens=torch.randint(3, min(cfg.vocab, 259), (B, S), generator=gen),
        loss_mask=mask,
        behavior_logp=-torch.rand((B, S), generator=gen) * 3 * mask,
        advantages=torch.randn((B,), generator=gen))
    return {k: v.to(device) for k, v in batch.items()}


def xlstm_step_phase():
    """One timed GRPO train step of xlstm-1.3b on the published config
    (bfloat16, vocab 50304, remat) at the launcher's batch (8 x 160, 48
    response tokens), after one warm-up step; peak memory; then one
    profiled step (device busy time, idle share, top kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models import xlstm
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.rl.grpo import make_train_step

    cfg = get_config("xlstm-1.3b")
    opt = AdamWConfig(lr=3e-5)
    params = xlstm.init(0, cfg, "cuda")
    params.requires_grad_(True)
    state = adamw_init(params, opt)
    step = make_train_step(cfg, opt)
    batch = _train_batch(cfg, 8, 160, 112, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(3):
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, m = step(params, state, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        counts = _read_counts()
        want = dict.fromkeys(counts, 0)
        want["mlstm_scan"] = 2 * cfg.n_layers      # forward + remat recompute
        variants = _scan_variants()
        want_variants = {"simt": 0, "mma": want["mlstm_scan"]}
        if counts != want or variants != want_variants or not (
                math.isfinite(loss) and math.isfinite(gnorm)):
            fail(f"xlstm bf16 train step: launches {counts} by kernel "
                 f"{variants} (expected {want}, {want_variants}), loss "
                 f"{loss}, grad_norm {gnorm}")
    out = dict(step_ms=times[1:], loss=loss, grad_norm=gnorm,
               launches=counts["mlstm_scan"], launches_by_variant=variants,
               params=sum(p.numel() for p in params.parameters()),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    say(f"xlstm-1.3b published config (bfloat16, vocab 50304, remat) GRPO "
        f"train step, B=8 S=160: {out['params'] / 1e9:.3f} B params, "
        f"{' / '.join(f'{t:.1f}' for t in times)} ms (first is warm-up; "
        f"host clock, synchronised), mlstm_scan launches "
        f"{out['launches']} per step ({variants}), loss {loss:.5f}, grad_norm "
        f"{gnorm:.4f}, peak memory {out['peak_mem_gib']:.2f} GiB")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(params, state, batch)
        torch.cuda.synchronize()
    kernels = _trace_kernels(prof, "xlstm_train_step")
    if not kernels:
        say("profile xlstm train step: the trace holds no kernel: device "
            "busy share not measured")
        return out
    out["profile"] = p = _busy(kernels, kernels[0][0], 1)
    p["mlstm_scan_ms"] = sum(e - s for s, e, name in kernels
                             if "mlstm_" in name) / 1e3
    # where the host's time goes: operators by their own CPU time
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    p["top_host_ops_ms"] = {e.key: e.self_cpu_time_total / 1e3
                            for e in host[:8]}
    say(f"profile xlstm train step (torch.profiler): window "
        f"{p['window_ms']:.1f} ms, device busy {p['busy_ms']:.1f} ms, idle "
        f"share {p['idle_share']:.3f}, K4 kernels (forward and remat "
        f"recompute) {p['mlstm_scan_ms']:.2f} ms; top kernels ms " + ", ".join(
            f"{k} {v:.2f}" for k, v in p["top_kernels_ms"].items())
        + "; top host ops ms (self CPU) " + ", ".join(
            f"{k} {v:.1f}" for k, v in p["top_host_ops_ms"].items()))
    del params, state
    torch.cuda.empty_cache()
    return out


def qwen_step_phase():
    """One GRPO train step of qwen-distill-1.5b on the published config
    (bfloat16, vocab 151936, remat) at the launcher's batch (8 x 160, 48
    response tokens): first the same step in float32 from the same
    weights (the loss to hold the bf16 loss to, within 5e-2 relative),
    then a warm-up bf16 step (its loss is the one compared), two timed
    steps and one profiled step (device busy time, idle share, K1's time,
    top kernels).  The behaviour log-probs are the float32 model's own, as
    a rollout's would be, so the ratio starts at 1.  Every bf16 step
    launches K1 2 x 28 times (the forward and the remat recompute of each
    layer; the gradient of attention is the plain version's, no kernel),
    all on the tensor-core kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.params import Params, tree_map
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.rl.grpo import make_train_step, token_logp_from_logits

    cfg = get_config(ARCH)
    cfg32 = cfg.replace(dtype="float32")
    opt = AdamWConfig(lr=3e-5)
    B, S, prompt = 8, 160, 112
    torch.cuda.empty_cache()
    p32 = transformer.init(0, cfg32, "cuda")
    p16 = Params(tree_map(lambda t: t.to(torch.bfloat16), p32))
    batch = _train_batch(cfg, B, S, prompt, "cuda")
    with torch.no_grad():
        lp = token_logp_from_logits(
            transformer.forward(p32, cfg32, batch["tokens"])[:, :-1],
            batch["tokens"][:, 1:])
    batch["behavior_logp"] = torch.cat(
        [torch.zeros_like(lp[:, :1]), lp], 1) * batch["loss_mask"]
    del lp
    # the float32 step from the same weights: K1 on the CUDA-core kernel
    p32.requires_grad_(True)
    _reset_counts()
    _, _, m = make_train_step(cfg32, opt)(p32, adamw_init(p32, opt), batch)
    loss32, gnorm32 = float(m["loss"]), float(m["grad_norm"])
    _expect_variants("qwen f32 train step", {"simt": 2 * cfg.n_layers,
                                             "wgmma": 0})
    del p32, m
    torch.cuda.empty_cache()

    p16.requires_grad_(True)
    state = adamw_init(p16, opt)
    step = make_train_step(cfg, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses, gnorms = [], [], []
    want = {"flash_attention_fwd": 2 * cfg.n_layers, "flash_decode": 0,
            "paged_flash_decode": 0, "mlstm_scan": 0}
    for i in range(3):
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, m = step(p16, state, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        gnorms.append(gnorm)
        counts = _read_counts()
        if counts != want or not (math.isfinite(loss)
                                  and math.isfinite(gnorm)):
            fail(f"qwen bf16 train step: launches {counts} (expected "
                 f"{want}), loss {loss}, grad_norm {gnorm}")
        variants = _expect_variants(f"qwen bf16 train step {i + 1}",
                                    {"simt": 0, "wgmma": 2 * cfg.n_layers})
    rel = abs(losses[0] - loss32) / abs(loss32)
    if not rel <= 5e-2:
        fail(f"qwen bf16 train step: loss {losses[0]} vs float32 {loss32} "
             f"from the same weights, relative {rel:.3e} > 5e-2")
    gnorm_rel = abs(gnorms[0] - gnorm32) / abs(gnorm32)
    out = dict(step_ms=times[1:], warmup_ms=times[0], loss=losses[0],
               loss_float32=loss32, loss_rel=rel, grad_norm=gnorms[0],
               grad_norm_float32=gnorm32, grad_norm_rel=gnorm_rel,
               losses=losses, grad_norms=gnorms,
               launches=counts["flash_attention_fwd"],
               launches_by_variant=variants,
               params=sum(p.numel() for p in p16.parameters()),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    say(f"qwen-distill-1.5b published config (bfloat16, vocab 151936, remat) "
        f"GRPO train step, B=8 S=160: {out['params'] / 1e9:.3f} B params, "
        f"{' / '.join(f'{t:.1f}' for t in times)} ms (first is warm-up; host "
        f"clock, synchronised), flash_attention launches {out['launches']} "
        f"per step ({variants}), loss {losses[0]:.6f} vs float32 "
        f"{loss32:.6f} from the same weights (relative {rel:.2e} <= 5e-2), "
        f"grad_norm {gnorms[0]:.4f} vs float32 {gnorm32:.4f} (relative "
        f"{gnorm_rel:.2e}; the later steps' losses "
        f"{', '.join(f'{x:.6f}' for x in losses[1:])} and grad norms "
        f"{', '.join(f'{x:.4f}' for x in gnorms[1:])} follow the updates), "
        f"peak memory {out['peak_mem_gib']:.2f} GiB")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(p16, state, batch)
        torch.cuda.synchronize()
    kernels = _trace_kernels(prof, "qwen_train_step")
    if kernels:
        out["profile"] = p = _busy(kernels, kernels[0][0], 1)
        p["flash_attention_ms"] = sum(e - s for s, e, name in kernels
                                      if "flash_fwd_sm90" in name) / 1e3
        host = sorted(prof.key_averages(),
                      key=lambda e: -e.self_cpu_time_total)
        p["top_host_ops_ms"] = {e.key: e.self_cpu_time_total / 1e3
                                for e in host[:8]}
        say(f"profile qwen train step (torch.profiler): window "
            f"{p['window_ms']:.1f} ms, device busy {p['busy_ms']:.1f} ms, "
            f"idle share {p['idle_share']:.3f}, K1 tensor-core kernel "
            f"(forward and remat recompute) {p['flash_attention_ms']:.2f} ms;"
            " top kernels ms " + ", ".join(
                f"{k} {v:.2f}" for k, v in p["top_kernels_ms"].items())
            + "; top host ops ms (self CPU) " + ", ".join(
                f"{k} {v:.1f}" for k, v in p["top_host_ops_ms"].items()))
    else:
        say("profile qwen train step: the trace holds no kernel: device "
            "busy share not measured")
    del p16, state
    torch.cuda.empty_cache()
    return out


def ckpt_launcher_phase():
    """The launcher as a user runs it, on the card (no ``--device``): a
    ``--crash-after 2`` run of ``--smoke --steps 4 --ckpt-every 1`` must
    exit 17 and leave ``step-00000002`` and no ``tmp-*``; ``--resume``
    from the same directory must report a resume from step 2 and finish
    step 4.  The directory is a temporary one, removed at the end."""
    import os
    import shutil
    import tempfile

    ckpt = Path(tempfile.mkdtemp(prefix="ckpt-smoke-"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
            "--steps", "4", "--ckpt-dir", str(ckpt), "--json"]
    try:
        t0 = time.perf_counter()
        crash = subprocess.run(base + ["--ckpt-every", "1", "--crash-after",
                                       "2"], env=env, cwd=ROOT,
                               capture_output=True, text=True, timeout=300)
        crash_s = time.perf_counter() - t0
        left = sorted(p.name for p in ckpt.iterdir())
        if crash.returncode != 17 or "step-00000002" not in left or any(
                n.startswith("tmp-") for n in left):
            fail(f"train --crash-after 2: exit {crash.returncode} (expected "
                 f"17), left {left}: {crash.stdout[-2000:]}"
                 f"{crash.stderr[-2000:]}")
        t0 = time.perf_counter()
        res = subprocess.run(base + ["--resume"], env=env, cwd=ROOT,
                             capture_output=True, text=True, timeout=300)
        resume_s = time.perf_counter() - t0
        logs = [json.loads(line) for line in res.stdout.splitlines()
                if line.startswith("{")]
        resumed = [m["resumed_step"] for m in logs if "resumed_step" in m]
        reached = max((m["step"] for m in logs if "step" in m), default=0)
        if res.returncode != 0 or resumed != [2] or reached != 4:
            fail(f"train --resume: exit {res.returncode}, resumed from "
                 f"{resumed} (expected [2]), reached step {reached} "
                 f"(expected 4): {res.stdout[-2000:]}{res.stderr[-2000:]}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    say(f"train --smoke --crash-after 2 on the card: exit 17 in "
        f"{crash_s:.1f} s, left {left}; --resume: resumed from step 2, "
        f"reached step 4, exit 0 in {resume_s:.1f} s (each a fresh process)")
    return dict(crash_s=crash_s, resume_s=resume_s, left=left)


def ckpt_full_width_phase():
    """qwen-distill-1.5b's launcher setup (float32, tokenizer vocab, no
    remat) at full width cut to 2 layers, on the card: 2 steps, a save,
    a restore into a fresh trainer from the same seed (the launcher's
    ``resume``), every parameter and AdamW moment, the step count and the
    weight version equal bit for bit; then one more step.  One save is
    about 1.1 GB (a full-depth float32 save would be about 13 GB)."""
    import shutil
    import tempfile
    import torch
    from repro_torch.ckpt.checkpoint import (restore_checkpoint,
                                             save_checkpoint, trainer_state)
    from repro_torch.launch.train import (launcher_config, make_trainer,
                                          parser, resume, train_loop)
    from repro_torch.obs import log

    args = parser().parse_args(["--steps", "3", "--quiet", "--device",
                                "cuda"])
    log.configure(args)
    cfg = launcher_config(args).replace(n_layers=2)
    ckpt = Path(tempfile.mkdtemp(prefix="ckpt-full-"))
    try:
        first = make_trainer(args, cfg)
        train_loop(first, 2)
        t0 = time.perf_counter()
        path = save_checkpoint(ckpt, 2, trainer_state(
            first.params, first.opt_state, first.store.version))
        save_s = time.perf_counter() - t0
        size = (path / "state.pkl").stat().st_size
        t0 = time.perf_counter()
        step, state = restore_checkpoint(ckpt, device="cuda")
        restore_s = time.perf_counter() - t0
        fresh = make_trainer(args, cfg)
        if all(torch.equal(a, b) for a, b in zip(
                first.params.parameters(), fresh.params.parameters())):
            fail("checkpoint full width: a fresh trainer already equals the "
                 "trained one; the comparison would prove nothing")
        resume(fresh, state)
        version = int(state["version"])
        del state
        n = 0
        for name, p in first.params.named_parameters():
            q = fresh.params.get_parameter(name)
            pairs = [(p, q), (first.opt_state["m"][name],
                              fresh.opt_state["m"][name]),
                     (first.opt_state["v"][name],
                      fresh.opt_state["v"][name])]
            for a, b in pairs:
                if a.dtype != b.dtype or not torch.equal(a, b):
                    fail(f"checkpoint full width: {name} differs after "
                         "the restore")
                n += 1
        if (step, fresh.opt_state["count"], version) != (
                2, first.opt_state["count"], first.store.version):
            fail(f"checkpoint full width: step {step}, count "
                 f"{fresh.opt_state['count']} / {first.opt_state['count']}, "
                 f"version {version} / {first.store.version}")
        del first
        torch.cuda.empty_cache()
        out = train_loop(fresh, 3, step0=2)
        last = out["steps"][-1]
        if (len(out["steps"]) != 1 or last["step"] != 3
                or not math.isfinite(last["loss"])):
            fail(f"checkpoint full width: the step after the restore gave "
                 f"{out['steps']}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    say(f"checkpoint full width ({cfg.name}, 2 layers, float32, on the card):"
        f" save {size / 2 ** 30:.2f} GiB in {save_s:.2f} s, restore "
        f"{restore_s:.2f} s; {n} tensors (params, m, v), count and version "
        f"bit-exact; step 3 after the restore: loss {last['loss']:.5f}")
    del fresh
    torch.cuda.empty_cache()
    return dict(save_gib=size / 2 ** 30, save_s=save_s, restore_s=restore_s,
                tensors=n)


# ------------------------------------------------------------------ phase 4
def teacher_forced_phase(arch=ARCH, n_layers=4):
    """``arch`` at full width cut to ``n_layers`` in float32, the same
    params on the card and the CPU: prefill + 8 decode steps fed the CPU's
    greedy tokens, logits within 1e-3 of max |logit|."""
    import numpy as np
    import torch
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import get_config
    from repro_torch.data.tasks import MathTaskGenerator, Tokenizer
    from repro_torch.models import transformer

    cfg = get_config(arch).replace(n_layers=n_layers, dtype="float32")
    on_card = transformer.init(1, cfg, "cuda")
    on_cpu = params_from_jax(on_card.tree(), "cpu")
    tasks = MathTaskGenerator(seed=2).batch(2)
    plen = max(len(t.prompt_ids) for t in tasks)
    toks = np.full((2, plen), Tokenizer.PAD, np.int64)
    for i, t in enumerate(tasks):
        toks[i, plen - len(t.prompt_ids):] = t.prompt_ids
    steps, worst = 8, 0.0
    with torch.inference_mode():
        lg_gpu, c_gpu = transformer.prefill(
            on_card, cfg, torch.from_numpy(toks).cuda(), max_len=plen + steps)
        lg_cpu, c_cpu = transformer.prefill(
            on_cpu, cfg, torch.from_numpy(toks), max_len=plen + steps)
        for t in range(steps + 1):
            a, b = lg_gpu.float().cpu(), lg_cpu.float()
            rel = float((a - b).abs().max() / b.abs().max())
            worst = max(worst, rel)
            if not (torch.isfinite(a).all() and rel <= 1e-3):
                fail(f"teacher-forced {arch} step {t}: max |card - cpu| / "
                     f"max |cpu| = {rel:.3e} > 1e-3")
            if t == steps:
                break
            tok = torch.argmax(b[:, :cfg.vocab], dim=-1).to(torch.int32)
            pos = torch.full((2,), plen + t, dtype=torch.int32)
            lg_gpu, c_gpu = transformer.decode_step(on_card, cfg, c_gpu,
                                                    tok.cuda(), pos.cuda())
            lg_cpu, c_cpu = transformer.decode_step(on_cpu, cfg, c_cpu, tok,
                                                    pos)
    say(f"teacher-forced card vs cpu ({arch}, {n_layers} layers, float32, "
        f"prefill + {steps} decode steps): worst max |card - cpu| / max "
        f"|cpu| = {worst:.2e} <= 1e-3")
    del on_card, c_gpu, lg_gpu
    torch.cuda.empty_cache()
    return worst


def paged_teacher_forced_phase():
    """The paged forward passes on the card against the CPU: 2 prompts
    prefilled in chunks of 16 into pages of 16 (so chunks with p0 > 0 run),
    then 8 paged decode steps fed the CPU's greedy tokens, with a third
    slot inactive."""
    import numpy as np
    import torch
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import get_config
    from repro_torch.data.tasks import MathTaskGenerator
    from repro_torch.models import transformer
    from repro_torch.serve.model import paged_decode_step, paged_prefill_chunk

    cfg = get_config(ARCH).replace(n_layers=4, dtype="float32")
    params = {"cuda": transformer.init(3, cfg, "cuda")}
    params["cpu"] = params_from_jax(params["cuda"].tree(), "cpu")
    prompts = [t.prompt_ids for t in MathTaskGenerator(seed=2).batch(2)]
    page, chunk, steps, slots = 16, 16, 8, 3
    maxp = -(-(max(map(len, prompts)) + steps) // page)
    tables = np.random.default_rng(0).permutation(slots * maxp) + 1
    tables = tables.reshape(slots, maxp).astype(np.int32)
    shape = (cfg.n_layers, 1 + slots * maxp, page, cfg.n_kv_heads, cfg.hd)
    pools = {d: [torch.zeros(shape, device=d) for _ in range(2)]
             for d in params}
    worst, offsets = 0.0, []

    def compare(what, a, b):
        nonlocal worst
        a, b = a.float().cpu(), b.float()
        rel = float((a - b).abs().max() / b.abs().max())
        worst = max(worst, rel)
        if not (torch.isfinite(a).all() and rel <= 1e-3):
            fail(f"paged teacher-forced {what}: max |card - cpu| / max |cpu|"
                 f" = {rel:.3e} > 1e-3")

    last = []
    with torch.no_grad():
        for s, prompt in enumerate(prompts):
            for p0 in range(0, len(prompt), chunk):
                n = min(chunk, len(prompt) - p0)
                toks = np.zeros(chunk, np.int64)
                toks[:n] = prompt[p0:p0 + n]
                out = {d: paged_prefill_chunk(
                    p, cfg, *pools[d], torch.from_numpy(tables[s]).to(d),
                    torch.from_numpy(toks).to(d), p0)[0]
                    for d, p in params.items()}
                compare(f"prefill slot {s} p0={p0}", out["cuda"][:n],
                        out["cpu"][:n])
                offsets.append(p0)
            last.append(out["cpu"][n - 1])
        if max(offsets) == 0:
            fail("paged teacher-forced: no prefill chunk with p0 > 0 ran")
        logits = torch.stack([last[0], last[1], last[1]])
        active = torch.tensor([1, 1, 0], dtype=torch.int32)
        for t in range(steps):
            tok = torch.argmax(logits[:, :cfg.vocab], dim=-1).to(torch.int32)
            pos = torch.tensor([len(prompts[0]) + t, len(prompts[1]) + t, 0],
                               dtype=torch.int32)
            out = {d: paged_decode_step(
                p, cfg, *pools[d], torch.from_numpy(tables).to(d), tok.to(d),
                pos.to(d), active.to(d))[0] for d, p in params.items()}
            compare(f"decode step {t}", out["cuda"][:2], out["cpu"][:2])
            logits = out["cpu"]
    say(f"paged teacher-forced card vs cpu (4 layers, float32, prefill in "
        f"chunks of {chunk} at p0 = {offsets} over pages of {page}, {steps} "
        f"decode steps, one inactive slot): worst max |card - cpu| / max "
        f"|cpu| = {worst:.2e} <= 1e-3")
    return worst


def _rel(a, b):
    """max |card - cpu| / max |cpu|, the card's tensor brought over."""
    a, b = a.detach().float().cpu(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max())


def xlstm_teacher_forced_phase():
    """xlstm-1.3b at full width cut to 4 layers, float32, the same params
    on the card and the CPU: the training forward's logits, the prefill's
    logits and (C, n, m) carry, then 8 decode steps fed the CPU's greedy
    tokens, each within 1e-3 of max |value|."""
    import numpy as np
    import torch
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import get_config
    from repro_torch.data.tasks import MathTaskGenerator, Tokenizer
    from repro_torch.models import xlstm

    cfg = get_config("xlstm-1.3b").replace(n_layers=4, dtype="float32")
    on_card = xlstm.init(1, cfg, "cuda")
    on_cpu = params_from_jax(on_card.tree(), "cpu")
    tasks = MathTaskGenerator(seed=2).batch(2)
    plen = max(len(t.prompt_ids) for t in tasks)
    toks = np.full((2, plen), Tokenizer.PAD, np.int64)
    for i, t in enumerate(tasks):
        toks[i, plen - len(t.prompt_ids):] = t.prompt_ids
    toks = torch.from_numpy(toks)
    steps, worst = 8, {}

    def compare(what, a, b):
        rel = _rel(a, b)
        worst[what.split()[0]] = max(worst.get(what.split()[0], 0.0), rel)
        if not (bool(torch.isfinite(a).all()) and rel <= 1e-3):
            fail(f"xlstm card vs cpu {what}: max |card - cpu| / max |cpu| = "
                 f"{rel:.3e} > 1e-3")

    _reset_counts()
    with torch.inference_mode():
        compare("forward logits", xlstm.forward(on_card, cfg, toks.cuda()),
                xlstm.forward(on_cpu, cfg, toks))
        lg_gpu, c_gpu = xlstm.prefill(on_card, cfg, toks.cuda(),
                                      max_len=plen + steps)
        lg_cpu, c_cpu = xlstm.prefill(on_cpu, cfg, toks, max_len=plen + steps)
        for name in ("C", "n", "m"):
            compare(f"prefill {name}", c_gpu[name], c_cpu[name])
        for t in range(steps + 1):
            compare(f"logits step {t}", lg_gpu, lg_cpu)
            if t == steps:
                break
            tok = torch.argmax(lg_cpu[:, :cfg.vocab], dim=-1).to(torch.int32)
            pos = torch.full((2,), plen + t, dtype=torch.int32)
            lg_gpu, c_gpu = xlstm.decode_step(on_card, cfg, c_gpu,
                                              tok.cuda(), pos.cuda())
            lg_cpu, c_cpu = xlstm.decode_step(on_cpu, cfg, c_cpu, tok, pos)
    # one scan per layer for the forward and for the prefill, all float32
    variants = _scan_variants()
    if variants != {"simt": 2 * cfg.n_layers, "mma": 0}:
        fail(f"xlstm teacher-forced: mlstm_scan launches by kernel "
             f"{variants}, expected {2 * cfg.n_layers} on the CUDA-core "
             "kernel")
    say("xlstm teacher-forced card vs cpu (4 layers, float32, forward, "
        f"prefill + carry, {steps} decode steps): worst max |card - cpu| / "
        "max |cpu| " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
        + " <= 1e-3")
    return worst


def train_step_parity_phase():
    """One GRPO train step on the card and on the CPU from the same params
    and batch, at full width cut to 4 layers in float32: xlstm-1.3b (K4
    forward, recomputed backward) and qwen-distill-1.5b (K1 forward, its
    recompute backward).  Loss and grad_norm agree within 1e-3 relative."""
    import torch
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import get_config
    from repro_torch.models.api import get_model
    from repro_torch.models.params import tree_map
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.rl.grpo import make_train_step

    out = {}
    for arch in ("xlstm-1.3b", ARCH):
        cfg = get_config(arch).replace(n_layers=4, dtype="float32",
                                       remat=False)
        opt = AdamWConfig(lr=3e-5)
        step = make_train_step(cfg, opt)
        card = get_model(cfg).init(4, cfg, "cuda")
        res = []
        host = tree_map(lambda t: t.to("cpu", copy=True), card.tree())
        for params in (card, params_from_jax(host, "cpu")):
            dev = params["embed"].device
            params.requires_grad_(True)
            _reset_counts()
            _, _, m = step(params, adamw_init(params, opt),
                           _train_batch(cfg, 4, 64, 40, dev, seed=1))
            res.append((float(m["loss"]), float(m["grad_norm"])))
            if params is card:
                counts = _read_counts()
                key = ("mlstm_scan" if cfg.family == "ssm"
                       else "flash_attention_fwd")
                if counts[key] != cfg.n_layers or (
                        key == "mlstm_scan" and _scan_variants()["mma"]):
                    fail(f"train step parity {arch}: launches {counts} (scan "
                         f"by kernel {_scan_variants()}), expected "
                         f"{cfg.n_layers} {key}, none on the bf16 kernel")
        del card, params
        rel = [abs(a - b) / abs(b) for a, b in zip(*res)]
        if not all(math.isfinite(x) and x <= 1e-3 for x in rel):
            fail(f"train step parity {arch}: card (loss, grad_norm) "
                 f"{res[0]} vs cpu {res[1]}: relative {rel}")
        say(f"train step card vs cpu {arch} (4 layers, float32): loss "
            f"{res[0][0]:.6f} / {res[1][0]:.6f}, grad_norm "
            f"{res[0][1]:.6f} / {res[1][1]:.6f}, relative "
            f"{rel[0]:.2e} / {rel[1]:.2e} <= 1e-3")
        out[arch] = rel
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------- main
def main() -> None:
    t_start = time.perf_counter()
    setup()
    import torch
    from repro_torch.data.tasks import MathTaskGenerator

    prompt_len = max(len(t.prompt_ids)
                     for t in MathTaskGenerator(seed=0).batch(32))
    records = kernels_phase(prompt_len, 128)
    records["paged_flash_decode"] = paged_kernel_phase(
        max(len(t.prompt_ids) for t in MathTaskGenerator(seed=0).batch(8)),
        128)
    records["mlstm_scan"] = ssm_kernel_phase(160)
    for name, part in gqa_phase(prompt_len, 128).items():
        records[name]["gqa_groups"] = part
    flash_grad_phase()
    counts, gen = serve_phase()
    records["flash_attention_fwd"]["launches"] = counts["flash_attention_fwd"]
    by_variant = {v: sum(run[v] for run in
                         gen["flash_launches_by_variant"].values())
                  for v in ("simt", "wgmma")}
    if min(by_variant.values()) < 1:
        fail(f"a K1 kernel was not launched on the serving path: {by_variant}")
    records["flash_attention_fwd"]["launches_by_variant"] = by_variant
    records["flash_decode"]["launches"] = counts["flash_decode"]
    say("serve summary " + json.dumps(gen))
    records["paged_flash_decode"]["launches"], paged, measured = (
        paged_serve_phase())
    say("paged serve summary " + json.dumps(paged))
    say("schedule feedback summary " + json.dumps(dict(
        schedule_feedback_phase(measured), **CARD)))
    train = train_phase()
    records["mlstm_scan"]["launches"] = train["xlstm-1.3b"][0]["mlstm_scan"]
    for name, rec in records.items():
        # launches on the training path: xlstm's run for the scan, the
        # dense run for the attention kernels
        arch = "xlstm-1.3b" if name == "mlstm_scan" else ARCH
        rec["train_launches"] = train[arch][0][name]
    for arch, (_, summary, _) in train.items():
        say(f"train summary {arch} " + json.dumps(summary))
    step = xlstm_step_phase()
    say("xlstm train step summary " + json.dumps(step))
    # K4 by kernel over the training runs: the float32 launcher run and the
    # published-config (bf16) step
    scan_by_variant = {v: train["xlstm-1.3b"][2][v]
                       + step["launches_by_variant"][v]
                       for v in ("simt", "mma")}
    if min(scan_by_variant.values()) < 1:
        fail(f"a K4 kernel was not launched on the training path: "
             f"{scan_by_variant}")
    records["mlstm_scan"]["launches_by_variant"] = scan_by_variant
    qstep = qwen_step_phase()
    say("qwen train step summary " + json.dumps(dict(qstep, **CARD)))
    records["flash_attention_fwd"]["train_step_launches_by_variant"] = (
        qstep["launches_by_variant"])
    say("checkpoint summary " + json.dumps(dict(
        launcher=ckpt_launcher_phase(), full_width=ckpt_full_width_phase())))
    for arch in ("qwen-distill-7b", "qwen-distill-14b"):
        big = big_serve_phase(arch)
        say(f"{arch} serve summary " + json.dumps(dict(big, **CARD)))
        for name, engine in (("flash_attention_fwd", "static"),
                             ("flash_decode", "static"),
                             ("paged_flash_decode", "paged")):
            records[name].setdefault("serve_launches", {})[arch] = (
                big[engine]["launches"][name])
    teacher_forced_phase()
    for arch in ("qwen-distill-7b", "qwen-distill-14b"):
        teacher_forced_phase(arch, 2)
    paged_teacher_forced_phase()
    xlstm_teacher_forced_phase()
    train_step_parity_phase()
    kernels = [dict(name=name, **rec) for name, rec in records.items()]
    for k in kernels:
        if not all(math.isfinite(k[key]) for key in
                   ("ms", "plain_ms", "bound_ms")) or not (
                k["library_ms"] is None or math.isfinite(k["library_ms"])):
            fail(f"kernel record {k['name']} has a non-finite time: {k}")
        if k["launches"] < 1:
            fail(f"kernel {k['name']} was not launched on its path")
    say(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
