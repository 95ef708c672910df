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
   and one long shape each.  K1 has three kernels (``_variant``): every
   case at D 64 / 80 / 128 runs a tensor-core kernel through the wrapper
   (wgmma in bfloat16, the 3xTF32 kernel "tf32x3" in float32; its launch
   counted by variant) and the CUDA-core kernel through its C entry, both
   held to the plain version and their max errors printed side by side,
   over a sweep of D 64 / 80 / 128, groups of 1, 5, 6, 7 and 8 heads,
   Sq 2..160, windows 9 / 200, Sq != Sk and non-causal, and a case whose
   rows at positions >= 47 attend nothing and must read 0.  K3 adds
   n_split forced to 1, 2 and 7 over 8192 slots with one valid, a window
   that empties the early splits, ring layouts over 1 and 4 splits,
   groups of 5..8, D 64 / 80 / 128 and C not a multiple of the tile (each
   call on the block body ``_decode_body`` names, read from the
   wrapper's ``launches_by_variant``: the tensor cores at D 64 / 80 /
   128, "mma" for bfloat16 and "tf32x3", three TF32 products, for
   float32, a float32 call there on "core" failing the phase; the CUDA
   cores otherwise), and is timed at n_split 1, 2, 4, 8 and the default
   at B=32 and B=8, 64 over 8192 slots, in float32 with the CUDA-core
   body beside it at the count the rule gives that body
   (``CORE_PINNED_SPLITS``), the float32 defaults held to
   ``TF32X3_PINNED_SPLITS``.  K2, on the same split-cache kernels, gets
   the same split cases over the paged layout (pages of 4 / 16 / 128) and
   the same split sweep.  K4 has three kernels (``_variant``): at D 64..512 the
   tensor-core kernels ("mma" in bfloat16, "tf32x3" in float32: three TF32
   products) run through the wrapper at the CPU sweep's shapes widened to
   D 64 / 128 / 256 and at D 512 (train, prefill and long shapes), the
   CUDA-core kernel ("simt") through its C entry beside them, all with the
   final carry; a call at D 64..512 that takes "simt" fails the phase.
   GQA groups: K3 and K2 at G = 7 and 5 (the
   7B / 14B configs, 28 / 4 and 40 / 8 heads) and above 8, G = 12 (48 / 4,
   starcoder2-15b) and 16 (64 / 4), D = 128, at one split and at splits
   forced above 1, one launch a call; K1 prefill at the 7B / 14B head
   counts; bf16 times at G = 12 / 16.  Times
   (CUDA events, median of 20 launches, L2 flushed before each behind a
   device-side wait longer than the host's enqueue) for the
   kernel, its plain version and ``scaled_dot_product_attention`` as a
   yardstick (for the paged kernel over the pre-gathered dense cache: the
   gather is not timed), and K1's and K4's CUDA-core kernels beside their
   tensor-core ones (both in both dtypes; K4's by pass too), beside the
   least time the card could take for the same work, at the B=32 shapes
   and the long shapes (K1 also at the float32 train step's B=8 x 160).
   The bound of the float32 tensor-core kernels counts their operations
   at the TF32 peak over 3 (``PEAK_FLOPS["tf32x3"]``), of the CUDA-core
   kernels at the float32 CUDA-core peak (printed beside it).
   The autotuner (``autotune_phase``): a full ``run_sweep`` of the four
   kernels, H100 measured (every feasible config of every bucket through
   its wrapper, the knob passed explicitly, CUDA events, median of 20, L2
   flushed) and H800 / H20 estimated, with the launch counts set to 0
   before it and read after; per kernel and bucket the winner, the
   builtin default's time and the bound; each winner held to the plain
   version (bf16 at ``_tol``) and to the float32 plain version; the
   CostDB saved, checked by ``python -m repro_torch.autotune validate``
   in a subprocess and reloaded; the card's fractions of peak beside the
   analytic H800 factors; the 1.5B plan on 8 H800 + 8 H20 under
   ``MeasuredCostModel`` (modelled); the winners loaded into
   ``kernels.tuning``, shown in effect on one launch per kernel and
   cleared, so every later phase runs on the builtin knobs; ``python -m
   repro_torch.obs regress`` over the committed baselines (exit 0) and
   over a copy with one throughput cut by 10% (exit 2).
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
   The simulator (``sim_phase``, host numpy) runs every one of those
   plans at fig3's settings (30 steps x 256 rollouts, eta 4, reward
   0.5 s) with its invariants checked: eta held and every launched
   rollout trained, buffered, generating or dropped; the 1.5B
   heterogeneous measured plan also observed (tracer, registry, monitor:
   the same ``SimResult`` in every field but ``stalls_data``, as the
   reference's tests hold it, ``check_report`` passing),
   crashed once under a file-mode ``RecoveryManager`` (no consumed
   rollout lost, a fresh manager reads the files back), with a replica
   failed under an ``ElasticReplanner`` (a swap), and beside the 7B on a
   two-job pool priced by the card (per-job eta, the device ledger
   conserved); its throughputs are modelled, not measured.  The monitor
   on the card (``monitor_phase``): the timed ``generate_groups`` workload
   bare and with a ``HealthMonitor`` and a ``Tracer`` (identical tokens
   and K2 launches), then an ``AsyncGRPOTrainer`` at the 1.5B's full width
   and depth (float32, group 4 x 4 prompts, paged engine, monitor,
   tracer, registry): a warm-up step and 2 measured steps with exact K1 /
   K2 launches, the measured steps' per-stage utilization and bubble
   fraction from ``analyze_trace`` (``check_report`` passing), then a
   file-mode snapshot of its params, moments and buffered rollouts
   (15 GiB) and a fourth step.  Recovery on the card
   (``recovery_phase``): a new manager restores the snapshot into a fresh
   trainer bit for bit, the buffered rollouts field for field
   (``verify_restored`` passing), and the 1.5B ``PagedEngine`` quiesced
   twice mid-run gives an uninterrupted run's tokens.
   Training: ``repro_torch.launch.train`` at
   full width with the launcher's setup (float32: xlstm-1.3b 3 steps, its
   scans all on K4's "tf32x3" kernel; qwen 2 steps with ``--schedule``,
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
   Sharding (``parallel_phase``, after the qwen step): the meta-device
   dry-run (``python -m repro_torch.launch.dryrun``) of qwen-distill-1.5B
   / 7B / 14B x train_4k / decode_32k x single / multi pod in
   subprocesses on the host, eight at a time, each ``ok`` with collectives,
   its roofline terms (modelled, H100 SXM data sheet) and the largest
   rank's argument GB printed, then ``launch.report``'s tables; the 1.5B
   bf16 GRPO step (B=8 x 160, remat) over ``make_host_mesh((1, 1))``
   (NCCL, world 1) with params by ``param_pspecs(fsdp=True)``, AdamW
   state by ``opt_state_pspecs``, batch by ``batch_pspecs`` and
   attention through ``local_map``: 2 x 28 K1 launches a step, all on
   the tensor-core kernel, loss and grad norm within 1e-3 of the
   unsharded step from the same weights, both timed (host clock, device
   busy, idle share) and set beside the same program's dry-run roofline
   at (1, 1); ``make_serve_step`` at B=32 over the cache placed by
   ``cache_pspecs``, 28 K3 launches a step, logits within 1e-3 of the
   unsharded ``decode_step``; K3 on a context-split cache's path (2 and 4
   runs of the context, each launch with its log-sum-exp, merged) held to
   K3 over the whole cache and the plain version; K3's two passes for a
   cache split on its head dim (``hd_phase``: ``decode_scores`` per
   slice, the slices' scores summed, ``decode_softmax_pv`` per slice)
   over 2, 4 and 16 slices at B=32 C=161 and B=64 C=8192, G=12, danube's
   D 80 (Dl 5) on a ring past its window, rows that attend nothing and K3's
   wrapper at D 384, each through the wrappers (which must take the ring
   body wherever 16-byte copies fit) and through each body directly (the
   ring and slice 12's), held to K3 whole and the plain versions (pass 1
   at 2e-5 in either dtype; in bfloat16 pass 2 and the whole decode also
   row by row to the float32 plain version), each pass also alone, and
   ``parallel.local._decode_split_hd`` itself over one slice (one launch
   of each pass); a copy of ``decode_hd.cu`` whose ring pass 2 drops its
   last split in the merge (built beside the kernels in phase 1) must
   fail the row gate and f32's 2e-5; timed at m 2 and 16, both bodies,
   beside K3 whole, the plain versions, one ``torch.einsum`` for pass 1,
   the bound and each body's GB/s, and K3 whole at B=32 C=161 set beside
   its phase-2 time (the timer's device-side wait); the int8
   error-feedback all-reduce over the
   NCCL group on the step's gradients in float32, every leaf within
   0.75 x scale, with the bytes it reduces and its time.  Then
   (``hd_decode_phase``) qwen-distill-1.5B's published config (bf16, 28
   layers, B=32, 32 new tokens) decodes with every attention routed
   through the two passes over 2 head-dim slices: 2 x 28 launches of each
   pass a step, all on the ring bodies, and none of K3, logits within 5e-2
   of K3's decode from the
   same weights, the decode ms a step beside K3's; in float32 at 2 layers
   the greedy tokens equal K3's.
4. Card against CPU, teacher-forced: the full width cut to 4 layers in
   float32, same params on both, 2 prompts.  Static: prefill + 8 decode
   steps fed the CPU's greedy tokens.  Paged: prefill in chunks of 16 over
   pages of 16 (so chunks with p0 > 0 run) + 8 paged decode steps with an
   inactive third slot.  Logits agree within 1e-3 of max |logit|.  xlstm:
   forward, prefill carry and 8 decode steps (its scans on "tf32x3");
   one train step of each family, loss and grad_norm within 1e-3.
   The 7B and 14B at full width cut to 2 layers, static path as above.
5. The other model families (qwen2.5-3b, h2o-danube-1.8b, starcoder2-15b,
   yi-34b, internvl2-2b, qwen3-moe-235b-a22b, grok-1-314b, hymba-1.5b,
   whisper-small).  Kernels at their shapes in float32 and bfloat16
   against the plain versions, timed in bfloat16 beside the plain version,
   SDPA and the bound, each call on the kernel or body it should take: K1
   at D = 80 with window 4096 (S 33 and 4200, the tensor-core kernel; the
   CUDA-core kernel held and timed beside it), non-causal at Sq 33 / Sk
   1500 and 1500 / 1500 (H 12, D 64), at 25 / 5 heads with window 1024 and
   at G = 12 and 16; K3 over rings of 4096 (D = 80) and 1024 slots past
   the window, over whisper's 1500 frames and at G = 16; K2 at D = 80 with
   window 4096 and lengths past it (K3 and K2 at D = 80 on the tensor-core
   body, the CUDA-core body held and timed beside it); at D = 80 a planted
   fault that zeroes q's dims 64..79 must fail the bfloat16 row gate for
   each of the three.  h2o-danube's 24-layer bf16 prefill of a 4200-token
   prompt: host ms, 24 K1 launches all on the tensor-core kernel, their
   device ms (torch.profiler).  Card against CPU in float32,
   teacher-forced, logits within 1e-3 and greedy tokens identical, with
   exact K1 / K3 launches: 2 layers at the published width (qwen3-moe 1;
   grok-1 at its smoke width),
   h2o-danube over a 4200-token prompt and hymba over 1100 (past their
   windows), whisper with frames [2, 1500, 768], internvl2 with patches
   [2, 256, 1024].  Serving in bfloat16 at the published width (random
   init on the card, published and freed before the fetch), at the
   published depth or the largest under 16 GiB of weights (starcoder2 20
   of 40 layers, yi 13 of 60, qwen3-moe 2 of 94, grok-1 1 of 64), B = 8,
   32 new tokens, greedy, through ``RolloutEngine`` (whisper: through
   ``prefill(frames=...)`` and ``decode_step``, since no engine passes
   frames): exact launches (K1 once per attention layer per prefill,
   whisper 36; K3 once per attention layer per decode step, whisper 24;
   h2o-danube's K3 and K2 launches all on the tensor-core body, the other
   families' reported by body), tok/s with and without the fetch, prefill
   ms, decode ms/step, and a
   profiled decode step's device busy time and idle share; h2o-danube and
   starcoder2 also through ``PagedEngine`` with exact K2 launches.  Timed
   bf16 GRPO train steps (remat, B = 8 x 160) of qwen2.5-3b at full depth
   and qwen3-moe at full width and 1 layer: 2 K1 launches per layer a
   step, finite loss and grad norm, params moved.

On every serve, train and teacher-forced path above, K3's and K2's
launches since the counts were set to 0 are read by block body
(``_expect_decode_bodies``): float32 at D 64 / 80 / 128 all on the 3xTF32
body, bfloat16 there all on the mma body, none elsewhere; the K3 and K2
records carry them by path (``launches_by_body``).

The line before the last is ``{"kernels": [...]}`` (eight records: K1
and its float32 kernel, K3, K2, K4 and its float32 kernel, K3's two
head-dim passes); the last line is
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                 # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12,           # fp32 outside the tensor cores
              "bfloat16": 989e12,         # dense bf16 tensor cores
              "tf32x3": 495e12 / 3}       # float32 as three TF32 products
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
    _start_mutant_build()            # waited for in hd_phase
    libs = _build.build_all()
    say(f"built {sorted(libs)} with {' '.join(_build.FLAGS)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in sorted(libs):
        entry = ""
        for line in _build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                entry = _kernel_name(line.split("'")[1])
            elif ("ptxas info" in line and "Used" in line) or "spill" in line:
                say(f"  {name}: {line.split('ptxas info    :')[-1].strip()}"
                    f" [{entry}]")


def _kernel_name(mangled):
    """A kernel's name and template arguments, demangled by c++filt where
    the toolkit's host has it."""
    try:
        name = subprocess.run(["c++filt", mangled], capture_output=True,
                              text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return mangled
    name = name.removeprefix("void ")
    cut = name.rfind(">(")    # where the parameters follow the template
    return name[:cut + 1] if cut >= 0 else name.split("(", 1)[0]


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


def _by_body(errs, body, dtype, got, want):
    """Keep the worst |kernel - plain| of K3's or K2's block ``body`` in
    ``dtype`` in ``errs`` under "body dtype"."""
    key = f"{body} {dtype}"
    errs[key] = max(errs.get(key, 0.0), _max_err(got, want))


def _time_ms(fn, flush, reps=20):
    """Median ms of ``reps`` launches by CUDA events, L2 flushed before
    each, after 3 warm-up launches (the autotuner's timer)."""
    from repro_torch.autotune.bench import time_on_device
    return time_on_device(fn, flush, reps) * 1e3


def _bound_ms(n_bytes, flops, route):
    """The least time of a call: bytes at the HBM rate or operations at
    the peak of ``route`` (a dtype, or "tf32x3"), whichever is longer."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[route] * 1e3
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


def _rule(name, args, kw=None, body=None):
    """(body, resident(Gc), groups, n_split) of K3's (``name``
    "flash_decode") or K2's launch on ``args`` (the wrapper's positional
    arguments, ``kw`` its keywords): the body ``_decode_body`` names (or
    ``body``), the blocks an SM holds of it (the card's query), the head
    groups and the split count of the one rule."""
    from repro_torch.kernels import tuning
    from repro_torch.kernels.decode_attention.ops import (
        _aligned, _decode_body, _launch_groups, _launch_splits, _resident,
        _sm_count)
    from repro_torch.kernels.paged_attention.ops import (_paged_groups,
                                                         _paged_splits)
    kw = kw or {}
    q, k, v = args[:3]
    B, H, D = q.shape
    Hkv = k.shape[2]
    aligned = _aligned(q, k, v)
    body = body or _decode_body(q.dtype, D, aligned)
    n_sm = _sm_count(q.device)
    res = _resident(name, q.device, q.dtype, D, body, aligned)
    if name == "flash_decode":
        C = k.shape[1]
        groups = _launch_groups(B, H // Hkv, Hkv, D, C, n_sm, res,
                                tuning.resolve("decode_attention",
                                               "min_split_tiles", None),
                                body)
        return body, res, groups, _launch_splits(B, H, Hkv, D, C, n_sm, res,
                                                 None, body, groups)
    maxp, page = args[3].shape[1], k.shape[1]
    window, max_len = kw.get("window"), kw.get("max_len")
    groups = _paged_groups(B, H // Hkv, Hkv, D, maxp, page, window, n_sm,
                           res, None, body, max_len)
    return body, res, groups, _paged_splits(B, Hkv, D, maxp, page, window,
                                            n_sm, res, H // Hkv, None, body,
                                            groups, max_len)


def _core_at_rule(name, args, kw):
    """K3's (``name`` "flash_decode") or K2's CUDA-core body on ``args``
    at the split count and head groups the rule gives that body, held to
    CORE_PINNED_SPLITS at the pinned shapes: (a call that launches it
    uncounted, its split count)."""
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.paged_attention import ops as pops
    kw = kw or {}
    q = args[0]
    _, _, groups, n = _rule(name, args, kw, body="core")
    window, scale = kw.get("window"), q.shape[2] ** -0.5
    launcher = ops._launch if name == "flash_decode" else pops._launch
    shape = (tuple(q.shape[:2]) + (args[1].shape[2], q.shape[2])
             + ((args[1].shape[1],) if name == "flash_decode"
                else (args[1].shape[1], args[3].shape[1])))
    want = CORE_PINNED_SPLITS.get((name, shape))
    if want is not None and n != want:
        fail(f"{name} {shape} float32: the rule gives the CUDA-core body "
             f"{n} splits, pinned {want}")
    return (lambda: launcher(*args, window, scale, n, "core",
                             groups[0])[0]), n


def _forced(name, args, kw, n_split):
    """One uncounted launch of K3's (``name`` "flash_decode") or K2's C
    entry at ``n_split`` splits (at most the tiles a row can reach), on the
    body and head groups the rule gives the wrapper's call; returns (o,
    the split count launched)."""
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.paged_attention import ops as pops
    kw = kw or {}
    q, k = args[:2]
    D = q.shape[2]
    body, _, groups, _ = _rule(name, args, kw)
    window = kw.get("window")
    scale = kw.get("scale") or D ** -0.5
    if name == "flash_decode":
        n = max(1, min(int(n_split), -(-k.shape[1] // ops.TILE)))
        return ops._launch(*args, window, scale, n, body, groups[0])[0], n
    reach = pops._reach(args[3].shape[1], k.shape[1], window)
    n = max(1, min(int(n_split), -(-reach // ops.TILE)))
    return pops._launch(*args, window, scale, n, body, groups[0])[0], n


def paged_kernel_phase(prompt_len, new_tokens):
    """Hold the paged flash-decode kernel to its plain version; time the
    main-path and long shapes.  Returns its record of the result line."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import (MMA_DIMS,
                                                          _decode_body)
    from repro_torch.kernels.paged_attention.ops import (
        paged_decode_attention, paged_decode_attention_ref)

    gen = torch.Generator(device="cuda").manual_seed(1)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    stats = {"checks": 0, "max_abs_err": 0.0}
    perr = {}      # the worst error by (body, dtype)
    timings = {}

    def check(what, got, want, dtype, shape):
        _check("paged_flash_decode", got, want, dtype, shape, stats)
        _by_body(perr, _decode_body(getattr(torch, dtype), shape[3], True),
                 dtype, got, want)
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

    # K3's split cases over the paged layout, n_split forced through the
    # uncounted launcher (_forced), or the wrapper's own count (None): most
    # splits empty (one valid slot of 8192), a window that empties the
    # early splits, pages of 4 / 16 / 128 (tiles spanning pages), groups of
    # 5..8 heads at D 64 / 80 / 128 with and without a window
    pcases = [((2, 12, 2, 128, 16, 512), None, n, "one") for n in (1, 2, 7)]
    pcases += [((4, 12, 2, 128, 16, 63), 100, n, "full") for n in (None, 5)]
    pcases += [((3, 12, 2, 128, page, -(-1000 // page)), None, None,
                "ragged") for page in (4, 16, 128)]
    pcases += [((3, 2 * G, 2, D, 8, 10), w, n, "ragged")
               for G in (5, 6, 7, 8) for D in (64, 80, 128)
               for w, n in [(None, None), (30, 3)]]
    for shape, window, force, kind in pcases:
        B, H, Hkv, D, page, maxp = shape
        C = maxp * page
        lens = ([C] * B if kind == "full" else [1] * B if kind == "one"
                else [max(1, C * (b + 1) // (B + 1)) for b in range(B)])
        for dtype in ("float32", "bfloat16"):
            args = paged_case(*shape, lens, dtype, gen)
            body = _decode_body(args[0].dtype, D, True)
            if dtype == "float32" and D in MMA_DIMS and body != "tf32x3":
                fail(f"paged_flash_decode {shape} float32: body {body}")
            if force is not None:
                got, n_split = _forced("paged_flash_decode", args,
                                       dict(window=window), force)
            else:
                before = dict(paged_decode_attention.launches_by_variant)
                got = paged_decode_attention(*args, window=window)
                n_split = paged_decode_attention.last_n_split
                if (paged_decode_attention.launches_by_variant[body]
                        != before[body] + 1):
                    fail(f"paged_flash_decode {shape} {dtype}: bodies "
                         f"{before} -> "
                         f"{paged_decode_attention.launches_by_variant}, "
                         f"expected one {body} launch")
            check(f"window={window} n_split={n_split} {kind} ({body})",
                  got, paged_decode_attention_ref(*args, window=window),
                  dtype, shape)

    # the main path (32 slots, pages of 128, lengths up to prompt + 128)
    # and the long shape
    cap = prompt_len + new_tokens
    main = (32, 12, 2, 128, 128, -(-cap // 128))
    mid = (8, 12, 2, 128, 128, 64)
    long = (64, 12, 2, 128, 128, 64)
    main_lens = torch.randint(prompt_len, cap + 1, (32,), generator=gen,
                              device="cuda").tolist()
    for shape in (main, mid, long):
        B, H, Hkv, D, page, maxp = shape
        lens = main_lens if shape == main else [8192] * B
        for dtype in ("float32", "bfloat16"):
            args = paged_case(*shape, lens, dtype, gen)
            body = _decode_body(args[0].dtype, D, True)
            check("lengths " + ("mixed" if shape == main else "8192"),
                  paged_decode_attention(*args),
                  paged_decode_attention_ref(*args), dtype, shape)
            q, kp, vp, bt, lengths = args
            C = maxp * page
            kd, vd = (x[bt.long()].reshape(B, C, Hkv, D).transpose(1, 2)
                      .contiguous() for x in (kp, vp))
            mask = (torch.arange(C, device="cuda")[None]
                    < lengths[:, None])[:, None, None]
            qt = q[:, :, None]
            n_bytes, flops = paged_work(*shape, lens, q.element_size())
            bound, by = _bound_ms(n_bytes, flops, "tf32x3" if body ==
                                  "tf32x3" else dtype)
            # the engine's call: the longest length as the host knows it
            kw = dict(max_len=max(lens))
            t = timings[(shape, dtype)] = dict(
                ms=_time_ms(lambda: paged_decode_attention(*args, **kw),
                            flush),
                plain_ms=_time_ms(lambda: paged_decode_attention_ref(*args),
                                  flush),
                library_ms=_time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kd, vd, attn_mask=mask, enable_gqa=True), flush),
                bound_ms=bound, bound_by=by, body=body,
                n_split=_rule("paged_flash_decode", args, kw)[3])
            if dtype == "float32":
                # the CUDA-core body beside it, at its own count
                core, t["core_n_split"] = _core_at_rule(
                    "paged_flash_decode", args, kw)
                t["core_ms"] = _time_ms(core, flush)
            if paged_decode_attention.last_n_split != timings[
                    (shape, dtype)]["n_split"]:
                fail(f"paged_flash_decode {shape} {dtype}: launched "
                     f"{paged_decode_attention.last_n_split} splits, the "
                     f"rule gives {timings[(shape, dtype)]['n_split']}")
            del kd, vd
            torch.cuda.synchronize()
    for (shape, dtype), t in timings.items():
        say(f"  time paged {shape} {dtype}: kernel {t['ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}), plain "
            f"{t['plain_ms']:.4f} ms, sdpa over the pre-gathered cache "
            f"(gather not timed) {t['library_ms']:.4f} ms, n_split "
            f"{t['n_split']}, body {t['body']}"
            + (f", CUDA-core body {t['core_ms']:.4f} ms at n_split "
               f"{t['core_n_split']}" if "core_ms" in t else ""))

    # the split count against time: n_split forced, and the default
    split_sweep = {}
    for shape in (main, (8, 12, 2, 128, 128, 64), long):
        B, H, Hkv, D, page, maxp = shape
        lens = main_lens if shape == main else [8192] * B
        for dtype in ("float32", "bfloat16"):
            args = paged_case(*shape, lens, dtype, gen)
            kw = dict(max_len=max(lens))
            row = {}
            for force in (1, 2, 4, 8, None):
                if force is None:
                    row["default"] = dict(
                        n_split=_rule("paged_flash_decode", args, kw)[3],
                        ms=_time_ms(lambda: paged_decode_attention(
                            *args, **kw), flush))
                    _hold_pin("paged_flash_decode", shape, dtype,
                              row["default"]["n_split"])
                    continue
                n = _forced("paged_flash_decode", args, kw, force)[1]
                row[str(n)] = dict(n_split=n, ms=_time_ms(
                    lambda n=n: _forced("paged_flash_decode", args, kw, n),
                    flush))
            split_sweep[f"{dtype} {shape}"] = row
            say(f"  time paged {shape} {dtype} by n_split: "
                + ", ".join(f"{key} {r['ms']:.4f} ms" if key != "default"
                            else f"default ({r['n_split']}) "
                                 f"{r['ms']:.4f} ms"
                            for key, r in row.items()))
            del args
            torch.cuda.synchronize()
    say(f"kernels: paged_flash_decode holds to its plain version at every "
        f"shape ({stats['checks']} checks); worst max err by body {perr}")
    return dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/paged_flash_decode.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:116",
        max_abs_err=stats["max_abs_err"], checks=stats["checks"],
        max_abs_err_by_body=perr,
        library="scaled_dot_product_attention over the pre-gathered dense "
                "cache (gather not timed)",
        **timings[(main, "bfloat16")],
        long=dict(shape=long, **timings[(long, "bfloat16")]),
        float32=timings[(main, "float32")],
        long_float32=dict(shape=long, **timings[(long, "float32")]),
        mid=dict(shape=mid, **timings[(mid, "bfloat16")]),
        mid_float32=dict(shape=mid, **timings[(mid, "float32")]),
        split_sweep=split_sweep)


def resident_check():
    """The blocks an SM holds of K3's and K2's tensor-core bodies (the
    card's occupancy query through ``ops._resident``, which the split
    rule counts a launch against) at D 64 / 80 / 128, the bf16 one in a
    group of 8 rows and of 16, the float32 one in groups of 6 and 8, and
    of the CUDA-core body in bf16 and float32 at D 128; the tensor-core
    bodies' must be ``ops.H100_RESIDENT`` and ``ops.H100_RESIDENT_TF32X3``,
    the numbers the CPU models of the card count with.  Returns {kernel:
    {instantiation: blocks}}."""
    import torch
    from repro_torch.kernels.decode_attention.ops import (
        H100_RESIDENT, H100_RESIDENT_TF32X3, _resident)
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {}
    for name in ("flash_decode", "paged_flash_decode"):
        rec = out[name] = {}
        for D in (64, 80, 128):
            res = _resident(name, dev, torch.bfloat16, D, "mma", True)
            for gc in (6, 12):
                rec[f"mma D={D} Gc={gc}"] = got = res(gc)
                if got != H100_RESIDENT[D]:
                    fail(f"{name}: {got} blocks an SM of the tensor-core "
                         f"body at D {D}, Gc {gc}; H100_RESIDENT says "
                         f"{H100_RESIDENT[D]}")
        for D in (64, 80, 128):
            res = _resident(name, dev, torch.float32, D, "tf32x3", True)
            for gc in (6, 8):
                rec[f"tf32x3 D={D} Gc={gc}"] = got = res(gc)
                if got != H100_RESIDENT_TF32X3[D]:
                    fail(f"{name}: {got} blocks an SM of the float32 "
                         f"tensor-core body at D {D}, Gc {gc}; "
                         f"H100_RESIDENT_TF32X3 says "
                         f"{H100_RESIDENT_TF32X3[D]}")
        for dtype in (torch.bfloat16, torch.float32):
            res = _resident(name, dev, dtype, 128, "core", True)
            for gc in (1, 6, 8):
                rec[f"core {dtype} D=128 Gc={gc}"] = res(gc)
        say(f"  {name}: blocks an SM holds " + ", ".join(
            f"{k} {v}" for k, v in rec.items()) + f" ({CARD['card']})")
    return out


ONE_GROUP = [(36, 4), (48, 4), (64, 4)]   # (H, Hkv): G = 9, 12, 16


def _launch_groups(wrapper, call):
    """Run ``call`` (one launch of K3's or K2's wrapper); return the head
    groups it launched with, as counted in ``wrapper.launches_by_groups``
    from what its C entry was given."""
    before = dict(wrapper.launches_by_groups)
    call()
    ran = [g for g, n in wrapper.launches_by_groups.items()
           if n != before.get(g, 0)]
    if len(ran) != 1 or wrapper.last_groups[0] != ran[0]:
        fail(f"{wrapper.__name__}: launches by head groups {before} -> "
             f"{wrapper.launches_by_groups} for one call (last groups "
             f"{wrapper.last_groups})")
    return ran[0]


def _rule_groups(name, args, kw=None):
    """The head groups ``_head_groups`` gives K3's (``name``
    "flash_decode") or K2's launch on ``args`` (the wrapper's positional
    arguments, ``kw`` its keywords) through the body ``_decode_body``
    names, from the one-group launch's grid (``_rule``)."""
    return _rule(name, args, kw)[2]


def _one_group_checks(gen):
    """bf16 K3 and K2 at G = 9, 12 and 16 (``ONE_GROUP``), D = 64, 80 and
    128, without and with a window of 128, at one split and at splits of
    3 and 4 (dense rows of 700 slots, paged rows in pages of 16, lengths
    700 / 333 / 40 / 1): each case launched on the tensor-core body in one
    head group through the uncounted ``_launch`` helpers, which return
    the groups the C entry was given, held to the bf16 plain version
    (5e-2) and, row by row, to the float32 one (``BF16_ROW_TOL``); at G =
    16 each dense case is also launched with ``return_lse``, its lse held
    to the float32 plain version's.  At G = 12 and 16 a planted fault,
    q's heads 8..15 of every KV group zeroed in the kernel's input only,
    must fail the row gate.  (At B 4 x Hkv 4 the wrappers themselves take
    two groups of 8: ``_head_groups``.)  Returns {kernel: stats} and the
    planted faults' row excess."""
    import torch
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention.ops import decode_attention_ref
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.kernels.paged_attention.ops import (
        paged_decode_attention_ref)

    B, C, page = 4, 700, 16
    valid = [700, 333, 40, 1]
    maxp = -(-C // page)
    stats = {name: {"checks": 0, "max_abs_err": 0.0, "row_excess": 0.0}
             for name in ("flash_decode", "paged_flash_decode")}
    stats["flash_decode"]["lse_max_abs_err"] = 0.0
    planted = {}

    def launch(name, shape, what, args, kw, n_split, lse=False):
        """One uncounted launch on "mma" in one head group; returns its
        output (and lse)."""
        D = args[0].shape[2]
        G = args[0].shape[1] // args[1].shape[2]
        scale = 1.0 / math.sqrt(D)
        if name == "flash_decode":
            o, lse_out, groups = dops._launch(*args, kw["window"], scale,
                                              n_split, "mma", 1, lse)
            got = (o, lse_out) if lse else o
        else:
            got, groups = pops._launch(*args, kw["window"], scale, n_split,
                                       "mma", 1)
        if tuple(groups) != (1, G):
            fail(f"{name} {shape} {what}: the C entry was given head groups "
                 f"{groups}, not one group of {G}")
        return got

    for H, Hkv in ONE_GROUP:
        G = H // Hkv
        for D in (64, 80, 128):
            for window in (None, 128):
                dshape = (B, H, Hkv, D, C)
                pshape = (B, H, Hkv, D, page, maxp)
                dargs = decode_case(*dshape, valid, "bfloat16", gen)
                pargs = paged_case(*pshape, valid, "bfloat16", gen)
                cases = [("flash_decode", decode_attention_ref, dshape,
                          dargs),
                         ("paged_flash_decode", paged_decode_attention_ref,
                          pshape, pargs)]
                for name, plain, shape, args in cases:
                    kw = dict(window=window)
                    want = plain(*args, **kw)
                    want32 = plain(*_widened(args), **kw)
                    for n_split in (1, 3, 4):
                        what = f"G={G} window={window} n_split={n_split}"
                        got = launch(name, shape, what, args, kw, n_split)
                        st = stats[name]
                        _check(name, got, want, "bfloat16", shape, st)
                        excess = _bf16_excess(got, want32)
                        st["row_excess"] = max(st["row_excess"], excess)
                        if not excess <= BF16_ROW_TOL:
                            fail(f"{name} {shape} {what}: row excess "
                                 f"{excess:.3e} > {BF16_ROW_TOL}")
                        if G == 16 and name == "flash_decode":
                            o, lse = launch(name, shape, what + " lse", args,
                                            kw, n_split, lse=True)
                            o32, lse32 = plain(*_widened(args),
                                               return_lse=True, **kw)
                            _check(name, o, want, "bfloat16", shape, st)
                            lst = {"checks": 0, "max_abs_err": 0.0}
                            _check(f"{name} lse", lse, lse32, "bfloat16",
                                   shape, lst)
                            st["checks"] += 1
                            st["lse_max_abs_err"] = max(
                                st["lse_max_abs_err"], lst["max_abs_err"])
                        if G > 8 and n_split == 3 and window is None:
                            qz = args[0].clone().view(B, Hkv, G, D)
                            qz[:, :, 8:] = 0
                            bad = launch(name, shape, what + " planted",
                                         (qz.view(B, H, D), *args[1:]), kw,
                                         n_split)
                            ex = _bf16_excess(bad, want32)
                            planted[f"{name} {shape}"] = ex
                            if ex <= BF16_ROW_TOL:
                                fail(f"{name} {shape} {what}: the planted "
                                     "fault 'q heads 8..15 zeroed' passes "
                                     f"the row gate ({ex:.3e} <= "
                                     f"{BF16_ROW_TOL})")
                        del got
                    del want, want32
                del dargs, pargs
                torch.cuda.synchronize()
    for name, st in stats.items():
        say(f"  {name} bf16 at G 9 / 12 / 16, D 64 / 80 / 128, windows, "
            f"n_split 1 / 3 / 4: {st['checks']} checks on the tensor-core "
            f"body in one head group, max err {st['max_abs_err']:.2e}, row "
            f"excess {st['row_excess']:.2e} <= {BF16_ROW_TOL}"
            + (f", lse max err {st['lse_max_abs_err']:.2e}"
               if "lse_max_abs_err" in st else ""))
    say("  planted 'q heads 8..15 zeroed' (row excess, must exceed "
        f"{BF16_ROW_TOL}): " + ", ".join(f"{k} {v:.2e}"
                                         for k, v in planted.items()))
    return stats, planted


def gqa_phase(prompt_len, new_tokens):
    """K3 and K2 at the GQA groups of the repo's configs, G = 7 (7B,
    28 / 4), 5 (14B, 40 / 8), 12 (starcoder2-15b, 48 / 4) and 16
    (qwen3-moe, 64 / 4), D = 128, in float32 and bfloat16 at one split and
    at splits forced above 1 (head groups must keep their merge tickets
    apart: float32 runs G 12 / 16 in two groups of 8 rows on the 3xTF32
    body), held
    to the plain versions; bf16 at G = 9, 12 and 16 on the tensor cores
    in one head group (``_one_group_checks``); K1 prefill at the 7B and
    14B head counts; bf16 times at G = 12 and 16 at the serve, main and
    two long shapes: the wrapper, in the groups ``_head_groups`` gives, beside
    the same body launched in one group and in two.  Returns {kernel:
    record part}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention.ops import (
        _cut, _resident, _sm_count, decode_attention, decode_attention_ref)
    from repro_torch.kernels.flash_attention.ops import (
        _variant, flash_attention, flash_attention_ref)
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.kernels.paged_attention.ops import (
        paged_decode_attention, paged_decode_attention_ref)

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
    for H, Hkv in groups:
        G = H // Hkv
        for B, C, forces in [(8, prompt_len + 32, (1, 3)),
                             (4, 8192, (1, 4))]:
            valid = [max(1, C * (b + 1) // B) for b in range(B)]
            # the wrapper at its own count (one counted launch), then the
            # counts forced through the uncounted launcher (_forced)
            for force in (None, *forces):
                for dtype in ("float32", "bfloat16"):
                    shape = (B, H, Hkv, 128, C)
                    dargs = decode_case(*shape, valid, dtype, gen)
                    page = 128
                    maxp = -(-C // page)
                    pshape = (B, H, Hkv, 128, page, maxp)
                    pargs = paged_case(*pshape, valid, dtype, gen)
                    for wrapper, name, plain, sh, args in [
                            (decode_attention, "flash_decode",
                             decode_attention_ref, shape, dargs),
                            (paged_decode_attention, "paged_flash_decode",
                             paged_decode_attention_ref, pshape, pargs)]:
                        if force is None:
                            once(wrapper, name, lambda: wrapper(*args),
                                 lambda: plain(*args), dtype, sh,
                                 f"G={G} (the rule's count)")
                            continue
                        got, n = _forced(name, args, {}, force)
                        _check(name, got, plain(*args), dtype, sh,
                               stats[name])
                        say(f"  {name} {sh} G={G} n_split={n} (forced) "
                            f"{dtype}: ok, max err "
                            f"{stats[name]['max_abs_err']:.2e}")
                    del dargs, pargs
                    torch.cuda.synchronize()

    one_stats, planted = _one_group_checks(gen)

    # bf16 times at G = 12 and 16 at the serve shape, the main path's and
    # two long ones (B 32 x 2048: one group by the rows' length, B 64 x
    # 8192: by the grid): the wrapper (the groups ``_head_groups`` gives)
    # beside the same body launched in one group and in two (uncounted),
    # each at the split count the wrappers' rule takes for those groups
    timings = {"flash_decode": {}, "paged_flash_decode": {}}
    n_sm = _sm_count(torch.device("cuda"))

    def timed(wrapper, name, call, args):
        """(ms, n_split, head groups) of the wrapper's launch, which must
        be on the tensor-core body in the groups of ``_rule_groups``."""
        mma = wrapper.launches_by_variant["mma"]
        ng = _launch_groups(wrapper, call)
        if wrapper.launches_by_variant["mma"] != mma + 1:
            fail(f"{name}: not on the tensor-core body")
        if ng != _rule_groups(name, args)[0]:
            fail(f"{name}: launched in {ng} head groups, the rule gives "
                 f"{_rule_groups(name, args)}")
        return _time_ms(call, flush), wrapper.last_n_split, ng

    def both(wrapper, name, call, args):
        ms, n, ng = timed(wrapper, name, call, args)
        rec = dict(ms=ms, n_split=n, head_groups=ng)
        q = args[0]
        B, H, D = q.shape
        Hkv = args[1].shape[2]
        G = H // Hkv
        res = _resident(name, q.device, q.dtype, D, "mma", True)
        for label, g in (("one_group", 1), ("two_group", 2)):
            if name == "flash_decode":
                n_g = dops._launch_splits(B, H, Hkv, D, args[1].shape[1],
                                          n_sm, res, None, "mma", _cut(G, g))

                def launch():
                    return dops._launch(*args, None, 1.0 / math.sqrt(D), n_g,
                                        "mma", g)
            else:
                bt = args[3]
                n_g = pops._paged_splits(B, Hkv, D, bt.shape[1],
                                         args[1].shape[1], None, n_sm, res,
                                         G, None, "mma", _cut(G, g))

                def launch():
                    return pops._launch(*args, None, 1.0 / math.sqrt(D), n_g,
                                        "mma", g)
            if tuple(launch()[-1]) != _cut(G, g):
                fail(f"{name}: the C entry was not given {g} head groups")
            rec[f"{label}_ms"] = _time_ms(launch, flush)
            rec[f"{label}_n_split"] = n_g
        return rec

    for H, Hkv in groups[2:]:
        G = H // Hkv
        for B, C in [(8, prompt_len + new_tokens),
                     (32, prompt_len + new_tokens), (32, 2048), (64, 8192)]:
            shape = (B, H, Hkv, 128, C)
            valid = [C] * B
            dargs = decode_case(*shape, valid, "bfloat16", gen)
            q, k, v, q_pos, k_pos = dargs
            qt = q[:, :, None]
            kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
            mask = ((k_pos >= 0) & (k_pos <= q_pos[:, None]))[:, None, None]
            bound, by = _bound_ms(*decode_work(*shape, valid, 2), "bfloat16")
            timings["flash_decode"][f"G={G} {shape}"] = dict(
                both(decode_attention, "flash_decode",
                     lambda: decode_attention(q, k, v, q_pos, k_pos), dargs),
                plain_ms=_time_ms(lambda: decode_attention_ref(
                    q, k, v, q_pos, k_pos), flush),
                library_ms=_time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True), flush),
                bound_ms=bound, bound_by=by)
            del q, k, v, kt, vt, dargs
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
                both(paged_decode_attention, "paged_flash_decode",
                     lambda: paged_decode_attention(*args), args),
                plain_ms=_time_ms(lambda: paged_decode_attention_ref(*args),
                                  flush),
                library_ms=_time_ms(lambda: F.scaled_dot_product_attention(
                    pt, kd, vd, attn_mask=pmask, enable_gqa=True), flush),
                bound_ms=bound, bound_by=by)
            del args, qp, kp, vp, kd, vd
            torch.cuda.synchronize()
    for name, rows in timings.items():
        for key, t in rows.items():
            say(f"  time {name} {key} bfloat16: kernel {t['ms']:.4f} ms "
                f"(head groups {t['head_groups']}, n_split {t['n_split']}); "
                f"one group {t['one_group_ms']:.4f} ms (n_split "
                f"{t['one_group_n_split']}), two groups "
                f"{t['two_group_ms']:.4f} ms (n_split "
                f"{t['two_group_n_split']}); bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']}), plain {t['plain_ms']:.4f} ms, sdpa "
                f"{t['library_ms']:.4f} ms ({CARD['card']})")
    out = {}
    for name in stats:
        rec = dict(stats[name])
        if name in one_stats:
            rec["checks"] += one_stats[name]["checks"]
            rec["max_abs_err"] = max(rec["max_abs_err"],
                                     one_stats[name]["max_abs_err"])
            rec["one_group_bf16"] = dict(
                one_stats[name],
                planted={k: v for k, v in planted.items()
                         if k.startswith(name + " ")})
        if name in timings:
            rec["times_bf16"] = timings[name]
        out[name] = rec
    say("kernels: K1 at the 7B / 14B head counts, K3 and K2 at G = 5, 7, "
        "9, 12, 16 hold to their plain versions ("
        + ", ".join(f"{k} {v['checks']} checks" for k, v in out.items())
        + "), one launch a call")
    return out


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
    """(bytes, FLOPs) this scan needs: q/k/v read and h written once over
    the real length S (a short last chunk is not padded), the float32
    gates; per row 4 S D^2 FLOPs (q C and the C update) and, per chunk of
    T_c steps, 2 D T_c (T_c + 1) (the causal half of q k^T and of the
    scores times v).  ``q n_t`` needs no ``[T, D]`` product: it is the row
    sum of the weighted scores plus ``e^(a - m) q n``."""
    BH = B * H
    n_bytes = itemsize * 4 * BH * S * D + 4 * 2 * BH * S
    tri = sum(T * (T + 1) for T in
              [chunk] * (S // chunk) + [S % chunk] * (S % chunk > 0))
    return n_bytes, BH * (4.0 * S * D ** 2 + 2.0 * D * tri)


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
    """Hold K4's three kernels (``_variant``: at D in MMA_D "mma" for bf16
    and "tf32x3" for float32, "simt" otherwise) to the plain chunkwise
    version in float32 and bfloat16, the final carry included, the
    CUDA-core kernel beside each tensor-core call; time the main-path and
    long shapes, the CUDA-core kernel and the two passes beside the
    tensor-core kernels.  Returns the records of the result line: K4 (its
    bf16 kernel first) and its float32 kernel."""
    import torch
    from repro_torch.kernels.ssm_scan.ops import _variant, mlstm_scan

    gen = torch.Generator(device="cuda").manual_seed(2)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    stats = {"checks": 0, "max_abs_err": 0.0}
    kerr = {}          # worst error by (kernel, dtype)
    timings = {}
    chunk = 64

    def check(what, got, want, dtype, shape, name):
        _check("mlstm_scan", got, want, dtype, shape, stats, MLSTM_TOL)
        err = _max_err(got, want)
        kerr[(name, dtype)] = max(kerr.get((name, dtype), 0.0), err)
        say(f"  mlstm_scan {shape} {what} {dtype}: ok, max err {err:.2e}")

    # the CPU test sweep (B, S, H, D, chunk), S = 50 the padding path, and
    # the same at the D the tensor-core kernels are built for; then the
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
            # the kernel each call must take, written out here
            expect = ({"bfloat16": "mma", "float32": "tf32x3"}[dtype]
                      if D in (64, 128, 256, 512) else "simt")
            if variant != expect:
                fail(f"mlstm_scan {shape} {dtype}: _variant gives {variant},"
                     f" expected {expect}")
            before = dict(mlstm_scan.launches_by_variant)
            got = mlstm_scan(*args, chunk=T)
            if (mlstm_scan.launches_by_variant[variant]
                    != before[variant] + 1):
                fail(f"mlstm_scan {shape} {dtype}: variant counts {before} "
                     f"-> {mlstm_scan.launches_by_variant}, expected one "
                     f"{variant} launch")
            want = mlstm_plain(*args, T)
            check(f"h ({variant})", got, want, dtype, shape, variant)
            if variant != "simt":
                check("h (simt)", _simt_scan(*args, T), want, dtype, shape,
                      "simt")
            del got, want
            if shape in with_state:
                h_ref, ref = mlstm_plain(*args, T, return_state=True)
                runs = {variant: mlstm_scan(*args, chunk=T,
                                            return_state=True)}
                if variant != "simt":
                    runs["simt"] = _simt_scan(*args, T, return_state=True)
                for name, (h, state) in runs.items():
                    check(f"h with state ({name})", h, h_ref, dtype, shape,
                          name)
                    for part, got, want in zip("Cnm", state, ref):
                        check(f"final {part} ({name})", got, want, dtype,
                              shape, name)
                del runs, h_ref, ref
            if shape in (main, prefill, long):
                n_bytes, flops = mlstm_work(B, S, H, D, T,
                                            args[0].element_size())
                # the route's own peak: TF32 / 3 for the 3xTF32 kernel
                bound, by = _bound_ms(n_bytes, flops, "tf32x3"
                                      if variant == "tf32x3" else dtype)
                t = dict(
                    ms=_time_ms(lambda: mlstm_scan(*args, chunk=T), flush),
                    plain_ms=_time_ms(lambda: mlstm_plain(*args, T), flush),
                    library_ms=None, bound_ms=bound, bound_by=by,
                    variant=variant)
                t["simt_ms"] = _time_ms(lambda: _simt_scan(*args, T), flush)
                # the CUDA-core kernel's own bound: fp32 CUDA-core math in
                # either dtype
                t["simt_bound_ms"] = _bound_ms(n_bytes, flops, "float32")[0]
                t["passes_ms"] = _pass_ms(
                    lambda: mlstm_scan(*args, chunk=T),
                    ("mlstm_scores",) * (variant == "tf32x3")
                    + ("mlstm_intra", "mlstm_carry"))
                timings[(shape, dtype)] = t
            del args
            torch.cuda.synchronize()
    for (shape, dtype), t in timings.items():
        say(f"  time mlstm_scan {shape} {dtype} ({t['variant']}): kernel "
            f"{t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}), plain {t['plain_ms']:.4f} ms, no single "
            f"PyTorch call, CUDA-core kernel {t['simt_ms']:.4f} ms (its "
            f"bound {t['simt_bound_ms']:.4f} ms), by pass " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in t["passes_ms"].items())
            + f"; {CARD['card']}")
    say(f"kernels: mlstm_scan (all three kernels) holds to its plain version"
        f" at every shape ({stats['checks']} checks); worst max err "
        + ", ".join(f"{name} {dtype} {e:.2e}" for (name, dtype), e in
                    sorted(kerr.items())))
    sources = {"mma": "src/repro_torch/kernels/csrc/mlstm_scan_sm90.cu",
               "tf32x3": "src/repro_torch/kernels/csrc/mlstm_scan_tf32x3.cu",
               "simt": "src/repro_torch/kernels/csrc/mlstm_scan.cu"}
    return {
        "mlstm_scan": dict(
            route="cuda", source=sources["mma"], sources=sources,
            replaces="src/repro/kernels/ssm_scan/kernel.py:87",
            max_abs_err=stats["max_abs_err"], checks=stats["checks"],
            max_abs_err_by_kernel={f"{name} {dtype}": e for (name, dtype), e
                                   in sorted(kerr.items())},
            library="none: no single PyTorch call computes the mLSTM scan",
            **timings[(main, "bfloat16")],
            float32=timings[(main, "float32")],
            prefill=dict(shape=prefill, **timings[(prefill, "bfloat16")]),
            long=dict(shape=long, **timings[(long, "bfloat16")]),
            long_float32=timings[(long, "float32")]),
        # K4's float32 kernel on its own line: the launcher's train batch,
        # its prefill, then the long shape; launches are counted on the
        # float32 paths in main()
        "mlstm_scan_tf32x3": dict(
            route="cuda", source=sources["tf32x3"],
            replaces="src/repro/kernels/ssm_scan/kernel.py:87",
            max_abs_err=kerr[("tf32x3", "float32")],
            simt_max_abs_err=kerr[("simt", "float32")],
            library="none: no single PyTorch call computes the mLSTM scan",
            shape=main, **timings[(main, "float32")],
            prefill=dict(shape=prefill, **timings[(prefill, "float32")]),
            long=dict(shape=long, **timings[(long, "float32")]))}


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
    entry, whatever the dtype: the wrapper sends both dtypes at D = 64, 80
    or 128 to a tensor-core kernel, so this is how the sweep holds the
    older design to the plain version there too, and how the phase times
    it beside the new ones.  Not counted as a launch."""
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


def _core_decode(q, k, v, q_pos, k_pos, window=None):
    """K3's CUDA-core body (``split_decode.cuh::decode_block``) through
    ``ops._launch``, at the split count it took before the tensor-core
    body served D = 80 (two waves): how the families phase times the older
    design beside the new one.  Not counted as a launch."""
    from repro_torch.kernels.decode_attention import ops
    B, H, D = q.shape
    C, Hkv = k.shape[1], k.shape[2]
    ng = ops._head_groups(H // Hkv, "core")[0]
    n = _two_waves(B * Hkv * ng, C, ops._sm_count(q.device))
    return ops._launch(q, k, v, q_pos, k_pos, window, 1.0 / math.sqrt(D), n,
                       "core", ng)[0]


def _two_waves(pairs, C, n_sm):
    """The split count the CUDA-core body took before the tensor-core
    body served D = 80: two waves of blocks over the SMs, every split at
    least 8 tiles of 16 slots."""
    return max(1, min(-(-2 * n_sm // pairs), -(-C // 16) // 8))


def _core_paged(q, kp, vp, bt, lengths, window=None):
    """K2's CUDA-core body through ``paged_attention.ops._launch``, as
    ``_core_decode``.  Not counted as a launch."""
    from repro_torch.kernels.decode_attention.ops import (_head_groups,
                                                          _sm_count)
    from repro_torch.kernels.paged_attention import ops
    B, H, D = q.shape
    page, Hkv = kp.shape[1], kp.shape[2]
    maxp = bt.shape[1]
    reach = maxp * page if window is None else min(maxp * page, window)
    ng = _head_groups(H // Hkv, "core")[0]
    n = _two_waves(B * Hkv * ng, reach, _sm_count(q.device))
    return ops._launch(q, kp, vp, bt, lengths, window, 1.0 / math.sqrt(D), n,
                       "core", ng)[0]


def kernels_phase(prompt_len, new_tokens):
    """Hold K1 (all three kernels) and K3 to their plain versions over the
    sweeps; time the main-path and long shapes.  Returns the per-kernel
    records of the result line."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import (
        MMA_DIMS, _decode_body, decode_attention, decode_attention_ref)
    from repro_torch.kernels.flash_attention.ops import (
        _variant, flash_attention, flash_attention_ref)

    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    fstats = {"checks": 0, "max_abs_err": 0.0}
    dstats = {"checks": 0, "max_abs_err": 0.0}
    derr = {}      # K3's worst error by (body, dtype)
    # K1's worst error by (kernel, dtype) over the sweep and the shapes
    kerr = {}
    timings = {}

    # -- flash attention (K1)
    # serve.run (B=8, float32) and the timed generate (B=32, bfloat16)
    serve_f = (8, prompt_len, prompt_len, 12, 2, 128)
    main_f = (32, prompt_len, prompt_len, 12, 2, 128)
    long_f = (4, 4096, 4096, 12, 2, 128)
    # the float32 train step's forward (qwen_step_phase, B=8 x 160)
    train_f = (8, 160, 160, 12, 2, 128)
    timed = (main_f, long_f, train_f)
    # rows at positions >= 47 attend nothing (keys < 32, window 16)
    masked_f = (2, 96, 32, 8, 2, 128)
    shapes = [((2, 33, 65, 4, 4, 24), m) for m in
              [(True, None), (True, 9), (False, None)]]
    shapes += [((2, 40, 40, 4, 2, 16), (True, 9)),
               ((1, 24, 24, 4, 1, 8), (True, None)),
               ((1, 128, 128, 8, 2, 64), (True, 20)),
               (masked_f, (True, 16)),
               (serve_f, (True, None)), (main_f, (True, None)),
               (train_f, (True, None)), (long_f, (True, None))]
    # the tensor-core sweep: D 64 / 80 / 128 (80: h2o-danube, padded to
    # two 64-column chunks in shared memory), groups of 1 and of the
    # 1.5B / 7B / 14B configs (6, 7, 5) and 8; lengths around the 128-row
    # tile (G = 6, Sq = 22 is 132 rows); windows; Sq != Sk; non-causal
    sweep = []
    for D in (64, 80, 128):
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
            if variant != "simt":
                outs["simt"] = _simt_flash(q, k, v, causal, window)
            for name, out in outs.items():
                _check(f"flash_attention_fwd ({name})", out, want, dtype,
                       shape, fstats)
                err = _max_err(out, want)
                kerr[(name, dtype)] = max(kerr.get((name, dtype), 0.0), err)
                errs.append(f"{dtype} {name} {err:.2e}")
                if shape == masked_f and bool(out[:, 47:].abs().max() != 0):
                    fail(f"flash_attention_fwd ({name}) {shape} {dtype}: "
                         "rows that attend nothing are not 0")
            del got, want, outs
            if shape in timed:
                if variant != {"bfloat16": "wgmma",
                               "float32": "tf32x3"}[dtype]:
                    fail(f"flash_attention {shape} {dtype} took {variant}")
                qt, kt, vt = (x.transpose(1, 2).contiguous()
                              for x in (q, k, v))
                n_bytes, flops = flash_work(*shape, causal, window,
                                            q.element_size())
                # the route's own peak: TF32 / 3 for the 3xTF32 kernel
                bound, by = _bound_ms(n_bytes, flops,
                                      "tf32x3" if variant == "tf32x3"
                                      else dtype)
                t = dict(
                    ms=_time_ms(lambda: flash_attention(q, k, v, causal,
                                                        window), flush),
                    plain_ms=_time_ms(lambda: flash_attention_ref(
                        q, k, v, causal, window), flush),
                    library_ms=_time_ms(lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, enable_gqa=True), flush),
                    bound_ms=bound, bound_by=by, variant=variant)
                t["simt_ms"] = _time_ms(lambda: _simt_flash(
                    q, k, v, causal, window), flush)
                # the CUDA-core kernel's own bound (its peak)
                t["simt_bound_ms"] = _bound_ms(n_bytes, flops, dtype)[0]
                timings[("flash", shape, dtype)] = t
            del q, k, v
            torch.cuda.synchronize()
        if (shape, (causal, window)) in shapes or shape[3:] == (12, 2, 128):
            say(f"  flash_attention_fwd {shape} causal={causal} "
                f"window={window}: ok, max err " + ", ".join(errs))
    say(f"  flash_attention_fwd tensor-core sweep: {len(sweep)} shapes, "
        "the tensor-core kernel (wgmma in bf16, tf32x3 in f32) and the "
        "CUDA-core kernel in both dtypes hold to the plain version; rows "
        "that attend nothing read 0; worst max err " + ", ".join(
            f"{name} {dtype} {e:.2e}" for (name, dtype), e in
            sorted(kerr.items())))

    # -- flash decode (K3)
    serve_d = (8, 12, 2, 128, prompt_len + 32)
    main_d = (32, 12, 2, 128, prompt_len + new_tokens)
    mid_d = (8, 12, 2, 128, 8192)
    long_d = (64, 12, 2, 128, 8192)
    # (shape, window, forced n_split, valid lengths: "full", "one" or
    # ragged)
    dcases = [((2, 4, 2, 16, 24), w, None, "ragged") for w in (None, 8)]
    dcases += [((2, 8, 1, 64, 40), 8, None, "ragged"),
               ((3, 6, 3, 20, 17), None, None, "ragged"),
               ((4, 4, 2, 16, 40), 6, None, "ragged"),
               (serve_d, None, None, "full"), (main_d, None, None, "full"),
               (mid_d, None, None, "full"), (long_d, None, None, "full")]
    # most splits empty: one valid slot of 8192, n_split forced
    dcases += [((2, 12, 2, 128, 8192), None, n, "one") for n in (1, 2, 7)]
    # a window that empties the early splits
    dcases += [((4, 12, 2, 128, 1000), 100, n, "full") for n in (None, 5)]
    # groups of 5..8 heads, D 64 / 80 / 128, C not a multiple of the tile
    dcases += [((3, 2 * G, 2, D, 77), w, n, "ragged")
               for G in (5, 6, 7, 8) for D in (64, 80, 128)
               for w, n in [(None, None), (30, 3)]]
    for shape, window, force, lens in dcases:
        B, H, Hkv, D, C = shape
        valid = ([C] * B if lens == "full" else [1] * B if lens == "one"
                 else [max(1, (C * (b + 1)) // (B + 1)) for b in range(B)])
        for dtype in ("float32", "bfloat16"):
            q, k, v, q_pos, k_pos = decode_case(*shape, valid, dtype, gen)
            args, kw = (q, k, v, q_pos, k_pos), dict(window=window)
            body = _decode_body(q.dtype, D, True)
            if dtype == "float32" and D in MMA_DIMS and body != "tf32x3":
                fail(f"flash_decode {shape} float32: body {body}")
            if force is not None:
                # forced through the uncounted launcher
                got, n_split = _forced("flash_decode", args, kw, force)
            else:
                before = dict(decode_attention.launches_by_variant)
                got = decode_attention(*args, **kw)
                n_split = decode_attention.last_n_split
                if (decode_attention.launches_by_variant[body]
                        != before[body] + 1):
                    fail(f"flash_decode {shape} {dtype}: bodies {before} -> "
                         f"{decode_attention.launches_by_variant}, expected "
                         f"one {body} launch")
            want = decode_attention_ref(*args, **kw)
            _check("flash_decode", got, want, dtype, shape, dstats)
            _by_body(derr, body, dtype, got, want)
            say(f"  flash_decode {shape} window={window} n_split="
                f"{n_split} {lens} {dtype} ({body}): ok, max err "
                f"{_max_err(got, want):.2e}")
            if shape in (main_d, mid_d, long_d):
                qt = q[:, :, None]                   # [B, H, 1, D]
                kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
                mask = ((k_pos >= 0) & (k_pos <= q_pos[:, None]))[
                    :, None, None]
                n_bytes, flops = decode_work(*shape, valid,
                                             q.element_size())
                bound, by = _bound_ms(n_bytes, flops, "tf32x3" if body ==
                                      "tf32x3" else dtype)
                t = timings[("decode", shape, dtype)] = dict(
                    ms=_time_ms(lambda: decode_attention(*args, **kw),
                                flush),
                    plain_ms=_time_ms(lambda: decode_attention_ref(
                        *args, **kw), flush),
                    library_ms=_time_ms(
                        lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, attn_mask=mask, enable_gqa=True),
                        flush),
                    bound_ms=bound, bound_by=by, n_split=n_split, body=body)
                if dtype == "float32":
                    # the CUDA-core body beside it, at its own count
                    core, t["core_n_split"] = _core_at_rule(
                        "flash_decode", args, kw)
                    t["core_ms"] = _time_ms(core, flush)
            del q, k, v, got, want, args
            torch.cuda.synchronize()
    # SWA ring layouts: valid slots wrap around the ring (row 0) or are a
    # prefix (row 1); C = 16 (one tile) through the wrapper and C = 64 over
    # 4 splits forced
    for C, qp, window, force, D in [(16, 20, 10, None, 16),
                                    (64, 100, 40, 4, 128)]:
        ring_pos = [[qp - ((qp - s) % C) for s in range(C)],
                    [s if s < 5 else EMPTY for s in range(C)]]
        for dtype in ("float32", "bfloat16"):
            q, k, v, _, _ = decode_case(2, 12, 2, D, C, [C, C], dtype, gen)
            q_pos = torch.tensor([qp, 4], dtype=torch.int32, device="cuda")
            k_pos = torch.tensor(ring_pos, dtype=torch.int32, device="cuda")
            args, kw = (q, k, v, q_pos, k_pos), dict(window=window)
            if force is None:
                got = decode_attention(*args, **kw)
                n_split = decode_attention.last_n_split
            else:
                got, n_split = _forced("flash_decode", args, kw, force)
            want = decode_attention_ref(*args, **kw)
            _check("flash_decode", got, want, dtype, "ring", dstats)
            _by_body(derr, _decode_body(q.dtype, D, True), dtype, got, want)
            say(f"  flash_decode ring C={C} D={D} window={window} n_split="
                f"{n_split} {dtype}: ok, max err {_max_err(got, want):.2e}")
    # the split count against time: n_split forced, and the default
    split_sweep = {}
    for shape in (main_d, (8, 12, 2, 128, 8192), long_d):
        B, H, Hkv, D, C = shape
        for dtype in ("float32", "bfloat16"):
            args = decode_case(*shape, [C] * B, dtype, gen)
            row = {}
            for force in (1, 2, 4, 8, None):
                if force is None:
                    row["default"] = dict(
                        n_split=_rule("flash_decode", args)[3],
                        ms=_time_ms(lambda: decode_attention(*args), flush))
                    _hold_pin("flash_decode", shape, dtype,
                              row["default"]["n_split"])
                    continue
                n = _forced("flash_decode", args, {}, force)[1]
                row[str(n)] = dict(n_split=n, ms=_time_ms(
                    lambda n=n: _forced("flash_decode", args, {}, n), flush))
            split_sweep[f"{dtype} {shape}"] = row
            say(f"  time flash_decode {shape} {dtype} by n_split: "
                + ", ".join(f"{key} {r['ms']:.4f} ms" if key != "default"
                            else f"default ({r['n_split']}) "
                                 f"{r['ms']:.4f} ms"
                            for key, r in row.items()))
            del args
            torch.cuda.synchronize()

    for (kind, shape, dtype), t in sorted(timings.items(), key=str):
        extra = "".join(f", {key} {t[key]}" for key in ("variant", "n_split",
                                                       "body") if key in t)
        if "core_ms" in t:
            extra += (f", CUDA-core body {t['core_ms']:.4f} ms at n_split "
                      f"{t['core_n_split']}")
        if "simt_ms" in t:
            extra += (f", CUDA-core kernel {t['simt_ms']:.4f} ms (its bound "
                      f"{t['simt_bound_ms']:.4f} ms)")
        say(f"  time {kind} {shape} {dtype}: kernel {t['ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}), plain "
            f"{t['plain_ms']:.4f} ms, sdpa {t['library_ms']:.4f} ms{extra}")
    say("kernels: both hold to their plain versions at every shape "
        f"({fstats['checks']} flash, {dstats['checks']} decode checks); "
        f"flash_decode's worst max err by body {derr}")
    flash = timings[("flash", main_f, "bfloat16")]
    f32 = {key: timings[("flash", shape, "float32")]
           for key, shape in (("main", main_f), ("long", long_f),
                              ("train", train_f))}
    records = {
        "flash_attention_fwd": dict(
            route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention_fwd_sm90.cu",
            sources={"wgmma": "src/repro_torch/kernels/csrc/"
                              "flash_attention_fwd_sm90.cu",
                     "tf32x3": "src/repro_torch/kernels/csrc/"
                               "flash_attention_fwd_tf32x3.cu",
                     "simt": "src/repro_torch/kernels/csrc/"
                             "flash_attention_fwd.cu"},
            replaces="src/repro/kernels/flash_attention/kernel.py:118",
            max_abs_err=fstats["max_abs_err"], checks=fstats["checks"],
            max_abs_err_by_kernel={f"{name} {dtype}": e for (name, dtype), e
                                   in sorted(kerr.items())},
            **flash,
            float32=f32["main"],
            long=dict(shape=long_f, **timings[("flash", long_f, "bfloat16")]),
            long_float32=f32["long"],
            train_float32=dict(shape=train_f, **f32["train"])),
        # K1's float32 kernel on its own line: the float32 train step's
        # forward (B=8 x 160) first, then the B=32 prefill and the long
        # shape; launches are counted on the float32 paths in main()
        "flash_attention_fwd_tf32x3": dict(
            route="cuda",
            source="src/repro_torch/kernels/csrc/"
                   "flash_attention_fwd_tf32x3.cu",
            replaces="src/repro/kernels/flash_attention/kernel.py:118",
            max_abs_err=kerr[("tf32x3", "float32")],
            simt_max_abs_err=kerr[("simt", "float32")],
            shape=train_f, **f32["train"],
            main=dict(shape=main_f, **f32["main"]),
            long=dict(shape=long_f, **f32["long"])),
        "flash_decode": dict(
            route="cuda",
            source="src/repro_torch/kernels/csrc/flash_decode.cu",
            replaces="src/repro/kernels/decode_attention/kernel.py:90",
            max_abs_err=dstats["max_abs_err"], checks=dstats["checks"],
            max_abs_err_by_body=derr,
            **timings[("decode", main_d, "bfloat16")],
            float32=timings[("decode", main_d, "float32")],
            long=dict(shape=long_d, **timings[("decode", long_d, "bfloat16")]),
            long_float32=timings[("decode", long_d, "float32")],
            mid=dict(shape=mid_d, **timings[("decode", mid_d, "bfloat16")]),
            mid_float32=timings[("decode", mid_d, "float32")],
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


def _hd_wrappers():
    """The two passes of K3 over a head-dim-split cache (counted apart:
    only the head-dim phases and K3's wrapper at D > 256 launch them)."""
    from repro_torch.kernels.decode_attention.ops import (decode_scores,
                                                          decode_softmax_pv)
    return {"decode_scores": decode_scores,
            "decode_softmax_pv": decode_softmax_pv}


def _reset_counts():
    for fn in list(_wrappers().values()) + list(_hd_wrappers().values()):
        fn.launches = 0
        for variant in getattr(fn, "launches_by_variant", {}):
            fn.launches_by_variant[variant] = 0
        getattr(fn, "launches_by_groups", {}).clear()
        getattr(fn, "launches_by_splits", {}).clear()


def _scan_variants():
    """K4's launches by kernel since the last _reset_counts()."""
    return dict(_wrappers()["mlstm_scan"].launches_by_variant)


def _expect_variants(what, want):
    """K1's launches by kernel since the last _reset_counts(), against
    ``want`` (kernels it leaves out: none)."""
    got = dict(_wrappers()["flash_attention_fwd"].launches_by_variant)
    want = {variant: want.get(variant, 0) for variant in got}
    if got != want:
        fail(f"{what}: flash_attention launches by kernel {got}, expected "
             f"{want}")
    say(f"{what}: flash_attention launches by kernel {got}")
    return got


def _read_counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


# K3's and K2's launches by block body on the paths that hold them
# (_expect_decode_bodies), for the kernels line
DECODE_BODIES = {}


def _expect_decode_bodies(what, body):
    """K3's and K2's launches by block body since the last _reset_counts():
    every one on ``body``, the body ``_decode_body`` names for the path's
    dtype and head dim on aligned tensors ("tf32x3" for float32 at D 64 /
    80 / 128, "mma" for bf16 there), none on another.  Kept in
    DECODE_BODIES under ``what``; returns {kernel: launches by body}."""
    got = {}
    for name in ("flash_decode", "paged_flash_decode"):
        fn = _wrappers()[name]
        by = dict(fn.launches_by_variant)
        if by != {b: fn.launches * (b == body) for b in by}:
            fail(f"{what}: {name} launches by body {by}, expected all "
                 f"{fn.launches} on {body}")
        got[name] = by
    DECODE_BODIES[what] = got
    say(f"{what}: K3 / K2 launches by body {got}")
    return got


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


# ------------------------------------------------------------ the autotuner
# the CostDB's kernel names -> the result line's
TUNED_NAMES = {"flash_attention": "flash_attention_fwd",
               "decode_attention": "flash_decode",
               "paged_attention": "paged_flash_decode",
               "ssm_scan": "mlstm_scan"}
AUTOTUNE_DIR = ROOT / "build" / "chip_smoke_autotune"


def _bucket_work(kernel, d, cfg):
    """(bytes, FLOPs) one launch at bucket ``d`` needs (each input read
    and the output written once), as phase 2 counts them."""
    if kernel == "flash_attention":
        return flash_work(d["B"], d["S"], d["S"], d["H"], d["Hkv"], d["D"],
                          True, None, 2)
    if kernel == "decode_attention":
        return decode_work(d["B"], d["H"], d["Hkv"], d["D"], d["C"],
                           [d["C"]] * d["B"], 2)
    if kernel == "paged_attention":
        page = cfg["page_size"]
        return paged_work(d["B"], d["H"], d["Hkv"], d["D"], page,
                          -(-d["C"] // page), [d["C"]] * d["B"], 2)
    return mlstm_work(d["B"], d["S"], d["H"], d["D"], cfg["chunk"], 2)


def autotune_phase():
    """The autotuner on the card: a full ``run_sweep`` of the four kernels,
    H100 measured (every feasible config through its wrapper, CUDA events)
    and H800 / H20 estimated, with the launch counts set to 0 before it
    and read after; each bucket's winner, the builtin default's time and
    the bound; each winner held to the plain version (bf16 at ``_tol``)
    and to the float32 plain version; the CostDB saved, checked by the
    ``validate`` CLI in a subprocess and reloaded; the card's fractions of
    peak beside the analytic H800 factors; the 1.5B plan on 8 H800 + 8 H20
    under ``MeasuredCostModel`` (modelled: its records are estimates); the
    winners loaded into ``kernels.tuning`` and shown in effect on one
    launch per kernel, then cleared; and ``python -m repro_torch.obs
    regress`` over the committed baselines (exit 0) and over a copy with
    one throughput cut by 10% (exit 2).  Returns (summary, per-kernel
    entries for the result line)."""
    import os
    import shutil
    import torch
    from repro_torch.autotune import (CostDB, MeasuredCostModel, SPACES,
                                      bench, card_fractions,
                                      load_tuned_defaults, run_sweep)
    from repro_torch.configs import get_config
    from repro_torch.core.cluster import PROFILES, paper_heterogeneous
    from repro_torch.core.cost_model import ANALYTIC
    from repro_torch.core.model_spec import PAPER_MODELS
    from repro_torch.core.scheduler import schedule
    from repro_torch.kernels import tuning
    from repro_torch.serve.kv_cache import PagedKVCache

    t0 = time.perf_counter()
    card = tuning.current_device_type()
    if card != "H100":
        fail(f"autotune: the card's device type is {card!r}, expected H100")
    lines, trials = [], {}
    _reset_counts()
    db = run_sweep(device_types=[card, "H800", "H20"], log=lines.append,
                   trials=trials)
    torch.cuda.synchronize()
    launches = _read_counts()
    sweep_s = time.perf_counter() - t0
    if min(launches.values()) < 1:
        fail(f"autotune: a kernel was not launched by the sweep: {launches}")
    say(f"autotune: sweep of {sum(len(t) for t in trials.values())} "
        f"configs on the card in {sweep_s:.1f} s, launches {launches}")
    for line in lines:
        say("  " + line)

    cuda = torch.device("cuda")
    entries, stats = {}, {"checks": 0, "max_abs_err": 0.0}
    for kernel, space in SPACES.items():
        name = TUNED_NAMES[kernel]
        default = dict(tuning.BUILTIN_DEFAULTS[kernel]
                       or tuning.COMPILED[kernel][0])
        rows = {}
        for shape in space.buckets():
            d = shape.d
            rec = db.lookup(card, kernel, shape.name)
            tried = trials[(kernel, shape.name)]
            if (rec is None or rec.mode != "device"
                    or len(tried) != rec.configs_tried
                    or rec.configs_tried != len(space.configs())):
                fail(f"autotune {kernel} {shape.name}: record {rec}, "
                     f"{len(tried)} of {len(space.configs())} configs timed")
            win = rec.best_config
            default_s = [t for cfg, t in tried if cfg == default]
            n_bytes, flops = _bucket_work(kernel, d, win)
            bound, by = _bound_ms(n_bytes, flops, "bfloat16")
            ms = rec.time_s * 1e3
            # the winner against the plain version, bf16 and float32
            args = bench.kernel_case(kernel, shape, win, cuda, seed=1)
            got = bench.launch(kernel, win, args)
            want = bench.plain(kernel, win, args)
            tols = MLSTM_TOL if kernel == "ssm_scan" else TOL
            _check(f"autotune {name} {win}", got, want, "bfloat16", shape.name,
                   stats, tols)
            want32 = bench.plain(kernel, win, _widened(args))
            if kernel == "ssm_scan":
                _check(f"autotune {name} {win} vs float32 plain",
                       got.float(), want32, "bfloat16", shape.name, stats,
                       tols)
                excess = None
            else:
                excess = _bf16_excess(got, want32)
                if not excess <= BF16_ROW_TOL:
                    fail(f"autotune {name} {shape.name} {win}: bfloat16 vs "
                         f"float32 plain row excess {excess:.3e} > "
                         f"{BF16_ROW_TOL}")
            del args, got, want, want32
            rows[shape.name] = dict(
                winner=win, ms=ms, default=default,
                default_ms=default_s[0] * 1e3 if default_s else None,
                bound_ms=bound, bound_by=by, share_of_bound=bound / ms,
                configs=len(tried),
                times_ms={" ".join(f"{k}={v}" for k, v in sorted(c.items())):
                          t * 1e3 for c, t in tried},
                bf16_excess=excess)
            say(f"  autotune {name} {shape.name}: winner {win} {ms:.4f} ms, "
                f"default {default} "
                + (f"{default_s[0] * 1e3:.4f} ms" if default_s else "-")
                + f", bound {bound:.4f} ms ({by}), {bound / ms:.3f} of the "
                f"bound; held to plain (bf16 and f32); {CARD['card']}")
        entries[name] = dict(buckets=rows, launches=launches[name])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # persist, check with the CLI, reload
    shutil.rmtree(AUTOTUNE_DIR, ignore_errors=True)
    AUTOTUNE_DIR.mkdir(parents=True)
    path = AUTOTUNE_DIR / "costdb.json"
    db.save(path)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    val = subprocess.run([sys.executable, "-m", "repro_torch.autotune",
                          "validate", str(path)], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    if val.returncode != 0:
        fail(f"autotune validate exited {val.returncode}: {val.stdout}"
             f"{val.stderr}")
    say("autotune: " + val.stdout.strip())
    back = CostDB.load(path)
    if back.to_json() != db.to_json():
        fail("autotune: the reloaded CostDB differs from the saved one")
    say(back.describe())

    # the card's fractions of peak beside the analytic H800 factors, and
    # the 1.5B plan under the measured model (modelled: estimates)
    h800 = PROFILES["H800"]
    fractions = card_fractions(back, card)
    analytic = {"prefill_mfu": ANALYTIC.prefill_mfu(h800),
                "hbm_eff": ANALYTIC.hbm_eff(h800)}
    say(f"autotune: the card's fractions of its own peak (bf16 989 TFLOP/s, "
        f"3.35 TB/s) {fractions}; analytic H800 {analytic}; {CARD['card']}")
    model = MeasuredCostModel(back)
    say(model.efficiency_table())
    spec = PAPER_MODELS["1.5B"]
    cluster = paper_heterogeneous(8, 8)
    plans = {}
    for label, provider in (("measured", model), ("analytic", None)):
        plan = schedule(spec, cluster, cost_provider=provider)
        _check_plan(f"autotune 1.5B {label}", plan, len(cluster.devices))
        plans[label] = dict(
            D_T=len(plan.train_devices), D_I=len(plan.infer_devices),
            gamma=plan.gamma, C_T=plan.cost_train, C_I=plan.cost_infer)
        say(f"autotune: 1.5B on 8 H800 + 8 H20, {label} cost model "
            f"(modelled): {plans[label]}")

    # the winners into the wrappers, shown on one launch each, then cleared
    n = load_tuned_defaults(back)
    tuned = {kernel: tuning.tuned_config(kernel) for kernel in SPACES}
    in_effect = {}
    for kernel, space in SPACES.items():
        want_cfg = back.best_config(card, kernel)
        shape = space.buckets()[0]
        args = bench.kernel_case(kernel, shape, tuned[kernel] or want_cfg,
                                 cuda, seed=2)
        wrapper = _wrappers()[TUNED_NAMES[kernel]]
        out = wrapper(*args)                  # no knob: the tuned table
        torch.cuda.synchronize()
        if kernel in ("decode_attention", "paged_attention"):
            took = wrapper.last_n_split
            expect = space.n_split(shape, want_cfg)
        elif kernel == "ssm_scan":
            took, expect = wrapper.last_chunk, want_cfg["chunk"]
        else:
            took, expect = tuned[kernel], {}   # compile-time tiles only
        if took != expect or not bool(torch.isfinite(out.float()).all()):
            fail(f"autotune: {kernel} launched with {took}, the H100 "
                 f"winner {want_cfg} gives {expect}")
        in_effect[kernel] = dict(winner=want_cfg, launched=took)
    cache = PagedKVCache(get_config(ARCH), max_slots=1, max_len=256,
                         device="cuda")
    if cache.page != tuned["paged_attention"]["page_size"]:
        fail(f"autotune: the paged pool took page {cache.page}, tuned "
             f"{tuned['paged_attention']}")
    del cache
    say(f"autotune: load_tuned_defaults registered {n} tables; in effect on "
        f"the card: {in_effect}, pool page {tuned['paged_attention']}")
    tuning.clear_tuned()
    for kernel in SPACES:
        if tuning.tuned_config(kernel) != tuning.BUILTIN_DEFAULTS[kernel]:
            fail(f"autotune: {kernel} still tuned after clear_tuned()")

    # the regression harness over the committed baselines
    baselines = ROOT / "benchmarks" / "baselines"
    run = AUTOTUNE_DIR / "run"
    shutil.copytree(baselines, run)
    f = run / "BENCH_end_to_end.json"
    payload = json.loads(f.read_text())
    row = payload["rows"][0]
    head, tail = row.split("throughput=", 1)
    num = tail.split()[0]
    payload["rows"][0] = (head + f"throughput={float(num) * 0.9!r}"
                          + tail[len(num):])
    f.write_text(json.dumps(payload))
    regress = {}
    for label, run_dir, want_rc in (("self", baselines, 0), ("cut", run, 2)):
        res = subprocess.run([sys.executable, "-m", "repro_torch.obs",
                              "regress", "--baselines", str(baselines),
                              "--run", str(run_dir)], env=env, cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
        if res.returncode != want_rc:
            fail(f"obs regress ({label}) exited {res.returncode}, expected "
                 f"{want_rc}: {res.stdout[-2000:]}{res.stderr[-2000:]}")
        regress[label] = res.returncode
        say(f"obs regress ({label}): exit {res.returncode}, "
            + res.stdout.strip().splitlines()[-1])
    shutil.rmtree(AUTOTUNE_DIR, ignore_errors=True)
    summary = dict(sweep_s=sweep_s, phase_s=time.perf_counter() - t0,
                   fractions=fractions, analytic_h800=analytic, plans=plans,
                   tuned_in_effect=in_effect, regress=regress,
                   checks=stats["checks"], max_abs_err=stats["max_abs_err"])
    return summary, entries


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
    # float32 weights at D 128: the 3xTF32 kernel
    variants = {"serve.run": _expect_variants(
        "serve.run", {"tf32x3": n_layers})}
    _expect_decode_bodies("serve.run", "tf32x3")
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
    _expect_decode_bodies("generate bf16 B=32", "mma")
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
    _expect_decode_bodies("serve.run --engine paged", "tf32x3")
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
    _expect_decode_bodies("serve.run --engine paged --turns 2", "tf32x3")
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
    _expect_decode_bodies(what, "mma")
    # the engine hands K2 the longest row (at most prompt + 128 slots, two
    # pages): every launch at the pinned count
    by_splits = dict(_wrappers()["paged_flash_decode"].launches_by_splits)
    pinned = PINNED_SPLITS["1.5B paged step"]
    if by_splits != {pinned: counts["paged_flash_decode"]}:
        fail(f"{what}: paged launches by split count {by_splits}, expected "
             f"all {counts['paged_flash_decode']} at {pinned}")
    say(f"{what}: paged launches by split count {by_splits} (pinned "
        f"{pinned})")
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
    the paper's.  Returns (summary, the plan objects for ``sim_phase``:
    {"<arch> <cluster>": {arch, spec, cluster, measured, analytic}} and
    the ``ServingCostModel``)."""
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
    plans = {}
    for arch, where, cluster in cases:
        spec = get_config(arch).spec
        plan = schedule(spec, cluster, cost_provider=model)
        base = schedule(spec, cluster)
        for name, p in (("measured", plan), ("analytic", base)):
            _check_plan(f"{arch} on {where} ({name})", p, len(cluster))
        say(f"schedule {arch} on {where}: measured {line(plan)}; analytic "
            f"{line(base)}; scheduler wall time {plan.wall_time_s * 1e3:.1f} "
            f"ms / {base.wall_time_s * 1e3:.1f} ms (the card's host)")
        plans[f"{arch} {where}"] = dict(arch=arch, spec=spec,
                                         cluster=cluster, measured=plan,
                                         analytic=base)
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
    return summary, dict(plans=plans, model=model)


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


# ------------------------------------------------ simulator, monitor, recovery
FIG3_SIM = dict(n_steps=30, rollouts_per_step=256, eta=4, reward_cost_s=0.5)
SIM_DIR = ROOT / "build" / "chip_smoke_sim_recovery"
SNAP_DIR = ROOT / "build" / "chip_smoke_recovery"


def _check_sim(what, r, n_steps, eta):
    """A simulated run finished its steps with the eta bound held, and its
    ledger conserves: launched = trained + buffered + generating + dropped."""
    held = (r.rollouts_trained + r.rollouts_in_buffer
            + r.rollouts_generating + r.dropped)
    if (r.steps != n_steps or r.max_staleness > eta
            or r.rollouts_launched != held
            or not (math.isfinite(r.throughput_tps) and r.throughput_tps > 0)):
        fail(f"{what}: steps {r.steps}/{n_steps}, max staleness "
             f"{r.max_staleness} (eta {eta}), launched {r.rollouts_launched}"
             f" != trained + buffered + generating + dropped {held}, or "
             f"throughput {r.throughput_tps}")


def _sim_line(r):
    return dict(throughput_tps=r.throughput_tps,
                train_busy_frac=r.train_busy_frac,
                gen_busy_frac=r.gen_busy_frac,
                mean_staleness=r.mean_staleness,
                max_staleness=r.max_staleness, wall_time_s=r.wall_time_s,
                swaps=len(r.swaps), dropped=r.dropped)


def sim_phase(fed):
    """The port's discrete-event simulator (host numpy) over the plans that
    ``schedule_feedback_phase`` built from the card's measurements, at
    ``benchmarks/fig3_end_to_end.py``'s settings (30 steps, 256 rollouts a
    step, eta 4, reward 0.5 s) and the plans' own length profile.  Every
    plan, measured and analytic, runs with ``check_invariants``.  The 1.5B
    heterogeneous measured plan runs four more times: observed (tracer,
    registry, health monitor: the ``SimResult`` equal to the bare run's
    in every field but ``stalls_data``, which the monitor's polls may
    raise, the trace passing ``check_report``); with a file-mode
    ``RecoveryManager`` under ``build/`` and one controller crash (30 steps,
    one recovery, no consumed rollout lost, the restored snapshot at most
    one interval old, and the files a fresh manager reads back); with one
    rollout replica failed and an ``ElasticReplanner`` (at least one swap);
    and ``MultiJobSimulator`` on a 1.5B + 7B pool priced by the card's
    ``ServingCostModel`` (per-job eta, the device ledger conserved).  The
    throughputs are modelled on the scheduler's H800/H20 profiles with the
    H800 rollout prices taken from the card's slot occupancy and g_eff;
    nothing here runs on the card."""
    import shutil
    from repro_torch.core.cluster import paper_heterogeneous
    from repro_torch.core.cost_model import LengthDistribution
    from repro_torch.core.pool import JobSpec, schedule_pool
    from repro_torch.obs import (HealthMonitor, MetricsRegistry, Tracer,
                                 analyze_trace, check_report, log)
    from repro_torch.recovery import RecoveryConfig, RecoveryManager
    from repro_torch.sim import (AsyncRLSimulator, ControllerCrash,
                                 DeviceLedger, ElasticConfig,
                                 ElasticReplanner, FailureInjection,
                                 MultiJobSimulator, MultiSimConfig, SimConfig)

    P = LengthDistribution()          # what schedule() priced the plans with
    eta, n = FIG3_SIM["eta"], FIG3_SIM["n_steps"]
    label = ("modelled on the scheduler's H800/H20 profiles (H800 rollout "
             "prices from the card's EngineReport in the measured plans)")
    summary = dict(modelled=label, runs={})
    t0 = time.perf_counter()
    for key, case in fed["plans"].items():
        for kind in ("measured", "analytic"):
            r = AsyncRLSimulator(case[kind], P, SimConfig(
                **FIG3_SIM, check_invariants=True)).run()
            _check_sim(f"sim {key} ({kind})", r, n, eta)
            summary["runs"][f"{key} {kind}"] = _sim_line(r)
            say(f"sim {key} ({kind} plan), {label}: throughput "
                f"{r.throughput_tps:.1f} tok/s, train busy "
                f"{r.train_busy_frac:.4f}, gen busy {r.gen_busy_frac:.4f}, "
                f"staleness mean {r.mean_staleness:.4f} max "
                f"{r.max_staleness} (eta {eta}), wall {r.wall_time_s:.1f} "
                f"sim-s; launched {r.rollouts_launched} = trained "
                f"{r.rollouts_trained} + buffered {r.rollouts_in_buffer} + "
                f"generating {r.rollouts_generating} + dropped {r.dropped}")

    key = "qwen-distill-1.5b paper_heterogeneous(8, 8)"
    case = fed["plans"][key]
    plan, spec, cluster = case["measured"], case["spec"], case["cluster"]
    bare = AsyncRLSimulator(plan, P, SimConfig(**FIG3_SIM)).run()

    # (a) observed: tracer, registry and monitor change nothing
    tr, mx, mon = Tracer(), MetricsRegistry(), HealthMonitor()
    log.configure(quiet=True)          # the monitor logs each alert
    try:
        seen = AsyncRLSimulator(plan, P, SimConfig(
            **FIG3_SIM, check_invariants=True, trace=tr, metrics=mx,
            monitor=mon)).run()
    finally:
        log.configure()
    # every field but stalls_data, as the reference's tests hold it: a
    # monitor poll runs the trainer probe, which may count a data stall
    diff = [f.name for f in dataclasses.fields(bare)
            if f.name != "stalls_data"
            and getattr(bare, f.name) != getattr(seen, f.name)]
    if diff:
        fail(f"sim {key} observed: SimResult differs from the bare run in "
             f"{diff}")
    report = analyze_trace(tr.to_chrome())
    fails = check_report(report, min_stages=2)
    if fails:
        fail(f"sim {key} observed: check_report: {fails}")
    by_det = {}
    for a in mon.alerts:
        by_det[a.detector] = by_det.get(a.detector, 0) + 1
    stages = {k: dict(utilization=v["utilization"],
                      bubble_fraction=v["bubble_fraction"])
              for k, v in report["stages"].items()}
    summary["observed"] = dict(stages=stages, alerts=by_det, polls=mon.polls,
                               tput_rel_err=report["throughput"]["rel_err"],
                               stalls_data=[bare.stalls_data,
                                            seen.stalls_data])
    say(f"sim {key} observed (tracer, registry, monitor): SimResult equal to "
        f"the bare run in every field but stalls_data ({seen.stalls_data} "
        f"monitored, {bare.stalls_data} bare); check_report passes (trace "
        f"vs ledger "
        f"throughput rel_err {report['throughput']['rel_err']:.2e}); stages "
        + ", ".join(f"{k} util {v['utilization']:.4f}"
                    for k, v in sorted(stages.items()))
        + f"; {mon.polls} polls, alerts {by_det}")

    # (b) file-mode recovery with one controller crash
    shutil.rmtree(SIM_DIR, ignore_errors=True)
    rcfg = RecoveryConfig(interval_s=60.0, restore_latency_s=5.0,
                          directory=str(SIM_DIR))
    mgr = RecoveryManager(rcfg)
    t_crash = round(0.4 * bare.wall_time_s, 1)
    tc0 = time.perf_counter()
    r = AsyncRLSimulator(plan, P, SimConfig(
        **FIG3_SIM, check_invariants=True, recovery=mgr,
        crashes=[ControllerCrash(t_crash)])).run()
    crash_s = time.perf_counter() - tc0
    _check_sim(f"sim {key} crash", r, n, eta)
    if len(r.recoveries) != 1:
        fail(f"sim {key} crash: {len(r.recoveries)} recovery events, "
             "expected 1")
    rv = r.recoveries[0]
    if (rv.lost_consumed != 0 or rv.lost_inflight < 0
            or rv.snapshot_age_s > rcfg.interval_s + 1e-9
            or rv.mttr_s != rcfg.restore_latency_s
            or rv.t_resume != t_crash + rcfg.restore_latency_s):
        fail(f"sim {key} crash: {rv} breaks the bounds (no consumed rollout "
             f"lost, snapshot age <= {rcfg.interval_s} s, MTTR "
             f"{rcfg.restore_latency_s} s)")
    t_disk, _, entries = RecoveryManager(rcfg).latest()
    if float(t_disk) != mgr.last_snapshot_t or len(entries) != len(
            mgr._entries):
        fail(f"sim {key} crash: a fresh manager on {SIM_DIR} reads snapshot "
             f"t={float(t_disk)} with {len(entries)} journal entries, the "
             f"run's last was t={mgr.last_snapshot_t} with "
             f"{len(mgr._entries)}")
    shutil.rmtree(SIM_DIR, ignore_errors=True)
    summary["crash"] = dict(_sim_line(r), **dataclasses.asdict(rv),
                            snapshots=mgr.n_snapshots,
                            journal_entries=mgr.n_journal_entries,
                            host_s=crash_s)
    say(f"sim {key} file-mode recovery, crash at {t_crash} sim-s: 30 steps, "
        f"max staleness {r.max_staleness}, throughput {r.throughput_tps:.1f}"
        f" tok/s ({label}); lost in flight {rv.lost_inflight}, lost "
        f"consumed {rv.lost_consumed}, journal replayed "
        f"{rv.journal_replayed}, snapshot age {rv.snapshot_age_s:.1f} s; "
        f"{mgr.n_snapshots} snapshots and {mgr.n_journal_entries} journal "
        f"entries written under build/ in {crash_s:.2f} s (host); a fresh "
        f"manager reads the last one back")

    # (c) one rollout replica fails; the elastic replanner swaps the plan
    t_fail = round(0.25 * bare.wall_time_s, 1)
    rp = ElasticReplanner(spec, cluster, P, None,
                          ElasticConfig(replan_latency_s=5.0))
    r = AsyncRLSimulator(plan, P, SimConfig(
        **FIG3_SIM, check_invariants=True, replanner=rp,
        failures=[FailureInjection(0, t_fail=t_fail)])).run()
    _check_sim(f"sim {key} elastic", r, n, eta)
    if not r.swaps:
        fail(f"sim {key} elastic: replica 0 failed at {t_fail} sim-s and no "
             "plan swap was committed")
    summary["elastic"] = dict(_sim_line(r), excluded=sorted(rp.excluded))
    say(f"sim {key} elastic, replica 0 failed at {t_fail} sim-s: "
        f"{len(r.swaps)} swap(s) ({r.swaps[0].reason}), throughput "
        f"{r.throughput_tps:.1f} tok/s ({label}), max staleness "
        f"{r.max_staleness}, devices excluded {sorted(rp.excluded)}")

    # (d) two jobs on one pool, priced by the card's serving model
    pool_cluster = paper_heterogeneous(16, 16)
    jobs = [JobSpec("qwen-distill-1.5b", spec),
            JobSpec("qwen-distill-7b", fed["plans"][
                "qwen-distill-7b paper_heterogeneous(8, 8)"]["spec"])]
    pool = schedule_pool(jobs, pool_cluster, cost_provider=fed["model"])
    pool.assert_partition(pool_cluster)
    m = MultiJobSimulator(pool, MultiSimConfig(
        n_steps=n, rollouts_per_step=FIG3_SIM["rollouts_per_step"],
        reward_cost_s=FIG3_SIM["reward_cost_s"], check_invariants=True)).run()
    ledger = DeviceLedger(pool.owner)
    ledger.exclude(m.excluded)
    ledger.apply(m.owner_final, m.wall_time_s)
    if not ledger.conserved:
        fail("sim two-job pool: the device ledger is not conserved")
    summary["pool"] = {}
    for j in jobs:
        jr = m.per_job[j.name]
        _check_sim(f"sim two-job pool {j.name}", jr, n, j.eta)
        summary["pool"][j.name] = _sim_line(jr)
        say(f"sim two-job pool on paper_heterogeneous(16, 16) (card-priced "
            f"ServingCostModel): {j.name} {len(pool.job_devices(j.name))} "
            f"devices, throughput {jr.throughput_tps:.1f} tok/s ({label}), "
            f"max staleness {jr.max_staleness} (eta {j.eta})")
    summary["host_s"] = time.perf_counter() - t0
    say(f"sim phase: {summary['host_s']:.2f} s on the host; the device "
        "ledger is conserved")
    return summary


def _trainer_counts(what, n_layers, steps, decode_steps, counts):
    """The paged trainer: one K1 launch per layer a train step (float32,
    no remat: the recompute backward runs the plain version), one K2
    launch per layer a decode step, and no other."""
    want = {"flash_attention_fwd": n_layers * steps, "flash_decode": 0,
            "paged_flash_decode": n_layers * decode_steps, "mlstm_scan": 0}
    if counts != want or decode_steps < 1:
        fail(f"{what}: kernel launches {counts}, expected {want} ({steps} "
             f"train steps, {decode_steps} decode steps)")
    say(f"{what}: launches flash_attention_fwd={want['flash_attention_fwd']}"
        f" (= {n_layers} per train step x {steps}), paged_flash_decode="
        f"{want['paged_flash_decode']} (= {n_layers} per decode step x "
        f"{decode_steps}), flash_decode=0, mlstm_scan=0")


def monitor_phase():
    """The health monitor and the tracer on the card.  (a) The 1.5B
    ``PagedEngine`` on the published config (bfloat16) runs
    ``paged_serve_phase``'s timed workload (8 tasks x group 8 through 32
    slots, 128 new tokens, greedy) bare and then with a ``HealthMonitor``
    and a ``Tracer``: identical completion ids and identical K1 / K2
    launch counts.  (b) An ``AsyncGRPOTrainer`` with the launcher's setup
    (float32, tokenizer vocab, no remat) at qwen-distill-1.5B's full width
    and depth (28 layers) and ``TrainerConfig``'s defaults (group 4 x 4
    prompts, eta 2), on the paged engine, with a monitor, a tracer and a
    registry, takes a warm-up step (the process's first backward pass)
    and 2 measured steps (exact K1 / K2 launches over the 3).  The
    per-stage utilization and bubble fraction of the measured steps'
    trace, the monitor's alerts and the registry's summary are printed;
    ``check_report(min_stages=2)`` must pass.  Then it produces one more
    batch, a file-mode ``RecoveryManager`` snapshots its params, AdamW
    moments and buffered rollouts under ``build/`` (about 15 GiB), and it
    takes a fourth step.
    Returns (summary, what ``recovery_phase`` needs)."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.ckpt.checkpoint import trainer_state
    from repro_torch.configs import get_config
    from repro_torch.data.tasks import MathTaskGenerator, Tokenizer
    from repro_torch.models import transformer
    from repro_torch.obs import (HealthMonitor, MetricsRegistry,
                                 MonitorConfig, Tracer, analyze_trace,
                                 check_report, log, summarize_metrics)
    from repro_torch.optim.adamw import named_leaves
    from repro_torch.recovery import (RecoveryConfig, RecoveryManager,
                                      capture_buffers)
    from repro_torch.rl.async_trainer import AsyncGRPOTrainer, TrainerConfig
    from repro_torch.rl.buffer import JobBuffers
    from repro_torch.rl.rollout import GenConfig
    from repro_torch.rl.weight_sync import WeightStore
    from repro_torch.serve import PagedEngine, ServeConfig

    t_phase = time.perf_counter()
    cfg = get_config(ARCH)
    store = WeightStore()
    store.publish(transformer.init(0, cfg, "cuda"))
    tasks = MathTaskGenerator(seed=0).batch(8)
    plen = max(len(t.prompt_ids) for t in tasks)

    def serve(**kw):
        engine = PagedEngine(cfg, store,
                             GenConfig(max_new_tokens=128, greedy=True),
                             ServeConfig(max_slots=32, max_len=plen + 128),
                             device="cuda", **kw)
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        rollouts, m = engine.generate_groups(tasks, 8)
        dt = time.perf_counter() - t0
        return rollouts, m, _read_counts(), dt

    what = "monitored generate_groups bf16 8 tasks x 8 slots=32"
    bare, bm, bcounts, bdt = serve()
    _expect_paged_counts(f"{what} (bare)", cfg.n_layers, bm["decode_steps"],
                         bcounts)
    _expect_decode_bodies(f"{what} (bare)", "mma")
    tr, mon = Tracer(meta={"phase": "monitor"}), HealthMonitor()
    seen, sm, scounts, sdt = serve(monitor=mon, tracer=tr)
    if [r.completion_ids for r in seen] != [r.completion_ids for r in bare]:
        fail(f"{what}: completion ids differ with a monitor and a tracer")
    if scounts != bcounts:
        fail(f"{what}: launches {scounts} with a monitor and a tracer, "
             f"{bcounts} bare")
    if not {"decode", "prefill"} <= set(mon._stages) or tr.open_spans():
        fail(f"{what}: the monitor saw stages {sorted(mon._stages)} and the "
             f"tracer left {tr.open_spans()} open")
    log.configure(quiet=True)
    try:
        serve_alerts = [a.to_dict() for a in mon.poll(mon.now())]
    finally:
        log.configure()
    n_tok = sum(len(r.completion_ids) for r in seen)
    engine_spans = {}
    for name, _, dur, _ in tr.spans("engine"):
        engine_spans[name] = engine_spans.get(name, 0.0) + dur
    say(f"{what}: {len(seen)} completions identical to the bare run's, "
        f"launches identical ({scounts}); {n_tok} tokens in {sdt:.3f} s "
        f"monitored vs {bdt:.3f} s bare (host clock); {tr.n_events} trace "
        f"events, engine spans s "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(engine_spans.items()))
        + f"; alerts {[(a['detector'], a['key']) for a in serve_alerts]}")
    del store
    torch.cuda.empty_cache()

    # (b) the monitored trainer
    tcfg = cfg.replace(vocab=Tokenizer().vocab_size, dtype="float32",
                       remat=False)
    tr, mx = Tracer(meta={"phase": "monitor", "arch": tcfg.name}), \
        MetricsRegistry()
    mon = HealthMonitor(MonitorConfig(poll_interval_s=0.5), tracer=tr)
    tc = TrainerConfig(engine="paged", trace=tr, metrics=mx, monitor=mon)
    eta = tc.staleness.eta
    trainer = AsyncGRPOTrainer(tcfg, tc, device="cuda")
    steps0 = trainer.engine.stats.decode_steps
    _reset_counts()
    log.configure(quiet=True)              # the monitor logs each alert
    try:
        trainer.run(1, verbose=False)      # warm-up: first backward pass
        torch.cuda.synchronize()
        t_cut = tr.now()
        trainer.run(2, verbose=False)      # the measured steps
        torch.cuda.synchronize()
        mon.poll(mon.now())
    finally:
        log.configure()
    counts = _read_counts()
    decode_steps = trainer.engine.stats.decode_steps - steps0
    _trainer_counts("monitored trainer (1 + 2 steps)", tcfg.n_layers, 3,
                    decode_steps, counts)
    _expect_decode_bodies("monitored trainer (1 + 2 steps)", "tf32x3")
    k1_variants = _expect_variants("monitored trainer (1 + 2 steps)",
                                   {"tf32x3": tcfg.n_layers * 3})
    hist = list(trainer.history)
    if len(hist) != 3 or any(not math.isfinite(h["loss"]) for h in hist) \
            or max(h["max_staleness"] for h in hist) > eta:
        fail(f"monitored trainer: history {hist}")
    doc = tr.to_chrome()
    warm = [(e["name"], e["dur"] / 1e6) for e in doc["traceEvents"]
            if e["ph"] == "X" and e["ts"] < t_cut * 1e6
            and e["name"] in ("produce", "train_step")]
    # the measured window: the events from the second step on
    report = analyze_trace(dict(doc, traceEvents=[
        e for e in doc["traceEvents"]
        if e["ph"] == "M" or e["ts"] >= t_cut * 1e6]))
    fails = check_report(report, min_stages=2)
    if fails:
        fail(f"monitored trainer: check_report: {fails}")
    stages = {k: dict(utilization=v["utilization"],
                      bubble_fraction=v["bubble_fraction"],
                      busy_s=v["busy_s"], spans=v["spans"])
              for k, v in report["stages"].items()}
    for k in ("generation", "train"):
        if k not in stages:
            fail(f"monitored trainer: no {k} stage in the trace: {stages}")
    alerts = [a.to_dict() for a in mon.alerts]
    metrics = summarize_metrics(mx.snapshot())
    say(f"monitored trainer ({tcfg.name} full width and depth, "
        f"{tcfg.n_layers} layers, float32, group {tc.group_size} x "
        f"{tc.prompts_per_step} prompts, eta {eta}, paged engine, on the "
        f"card), warm-up step spans "
        + ", ".join(f"{n} {d:.3f} s" for n, d in warm)
        + f"; steps 2-3 measured: wall {report['wall_s']:.3f} s; "
        + "; ".join(f"{k} utilization {v['utilization']:.4f} bubble "
                    f"fraction {v['bubble_fraction']:.4f} ({v['spans']} "
                    f"spans, {v['busy_s']:.3f} s)"
                    for k, v in sorted(stages.items()))
        + f"; {mon.polls} polls, alerts "
        + str([(a["detector"], a["key"], a["severity"]) for a in alerts]))
    say("monitored trainer metrics " + json.dumps(metrics))

    # a batch waits in the buffer, then everything is snapshotted (after
    # the measured window, so its seconds stay out of the bubbles)
    trainer.produce()
    bufs = JobBuffers()
    bufs._bufs["trainer"] = trainer.buffer
    shutil.rmtree(SNAP_DIR, ignore_errors=True)
    rcfg = RecoveryConfig(interval_s=600.0, directory=str(SNAP_DIR))
    t0 = time.perf_counter()
    RecoveryManager(rcfg, monitor=mon).snapshot(mon.now(), {
        "trainer": trainer_state(trainer.params, trainer.opt_state,
                                 trainer.store.version),
        "buffers": capture_buffers(bufs)})
    snap_s = time.perf_counter() - t0
    pushed = mx.counter("buffer/pushed").value
    # the snapshotted state, kept on the card (15 GiB; the host would
    # need a second copy) to hold the restore to
    want = {
        "params": {k: p.detach().clone()
                   for k, p in named_leaves(trainer.params)},
        "m": {k: t.clone() for k, t in trainer.opt_state["m"].items()},
        "v": {k: t.clone() for k, t in trainer.opt_state["v"].items()},
        "count": trainer.opt_state["count"],
        "version": trainer.store.version,
        "rollouts": [dict(prompt_ids=list(r.prompt_ids),
                          completion_ids=list(r.completion_ids),
                          behavior_logp=np.array(r.behavior_logp),
                          version=r.version, group_id=r.group_id,
                          reward=r.reward, plan_epoch=r.plan_epoch)
                     for r in trainer.buffer._items],
        # every launched rollout was pushed: produce() is synchronous
        "launched": int(pushed),
        "consumed": int(mx.counter("buffer/consumed").value),
        "dropped": trainer.buffer.dropped,
        "in_flight": trainer.buffer.ctl.in_flight}
    size = sum(f.stat().st_size for f in SNAP_DIR.rglob("*") if f.is_file())
    log.configure(quiet=True)
    try:
        trainer.run(1, verbose=False)     # step 4 moves off the snapshot
    finally:
        log.configure()
    say(f"monitored trainer snapshot after step 3 (params, AdamW moments, "
        f"{len(want['rollouts'])} buffered rollouts): {size / 2 ** 30:.3f} "
        f"GiB under build/ in {snap_s:.2f} s; step 4 loss "
        f"{trainer.history[-1]['loss']:.5f}")
    summary = dict(
        serve=dict(completions=len(seen), tokens=n_tok, bare_s=bdt,
                   monitored_s=sdt, trace_events=tr.n_events,
                   alerts=serve_alerts),
        launches={k: scounts[k] + counts[k] for k in counts},
        trainer_k1_by_variant=k1_variants,
        trainer=dict(layers=tcfg.n_layers, group_size=tc.group_size,
                     prompts_per_step=tc.prompts_per_step,
                     measured_steps=2, warmup_spans_s=warm,
                     wall_s=report["wall_s"],
                     stages=stages, alerts=alerts, polls=mon.polls,
                     metrics=metrics, losses=[h["loss"] for h in hist],
                     snapshot_s=snap_s, snapshot_gib=size / 2 ** 30),
        seconds=time.perf_counter() - t_phase)
    del trainer
    torch.cuda.empty_cache()
    return summary, dict(cfg=tcfg, tc=tc, rcfg=rcfg, want=want)


def recovery_phase(snap):
    """Crash recovery on the card.  A new ``RecoveryManager`` on the
    monitored trainer's snapshot directory reads the snapshot back
    (``latest()``) and restores it into a fresh trainer on the card (another
    seed): every parameter and AdamW moment equal to the snapshot bit for
    bit, the step count and version too; the buffered rollouts come back
    through ``restore_buffers`` with the fields the GRPO step and the eta
    bound read (tokens, behaviour log-probs bit for bit, version, group,
    reward, plan epoch) equal and pass ``verify_restored``.  Then the
    1.5B ``PagedEngine`` (bfloat16, published config) serves 8 prompts
    through 4 slots in prefill chunks of 8, once straight through and once
    ``quiesce``d twice mid-run: the same tokens, with K2 launched."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.ckpt.checkpoint import load_trainer_state
    from repro_torch.configs import get_config
    from repro_torch.data.tasks import MathTaskGenerator
    from repro_torch.models import transformer
    from repro_torch.optim.adamw import named_leaves
    from repro_torch.recovery import (RecoveryManager, restore_buffers,
                                      verify_restored)
    from repro_torch.rl.async_trainer import AsyncGRPOTrainer
    from repro_torch.rl.rollout import GenConfig
    from repro_torch.rl.weight_sync import WeightStore
    from repro_torch.serve import PagedEngine, ServeConfig

    t_phase = time.perf_counter()
    want = snap["want"]
    t0 = time.perf_counter()
    _, state, entries = RecoveryManager(snap["rcfg"]).latest()
    read_s = time.perf_counter() - t0
    fresh = AsyncGRPOTrainer(snap["cfg"], dataclasses.replace(
        snap["tc"], seed=1, trace=None, metrics=None, monitor=None),
        device="cuda")
    if all(torch.equal(p, want["params"][k])
           for k, p in named_leaves(fresh.params)):
        fail("recovery: a fresh trainer already equals the snapshot; the "
             "comparison would prove nothing")
    t0 = time.perf_counter()
    load_trainer_state(state["trainer"], fresh.params, fresh.opt_state)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    n = 0
    for k, p in named_leaves(fresh.params):
        for got, exp in ((p, want["params"][k]),
                         (fresh.opt_state["m"][k], want["m"][k]),
                         (fresh.opt_state["v"][k], want["v"][k])):
            if got.device.type != "cuda" or not torch.equal(got, exp):
                fail(f"recovery: {k} differs from the snapshot after the "
                     "restore")
            n += 1
    version = int(state["trainer"]["version"])
    if (fresh.opt_state["count"], version) != (want["count"],
                                               want["version"]):
        fail(f"recovery: count {fresh.opt_state['count']} / "
             f"{want['count']}, version {version} / {want['version']}")
    shutil.rmtree(SNAP_DIR, ignore_errors=True)   # 15 GiB of snapshot
    bufs = restore_buffers(state["buffers"])
    got = bufs["trainer"]._items
    if len(got) != len(want["rollouts"]) or not got:
        fail(f"recovery: {len(got)} restored rollouts, "
             f"{len(want['rollouts'])} snapshotted")
    for i, (r, w) in enumerate(zip(got, want["rollouts"])):
        logp = np.asarray(r.behavior_logp)
        if ([int(t) for t in r.prompt_ids] != w["prompt_ids"]
                or [int(t) for t in r.completion_ids] != w["completion_ids"]
                or logp.dtype != w["behavior_logp"].dtype
                or not np.array_equal(logp, w["behavior_logp"])
                or (int(r.version), int(r.group_id), int(r.plan_epoch))
                != (w["version"], w["group_id"], w["plan_epoch"])
                or float(r.reward) != w["reward"]):
            fail(f"recovery: restored rollout {i} differs from the "
                 "snapshotted one in its tokens, behaviour log-probs, "
                 "version, group, reward or plan epoch")
    verify_restored(buffers=bufs, counters={"trainer": {
        k: want[k] for k in ("launched", "consumed", "dropped",
                             "in_flight")}})
    say(f"recovery: a fresh manager read the snapshot back in {read_s:.2f} s "
        f"({len(entries)} journal entries) and restored it into a fresh "
        f"trainer on the card in {load_s:.2f} s: {n} tensors (params, m, v),"
        f" count {want['count']} and version {version} bit-exact; "
        f"{len(got)} buffered rollouts restored (tokens, behaviour "
        f"log-probs, version, group, reward, plan epoch equal), "
        f"verify_restored passes")
    for k in ("params", "m", "v"):
        del want[k]                    # 15 GiB on the card
    del fresh, state
    torch.cuda.empty_cache()

    cfg = get_config(ARCH)
    store = WeightStore()
    store.publish(transformer.init(0, cfg, "cuda"))
    tasks = MathTaskGenerator(seed=0).batch(8)
    plen = max(len(t.prompt_ids) for t in tasks)

    def engine():
        return PagedEngine(cfg, store, GenConfig(max_new_tokens=32,
                                                 greedy=True),
                           ServeConfig(max_slots=4, max_len=plen + 32,
                                       prefill_chunk=8), device="cuda")

    straight = engine()
    _reset_counts()
    straight.submit(tasks)
    straight.drain()
    plain_run, _ = straight.collect()
    straight_counts = _read_counts()
    quiet = engine()
    _reset_counts()
    quiet.submit(tasks)
    quiet.step()
    mid = [r.state for r in quiet._active.values()]
    q1 = quiet.quiesce()
    if not any(s in ("PREFILL", "FORK") for s in mid) or q1 < 1 or any(
            r.state != "DECODE" for r in quiet._active.values()):
        fail(f"recovery quiesce: states {mid} before, {q1} drain steps, "
             "expected a request mid-prefill and none after")
    # run on until a later prompt is admitted and caught mid-prefill
    for _ in range(1000):
        if not quiet.step() or any(r.state in ("PREFILL", "FORK")
                                   for r in quiet._active.values()):
            break
    q2 = quiet.quiesce()
    if q2 < 1:
        fail("recovery quiesce: no later request was caught mid-prefill "
             "for the second quiesce()")
    quiet.drain()
    quiesced, _ = quiet.collect()
    counts = _read_counts()
    if [r.completion_ids for r in quiesced] != [
            r.completion_ids for r in plain_run]:
        fail("recovery quiesce: the quiesced run's tokens differ from the "
             "uninterrupted run's")
    if counts["paged_flash_decode"] < 1:
        fail(f"recovery quiesce: launches {counts}, expected K2")
    say(f"recovery quiesce ({ARCH} bf16, 8 prompts through 4 slots, prefill "
        f"chunks of 8): {len(quiesced)} completions identical to the "
        f"uninterrupted run's after quiesce() drained {q1} and {q2} steps; "
        f"launches paged_flash_decode {counts['paged_flash_decode']} "
        f"(uninterrupted {straight_counts['paged_flash_decode']})")
    del straight, quiet, store
    torch.cuda.empty_cache()
    return dict(tensors=n, read_s=read_s, load_s=load_s,
                rollouts=len(got), quiesce_steps=[q1, q2],
                quiesce_launches=counts,
                straight_launches=straight_counts,
                seconds=time.perf_counter() - t_phase)


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
    _expect_decode_bodies(what, "mma")
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
    _expect_decode_bodies(what, "mma")
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
    Returns {arch: (launch counts, summary, K4's and K1's launches by
    kernel)}."""
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
        _expect_decode_bodies(what, "tf32x3")
        if "--schedule" in argv:
            if not out["schedule"]:
                fail(f"{what} --schedule: run() returned no plan")
            _check_plan(f"{what} --schedule", out["plan"], 16)
            say(f"{what} --schedule plan (8 H800 + 8 H20):\n"
                + out["schedule"])
        scan_variants = _scan_variants()
        if scan_variants != {"simt": 0, "mma": 0,
                             "tf32x3": counts["mlstm_scan"]}:
            fail(f"{what}: mlstm_scan launches by kernel {scan_variants}, "
                 "expected every one on the 3xTF32 kernel (float32, D 512)")
        # float32 at D 128: every K1 launch on the 3xTF32 kernel
        flash_variants = _expect_variants(
            what, {"tf32x3": counts["flash_attention_fwd"]})
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
        results[arch] = (counts, summary, scan_variants, flash_variants)
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
        want_variants = {"simt": 0, "mma": want["mlstm_scan"], "tf32x3": 0}
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
    # the float32 step from the same weights: K1 on the 3xTF32 kernel
    p32.requires_grad_(True)
    _reset_counts()
    _, _, m = make_train_step(cfg32, opt)(p32, adamw_init(p32, opt), batch)
    loss32, gnorm32 = float(m["loss"]), float(m["grad_norm"])
    f32_variants = _expect_variants("qwen f32 train step",
                                    {"tf32x3": 2 * cfg.n_layers})
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
                                    {"wgmma": 2 * cfg.n_layers})
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
               f32_launches_by_variant=f32_variants,
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


PARALLEL_ARCHS = ("qwen-distill-1.5b", "qwen-distill-7b", "qwen-distill-14b")
ROOFLINE_STEP = r"""
import json
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import roofline as rf
from repro_torch.launch.dryrun import count_program
from repro_torch.launch.mesh import make_fake_mesh
cfg = get_config("qwen-distill-1.5b")
mesh = make_fake_mesh((1, 1), ("data", "model"))
cost, coll, comm, _, ext = count_program(
    cfg, ShapeSpec("chip_step", "train", 160, 8), mesh)
print(json.dumps(dict(flops=cost["flops"], bytes=cost["bytes accessed"],
                      counts=coll["counts"], extrapolated=ext,
                      t_compute_ms=cost["flops"] / rf.PEAK_FLOPS * 1e3,
                      t_memory_ms=cost["bytes accessed"] / rf.HBM_BW * 1e3)))
"""


def _dryrun_cells():
    """The meta-device dry-run (``python -m repro_torch.launch.dryrun``) of
    qwen-distill-1.5B / 7B / 14B x train_4k / decode_32k x single / multi
    pod, each cell a subprocess on the card's host (no GPU), up to eight
    at a time, plus the dry-run count of the sharded step below at mesh
    (1, 1).  Every cell must be ``ok`` with collectives > 0."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out_dir = ROOT / "experiments" / "dryrun_torch"
    logs = ROOT / "build" / "chip_smoke_dryrun"
    logs.mkdir(parents=True, exist_ok=True)
    cells = [(a, s, m) for a in PARALLEL_ARCHS
             for s in ("train_4k", "decode_32k") for m in ("single", "multi")]
    jobs = [("step_1x1", [sys.executable, "-c", ROOFLINE_STEP])] + [
        ("__".join(c), [sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", c[0], "--shape", c[1], "--mesh", c[2],
                        "--quiet"]) for c in cells]
    for a, s, m in cells:
        (out_dir / f"{a}__{s}__{m}.json").unlink(missing_ok=True)
    workers = min(8, os.cpu_count() or 1)

    def run(job):
        name, cmd = job
        t = time.perf_counter()
        with open(logs / f"{name}.log", "w") as log:
            try:
                rc = subprocess.run(cmd, env=env, cwd=ROOT, stdout=log,
                                    stderr=subprocess.STDOUT,
                                    timeout=400).returncode
            except subprocess.TimeoutExpired:
                rc = "timeout (400 s)"
        return name, (rc, time.perf_counter() - t)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=workers) as pool:
        done = dict(pool.map(run, jobs))
    wall = time.perf_counter() - t0
    for name, (rc, _) in done.items():
        if rc != 0:
            fail(f"dry-run {name}: exit {rc}; "
                 f"{(logs / (name + '.log')).read_text()[-2000:]}")
    step = json.loads((logs / "step_1x1.log").read_text().strip()
                      .splitlines()[-1])
    results = {}
    for a, s, m in cells:
        r = json.loads((out_dir / f"{a}__{s}__{m}.json").read_text())
        roof = r["roofline"]
        n_coll = sum(roof["counts"].values())
        if r["status"] != "ok" or n_coll < 1:
            fail(f"dry-run {a} {s} {m}: status {r['status']}, "
                 f"{n_coll} collectives")
        arg_gb = r["memory_analysis"]["argument_bytes"] / 1e9
        results[f"{a}/{s}/{m}"] = dict(
            t_compute=roof["t_compute"], t_memory=roof["t_memory"],
            t_collective=roof["t_collective"],
            bottleneck=roof["bottleneck"], collectives=roof["counts"],
            argument_gb=arg_gb, wall_s=done["__".join((a, s, m))][1])
        say(f"dry-run {a} {s} {m} ({r['n_devices']} ranks): ok, roofline "
            f"(modelled, H100 SXM data sheet) compute {roof['t_compute']:.4g}"
            f" s, memory {roof['t_memory']:.4g} s, collective "
            f"{roof['t_collective']:.4g} s -> {roof['bottleneck']}; "
            f"collectives {roof['counts']}; largest rank's arguments "
            f"{arg_gb:.2f} GB (of 80 GB)")
    rep = subprocess.run([sys.executable, "-m", "repro_torch.launch.report"],
                         env=env, cwd=ROOT, capture_output=True, text=True)
    if rep.returncode != 0:
        fail(f"launch.report: exit {rep.returncode}: {rep.stderr[-2000:]}")
    say(rep.stdout)
    say(f"dry-run: {len(cells)} cells and the step count in {wall:.1f} s "
        f"({workers} subprocesses at a time, on the "
        "host's cores)")
    return results, step


def _bf16_qwen(cfg):
    """qwen-distill-1.5b's published config in bfloat16 from seed 0 (the
    same weights on every call)."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.models.params import Params, tree_map
    p32 = transformer.init(0, cfg.replace(dtype="float32"), "cuda")
    return Params(tree_map(lambda t: t.to(torch.bfloat16), p32))


def _place_train(cfg, params, batch, mesh, opt):
    """Params (``param_pspecs(fsdp=True)``), AdamW state
    (``opt_state_pspecs``) and batch (``batch_pspecs``) as DTensors."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.parallel import sharding as shd
    dp = shd.distribute(params, shd.param_pspecs(params, cfg, mesh,
                                                 fsdp=True), mesh)
    dp.requires_grad_(True)
    o_spec = shd.flat(shd.opt_state_pspecs(params, cfg, mesh))
    st = adamw_init(params, opt)
    state = {k: {n: distribute_tensor(v, mesh, shd.placements(o_spec[n],
                                                               mesh))
                 for n, v in st[k].items()} for k in ("m", "v")}
    state["count"] = 0
    b_spec = shd.batch_pspecs(batch, mesh)
    db = {k: distribute_tensor(v, mesh, shd.placements(b_spec[k], mesh))
          for k, v in batch.items()}
    return dp, state, db


def _timed_steps(what, step, params, state, batch, n_layers, full):
    """A warm-up step, two timed steps and a profiled one; each must launch
    K1 2 x n_layers times, all on the tensor-core kernel.  Returns the
    first step's loss and grad norm, the host-clock times, the profile and
    the K1 launches counted over the three steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    times, first, launches = [], None, 0
    for i in range(3):
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, m = step(params, state, batch)
        loss, gnorm = float(full(m["loss"])), float(full(m["grad_norm"]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        first = first or (loss, gnorm)
        counts = _read_counts()
        launches += counts["flash_attention_fwd"]
        want = {"flash_attention_fwd": 2 * n_layers, "flash_decode": 0,
                "paged_flash_decode": 0, "mlstm_scan": 0}
        if counts != want or not (math.isfinite(loss)
                                  and math.isfinite(gnorm)):
            fail(f"{what} step {i + 1}: launches {counts} (expected {want}),"
                 f" loss {loss}, grad_norm {gnorm}")
        _expect_variants(f"{what} step {i + 1}",
                         {"simt": 0, "wgmma": 2 * n_layers})
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(params, state, batch)
        torch.cuda.synchronize()
    kernels = _trace_kernels(prof, what.replace(" ", "_"))
    if not kernels:
        fail(f"{what}: the profiler trace holds no kernel")
    prof_out = _busy(kernels, kernels[0][0], 1)
    return first, times, prof_out, launches


def _grads(cfg, params, batch):
    """The GRPO loss's gradients at ``params`` (plain tensors), by name."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.optim.adamw import named_leaves
    from repro_torch.rl.grpo import grpo_loss
    leaves = list(named_leaves(params))
    with torch.enable_grad():
        for _, p in leaves:
            p.requires_grad_(True)
        logits = transformer.forward(params, cfg, batch["tokens"])
        loss, _ = grpo_loss(logits, batch["tokens"], batch["behavior_logp"],
                            batch["advantages"], batch["loss_mask"])
        grads = torch.autograd.grad(loss, [p for _, p in leaves])
    return {name: g for (name, _), g in zip(leaves, grads)}


def _ctx_split_check(B, C):
    """K3 on the path of a context-split cache (``parallel.local.
    decode_attention`` with ``cache_shard="ctx"``), on one card: the
    1.5B's decode shape (H 12, Hkv 2, D 128, B rows over C slots) cut
    into 2 and 4 runs of the context as ``torch.chunk`` cuts it over
    ranks; each run's K3 launch with its log-sum-exp, merged by
    ``merge_lse``, is held to K3 over the whole cache and to the plain
    version, and the whole cache's lse to the plain version's.  Rows
    attend from 1 to C slots (so a merge meets runs that attend all, some
    or none of a row), and row 0 attends nothing.  Returns the stats."""
    import torch
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref, merge_lse)

    def reduce(x, op):
        return x.amax(0) if op == "max" else x.sum(0)

    gen = torch.Generator(device="cuda").manual_seed(5)
    valid = [0] + [C - (37 * i) % C for i in range(1, B)]
    stats = {"checks": 0, "max_abs_err": 0.0}
    for dtype in ("float32", "bfloat16"):
        q, k, v, qp, kp = decode_case(B, 12, 2, 128, C, valid, dtype, gen)
        shape = (B, 12, 2, 128, C)
        whole, lse = decode_attention(q, k, v, qp, kp, return_lse=True)
        want, want_lse = decode_attention_ref(q, k, v, qp, kp,
                                              return_lse=True)
        _check("flash_decode lse", lse, want_lse, dtype, shape, stats)
        for n in (2, 4):
            runs = zip(*(t.chunk(n, dim=1) for t in (k, v, kp)))
            o, ls = zip(*(decode_attention(q, kr.contiguous(),
                                           vr.contiguous(), qp,
                                           pr.contiguous(), return_lse=True)
                          for kr, vr, pr in runs))
            got = merge_lse(torch.stack(o), torch.stack(ls), reduce)
            _check(f"flash_decode ctx split {n}", got, want, dtype, shape,
                   stats)
            _check(f"flash_decode ctx split {n} vs whole", got, whole,
                   dtype, shape, stats)
    return stats


def _hd_passes(q, k, v, qp, kp, m, window=None, body=None):
    """K3 over a cache split on its head dim into m slices, on one card:
    q, k and v cut on D by ``chunk`` (views, as a model axis of m cuts
    them), pass 1 per slice, the slices' scores summed on the card (in
    place of the all-reduce over ranks), pass 2 per slice, the outputs
    concatenated.  ``body=None`` goes through the wrappers (counted, each
    choosing its body); a pair ``(pass 1's, pass 2's)`` of "ring" / "simt"
    launches those bodies directly (not counted), as ``_simt_flash`` does
    for K1."""
    import torch
    from repro_torch.kernels.decode_attention import ops
    scale = q.shape[-1] ** -0.5
    if body is None:
        s = sum(ops.decode_scores(a, b, scale=scale)
                for a, b in zip(q.chunk(m, -1), k.chunk(m, -1)))
        return torch.cat([ops.decode_softmax_pv(s, c, qp, kp, window=window)
                          for c in v.chunk(m, -1)], -1)
    s = sum(ops._launch_scores(a, b, scale, body[0])
            for a, b in zip(q.chunk(m, -1), k.chunk(m, -1)))
    return torch.cat([ops._launch_softmax_pv(s, c, qp, kp, window,
                                             body[1])[0]
                      for c in v.chunk(m, -1)], -1)


def _hd_bodies(q, k, v, m):
    """Each pass's bodies at m slices of the head dim, the wrapper's
    choice first: the ring (csrc/decode_hd.cu's cp.async rings, where
    16-byte copies fit the slice, in either dtype) and the first design's
    ("simt") everywhere."""
    from repro_torch.kernels.decode_attention import ops
    qs, ks, vs = (x.chunk(m, -1)[0] for x in (q, k, v))
    B, H, Dl = qs.shape
    C, Hkv = k.shape[1], k.shape[2]
    first = ops._scores_variant(qs, ks)
    second = ops._variant(vs.dtype, Dl, (vs,), ops._pv_geometry(
        B, C, H, Hkv, Dl, vs.element_size(), ops._sm_count(vs.device))
        is not None)
    return {name: ("ring", "simt") if choice == "ring" else ("simt",)
            for name, choice in (("decode_scores", first),
                                 ("decode_softmax_pv", second))}


def _hd_bf16_rows(name, got, want32, stats):
    """A bfloat16 output of the head-dim passes against the float32 plain
    version of the same inputs, row by row (``_bf16_excess``): each row
    is held at its own scale, so a long row's small outputs (about
    1/sqrt(slots)) cannot hide under an absolute tolerance."""
    excess = _bf16_excess(got, want32)
    stats["bf16_row_excess"] = max(stats.get("bf16_row_excess", 0.0),
                                   excess)
    if not excess <= BF16_ROW_TOL:
        fail(f"{name} bfloat16: row excess over the float32 plain version "
             f"{excess:.3e} > {BF16_ROW_TOL}")


def _hd_case_check(what, q, k, v, qp, kp, m, window, dtype, shape, stats):
    """One head-dim split of m slices, through the wrappers and, where a
    wrapper takes a ring body, through PR 22's bodies directly, held to
    the plain version and (D <= 256) to K3 over the whole head dim; each
    body of each pass (``_hd_bodies``) on its own held to its plain
    version.  The wrappers must take the ring wherever 16-byte copies fit
    the slice, in either dtype (``launches_by_variant``; every case here
    fits a ring in shared memory).  Pass 1 writes float32 scores from the
    same operands as its plain version, so it is held at the float32
    tolerance in either dtype; in bfloat16, pass 2 and the whole decode are
    also held row by row to the float32 plain version
    (``_hd_bf16_rows``)."""
    from repro_torch.kernels.decode_attention import ops
    s1, s2 = stats
    scale = q.shape[-1] ** -0.5
    bodies = _hd_bodies(q, k, v, m)
    ring = (q.shape[-1] // m * q.element_size()) % 16 == 0
    for n, b in bodies.items():
        if b[0] != ("ring" if ring else "simt"):
            fail(f"{what} m={m} {dtype}: {n} takes the {b[0]} body, expected "
                 f"{'the ring' if ring else 'simt'}")
    want = ops.decode_attention_ref(q, k, v, qp, kp, window=window)
    want32 = (ops.decode_attention_ref(q.float(), k.float(), v.float(), qp,
                                       kp, window=window)
              if dtype == "bfloat16" else None)
    whole = (ops.decode_attention(q, k, v, qp, kp, window=window)
             if q.shape[-1] <= 256 else None)
    before = {n: dict(f.launches_by_variant)
              for n, f in _hd_wrappers().items()}
    runs = [("wrappers", _hd_passes(q, k, v, qp, kp, m, window))]
    for n, f in _hd_wrappers().items():
        added = {b: f.launches_by_variant[b] - before[n][b]
                 for b in ("ring", "simt")}
        if added != {b: m if b == bodies[n][0] else 0 for b in added}:
            fail(f"{what} m={m} {dtype}: {n} launched {added}, expected "
                 f"{m} of the {bodies[n][0]} body")
    if any(len(b) > 1 for b in bodies.values()):
        runs.append(("simt", _hd_passes(q, k, v, qp, kp, m, window,
                                        ("simt", "simt"))))
    s = sum(ops.decode_scores_ref(a, b, scale=scale)
            for a, b in zip(q.chunk(m, -1), k.chunk(m, -1)))
    for body, got in runs:
        name = f"{what} m={m} ({body})"
        _check(name, got, want, dtype, shape, s2)
        if want32 is not None:
            _hd_bf16_rows(name, got, want32, s2)
        if whole is not None:
            _check(f"{name} vs K3 whole", got, whole, dtype, shape, s2)
        empty = ~((kp >= 0) & (kp <= qp[:, None])).any(dim=1)
        if bool(empty.any()) and bool(got[empty].abs().max() != 0):
            fail(f"{name} {dtype}: a row that attends nothing is not 0")
    for body in bodies["decode_scores"]:
        for a, b in zip(q.chunk(m, -1), k.chunk(m, -1)):
            _check(f"decode_scores {what} m={m} ({body})",
                   ops._launch_scores(a, b, scale, body),
                   ops.decode_scores_ref(a, b, scale=scale), dtype, shape,
                   s1, {dtype: TOL["float32"]})
        s1.setdefault("checks_by_body", {}).setdefault(body, 0)
        s1["checks_by_body"][body] += 1
    for body in bodies["decode_softmax_pv"]:
        for c in v.chunk(m, -1):
            o = ops._launch_softmax_pv(s, c, qp, kp, window, body)[0]
            _check(f"decode_softmax_pv {what} m={m} ({body})", o,
                   ops.decode_softmax_pv_ref(s, c, qp, kp, window=window),
                   dtype, shape, s2)
            if dtype == "bfloat16":
                _hd_bf16_rows(f"decode_softmax_pv {what} m={m} ({body})", o,
                              ops.decode_softmax_pv_ref(s, c.float(), qp, kp,
                                                        window=window), s2)
        s2.setdefault("checks_by_body", {}).setdefault(body, 0)
        s2["checks_by_body"][body] += 1


def _hd_launched(fn):
    """``fn()`` and the launches it added to K3 and to each pass."""
    from repro_torch.kernels.decode_attention import ops
    fns = dict(_hd_wrappers(), flash_decode=ops.decode_attention)
    before = {n: f.launches for n, f in fns.items()}
    out = fn()
    return out, {n: f.launches - before[n] for n, f in fns.items()}


def _hd_package_check(what, q, k, v, qp, kp, window, dtype, shape, stats):
    """The package's own head-dim path, ``parallel.local._decode_split_hd``,
    on CUDA tensors over one slice (no groups to all-reduce over): one
    launch of each pass and none of K3, the output in v's dtype and held
    to K3 over the whole head dim."""
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.parallel import local as plocal
    got, added = _hd_launched(lambda: plocal._decode_split_hd(
        q, k, v, qp, kp, window, q.shape[-1] ** -0.5, []))
    if added != dict(decode_scores=1, decode_softmax_pv=1, flash_decode=0):
        fail(f"{what} {dtype}: parallel.local._decode_split_hd launched "
             f"{added}, expected one of each pass and no K3")
    _check(f"{what} parallel.local._decode_split_hd vs K3 whole", got,
           ops.decode_attention(q, k, v, qp, kp, window=window), dtype,
           shape, stats[1])


def _hd_split_check(B, C):
    """The decode of a head-dim-split cache (``parallel.local.
    decode_attention`` under ``cache_shard="hd"``) on one card, at the
    1.5B's decode shape (H 12, Hkv 2, D 128, B rows over C slots): for m
    in 2, 4 and 16 slices (``_hd_passes``) against K3 over the whole head
    dim and the plain version, and each pass against its plain version, in
    float32 and bfloat16; and ``_decode_split_hd`` itself over one slice.
    Rows attend from 0 (row 0) to C slots, spread evenly, so short rows
    sit beside long ones in every launch.  Returns the two passes' stats."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(11)
    valid = [0] + [max(1, C * i // (B - 1)) for i in range(1, B)]
    stats = tuple({"checks": 0, "max_abs_err": 0.0} for _ in range(2))
    for dtype in ("float32", "bfloat16"):
        q, k, v, qp, kp = decode_case(B, 12, 2, 128, C, valid, dtype, gen)
        shape = (B, 12, 2, 128, C)
        for m in (2, 4, 16):
            _hd_case_check("hd split", q, k, v, qp, kp, m, None, dtype,
                           shape, stats)
        _hd_package_check("hd split", q, k, v, qp, kp, None, dtype, shape,
                          stats)
        del q, k, v
    torch.cuda.empty_cache()
    return stats


def _hd_extra_check(stats):
    """The head-dim split's other cases: starcoder2's G = 12 (H 48, Hkv
    4, two head groups), h2o-danube's D 80 over 16 slices (Dl 5) with its
    window of 4096 on a ring past it (and ``_decode_split_hd`` there), each
    with a row that attends nothing; and K3's wrapper at D 384, which runs
    as the two passes over one slice (2 launches, no K3 launch)."""
    import torch
    from repro_torch.kernels.decode_attention import ops
    gen = torch.Generator(device="cuda").manual_seed(12)
    for dtype in ("float32", "bfloat16"):
        q, k, v, qp, kp = decode_case(4, 48, 4, 128, 700, [0, 700, 311, 5],
                                      dtype, gen)
        for m in (2, 4, 16):
            _hd_case_check("hd split G=12", q, k, v, qp, kp, m, None, dtype,
                           (4, 48, 4, 128, 700), stats)
        q, k, v, _, _ = decode_case(4, 32, 8, 80, 4096, [4096] * 4, dtype,
                                    gen)
        qp = torch.tensor([5000, 4100, 9999, 300], dtype=torch.int32,
                          device="cuda")
        kp = _ring_pos(qp.tolist(), 4096)
        kp[3] = EMPTY                            # attends nothing
        _hd_case_check("hd split danube ring", q, k, v, qp, kp, 16, 4096,
                       dtype, (4, 32, 8, 80, 4096), stats)
        _hd_package_check("hd split danube ring", q, k, v, qp, kp, 4096,
                          dtype, (4, 32, 8, 80, 4096), stats)
        q, k, v, qp, kp = decode_case(8, 12, 2, 384, 300,
                                      [0] + [300 - 31 * i for i in range(7)],
                                      dtype, gen)
        got, added = _hd_launched(lambda: ops.decode_attention(q, k, v, qp,
                                                               kp))
        if added != dict(decode_scores=1, decode_softmax_pv=1,
                         flash_decode=0):
            fail(f"decode_attention at D 384: launched {added}")
        for body, out in [("wrappers", got)] + [
                ("simt", _hd_passes(q, k, v, qp, kp, 1, None,
                                    ("simt", "simt")))]:
            _check(f"flash_decode D=384 (two passes, {body})", out,
                   ops.decode_attention_ref(q, k, v, qp, kp), dtype,
                   (8, 12, 2, 384, 300), stats[1])
            if dtype == "bfloat16":
                _hd_bf16_rows(f"flash_decode D=384 (two passes, {body})",
                              out, ops.decode_attention_ref(
                                  q.float(), k.float(), v.float(), qp, kp),
                              stats[1])
        del q, k, v
    torch.cuda.empty_cache()


def _hd_timings(B, C, flush, sweep=False):
    """Each pass over one slice (contiguous, as a rank holds it) at m 2
    and 16: the wrapper's body (the ring), PR 22's body launched directly
    (``simt_ms``), K3 over the whole head dim, the plain versions, one
    ``torch.einsum`` of q . k^T for pass 1 (pass 2 has no single PyTorch
    call), the bound and each body's achieved GB/s (the bound's bytes over
    its time); all rows attend all C slots.  ``sweep`` also times the ring
    pass 2 with its split count forced (``_launch_softmax_pv``'s
    ``n_split``).  The
    records hold only what this run measured and the bounds; the scores'
    size is read from the tensor, and the all-reduce's wire bytes
    (modelled: no all-reduce runs here) are only printed."""
    import torch
    from repro_torch.kernels.decode_attention import ops
    gen = torch.Generator(device="cuda").manual_seed(13)
    H, Hkv, D = 12, 2, 128
    out = {}
    for dtype in ("bfloat16", "float32"):
        q, k, v, qp, kp = decode_case(B, H, Hkv, D, C, [C] * B, dtype, gen)
        es = q.element_size()
        n_bytes, flops = decode_work(B, H, Hkv, D, C, [C] * B, es)
        bound, by = _bound_ms(n_bytes, flops, dtype)
        row = {"K3_whole": dict(
            ms=_time_ms(lambda: ops.decode_attention(q, k, v, qp, kp), flush),
            bound_ms=bound, bound_by=by)}
        for m in (2, 16):
            Dl = D // m
            qs, ks, vs = (x[..., :Dl].contiguous() for x in (q, k, v))
            qg = qs.reshape(B, Hkv, H // Hkv, Dl)
            s = ops.decode_scores(qs, ks, scale=D ** -0.5)
            b1 = es * (B * H * Dl + B * C * Hkv * Dl) + 4 * B * H * C
            b2 = (4 * B * H * C + es * (B * C * Hkv * Dl + B * H * Dl)
                  + 4 * B * (1 + C))
            fl = 2.0 * B * H * C * Dl
            t1, by1 = _bound_ms(b1, fl, dtype)
            t2, by2 = _bound_ms(b2, fl, dtype)
            scores_bytes = s.numel() * s.element_size()
            variant = {n: b[0] for n, b in _hd_bodies(qs, ks, vs, 1).items()}
            r1 = dict(
                variant=variant["decode_scores"],
                ms=_time_ms(lambda: ops.decode_scores(
                    qs, ks, scale=D ** -0.5), flush),
                simt_ms=_time_ms(lambda: ops._launch_scores(
                    qs, ks, D ** -0.5, "simt"), flush),
                plain_ms=_time_ms(lambda: ops.decode_scores_ref(
                    qs, ks, scale=D ** -0.5), flush),
                library_ms=_time_ms(lambda: torch.einsum(
                    "bhgd,bchd->bhgc", qg, ks), flush),
                bound_ms=t1, bound_by=by1, n_split=None)
            r2 = dict(
                variant=variant["decode_softmax_pv"],
                ms=_time_ms(lambda: ops.decode_softmax_pv(
                    s, vs, qp, kp), flush),
                simt_ms=_time_ms(lambda: ops._launch_softmax_pv(
                    s, vs, qp, kp, None, "simt"), flush),
                plain_ms=_time_ms(lambda: ops.decode_softmax_pv_ref(
                    s, vs, qp, kp), flush),
                library_ms=None, bound_ms=t2, bound_by=by2,
                n_split=ops.decode_softmax_pv.last_n_split,
                simt_n_split=ops._launch_softmax_pv(s, vs, qp, kp, None,
                                                    "simt")[1])
            for r, nb in ((r1, b1), (r2, b2)):
                r["gbps"] = nb / r["ms"] / 1e6
                r["simt_gbps"] = nb / r["simt_ms"] / 1e6
            row[f"m{m}"] = dict(Dl=Dl, decode_scores=r1, decode_softmax_pv=r2)
            if sweep:
                # pass 2's body at each count, through its launcher (at
                # most the tiles of its rows)
                tile = (ops._pv_geometry(B, C, H, Hkv, Dl, es, ops._sm_count(
                    vs.device))["tile"] if r2["variant"] == "ring"
                        else ops.PV_TILE)
                split_ms = {}
                for force in (1, 2, 3, 4, 6, 8, 12, 16):
                    n = min(force, -(-C // tile))
                    split_ms[n] = _time_ms(
                        lambda n=n: ops._launch_softmax_pv(
                            s, vs, qp, kp, None, r2["variant"], n), flush)
                r2["split_sweep"] = split_ms
                say(f"  time decode_softmax_pv ({r2['variant']}) B={B} C={C} "
                    f"{dtype} m={m} by n_split: " + ", ".join(
                        f"{n} {ms:.4f} ms" for n, ms in split_ms.items()))
            del qs, ks, vs, qg, s
        out[dtype] = row
        k1 = row["K3_whole"]
        say(f"  time K3 over a head-dim split B={B} C={C} {dtype}: K3 whole "
            f"{k1['ms']:.4f} ms (bound {k1['bound_ms']:.4f}); " + "; ".join(
                f"m={m}: " + ", ".join(
                    f"{name} {r['variant']} {r['ms']:.4f} ms "
                    f"({r['gbps']:.0f} GB/s), PR 22's body "
                    f"{r['simt_ms']:.4f} ms ({r['simt_gbps']:.0f} GB/s) "
                    f"(bound {r['bound_ms']:.4f} {r['bound_by']}, plain "
                    f"{r['plain_ms']:.4f}"
                    + (f", einsum {r['library_ms']:.4f}"
                       if r["library_ms"] is not None else "")
                    + (f", n_split {r['n_split']} / {r['simt_n_split']}"
                       if r["n_split"] else "")
                    + ")"
                    for name, r in ((n, row[f"m{m}"][n]) for n in
                                    ("decode_scores", "decode_softmax_pv")))
                for m in (2, 16))
            + f"; scores tensor {scores_bytes / 1e6:.2f} MB a layer (its "
            f"numel x element size); modelled, not run here: a ring "
            f"all-reduce of it sends 2(m-1)/m of that per rank, " + ", ".join(
                f"m={m} {2 * (m - 1) / m * scores_bytes / 1e6:.2f} MB"
                for m in (2, 16)) + f"; {CARD['card']}")
        del q, k, v
        torch.cuda.empty_cache()
    return out


MUTANT_DIR = ROOT / "build" / "chip_smoke_mutant"
MUTANT_MARK = "// every split's partial"
MUTANT = {}        # the mutant's nvcc process and library, from setup()


def _start_mutant_build():
    """Start nvcc (in the background, beside ``build_all``) on a copy of
    ``csrc`` whose ring pass 2 merges every split but the last: the line
    of ``decode_hd.cu`` marked ``MUTANT_MARK`` loops ``sp < n_split - 1``.
    ``_hd_mutation_check`` runs it."""
    import shutil
    from repro_torch.kernels import _build
    shutil.rmtree(MUTANT_DIR, ignore_errors=True)
    MUTANT_DIR.mkdir(parents=True)
    for path in list(_build.CSRC.glob("*.cu")) + list(_build.CSRC.glob(
            "*.cuh")):
        shutil.copy(path, MUTANT_DIR / path.name)
    cu = MUTANT_DIR / "decode_hd.cu"
    text = cu.read_text()
    marked = [line for line in text.splitlines() if MUTANT_MARK in line]
    if len(marked) != 1 or "sp < n_split;" not in marked[0]:
        fail(f"decode_hd.cu: expected one loop marked {MUTANT_MARK!r} over "
             f"'sp < n_split;', found {marked}")
    cu.write_text(text.replace(marked[0], marked[0].replace(
        "sp < n_split;", "sp < n_split - 1;")))
    so = MUTANT_DIR / "decode_hd_mutant.so"
    log = open(MUTANT_DIR / "nvcc.log", "w")
    MUTANT.update(so=so, log=MUTANT_DIR / "nvcc.log", proc=subprocess.Popen(
        [_build.nvcc()] + _build.FLAGS + ["-o", str(so), str(cu)],
        stdout=log, stderr=subprocess.STDOUT))


def _hd_mutation_check():
    """PR 22's mutation check on the ring pass 2: its merge dropping the
    last split (``_start_mutant_build``), at B=64 C=8192 m=2 (the ring's
    own split count, several splits), rows attending 0 to 8192 slots.  The
    bf16 row gate must fail it, and so must f32's 2e-5; the plain bf16
    gate's (5e-2) verdict is printed beside them.  The mutant library
    stands in for ``decode_hd`` only inside this check."""
    import ctypes
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops
    if MUTANT["proc"].wait() != 0:
        fail(f"the mutant of decode_hd.cu did not build:\n"
             f"{MUTANT['log'].read_text()[-3000:]}")
    B, C = 64, 8192
    gen = torch.Generator(device="cuda").manual_seed(14)
    valid = [0] + [max(1, C * i // (B - 1)) for i in range(1, B)]
    real = ops._hd_lib()
    out = {}
    try:
        _build._LIBS["decode_hd"] = ctypes.CDLL(str(MUTANT["so"]))
        for dtype in ("bfloat16", "float32"):
            q, k, v, qp, kp = decode_case(B, 12, 2, 128, C, valid, dtype, gen)
            s = sum(ops.decode_scores_ref(a, b, scale=128 ** -0.5)
                    for a, b in zip(q.chunk(2, -1), k.chunk(2, -1)))
            vs = v.chunk(2, -1)[0]
            got, n_split = ops._launch_softmax_pv(s, vs, qp, kp, None, "ring")
            want = ops.decode_softmax_pv_ref(s, vs, qp, kp)
            torch.cuda.synchronize()
            rec = dict(n_split=n_split, max_abs_err=_max_err(got, want))
            if dtype == "bfloat16":
                want32 = ops.decode_softmax_pv_ref(s, vs.float(), qp, kp)
                rec["row_excess"] = _bf16_excess(got, want32)
                rec["plain_gate_passes"] = bool(torch.allclose(
                    got.float(), want.float(), **TOL["bfloat16"]))
                caught = rec["row_excess"] > BF16_ROW_TOL
            else:
                caught = not torch.allclose(got, want, **TOL["float32"])
            if n_split < 2 or not caught:
                fail(f"mutation check {dtype}: a ring pass 2 whose merge "
                     f"drops its last split was not caught: {rec}")
            out[dtype] = rec
            del q, k, v, s
    finally:
        _build._LIBS["decode_hd"] = real
    say(f"mutation check (ring pass 2's merge dropping its last split, "
        f"B=64 C=8192 m=2, {out['bfloat16']['n_split']} splits): bf16 row "
        f"excess {out['bfloat16']['row_excess']:.3f} > {BF16_ROW_TOL} "
        f"(caught; the 5e-2 gate alone "
        f"{'passes' if out['bfloat16']['plain_gate_passes'] else 'fails'} "
        f"it, max err {out['bfloat16']['max_abs_err']:.2e}); f32 max err "
        f"{out['float32']['max_abs_err']:.2e} > 2e-5 (caught)")
    return out


def hd_phase(prompt_len):
    """The kernels of a head-dim-split cache on the card: the checks of
    ``_hd_split_check`` at the main decode shape (B 32, C prompt + 128)
    and at B 64 over 8192 slots and ``_hd_extra_check``, over both bodies
    of each pass; the mutation check; and the timings at both shapes.
    Returns the two passes' records (without launches)."""
    import torch
    stats = _hd_split_check(32, prompt_len + 128)
    for s, t in zip(stats, _hd_split_check(64, 8192)):
        s["checks"] += t["checks"]
        for key in ("max_abs_err", "bf16_row_excess"):
            if key in t:
                s[key] = max(s.get(key, 0.0), t[key])
        for body, n in t["checks_by_body"].items():
            s["checks_by_body"][body] = s["checks_by_body"].get(body, 0) + n
    _hd_extra_check(stats)
    say(f"K3 over a head-dim split: m = 2 / 4 / 16 slices at B=32 C="
        f"{prompt_len + 128} and B=64 C=8192, G=12, danube's ring (Dl 5), "
        f"D 384, through the wrappers and each body (cases by body: pass 1 "
        f"{stats[0]['checks_by_body']}, pass 2 {stats[1]['checks_by_body']}"
        f"): {stats[0]['checks']} decode_scores "
        f"checks (max err {stats[0]['max_abs_err']:.2e}), "
        f"{stats[1]['checks']} decode_softmax_pv and whole-decode checks "
        f"(max err {stats[1]['max_abs_err']:.2e}; bfloat16 row excess over "
        f"the float32 plain version {stats[1]['bf16_row_excess']:.2e} <= "
        f"{BF16_ROW_TOL}) against the plain versions and K3 whole, "
        f"_decode_split_hd included")
    mutation = _hd_mutation_check()
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    main = _hd_timings(32, prompt_len + 128, flush)
    long = _hd_timings(64, 8192, flush, sweep=True)
    del flush
    records = {}
    for i, name in enumerate(("decode_scores", "decode_softmax_pv")):
        records[name] = dict(
            route="cuda", source="src/repro_torch/kernels/csrc/decode_hd.cu",
            bodies={"ring": f"decode_hd.cu::{name}_ring",
                    "simt": f"decode_hd.cu::{name}"},
            replaces="src/repro/kernels/decode_attention/kernel.py:90",
            max_abs_err=stats[i]["max_abs_err"], checks=stats[i]["checks"],
            checks_by_body=stats[i]["checks_by_body"],
            **main["bfloat16"]["m2"][name], shape=(32, 12, 2, 128,
                                                   prompt_len + 128), m=2,
            float32=main["float32"]["m2"][name],
            main=main, long=dict(shape=(64, 12, 2, 128, 8192), **long),
            mutation_check=mutation if i == 1 else None)
    return records


def hd_decode_phase():
    """The slice's path at full width: qwen-distill-1.5B's published config
    (28 layers, bf16, seed 0's weights), B=32 math prompts, 32 new tokens,
    with every decode attention routed through ``_hd_passes`` over m = 2
    head-dim slices (``parallel.local.decode_attention`` replaced for the
    run; the package has no such switch).  K3's greedy decode from the
    same prefill first; then the routed decode fed K3's tokens: each step
    2 x 28 launches of each pass and none of K3, logits within 5e-2 of max
    |logit|, and the decode ms per step beside K3's.  Then float32 at the
    published width cut to 2 layers: the two greedy decodes give the same
    tokens.  Then float32 at the published depth (28 layers, seed 0's
    weights), the routed decode fed K3's greedy tokens: each step 2 x 28
    launches of each pass on the ring body, logits within 1e-3 of max
    |logit| of K3's, the decode ms per step beside K3's."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tasks import MathTaskGenerator, Tokenizer
    from repro_torch.models import transformer
    from repro_torch.parallel import local as plocal

    m, steps = 2, 32
    k3 = plocal.decode_attention

    def routed(q, k, v, q_pos, k_pos, *, window=None):
        return _hd_passes(q, k, v, q_pos, k_pos, m, window)

    tasks = MathTaskGenerator(seed=0).batch(32)
    plen = max(len(t.prompt_ids) for t in tasks)
    toks = np.full((32, plen), Tokenizer.PAD, np.int64)
    for i, t in enumerate(tasks):
        toks[i, plen - len(t.prompt_ids):] = t.prompt_ids
    toks = torch.from_numpy(toks).cuda()

    def decode(params, cfg, feed=None, hd=False):
        """Greedy decode (or fed ``feed``'s tokens) from a fresh prefill:
        tokens [steps, 32], logits per step, host ms per step, launches."""
        lg, cache = transformer.prefill(params, cfg, toks,
                                        max_len=plen + steps)
        out, logits, ms, counts = [], [], [], []
        plocal.decode_attention = routed if hd else k3
        try:
            for t in range(steps):
                tok = (torch.argmax(lg[:, :cfg.vocab].float(), -1)
                       .to(torch.int32) if feed is None else feed[t])
                out.append(tok)
                pos = torch.full((32,), plen + t, dtype=torch.int32,
                                 device="cuda")
                _reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, cache = transformer.decode_step(params, cfg, cache, tok,
                                                    pos)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                logits.append(lg[:, :cfg.vocab].float())
                counts.append(dict(_read_counts(), **{
                    n: f.launches for n, f in _hd_wrappers().items()}, **{
                    f"{n} by variant": dict(f.launches_by_variant)
                    for n, f in _hd_wrappers().items()}))
        finally:
            plocal.decode_attention = k3
        return torch.stack(out), logits, ms, counts

    def expect(what, counts, L, hd):
        n = m * L if hd else 0
        want = {"flash_attention_fwd": 0, "flash_decode": 0 if hd else L,
                "paged_flash_decode": 0, "mlstm_scan": 0,
                "decode_scores": n, "decode_softmax_pv": n,
                # the 1.5B's Dl 64 takes each pass's ring body, in either
                # dtype
                "decode_scores by variant": dict(ring=n, simt=0),
                "decode_softmax_pv by variant": dict(ring=n, simt=0)}
        for t, c in enumerate(counts):
            if c != want:
                fail(f"{what} step {t}: launches {c}, expected {want}")

    cfg = get_config(ARCH)
    L = cfg.n_layers
    params = _bf16_qwen(cfg)
    out = {}
    with torch.inference_mode():
        tok_k3, lg_k3, ms_k3, c_k3 = decode(params, cfg)
        expect("K3 decode (bf16)", c_k3, L, False)
        tok_hd, lg_hd, ms_hd, c_hd = decode(params, cfg, feed=tok_k3,
                                            hd=True)
        expect("head-dim split decode (bf16)", c_hd, L, True)
    worst = 0.0
    for t, (a, b) in enumerate(zip(lg_hd, lg_k3)):
        rel = float((a - b).abs().max() / b.abs().max())
        worst = max(worst, rel)
        if not (torch.isfinite(a).all() and rel <= 5e-2):
            fail(f"head-dim split decode step {t}: max |hd - K3| / max |K3| "
                 f"= {rel:.3e} > 5e-2")
    agree = float(np.mean([bool((torch.argmax(a, -1) == torch.argmax(b, -1))
                                .all()) for a, b in zip(lg_hd, lg_k3)]))
    launches = {n: sum(c[n] for c in c_hd) for n in _hd_wrappers()}
    by_variant = {n: {b: sum(c[f"{n} by variant"][b] for c in c_hd)
                      for b in ("ring", "simt")} for n in _hd_wrappers()}
    out["bf16"] = dict(
        layers=L, batch=32, prompt=plen, steps=steps, m=m,
        worst_rel_logits=worst, steps_same_greedy=agree,
        decode_ms_median=statistics.median(ms_hd[1:]),
        k3_decode_ms_median=statistics.median(ms_k3[1:]),
        decode_ms=ms_hd, k3_decode_ms=ms_k3, launches=launches,
        launches_by_variant=by_variant,
        modelled_scores_bytes_per_layer=4 * 32 * cfg.n_heads * (
            plen + steps))
    say(f"head-dim split decode, qwen-distill-1.5b published config (bf16, "
        f"{L} layers, B=32, prompts of {plen} tokens padded, {steps} new "
        f"tokens), m={m} slices through decode_scores / decode_softmax_pv: "
        f"{launches} launches ({m} x {L} of each a step; by body "
        f"{by_variant}), worst max |hd - "
        f"K3| / max |K3| logits {worst:.2e} <= 5e-2 (K3's greedy tokens fed;"
        f" share of steps whose argmax agree {agree:.3f}); decode "
        f"{out['bf16']['decode_ms_median']:.2f} ms a step (median of "
        f"{steps - 1}, host clock) against K3's "
        f"{out['bf16']['k3_decode_ms_median']:.2f} ms; scores all-reduce "
        f"payload (modelled, B x H x C x 4: no all-reduce runs in one "
        f"process) {out['bf16']['modelled_scores_bytes_per_layer'] / 1e3:.1f}"
        f" kB a layer; {CARD['card']}")
    del params, lg_k3, lg_hd
    torch.cuda.empty_cache()

    cfg = get_config(ARCH).replace(n_layers=2, dtype="float32")
    params = transformer.init(0, cfg, "cuda")
    with torch.inference_mode():
        tok_k3, lg_k3, _, c_k3 = decode(params, cfg)
        expect("K3 decode (f32, 2 layers)", c_k3, 2, False)
        tok_hd, lg_hd, _, c_hd = decode(params, cfg, hd=True)
        expect("head-dim split decode (f32, 2 layers)", c_hd, 2, True)
    if not torch.equal(tok_k3, tok_hd):
        fail("head-dim split decode (f32, 2 layers): greedy tokens differ "
             "from K3's")
    rel32 = max(float((a - b).abs().max() / b.abs().max())
                for a, b in zip(lg_hd, lg_k3))
    out["f32_2_layers"] = dict(tokens_identical=True, steps=steps,
                               worst_rel_logits=rel32)
    say(f"head-dim split decode (f32, published width, 2 layers, B=32, "
        f"{steps} greedy steps each): tokens identical to K3's; worst max "
        f"|hd - K3| / max |K3| logits {rel32:.2e}")
    del params, lg_k3, lg_hd
    torch.cuda.empty_cache()

    cfg = get_config(ARCH).replace(dtype="float32")
    L = cfg.n_layers
    params = transformer.init(0, cfg, "cuda")
    with torch.inference_mode():
        tok_k3, lg_k3, ms_k3, c_k3 = decode(params, cfg)
        expect("K3 decode (f32)", c_k3, L, False)
        _, lg_hd, ms_hd, c_hd = decode(params, cfg, feed=tok_k3, hd=True)
        expect("head-dim split decode (f32)", c_hd, L, True)
    worst = 0.0
    for t, (a, b) in enumerate(zip(lg_hd, lg_k3)):
        rel = float((a - b).abs().max() / b.abs().max())
        worst = max(worst, rel)
        if not (torch.isfinite(a).all() and rel <= 1e-3):
            fail(f"head-dim split decode (f32) step {t}: max |hd - K3| / max "
                 f"|K3| = {rel:.3e} > 1e-3")
    launches = {n: sum(c[n] for c in c_hd) for n in _hd_wrappers()}
    by_variant = {n: {b: sum(c[f"{n} by variant"][b] for c in c_hd)
                      for b in ("ring", "simt")} for n in _hd_wrappers()}
    out["f32"] = dict(
        layers=L, batch=32, prompt=plen, steps=steps, m=m,
        worst_rel_logits=worst,
        decode_ms_median=statistics.median(ms_hd[1:]),
        k3_decode_ms_median=statistics.median(ms_k3[1:]),
        decode_ms=ms_hd, k3_decode_ms=ms_k3, launches=launches,
        launches_by_variant=by_variant)
    say(f"head-dim split decode, qwen-distill-1.5b published config (f32, "
        f"{L} layers, B=32, {steps} new tokens, K3's greedy tokens fed), "
        f"m={m} slices: {launches} launches ({m} x {L} of each a step; by "
        f"body {by_variant}), worst max |hd - K3| / max |K3| logits "
        f"{worst:.2e} <= 1e-3; decode {out['f32']['decode_ms_median']:.2f} "
        f"ms a step (median of {steps - 1}, host clock) against K3's "
        f"{out['f32']['k3_decode_ms_median']:.2f} ms; {CARD['card']}")
    del params, lg_k3, lg_hd
    torch.cuda.empty_cache()
    return out


def parallel_phase():
    """Slice 11 on the card (``parallel/``, ``launch/{mesh,roofline,dryrun,
    report}``).  (1) The dry-run cells (``_dryrun_cells``) and the report's
    tables; every roofline term is modelled from the H100 SXM data sheet.
    (2) A sharded GRPO train step of qwen-distill-1.5b's published config
    (bf16, remat, B = 8 x 160) over ``make_host_mesh((1, 1))``, NCCL at
    world size 1: params by ``param_pspecs(fsdp=True)``, AdamW state by
    ``opt_state_pspecs``, batch by ``batch_pspecs``, attention through
    ``local_map``; 2 x 28 K1 launches a step on the tensor-core kernel,
    loss and grad_norm within 1e-3 of the unsharded step from the same
    weights (timed beside it: host clock, device busy ms, idle share), and
    measured busy ms beside the same program's dry-run roofline at (1, 1).
    (3) ``make_serve_step`` at B = 32 over the 1.5B's cache placed by
    ``cache_pspecs``: 28 K3 launches a step, logits within 1e-3 of the
    unsharded ``decode_step``; then ``_ctx_split_check``, K3 as a
    context-split cache runs it.  (4) The int8 error-feedback all-reduce
    over the NCCL group on the step's gradient tree: per leaf the error
    within 0.75 x scale, residual + mean reproduces the gradients within
    it; bytes reduced against bf16's, and the time."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.data.tasks import MathTaskGenerator, Tokenizer
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.compression import (init_residual,
                                                  make_compressed_allreduce)
    from repro_torch.rl.grpo import make_serve_step, make_train_step

    t_phase = time.perf_counter()
    out = {}
    out["dryrun"], roof = _dryrun_cells()

    cfg = get_config(ARCH)
    L = cfg.n_layers
    opt = AdamWConfig(lr=3e-5)
    B, S, prompt = 8, 160, 112
    batch = _train_batch(cfg, B, S, prompt, "cuda")
    step = make_train_step(cfg, opt)
    torch.cuda.empty_cache()
    # the unsharded step from seed 0's weights
    p16 = _bf16_qwen(cfg).requires_grad_(True)
    (loss0, gn0), t_plain, prof_plain, _ = _timed_steps(
        "unsharded qwen bf16 train", step, p16, adamw_init(p16, opt), batch,
        L, float)
    del p16
    torch.cuda.empty_cache()

    mesh = make_host_mesh((1, 1), ("data", "model"))
    say(f"host mesh {mesh} over {dist.get_backend()} at world size "
        f"{dist.get_world_size()}")
    dp, dstate, dbatch = _place_train(cfg, _bf16_qwen(cfg), batch, mesh, opt)
    placed = {str(p.placements) for p in dp.parameters()}

    def sharded(params, state, b):
        with implicit_replication():
            return step(params, state, b)

    (loss1, gn1), t_shard, prof_shard, launches = _timed_steps(
        "sharded qwen bf16 train", sharded, dp, dstate, dbatch, L,
        lambda x: x.full_tensor() if hasattr(x, "full_tensor") else x)
    rl, rg = abs(loss1 - loss0) / abs(loss0), abs(gn1 - gn0) / abs(gn0)
    if not (rl <= 1e-3 and rg <= 1e-3):
        fail(f"sharded train step: loss {loss1} vs {loss0} (rel {rl:.2e}), "
             f"grad_norm {gn1} vs {gn0} (rel {rg:.2e}) > 1e-3")
    bound_ms = max(roof["t_compute_ms"], roof["t_memory_ms"])
    out["train"] = dict(
        loss=loss1, loss_unsharded=loss0, loss_rel=rl, grad_norm=gn1,
        grad_norm_unsharded=gn0, grad_norm_rel=rg,
        bit_identical=(loss1 == loss0 and gn1 == gn0),
        step_ms=t_shard[1:], warmup_ms=t_shard[0],
        unsharded_step_ms=t_plain[1:], unsharded_warmup_ms=t_plain[0],
        busy_ms=prof_shard["busy_ms"], idle_share=prof_shard["idle_share"],
        unsharded_busy_ms=prof_plain["busy_ms"],
        unsharded_idle_share=prof_plain["idle_share"],
        top_kernels_ms=prof_shard["top_kernels_ms"], placements=sorted(placed),
        launches=launches, launch_steps=len(t_shard), roofline_1x1=roof, roofline_bound_ms=bound_ms,
        busy_over_bound=prof_shard["busy_ms"] / bound_ms)
    say(f"sharded GRPO train step, qwen-distill-1.5b published config (bf16,"
        f" remat, B=8 S=160) over make_host_mesh((1, 1)) ("
        f"{dist.get_backend()}, world {dist.get_world_size()}; placements "
        f"{sorted(placed)}): {' / '.join(f'{t:.1f}' for t in t_shard)}"
        f" ms host clock (first is warm-up) against the unsharded step's "
        f"{' / '.join(f'{t:.1f}' for t in t_plain)} ms in this run; device "
        f"busy {prof_shard['busy_ms']:.1f} ms (idle share "
        f"{prof_shard['idle_share']:.3f}) against {prof_plain['busy_ms']:.1f}"
        f" ms ({prof_plain['idle_share']:.3f}); loss {loss1:.6f} vs "
        f"{loss0:.6f} (rel {rl:.2e}), grad_norm {gn1:.5f} vs {gn0:.5f} (rel "
        f"{rg:.2e}), bit-identical: {out['train']['bit_identical']}; K1 "
        f"launches {launches} over {len(t_shard)} steps (2 x {L} a step); "
        f"{CARD['card']}")
    say(f"dry-run roofline of that step at mesh (1, 1) (modelled, H100 SXM "
        f"data sheet: 989 TFLOP/s bf16, 3.35 TB/s): {roof['flops']:.4g} "
        f"FLOPs -> {roof['t_compute_ms']:.2f} ms, {roof['bytes']:.4g} op-level"
        f" bytes -> {roof['t_memory_ms']:.2f} ms; measured busy "
        f"{prof_shard['busy_ms']:.1f} ms = {out['train']['busy_over_bound']:.2f}"
        f" x max(t_compute, t_memory)")
    del dp, dstate, dbatch
    torch.cuda.empty_cache()

    # (3) the sharded serve step at the main path's decode shape
    params = _bf16_qwen(cfg)
    tasks = MathTaskGenerator(seed=0).batch(32)
    plen = max(len(t.prompt_ids) for t in tasks)
    toks = np.full((32, plen), Tokenizer.PAD, np.int64)
    for i, t in enumerate(tasks):
        toks[i, plen - len(t.prompt_ids):] = t.prompt_ids
    serve = make_serve_step(cfg)
    dparams = shd.distribute(params, shd.param_pspecs(params, cfg, mesh),
                             mesh)
    rows = shd.placements(shd.P(("data",)), mesh)
    worst, t_s, t_u, steps, launches = 0.0, [], [], 4, 0
    with torch.no_grad():
        lg, cache = transformer.prefill(
            params, cfg, torch.from_numpy(toks).cuda(), max_len=plen + 128)
        dcache = shd.distribute({k: v.clone() for k, v in cache.items()},
                                shd.cache_pspecs(cache, cfg, mesh), mesh)
        for t in range(steps):
            tok = torch.argmax(lg[:, :cfg.vocab].float(), -1).to(torch.int32)
            pos = torch.full((32,), plen + t, dtype=torch.int32,
                             device="cuda")
            dtok, dpos = (distribute_tensor(x, mesh, rows) for x in (tok, pos))
            _reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with implicit_replication():
                lg_s, dcache = serve(dparams, dcache, dtok, dpos)
            torch.cuda.synchronize()
            t_s.append((time.perf_counter() - t0) * 1e3)
            counts = _read_counts()
            launches += counts["flash_decode"]
            want = {"flash_attention_fwd": 0, "flash_decode": L,
                    "paged_flash_decode": 0, "mlstm_scan": 0}
            if counts != want:
                fail(f"sharded serve step {t}: launches {counts}, expected "
                     f"{want}")
            t0 = time.perf_counter()
            lg, cache = transformer.decode_step(params, cfg, cache, tok, pos)
            torch.cuda.synchronize()
            t_u.append((time.perf_counter() - t0) * 1e3)
            a, b = lg_s.full_tensor().float(), lg.float()
            rel = float((a - b).abs().max() / b.abs().max())
            worst = max(worst, rel)
            if not (torch.isfinite(a).all() and rel <= 1e-3):
                fail(f"sharded serve step {t}: max |sharded - unsharded| / "
                     f"max |unsharded| = {rel:.3e} > 1e-3")
    out["serve"] = dict(worst_rel=worst, launches=launches, steps=steps,
                        step_ms=t_s, unsharded_step_ms=t_u,
                        context=plen + 128)
    say(f"sharded serve step (make_serve_step, B=32, cache of "
        f"{plen + 128} slots placed by cache_pspecs): K3 launches {launches}"
        f" over {steps} steps ({L} a step), worst max |sharded - unsharded| / max "
        f"|unsharded| = {worst:.2e} <= 1e-3; host clock "
        f"{' / '.join(f'{x:.1f}' for x in t_s)} ms against "
        f"{' / '.join(f'{x:.1f}' for x in t_u)} ms unsharded; {CARD['card']}")
    del dparams, dcache, cache
    torch.cuda.empty_cache()
    ctx = _ctx_split_check(32, plen + 128)
    out["serve"]["ctx_split"] = ctx
    say(f"K3 over a context split (the cache_shard='ctx' decode): 2 and 4 "
        f"runs of {plen + 128} slots, B=32, each with its lse, merged: "
        f"{ctx['checks']} checks against K3 over the whole cache and the "
        f"plain version, max err {ctx['max_abs_err']:.2e}")
    out["hd"] = hd_phase(plen)

    # (4) the compressed all-reduce on the step's gradient tree, in float32
    # as the reference's test holds it: the mean is cast back to the
    # gradient's dtype, and bf16's cast alone may add half an ulp (up to
    # 0.496 x scale), so the bf16 tree is reported, not held to the bound
    grads16 = _grads(cfg, params, batch)
    del params
    grads = {k: g.float() for k, g in grads16.items()}
    f = make_compressed_allreduce(mesh, "data")
    mean, res = f(grads, init_residual(grads))
    worst_err, worst_rec = 0.0, 0.0
    for name, x in grads.items():
        scale = max(float(x.abs().max()), 1e-12) / 127.0
        err = float((mean[name] - x).abs().max())
        rec = float((res[name] + mean[name] - x).abs().max())
        if not (err <= 0.75 * scale and rec <= 0.75 * scale):
            fail(f"compressed all-reduce {name}: error {err:.3e}, residual + "
                 f"mean {rec:.3e} > 0.75 x scale {scale:.3e}")
        worst_err = max(worst_err, err / scale)
        worst_rec = max(worst_rec, rec / scale)
    mean16, _ = f(grads16, init_residual(grads16))
    worst16 = max(float((mean16[k].float() - g.float()).abs().max())
                  / (max(float(g.float().abs().max()), 1e-12) / 127.0)
                  for k, g in grads16.items())
    del mean16
    n = sum(g.numel() for g in grads.values())
    times = []
    for _ in range(5):
        res0 = init_residual(grads)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f(grads, res0)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["compress"] = dict(
        leaves=len(grads), elements=n, worst_err_over_scale=worst_err,
        worst_rec_over_scale=worst_rec, bf16_tree_err_over_scale=worst16,
        int8_payload_bytes=n,
        int32_reduced_bytes=4 * n, bf16_bytes=2 * n,
        ms=statistics.median(times), ms_all=times)
    say(f"compressed all-reduce over {dist.get_backend()} (world "
        f"{dist.get_world_size()}) on the step's gradient "
        f"tree in float32 ({len(grads)} leaves, {n / 1e9:.3f} G elements): "
        f"worst error {worst_err:.3f} x scale, residual + mean "
        f"{worst_rec:.3f} x scale (<= 0.75; the bf16 tree, its mean cast "
        f"back to bf16: {worst16:.3f} x scale); int8 payload {n / 1e9:.3f} GB, reduced as int32 "
        f"{4 * n / 1e9:.3f} GB (as the reference sums it), bf16 "
        f"{2 * n / 1e9:.3f} GB; quantize-and-reduce "
        f"{statistics.median(times):.1f} ms median of 5 (host clock); "
        f"{CARD['card']}")
    del grads, grads16, mean, res
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"parallel phase {out['phase_s']:.1f} s")
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
    _reset_counts()
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
    what = f"teacher-forced {arch} ({n_layers} layers, float32)"
    _expect_counts(what, n_layers, steps, _read_counts())
    _expect_decode_bodies(what, "tf32x3")
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
    _reset_counts()
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
    what = "paged teacher-forced (4 layers, float32)"
    _expect_paged_counts(what, cfg.n_layers, steps, _read_counts())
    _expect_decode_bodies(what, "tf32x3")
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
    if variants != {"simt": 0, "mma": 0, "tf32x3": 2 * cfg.n_layers}:
        fail(f"xlstm teacher-forced: mlstm_scan launches by kernel "
             f"{variants}, expected {2 * cfg.n_layers} on the 3xTF32 "
             "kernel")
    say("xlstm teacher-forced card vs cpu (4 layers, float32, forward, "
        f"prefill + carry, {steps} decode steps): worst max |card - cpu| / "
        "max |cpu| " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
        + " <= 1e-3")
    return worst


def train_step_parity_phase():
    """GRPO train steps on the card and on the CPU from the same params
    and batch in float32: one step of xlstm-1.3b (K4 forward, recomputed
    backward) and of qwen-distill-1.5b (K1 forward, its recompute
    backward) at full width cut to 4 layers, and three steps of
    qwen3-moe's smoke config (the routing backward, and the grad norm's
    growth from step to step on a fixed batch).  Loss and grad_norm agree
    within 1e-3 relative at every step."""
    import torch
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models.api import get_model
    from repro_torch.models.params import tree_map
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.rl.grpo import make_train_step

    out = {}
    for arch, cut, n_steps in (("xlstm-1.3b", "4 layers", 1),
                               (ARCH, "4 layers", 1),
                               ("qwen3-moe-235b-a22b", "smoke width", 3)):
        cfg = (get_config(arch).replace(n_layers=4) if cut == "4 layers"
               else get_smoke_config(arch)).replace(dtype="float32",
                                                    remat=False)
        opt = AdamWConfig(lr=3e-5)
        step = make_train_step(cfg, opt)
        card = get_model(cfg).init(4, cfg, "cuda")
        res = []
        host = tree_map(lambda t: t.to("cpu", copy=True), card.tree())
        for params in (card, params_from_jax(host, "cpu")):
            dev = params["embed"].device
            params.requires_grad_(True)
            state = adamw_init(params, opt)
            batch = _train_batch(cfg, 4, 64, 40, dev, seed=1)
            res.append([])
            _reset_counts()
            for _ in range(n_steps):
                params, state, m = step(params, state, batch)
                res[-1] += [float(m["loss"]), float(m["grad_norm"])]
            if dev.type == "cuda":
                counts = _read_counts()
                key = ("mlstm_scan" if cfg.family == "ssm"
                       else "flash_attention_fwd")
                if counts[key] != n_steps * cfg.n_layers or (
                        key == "mlstm_scan" and _scan_variants()["tf32x3"]
                        != counts[key]):
                    fail(f"train step parity {arch}: launches {counts} (scan "
                         f"by kernel {_scan_variants()}), expected "
                         f"{n_steps * cfg.n_layers} {key}, all on the 3xTF32 "
                         "kernel")
        del card, params, state
        rel = [abs(a - b) / abs(b) for a, b in zip(*res)]
        if not all(math.isfinite(x) and x <= 1e-3 for x in rel):
            fail(f"train step parity {arch}: card (loss, grad_norm) per step "
                 f"{res[0]} vs cpu {res[1]}: relative {rel}")
        say(f"train step card vs cpu {arch} ({cut}, float32, {n_steps} "
            "step(s)): (loss, grad_norm) per step card "
            + ", ".join(f"{x:.6g}" for x in res[0]) + " / cpu "
            + ", ".join(f"{x:.6g}" for x in res[1]) + ", worst relative "
            f"{max(rel):.2e} <= 1e-3")
        out[arch] = rel
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------- the families
# the model families beyond qwen-distill and xlstm: their published
# configs, served at the published depth where the bf16 weights stay under
# SERVE_BYTES, else at the largest depth under it (SERVE_LAYERS)
FAMILY_ARCHS = ["qwen2.5-3b", "h2o-danube-1.8b", "starcoder2-15b", "yi-34b",
                "internvl2-2b", "qwen3-moe-235b-a22b", "grok-1-314b",
                "hymba-1.5b", "whisper-small"]
SERVE_BYTES = 16 * 2 ** 30
SERVE_LAYERS = {"starcoder2-15b": 20, "yi-34b": 13,
                "qwen3-moe-235b-a22b": 2, "grok-1-314b": 1}
DEV = "cuda"       # the families' phases run on this device
# the split counts K3's and K2's rule gives in bfloat16 at the serve shapes
# (the H100's 132 SMs and resident blocks), pinned beside the CPU tests'
# (tests/test_torch_split_rule.py): whisper-small's cross-attention decode,
# h2o-danube's ring and paged rows, the 1.5B paged step (every launch of
# the timed generate_groups)
PINNED_SPLITS = {"whisper-small cross": 4, "h2o-danube-1.8b ring": 8,
                 "h2o-danube-1.8b window=4096": 8, "1.5B paged step": 1}
# and the counts it gives the CUDA-core body in float32 at the kernel
# phases' sweep shapes (K3's (B, H, Hkv, D, C), K2's (B, H, Hkv, D, page,
# pages) with the host's longest length), pinned beside the CPU tests'
CORE_PINNED_SPLITS = {
    ("flash_decode", (32, 12, 2, 128, 161)): 1,
    ("flash_decode", (8, 12, 2, 128, 8192)): 24,
    ("flash_decode", (64, 12, 2, 128, 8192)): 3,
    ("paged_flash_decode", (32, 12, 2, 128, 128, 2)): 2,
    ("paged_flash_decode", (8, 12, 2, 128, 128, 64)): 24,
    ("paged_flash_decode", (64, 12, 2, 128, 128, 64)): 3}


# and the float32 tensor-core body's, which float32 takes at D 128
TF32X3_PINNED_SPLITS = {
    ("flash_decode", (32, 12, 2, 128, 161)): 1,
    ("flash_decode", (8, 12, 2, 128, 8192)): 8,
    ("flash_decode", (64, 12, 2, 128, 8192)): 1,
    ("paged_flash_decode", (32, 12, 2, 128, 128, 2)): 1,
    ("paged_flash_decode", (8, 12, 2, 128, 128, 64)): 8,
    ("paged_flash_decode", (64, 12, 2, 128, 128, 64)): 1}


def _hold_pin(name, shape, dtype, n_split):
    """Fail unless the float32 count (on the 3xTF32 body) at a pinned
    sweep shape is the pin."""
    want = TF32X3_PINNED_SPLITS.get((name, tuple(shape)))
    if dtype == "float32" and want is not None and n_split != want:
        fail(f"{name} {shape} float32: the rule gives {n_split} splits, "
             f"pinned {want}")


# bfloat16 kernel output against the float32 plain version of the same
# inputs: each element may be off by its own rounding to bfloat16 (2^-8 of
# it) plus BF16_ROW_TOL of its row's rms (a row: one query's heads x head
# dims), which covers the rounding of the probabilities in the P V product
# (2^-8 each, random, so about 2^-8 of the row's rms over thousands of
# keys) but not a key dropped or added (about 1/sqrt(keys) of the rms)
BF16_ROW_TOL = 2e-2


def _widened(args):
    return tuple(a.float() if hasattr(a, "is_floating_point")
                 and a.is_floating_point() else a for a in args)


def _bf16_excess(got, want32):
    """max over elements of (|got - want32| - 2^-8 |want32|) / the rms of
    want32 over the element's row (its last two dims: heads x head dim)."""
    g = got.float().reshape(-1, got.shape[-2] * got.shape[-1])
    w = want32.float().reshape(g.shape)
    rms = w.pow(2).mean(-1, keepdim=True).sqrt().clamp_min(1e-30)
    return float(((g - w).abs() - 2.0 ** -8 * w.abs()).div(rms).max())


def _attn_sites(cfg):
    """(K1 launches per prefill, K3 launches per decode step): one per
    attention layer; whisper's prefill runs its encoder and the decoder's
    self- and cross-attention, its decode step the last two."""
    if cfg.family == "encdec":
        return cfg.n_encoder_layers + 2 * cfg.n_layers, 2 * cfg.n_layers
    return cfg.n_layers, cfg.n_layers


def _ring_pos(q_pos, C):
    """k_pos [B, C] of a ring cache of C slots after writing positions
    0..q_pos of each row at slot ``pos % C``."""
    import torch
    rows = []
    for qp in q_pos:
        if qp < C:
            rows.append([s if s <= qp else EMPTY for s in range(C)])
        else:
            rows.append([qp - ((qp - s) % C) for s in range(C)])
    return torch.tensor(rows, dtype=torch.int32, device=DEV)


def families_kernel_phase(prompt_len):
    """K1, K3 and K2 at the shapes the families put them at, in float32 and
    bfloat16 against their plain versions (one launch a call, on the
    kernel or body ``_variant`` / ``_decode_body`` names, read from the
    wrapper's counts), timed in bfloat16 beside the plain version,
    ``scaled_dot_product_attention`` and the bound: K1 at D = 80 with
    window 4096 (h2o-danube, on the tensor-core kernel, its CUDA-core
    kernel held and timed beside it) at S 33 and 4200; K1 non-causal at
    Sq 33 / Sk 1500
    and 1500 / 1500, H 12, D 64 (whisper's cross-attention and encoder);
    K1 at hymba's 25 / 5 heads, D 64, window 1024, and at G = 12 and 16
    (starcoder2, qwen3-moe); K3 at D = 80 over a ring of 4096 slots past
    the window (rows at 3000, 4100, 4200 and 5000), at hymba's ring of
    1024, whisper's cross-attention (the query at Se - 1 over 1500 frames)
    and G = 16, D 128 (qwen3-moe); K2 at D = 80, window 4096, with lengths
    past the window.  At D = 80 K3 and K2 run the tensor-core body, their
    CUDA-core body held and timed beside it, and each D = 80 case must
    reject a planted fault that zeroes q's dims 64..79 (the second
    chunk's real columns).  K3 and K2 must launch in the head groups
    ``_head_groups`` gives (``_rule_groups``; qwen3-moe's G 16 at B 8 in
    bf16: two groups of 8 on the tensor cores, as the one-group grid does
    not fill the SMs), and qwen3-moe's case must reject a planted fault
    that zeroes q's heads 8..15 of every KV group.  Returns {kernel:
    {shape: record}}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import (
        _decode_body, decode_attention, decode_attention_ref)
    from repro_torch.kernels.flash_attention.ops import (
        _variant, flash_attention, flash_attention_ref)
    from repro_torch.kernels.paged_attention.ops import (
        paged_decode_attention, paged_decode_attention_ref)

    gen = torch.Generator(device=DEV).manual_seed(8)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=DEV)
    out = {"flash_attention_fwd": {}, "flash_decode": {},
           "paged_flash_decode": {}}

    def hold(name, wrapper, shape, what, call, plain, library, work,
             faults=(), expect=None, old=None, sweep=False):
        """Check one case in both dtypes; in bfloat16 also against the
        float32 plain version of the same inputs, row by row
        (``_bf16_excess``), and show that each planted fault in
        ``faults`` (name, args -> (args, kwargs) of a wrong call) fails
        that check; time it in bfloat16.  ``expect(dtype)`` names the
        kernel or body the call must launch (``launches_by_variant``);
        ``old(args)``, the older kernel or body (not counted), is held to
        the plain version and timed beside it in bfloat16; ``sweep`` (K3,
        K2) also times the wrapper with n_split forced."""
        rec = {"max_abs_err": 0.0}
        for dtype in ("float32", "bfloat16"):
            args = call(dtype)
            before = wrapper.launches
            by_before = dict(wrapper.launches_by_variant)
            groups_before = dict(getattr(wrapper, "launches_by_groups", {}))
            got = wrapper(*args[0], **args[1])
            if wrapper.launches != before + 1:
                fail(f"{name} {shape} {what} {dtype}: "
                     f"{wrapper.launches - before} launches for one call")
            ran = [v for v, n in wrapper.launches_by_variant.items()
                   if n != by_before[v]]
            rec[f"variant_{dtype}"] = ran[0] if len(ran) == 1 else ran
            if expect is not None and ran != [expect(dtype)]:
                fail(f"{name} {shape} {what} {dtype}: launched {ran}, "
                     f"expected {expect(dtype)}")
            if hasattr(wrapper, "launches_by_groups"):
                # K3 / K2: the split count the wrapper chose, which in
                # bfloat16 at the serve shapes must be the pinned one
                rec[f"n_split_{dtype}"] = wrapper.last_n_split
                if (dtype == "bfloat16" and what in PINNED_SPLITS
                        and wrapper.last_n_split != PINNED_SPLITS[what]):
                    fail(f"{name} {shape} {what}: {wrapper.last_n_split} "
                         f"splits, pinned {PINNED_SPLITS[what]}")
                # the groups the rule gives this launch
                ng = _rule_groups(name, *args)[0]
                if wrapper.launches_by_groups.get(ng, 0) != (
                        groups_before.get(ng, 0) + 1
                        ) or wrapper.last_groups[0] != ng:
                    fail(f"{name} {shape} {what} {dtype}: launches by head "
                         f"groups {groups_before} -> "
                         f"{wrapper.launches_by_groups}, expected one in "
                         f"{ng} on {ran[0]}")
                rec[f"head_groups_{dtype}"] = ng
            stats = {"checks": 0, "max_abs_err": 0.0}
            _check(name, got, plain(*args[0], **args[1]), dtype, shape, stats)
            rec["max_abs_err"] = max(rec["max_abs_err"], stats["max_abs_err"])
            rec[f"max_abs_err_{dtype}"] = stats["max_abs_err"]
            if dtype == "bfloat16":
                want32 = plain(*_widened(args[0]), **args[1])
                rec["bf16_excess"] = _bf16_excess(got, want32)
                if not rec["bf16_excess"] <= BF16_ROW_TOL:
                    fail(f"{name} {shape} {what} bfloat16: max (|kernel - "
                         "float32 plain| - 2^-8 |plain|) / row rms = "
                         f"{rec['bf16_excess']:.3e} > {BF16_ROW_TOL}")
                rec["planted"] = {}
                for fault, wrong in faults:
                    fargs, fkw = wrong(args)
                    rec["planted"][fault] = _bf16_excess(
                        wrapper(*fargs, **fkw), want32)
                    if rec["planted"][fault] <= BF16_ROW_TOL:
                        fail(f"{name} {shape} {what}: the planted fault "
                             f"'{fault}' passes the bfloat16 check "
                             f"({rec['planted'][fault]:.3e} <= "
                             f"{BF16_ROW_TOL})")
                    del fargs, fkw
                n_bytes, flops = work(2)
                bound, by = _bound_ms(n_bytes, flops, dtype)
                rec.update(
                    variant=rec["variant_bfloat16"],
                    n_split=rec.get("n_split_bfloat16"),
                    ms=_time_ms(lambda: wrapper(*args[0], **args[1]), flush),
                    plain_ms=_time_ms(lambda: plain(*args[0], **args[1]),
                                      flush),
                    library_ms=_time_ms(library(args), flush),
                    bound_ms=bound, bound_by=by)
                if old is not None:
                    got_old = old(args)
                    _check(f"{name} (old)", got_old,
                           plain(*args[0], **args[1]), dtype, shape, stats)
                    rec["old_max_abs_err"] = _max_err(
                        got_old, plain(*args[0], **args[1]))
                    rec["old_bf16_excess"] = _bf16_excess(got_old, want32)
                    rec["old_ms"] = _time_ms(lambda: old(args), flush)
                    del got_old
                if sweep:
                    # forced counts through the uncounted launcher, and
                    # the wrapper's own
                    rec["split_sweep"] = {}
                    for force in (1, 2, 3, 4, 6, 8):
                        n = _forced(name, args[0], args[1], force)[1]
                        rec["split_sweep"][str(n)] = dict(
                            n_split=n, ms=_time_ms(
                                lambda n=n: _forced(name, args[0], args[1],
                                                    n), flush))
                    rec["split_sweep"]["default"] = dict(
                        n_split=rec["n_split"], ms=rec["ms"])
            del args, got
            torch.cuda.synchronize()
        out[name][f"{what} {shape}"] = rec
        planted = "".join(f", planted '{k}' {v:.2e}"
                          for k, v in rec["planted"].items())
        older = (f", old kernel {rec['old_ms']:.4f} ms (max err "
                 f"{rec['old_max_abs_err']:.2e})" if old is not None else "")
        if "head_groups_bfloat16" in rec:
            older += (f", head groups float32 {rec['head_groups_float32']} "
                      f"bfloat16 {rec['head_groups_bfloat16']}, n_split "
                      f"float32 {rec['n_split_float32']} bfloat16 "
                      f"{rec['n_split_bfloat16']}")
        if sweep:
            older += "; by n_split " + ", ".join(
                f"{r['n_split']}{' (default)' if k == 'default' else ''} "
                f"{r['ms']:.4f} ms" for k, r in rec["split_sweep"].items())
        say(f"  {name} {shape} {what}: ok, max err float32 "
            f"{rec['max_abs_err_float32']:.2e}, bfloat16 "
            f"{rec['max_abs_err_bfloat16']:.2e}; bfloat16 vs float32 plain: "
            f"row excess {rec['bf16_excess']:.2e} <= {BF16_ROW_TOL}{planted}; "
            f"bf16 kernel ({rec['variant']}) {rec['ms']:.4f} ms, bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), plain "
            f"{rec['plain_ms']:.4f} ms, sdpa {rec['library_ms']:.4f} ms"
            f"{older} ({CARD['card']})")
        return rec

    def q_tail_zeroed(args):
        """q's dims 64..79 zeroed: the real columns of a D = 80 head's
        second 64-column chunk"""
        q = args[0][0].clone()
        q[..., 64:80] = 0
        return (q, *args[0][1:]), args[1]

    tail = ("q dims 64..79 zeroed", q_tail_zeroed)

    def q_heads8_zeroed(args):
        """q's heads 8..15 of every KV group zeroed: rows 8..15 of the
        tensor-core body's m16 tile"""
        q, k = args[0][:2]
        B, H, D = q.shape
        qz = q.clone().view(B, k.shape[2], H // k.shape[2], D)
        qz[:, :, 8:] = 0
        return (qz.view(B, H, D), *args[0][1:]), args[1]

    heads8 = ("q heads 8..15 zeroed", q_heads8_zeroed)

    # -- K1
    P = prompt_len
    fcases = [("h2o-danube-1.8b", (1, 33, 33, 32, 8, 80), True, 4096),
              ("h2o-danube-1.8b", (1, 4200, 4200, 32, 8, 80), True, 4096),
              ("whisper-small cross", (8, 33, 1500, 12, 12, 64), False, None),
              ("whisper-small encoder", (8, 1500, 1500, 12, 12, 64), False,
               None),
              ("hymba-1.5b", (8, P, P, 25, 5, 64), True, 1024),
              ("hymba-1.5b", (1, 1100, 1100, 25, 5, 64), True, 1024),
              ("starcoder2-15b G=12", (8, P, P, 48, 4, 128), True, None),
              ("qwen3-moe G=16", (8, P, P, 64, 4, 128), True, None),
              ("qwen3-moe G=16 train", (8, 160, 160, 64, 4, 128), True,
               None)]
    # planted faults, each a wrong call the bfloat16 check must reject: the
    # window one key short, or the keys of the last partial 64-key tile
    # (1500 = 23 x 64 + 28) left out
    def short_window(args):
        q, k, v, causal, window = args[0]
        return (q, k, v, causal, window - 1), {}

    def last_tile_dropped(args):
        q, k, v, causal, window = args[0]
        keep = k.shape[1] - k.shape[1] % 64
        return (q, k[:, :keep].contiguous(), v[:, :keep].contiguous(),
                causal, window), {}

    faults = {"h2o-danube-1.8b": [("window 4095", short_window)],
              "hymba-1.5b": [("window 1023", short_window)],
              "whisper-small cross": [("keys past 1472 dropped",
                                       last_tile_dropped)],
              "whisper-small encoder": [("keys past 1472 dropped",
                                         last_tile_dropped)]}
    for what, shape, causal, window in fcases:
        B, Sq, Sk, H, Hkv, D = shape

        def call(dtype, shape=shape, causal=causal, window=window):
            q, k, v = flash_case(*shape, dtype, gen)
            return (q, k, v, causal, window), {}

        def sdpa(args, Sq=Sq, Sk=Sk, causal=causal, window=window):
            q, k, v = (x.transpose(1, 2).contiguous() for x in args[0][:3])
            i = torch.arange(Sq, device=DEV)[:, None]
            j = torch.arange(Sk, device=DEV)[None]
            ok = (j <= i) if causal else torch.ones_like(i * j, dtype=bool)
            if window is not None:
                ok = ok & (j > i - window)
            return lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=ok, enable_gqa=True)

        hold("flash_attention_fwd", flash_attention, shape,
             f"{what} causal={causal} window={window}", call,
             flash_attention_ref, sdpa,
             lambda item, shape=shape, causal=causal, window=window:
             flash_work(*shape, causal, window, item),
             (faults.get(what, []) if window is None or Sq > window else [])
             + ([tail] if D == 80 else []),
             expect=lambda dtype, D=D: _variant(getattr(torch, dtype), D),
             old=(lambda args: _simt_flash(*args[0])) if D == 80 else None)

    # -- K3
    dcases = [("h2o-danube-1.8b ring", 32, 8, 80, 4096, 4096,
               [3000, 4100, 4200, 5000]),
              ("hymba-1.5b ring", 25, 5, 64, 1024, 1024,
               [600, 1023, 1100, 2000]),
              ("qwen3-moe G=16", 64, 4, 128, P + 32, None, [P + 31] * 8)]
    for what, H, Hkv, D, C, window, qps in dcases:
        B = len(qps)
        shape = (B, H, Hkv, D, C)

        def call(dtype, shape=shape, qps=qps, window=window):
            q, k, v, _, _ = decode_case(*shape, [shape[-1]] * shape[0],
                                        dtype, gen)
            q_pos = torch.tensor(qps, dtype=torch.int32, device=DEV)
            return (q, k, v, q_pos, _ring_pos(qps, shape[-1])), dict(
                window=window)

        def sdpa(args, window=window):
            q, k, v, q_pos, k_pos = args[0]
            qt = q[:, :, None]
            kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
            ok = (k_pos >= 0) & (k_pos <= q_pos[:, None])
            if window is not None:
                ok = ok & (k_pos > q_pos[:, None] - window)
            return lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=ok[:, None, None], enable_gqa=True)

        def dshort(args):
            return args[0], dict(window=args[1]["window"] - 1)

        attended = [min(qp + 1, C) for qp in qps]
        hold("flash_decode", decode_attention, shape, what, call,
             decode_attention_ref, sdpa,
             lambda item, shape=shape, attended=attended:
             decode_work(*shape, attended, item),
             ([(f"window {window - 1}", dshort)] if window else [])
             + ([tail] if D == 80 else [])
             + ([heads8] if H // Hkv > 8 else []),
             expect=lambda dtype, D=D: _decode_body(getattr(torch, dtype), D,
                                                    True),
             old=(lambda args: _core_decode(*args[0], **args[1]))
             if D == 80 else None, sweep=D == 80)
    # whisper's cross-attention decode: every frame visible to a query at
    # position Se - 1
    shape = (8, 12, 12, 64, 1500)

    def xcall(dtype):
        q, k, v, _, _ = decode_case(*shape, [1500] * 8, dtype, gen)
        q_pos = torch.full((8,), 1499, dtype=torch.int32, device=DEV)
        k_pos = torch.arange(1500, dtype=torch.int32,
                             device=DEV).expand(8, 1500).contiguous()
        return (q, k, v, q_pos, k_pos), {}

    def xsdpa(args):
        q, k, v = args[0][:3]
        kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
        return lambda: F.scaled_dot_product_attention(q[:, :, None], kt, vt)

    def xdropped(args):
        """the last partial 16-slot tile (1500 = 93 x 16 + 12) left out"""
        q, k, v, q_pos, k_pos = args[0]
        return (q, *(x[:, :1488].contiguous() for x in (k, v)), q_pos,
                k_pos[:, :1488].contiguous()), {}

    hold("flash_decode", decode_attention, shape, "whisper-small cross",
         xcall, decode_attention_ref, xsdpa,
         lambda item: decode_work(*shape, [1500] * 8, item),
         [("frames past 1488 dropped", xdropped)],
         expect=lambda dtype: _decode_body(getattr(torch, dtype), 64, True))

    # -- K2: D = 80, window 4096, lengths past it, pages of 128
    lens = [4200, 4500, 300, 4097]
    page = 128
    maxp = -(-max(lens) // page)
    pshape = (4, 32, 8, 80, page, maxp)

    def pcall(dtype):
        return paged_case(*pshape, lens, dtype, gen), dict(window=4096)

    def psdpa(args):
        q, kp, vp, bt, lengths = args[0]
        kd, vd = (x[bt.long()].reshape(4, maxp * page, 8, 80)
                  .transpose(1, 2).contiguous() for x in (kp, vp))
        j = torch.arange(maxp * page, device=DEV)[None]
        ok = (j < lengths[:, None]) & (j >= lengths[:, None] - 4096)
        return lambda: F.scaled_dot_product_attention(
            q[:, :, None], kd, vd, attn_mask=ok[:, None, None],
            enable_gqa=True)

    attended = [min(n, 4096) for n in lens]
    hold("paged_flash_decode", paged_decode_attention, pshape,
         "h2o-danube-1.8b window=4096", pcall, paged_decode_attention_ref,
         psdpa, lambda item: (
             item * 80 * (2 * 4 * 32 + 2 * 8 * sum(attended))
             + 4 * 4 * (maxp + 1), 4.0 * 80 * 32 * sum(attended)),
         [("window 4095", lambda args: (args[0], dict(window=4095))), tail],
         expect=lambda dtype: _decode_body(getattr(torch, dtype), 80, True),
         old=lambda args: _core_paged(*args[0], **args[1]), sweep=True)
    say("kernels at the families' shapes: "
        + ", ".join(f"{k} {len(v)} shapes" for k, v in out.items())
        + " hold to their plain versions in float32 and bfloat16")
    return out


def _family_inputs(cfg, B, S, seed):
    """(tokens [B, S] int64, extra model inputs) on the CPU: random prompt
    tokens, and whisper's frames / internvl2's patches."""
    import torch
    gen = torch.Generator(device="cpu").manual_seed(seed)
    toks = torch.randint(3, cfg.vocab, (B, S), generator=gen)
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = torch.randn((B, cfg.encoder_seq, cfg.enc_dim),
                                      generator=gen)
    if cfg.family == "vlm":
        extra["patches"] = torch.randn((B, cfg.encoder_seq, cfg.enc_dim),
                                       generator=gen)
    return toks, extra


def family_teacher_forced_phase(arch, n_layers, B, S, steps, smoke=False):
    """``arch`` in float32 on the card and the CPU from the same params (the
    published width cut to ``n_layers``, or the smoke config): prefill of
    a B x S prompt (with frames / patches) and ``steps`` decode steps fed
    the CPU's greedy tokens.  Logits within 1e-3 of max |logit| and the
    greedy tokens identical at every step; exact K1 / K3 launches."""
    import torch
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels.decode_attention.ops import _decode_body
    from repro_torch.models.api import get_model

    cfg = (get_smoke_config(arch) if smoke else get_config(arch)).replace(
        n_layers=n_layers, dtype="float32")
    model = get_model(cfg)
    on_card = model.init(1, cfg, DEV)
    on_cpu = params_from_jax(on_card.tree(), "cpu")
    toks, extra = _family_inputs(cfg, B, S, seed=3)
    k1, k3 = _attn_sites(cfg)
    worst, what = 0.0, f"teacher-forced {arch} ({n_layers} layers" + (
        ", smoke width" if smoke else "") + f", B={B}, S={S}, float32)"

    def run(params, dev, feed):
        """Prefill, then the decode steps fed ``feed`` (or, for None, the
        run's own greedy tokens): (logits per step, fed tokens)."""
        lg, cache = model.prefill(params, cfg, toks.to(dev), max_len=S + steps,
                                  **{k: v.to(dev) for k, v in extra.items()})
        logits, fed = [lg.float().cpu()], []
        for t in range(steps):
            tok = (torch.argmax(logits[-1][:, :cfg.vocab], -1).to(torch.int32)
                   if feed is None else feed[t])
            fed.append(tok)
            pos = torch.full((B,), S + t, dtype=torch.int32)
            lg, cache = model.decode_step(params, cfg, cache, tok.to(dev),
                                          pos.to(dev))
            logits.append(lg.float().cpu())
        return logits, fed

    with torch.inference_mode():
        want_logits, fed = run(on_cpu, "cpu", None)
        _reset_counts()
        got_logits, _ = run(on_card, DEV, fed)
    counts = _read_counts()
    for t, (a, b) in enumerate(zip(got_logits, want_logits)):
        rel = float((a - b).abs().max() / b.abs().max())
        worst = max(worst, rel)
        if not (torch.isfinite(a).all() and rel <= 1e-3):
            fail(f"{what} step {t}: max |card - cpu| / max |cpu| = "
                 f"{rel:.3e} > 1e-3")
        got, want = (torch.argmax(x[:, :cfg.vocab], -1) for x in (a, b))
        if not torch.equal(got, want):
            top = torch.topk(b[:, :cfg.vocab], 2).values
            fail(f"{what} step {t}: greedy tokens differ (card "
                 f"{got.tolist()}, cpu {want.tolist()}; cpu top-2 gaps "
                 f"{(top[:, 0] - top[:, 1]).tolist()})")
    counts = _read_counts()
    want = {"flash_attention_fwd": k1, "flash_decode": k3 * steps,
            "paged_flash_decode": 0, "mlstm_scan": 0}
    if counts != want:
        fail(f"{what}: kernel launches {counts}, expected {want}")
    _expect_decode_bodies(what, _decode_body(torch.float32, cfg.hd, True))
    say(f"{what}, prefill + {steps} decode steps: worst max |card - cpu| / "
        f"max |cpu| = {worst:.2e} <= 1e-3, greedy tokens identical; "
        f"launches {counts}")
    del on_card, on_cpu
    torch.cuda.empty_cache()
    return dict(worst_rel=worst, launches=counts)


def families_teacher_forced_phase():
    """Every family card against CPU: 2 layers at the published width (1
    for qwen3-moe; grok-1 at its smoke width: one of its layers is about
    23 GB in float32 on the host).  h2o-danube prefills 4200 tokens past
    its 4096 window and hymba 1100 past its 1024, so their ring caches and
    window masks act; whisper runs with frames [2, 1500, 768], internvl2
    with patches [2, 256, 1024] (its 300-token prompt longer than the
    patches it replaces)."""
    runs = [("qwen2.5-3b", 2, 2, 40, 6, False),
            ("h2o-danube-1.8b", 2, 1, 4200, 6, False),
            ("starcoder2-15b", 2, 2, 40, 6, False),
            ("yi-34b", 2, 2, 40, 6, False),
            ("internvl2-2b", 2, 2, 300, 6, False),
            ("qwen3-moe-235b-a22b", 1, 2, 40, 4, False),
            ("grok-1-314b", 2, 2, 40, 6, True),
            ("hymba-1.5b", 2, 1, 1100, 6, False),
            ("whisper-small", 2, 2, 40, 6, False)]
    return {arch: family_teacher_forced_phase(arch, *rest)
            for arch, *rest in runs}


def _weights_split(params):
    """(bytes of the stacked layer leaves, bytes of everything else)."""
    layer = other = 0
    for name, p in params.named_parameters():
        n = p.numel() * p.element_size()
        if name.startswith("layers.") or name.startswith("enc_layers."):
            layer += n
        else:
            other += n
    return layer, other


def _serve_config(arch):
    """The published config at its serving depth, and a line saying so:
    the published depth, or the largest under SERVE_BYTES of bf16
    weights."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    layers = SERVE_LAYERS.get(arch, cfg.n_layers)
    return cfg.replace(n_layers=layers), cfg.n_layers


def _timed(m, n_tok, dt):
    return dict(tokens=n_tok, seconds=dt, tok_per_s=n_tok / dt,
                gen_tok_per_s=n_tok / (m["prefill_s"] + m["decode_s"]),
                fetch_ms=m["fetch_s"] * 1e3, prefill_ms=m["prefill_s"] * 1e3,
                decode_ms_per_step=m["decode_s"] * 1e3 / m["decode_steps"],
                decode_steps=m["decode_steps"])


def _whisper_generate(params, cfg, tokens, frames, max_new):
    """Greedy generation the way whisper is served (no engine passes
    frames): ``prefill(frames=...)`` then ``decode_step``.  Returns (token
    ids [B, max_new], metrics with the engine's names)."""
    import torch
    from repro_torch.models import whisper
    B, S = tokens.shape
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = whisper.prefill(params, cfg, tokens,
                                        max_len=S + max_new, frames=frames)
        tok = torch.argmax(logits[:, :cfg.vocab], -1).to(torch.int32)
        out = [tok.cpu()]
        t1 = time.perf_counter()
        for t in range(1, max_new):
            pos = torch.full((B,), S + t - 1, dtype=torch.int32, device=DEV)
            logits, cache = whisper.decode_step(params, cfg, cache, tok, pos)
            tok = torch.argmax(logits[:, :cfg.vocab], -1).to(torch.int32)
            out.append(tok.cpu())
        t2 = time.perf_counter()
    return torch.stack(out, 1), dict(fetch_s=0.0, prefill_s=t1 - t0,
                                     decode_s=t2 - t1,
                                     decode_steps=max_new - 1)


def _decode_bodies(what, arch, name, cfg, n, slots, batch=8):
    """K3's or K2's launches by block body since the last _reset_counts().
    h2o-danube (D = 80) must have run all ``n`` on the tensor-core body,
    as ``_decode_body`` names it for the config's dtype and head dim; the
    other families' counts are reported.  Every family's launches must
    have run in the head groups ``_head_groups`` gives the body that ran
    them at 1 to ``batch`` rows over 1 to ``slots`` cache slots (rounded
    up to a page of 128; ``_launch_groups`` at the extremes): starcoder2-
    15b (G 12) and qwen3-moe (G 16) at B 8 over short rows in two groups
    of 8 on the tensor cores, whose one-group launch would leave SMs
    idle."""
    import torch
    from repro_torch.kernels import tuning
    from repro_torch.kernels.decode_attention.ops import (
        _decode_body, _launch_groups, _resident, _sm_count)
    wrapper = _wrappers()[name]
    got = dict(wrapper.launches_by_variant)
    body = _decode_body(cfg.tdtype, cfg.hd, True)
    want = {b: n * (b == body) for b in got}
    if arch == "h2o-danube-1.8b" and (got != want or body != "mma"):
        fail(f"{what}: {name} launches by body {got}, expected {want} on "
             "the tensor-core body")
    ran = [b for b, k in got.items() if k]
    groups = dict(wrapper.launches_by_groups)
    knob = "decode_attention" if name == "flash_decode" else \
        "paged_attention"
    min_tiles = tuning.resolve(knob, "min_split_tiles", None)
    dev = torch.device(DEV)
    ngs = sorted({_launch_groups(b, cfg.n_heads // cfg.n_kv_heads,
                                 cfg.n_kv_heads, cfg.hd, c, _sm_count(dev),
                                 _resident(name, dev, cfg.tdtype, cfg.hd,
                                           ran[0], True),
                                 min_tiles, ran[0])[0]
                  for b in (1, batch)
                  for c in (1, slots, -(-slots // 128) * 128)}) \
        if len(ran) == 1 else []
    if (len(ran) != 1 or sum(groups.values()) != n
            or not set(groups) <= set(ngs)
            or (len(ngs) == 1 and groups != {ngs[0]: n})):
        fail(f"{what}: {name} launches by head groups {groups}, expected "
             f"{n} in {ngs} (bodies {got})")
    say(f"{what}: {name} launches by head groups {groups}, by split count "
        f"{dict(wrapper.launches_by_splits)} (G "
        f"{cfg.n_heads // cfg.n_kv_heads}, body {ran})")
    return got


def danube_prefill_phase(S=4200):
    """h2o-danube-1.8b's published config (bfloat16, 24 layers, random
    init on the card) prefills one S-token prompt, past its 4096 window:
    a warm-up, three timed prefills (host clock, synchronised; the
    median) with one K1 launch a layer, all on the tensor-core kernel,
    finite logits, and a profiled one whose trace gives K1's device ms and
    the device's busy time (torch.profiler).  Returns the summary."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.api import get_model

    arch = "h2o-danube-1.8b"
    cfg, _ = _serve_config(arch)
    model = get_model(cfg)
    k1, _ = _attn_sites(cfg)
    params = model.init(0, cfg, DEV)
    toks = _family_inputs(cfg, 1, S, seed=4)[0].to(DEV)
    what = f"{arch} bf16 prefill B=1 S={S} ({cfg.n_layers} layers)"
    times = []
    with torch.inference_mode():
        model.prefill(params, cfg, toks, max_len=S + 1)           # warm-up
        for _ in range(3):
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            logits, cache = model.prefill(params, cfg, toks, max_len=S + 1)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            del cache
        counts = _read_counts()
        want = {"flash_attention_fwd": k1, "flash_decode": 0,
                "paged_flash_decode": 0, "mlstm_scan": 0}
        if counts != want:
            fail(f"{what}: kernel launches {counts}, expected {want}")
        _expect_variants(what, {"simt": 0, "wgmma": k1})
        if not bool(torch.isfinite(logits.float()).all()):
            fail(f"{what}: logits not finite")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.prefill(params, cfg, toks, max_len=S + 1)
            torch.cuda.synchronize()
    kernels = _trace_kernels(prof, "danube_prefill")
    mine = [e - s for s, e, name in kernels if "flash_fwd_sm90" in name]
    if len(mine) != k1:
        fail(f"{what}: the trace holds {len(mine)} tensor-core K1 kernels, "
             f"expected {k1}")
    busy = _busy(kernels, kernels[0][0], 1)
    out = dict(layers=cfg.n_layers, prompt=S, host_ms=statistics.median(times),
               host_ms_runs=times, k1_launches=k1,
               k1_device_ms=sum(mine) / 1e3,
               k1_device_ms_per_launch=sum(mine) / 1e3 / k1,
               device_busy_ms=busy["busy_ms"], idle_share=busy["idle_share"],
               top_kernels_ms=busy["top_kernels_ms"])
    say(f"{what}: host {out['host_ms']:.2f} ms (median of "
        f"{', '.join(f'{t:.2f}' for t in times)}); K1 {k1} launches, all "
        f"wgmma, {out['k1_device_ms']:.3f} ms on the device "
        f"({out['k1_device_ms_per_launch']:.4f} a launch); device busy "
        f"{out['device_busy_ms']:.3f} ms, idle share "
        f"{out['idle_share']:.3f}; top kernels ms "
        + ", ".join(f"{k} {v:.3f}" for k, v in out["top_kernels_ms"].items())
        + f" ({CARD['card']})")
    del params, logits
    torch.cuda.empty_cache()
    return out


def family_serve_phase(arch, paged=False):
    """``arch``'s published config (bfloat16, full vocab and width, random
    init on the card) at its serving depth, B = 8 math prompts, 32 new
    tokens, greedy.  The weights are made on the card, published to the
    host store and freed, then ``RolloutEngine`` fetches them (whisper:
    ``prefill(frames=...)`` and ``decode_step`` with frames [8, 1500,
    768], kept on the card).  A warm-up, a timed run with exact K1 / K3
    launches, and a profiled run of 9 new tokens (device busy time and
    idle share of a decode step).  ``paged``: then ``PagedEngine`` over 8
    slots, 2 tasks x group 8, exact K2 launches.  Returns the summary."""
    import torch
    from repro_torch.data.tasks import MathTaskGenerator, Tokenizer
    from repro_torch.kernels.flash_attention.ops import _variant
    from repro_torch.models.api import get_model
    from repro_torch.rl.rollout import GenConfig, RolloutEngine
    from repro_torch.rl.weight_sync import WeightStore

    cfg, published = _serve_config(arch)
    model = get_model(cfg)
    k1, k3 = _attn_sites(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(0, cfg, DEV)
    layer_b, other_b = _weights_split(params)
    weights = layer_b + other_b
    per_layer = layer_b / cfg.n_layers
    if weights > SERVE_BYTES or (cfg.n_layers < published and
                                 weights + per_layer <= SERVE_BYTES):
        fail(f"{arch}: {cfg.n_layers} of {published} layers hold "
             f"{weights / 2 ** 30:.2f} GiB; not the largest depth under "
             f"{SERVE_BYTES / 2 ** 30:.0f} GiB")
    out = dict(layers=cfg.n_layers, published_layers=published,
               params=sum(p.numel() for p in params.parameters()),
               weight_gib=weights / 2 ** 30)
    cut = ("full depth" if cfg.n_layers == published else
           f"cut to {cfg.n_layers} of {published} layers, the most under "
           f"{SERVE_BYTES / 2 ** 30:.0f} GiB of bf16 weights")
    tasks = MathTaskGenerator(seed=0).batch(8)
    variant = _variant(cfg.tdtype, cfg.hd)
    what = f"{arch} bf16 B=8 ({cut})"

    if cfg.family == "encdec":
        plen = max(len(t.prompt_ids) for t in tasks)
        toks = torch.full((8, plen), Tokenizer.PAD, dtype=torch.long)
        for i, t in enumerate(tasks):
            toks[i, plen - len(t.prompt_ids):] = torch.tensor(t.prompt_ids)
        toks = toks.to(DEV)
        gen = torch.Generator(device=DEV).manual_seed(0)
        frames = torch.randn((8, cfg.encoder_seq, cfg.enc_dim),
                             generator=gen, device=DEV).to(cfg.tdtype)
        _whisper_generate(params, cfg, toks, frames, 2)          # warm-up
        _reset_counts()
        t0 = time.perf_counter()
        ids, m = _whisper_generate(params, cfg, toks, frames, 32)
        dt = time.perf_counter() - t0
        counts = _read_counts()
        n_tok = ids.numel()
        if not (0 <= int(ids.min()) and int(ids.max()) < cfg.vocab):
            fail(f"{what}: token ids out of range")
        out["completions"] = ids[:2, :8].tolist()

        def profiled():
            return None, _whisper_generate(params, cfg, toks, frames, 9)[1]
    else:
        store = WeightStore()
        store.publish(params)
        del params
        torch.cuda.empty_cache()
        engine = RolloutEngine(cfg, store, GenConfig(max_new_tokens=2,
                                                     greedy=True),
                               device=DEV)
        engine.generate(tasks)                                    # warm-up
        engine.gen = GenConfig(max_new_tokens=32, greedy=True)
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        rollouts, m = engine.generate(tasks)
        dt = time.perf_counter() - t0
        counts = _read_counts()
        _check_rollouts(what, rollouts, cfg.vocab, 32)
        n_tok = sum(len(r.completion_ids) for r in rollouts)
        out["completions"] = [r.completion_ids[:8] for r in rollouts[:2]]

        def profiled():
            engine.gen = GenConfig(max_new_tokens=9, greedy=True)
            return engine.generate(tasks)
    want = {"flash_attention_fwd": k1, "flash_decode": k3 * m["decode_steps"],
            "paged_flash_decode": 0, "mlstm_scan": 0}
    if counts != want or m["decode_steps"] < 1:
        fail(f"{what}: kernel launches {counts}, expected {want} (one "
             f"prefill, {m['decode_steps']} decode steps)")
    _expect_variants(what, {variant: k1})
    bodies = _decode_bodies(what, arch, "flash_decode", cfg,
                            k3 * m["decode_steps"],
                            max(len(t.prompt_ids) for t in tasks) + 32)
    if cfg.family == "encdec":
        # the cross-attention launches, one a layer a step over the 1500
        # frames, at the pinned split count
        by_splits = dict(_wrappers()["flash_decode"].launches_by_splits)
        pinned = PINNED_SPLITS["whisper-small cross"]
        if by_splits.get(pinned, 0) < cfg.n_layers * m["decode_steps"]:
            fail(f"{what}: K3 launches by split count {by_splits}, expected "
                 f"at least {cfg.n_layers * m['decode_steps']} (the "
                 f"cross-attention's) at the pinned {pinned}")
    out["static"] = dict(_timed(m, n_tok, dt), launches=counts,
                         k1_variant=variant, k3_by_body=bodies,
                         k3_by_groups=dict(
                             _wrappers()["flash_decode"].launches_by_groups))
    s = out["static"]
    say(f"{what} max_new=32: {n_tok} tokens in {dt:.3f} s = "
        f"{s['tok_per_s']:.1f} tok/s ({s['gen_tok_per_s']:.1f} without the "
        f"weight fetch); fetch {s['fetch_ms']:.1f} ms ({out['weight_gib']:.2f}"
        f" GiB), prefill {s['prefill_ms']:.2f} ms, decode "
        f"{s['decode_ms_per_step']:.3f} ms/step over {m['decode_steps']} "
        f"steps (host clock); launches {counts} (= {k1} per prefill, {k3} "
        f"per decode step), K1 on {variant}, K3 by body {bodies} "
        f"({CARD['card']})")
    out["static"]["profile"] = profile_decode(
        profiled, "decode_(mma_)?kernel<.*DenseRows", arch)
    engine = profiled = None              # the static engine's weights go

    if paged:
        out["paged"] = _family_paged(arch, cfg, store, tasks)
    torch.cuda.empty_cache()
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def _family_paged(arch, cfg, store, tasks):
    """``PagedEngine`` on the fetched weights: 8 slots over pages of 128,
    2 tasks x group 8, 32 new tokens, greedy; exact K2 launches."""
    import torch
    from repro_torch.rl.rollout import GenConfig
    from repro_torch.serve import PagedEngine, ServeConfig

    plen = max(len(t.prompt_ids) for t in tasks)
    clock = SpanClock()
    engine = PagedEngine(cfg, store, GenConfig(max_new_tokens=2, greedy=True),
                         ServeConfig(max_slots=8, max_len=plen + 32,
                                     page_size=128),
                         tracer=clock, device=DEV)
    engine.generate_groups(tasks[:1], 2)                          # warm-up
    engine.gen = GenConfig(max_new_tokens=32, greedy=True)
    torch.cuda.synchronize()
    clock.reset()
    _reset_counts()
    t0 = time.perf_counter()
    rollouts, m = engine.generate_groups(tasks[:2], 8)
    dt = time.perf_counter() - t0
    what = f"{arch} PagedEngine bf16 2 tasks x 8, slots=8"
    counts = _read_counts()
    _expect_paged_counts(what, cfg.n_layers, m["decode_steps"], counts)
    bodies = _decode_bodies(what, arch, "paged_flash_decode", cfg,
                            cfg.n_layers * m["decode_steps"], plen + 32)
    _check_rollouts(what, rollouts, cfg.vocab, 32)
    n_tok = sum(len(r.completion_ids) for r in rollouts)
    steps = clock.count["decode_step"]
    out = dict(tokens=n_tok, seconds=dt, tok_per_s=n_tok / dt,
               decode_steps=m["decode_steps"],
               decode_ms_per_step=clock.total["decode_step"] * 1e3 / steps,
               prefill_ms=clock.total.get("prefill_chunk", 0.0) * 1e3,
               forks=m["forks"], launches=counts, k2_by_body=bodies,
               k2_by_groups=dict(
                   _wrappers()["paged_flash_decode"].launches_by_groups))
    say(f"{what} max_new=32: {n_tok} tokens in {dt:.3f} s = "
        f"{out['tok_per_s']:.1f} tok/s; decode {out['decode_ms_per_step']:.3f}"
        f" ms/step over {steps} steps, prefill {out['prefill_ms']:.2f} ms "
        f"(host clock); forks {m['forks']}; launches {counts}, K2 by body "
        f"{bodies}")
    del engine
    return out


def family_step_phase(arch, n_layers=None):
    """A timed bf16 GRPO train step of ``arch``'s published config (remat,
    random init on the card) at the launcher's batch, 8 x 160 with 48
    response tokens, ``n_layers`` deep (default: the published depth): a
    warm-up step, two timed steps and a profiled one (device busy time and
    idle share).  Every step launches K1 twice per layer (the forward and
    the remat recompute), all on the tensor-core kernel; loss and grad
    norm must be finite and the params must move (the embedding, wq, bq,
    the router and the three expert stacks, where the config has them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models.api import get_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.rl.grpo import make_train_step

    cfg = get_config(arch)
    cfg = cfg.replace(n_layers=n_layers or cfg.n_layers)
    what = f"{arch} bf16 train step ({cfg.n_layers} layers, B=8 S=160)"
    opt = AdamWConfig(lr=3e-5)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = get_model(cfg).init(0, cfg, DEV)
    params.requires_grad_(True)
    state = adamw_init(params, opt)
    batch = _train_batch(cfg, 8, 160, 112, DEV)
    # the first 64 columns of each watched leaf (whole copies of the expert
    # stacks would add GiBs to the peak memory the step reports)
    watch = {name: p.detach()[..., :64].clone()
             for name, p in params.named_parameters()
             if name in ("embed", "layers.attn.wq", "layers.attn.bq",
                         "layers.router", "layers.experts.w_gate",
                         "layers.experts.w_up", "layers.experts.w_down")}
    step = make_train_step(cfg, opt)
    want = {"flash_attention_fwd": 2 * cfg.n_layers, "flash_decode": 0,
            "paged_flash_decode": 0, "mlstm_scan": 0}
    times, losses, gnorms = [], [], []
    for i in range(3):
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, m = step(params, state, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        gnorms.append(gnorm)
        counts = _read_counts()
        if counts != want or not (math.isfinite(loss)
                                  and math.isfinite(gnorm) and gnorm > 0):
            fail(f"{what}: launches {counts} (expected {want}), loss {loss}, "
                 f"grad_norm {gnorm}")
        variants = _expect_variants(f"{what} {i + 1}",
                                    {"simt": 0, "wgmma": 2 * cfg.n_layers})
    moved = {name: float((p.detach()[..., :64] - watch[name]).abs().max())
             for name, p in params.named_parameters() if name in watch}
    if not moved or min(moved.values()) <= 0:
        fail(f"{what}: params did not move: {moved}")
    out = dict(step_ms=times[1:], warmup_ms=times[0], losses=losses,
               grad_norms=gnorms, launches=counts["flash_attention_fwd"],
               launches_by_variant=variants, moved=moved,
               params=sum(p.numel() for p in params.parameters()),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    say(f"{what}: {out['params'] / 1e9:.3f} B params, "
        f"{' / '.join(f'{t:.1f}' for t in times)} ms (first is warm-up; host "
        f"clock, synchronised), K1 launches {out['launches']} per step "
        f"({variants}), losses {losses}, grad norms {gnorms}, params moved "
        f"(max |change| {moved}), peak memory {out['peak_mem_gib']:.2f} GiB "
        f"({CARD['card']})")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(params, state, batch)
        torch.cuda.synchronize()
    kernels = _trace_kernels(prof, f"{arch}_train_step")
    if kernels:
        out["profile"] = p = _busy(kernels, kernels[0][0], 1)
        say(f"profile {what} (torch.profiler): window {p['window_ms']:.1f} "
            f"ms, device busy {p['busy_ms']:.1f} ms, idle share "
            f"{p['idle_share']:.3f}; top kernels ms " + ", ".join(
                f"{k} {v:.2f}" for k, v in p["top_kernels_ms"].items()))
    else:
        say(f"profile {what}: the trace holds no kernel: device busy share "
            "not measured")
    del params, state, watch
    torch.cuda.empty_cache()
    return out


def families_launcher_phase():
    """The launchers with the new families' ``--arch`` on the card, as a
    user runs them (float32, the tokenizer's vocab): ``launch.serve`` of
    hymba-1.5b at its published size through ``RolloutEngine`` and of
    h2o-danube-1.8b through ``PagedEngine``; ``launch.train`` (the
    ``AsyncGRPOTrainer``) for 2 steps of hymba-1.5b at its published size
    and of qwen3-moe's smoke config.  Exact kernel launches, rollouts in
    range, finite losses and grad norms.  Returns the summaries."""
    import torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.tasks import Tokenizer
    from repro_torch.kernels.decode_attention.ops import _decode_body
    from repro_torch.launch import serve, train

    out = {}
    vocab = Tokenizer().vocab_size
    for arch, engine in (("hymba-1.5b", "static"),
                         ("h2o-danube-1.8b", "paged")):
        argv = ["--arch", arch, "--engine", engine, "--greedy", "--quiet"]
        what = "serve.run " + " ".join(argv[:4])
        _reset_counts()
        r = serve.run(argv)
        counts = _read_counts()
        n_layers = get_config(arch).n_layers
        if engine == "paged":
            _expect_paged_counts(what, n_layers, r["decode_steps"], counts)
        else:
            _expect_counts(what, n_layers, r["decode_steps"], counts)
        _expect_decode_bodies(what, _decode_body(
            torch.float32, get_config(arch).hd, True))
        _check_rollouts(what, r["rollouts"], vocab, 32)
        out[what] = dict(tokens=r["tokens"], seconds=r["seconds"],
                         tok_per_s=r["tok_per_s"],
                         decode_steps=r["decode_steps"], launches=counts)
        say(f"{what}: {r['tokens']} tokens in {r['seconds']:.2f} s "
            f"({r['tok_per_s']:.1f} tok/s, host clock; {CARD['card']})")
        del r
        torch.cuda.empty_cache()
    for arch, smoke in (("hymba-1.5b", False),
                        ("qwen3-moe-235b-a22b", True)):
        argv = ["--arch", arch, "--steps", "2", "--quiet"] + (
            ["--smoke"] if smoke else [])
        what = "train.run " + " ".join(argv)
        _reset_counts()
        r = train.run(argv)
        counts = _read_counts()
        _expect_train_counts(what, get_config(arch).family, r["n_layers"], r,
                             counts)
        _expect_decode_bodies(what, _decode_body(torch.float32, (
            get_smoke_config(arch) if smoke else get_config(arch)).hd, True))
        hist = r["steps"]
        if len(hist) != 2 or not all(
                math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                for m in hist):
            fail(f"{what}: steps {[(m['loss'], m['grad_norm']) for m in hist]}")
        out[what] = dict(seconds=r["seconds"], launches=counts, steps=[
            {k: m[k] for k in ("loss", "grad_norm", "train_s", "produce_s")}
            for m in hist])
        say(f"{what}: {r['seconds']:.2f} s, (loss, grad_norm) per step "
            + ", ".join(f"({m['loss']:.5f}, {m['grad_norm']:.4f})"
                        for m in hist) + f" ({CARD['card']})")
        del r
        torch.cuda.empty_cache()
    return out


def families(records, prompt_len):
    """Phase 5: the other model families on the card (their kernel shapes,
    card against CPU, serving, the launchers, two train steps); their
    launches go into ``records``."""
    for name, part in families_kernel_phase(prompt_len).items():
        records[name]["families"] = part
    records["flash_attention_fwd"]["danube_prefill"] = danube_prefill_phase()
    say("families teacher-forced summary " + json.dumps(
        families_teacher_forced_phase()))
    for arch in FAMILY_ARCHS:
        out = family_serve_phase(arch, paged=arch in ("h2o-danube-1.8b",
                                                      "starcoder2-15b"))
        say(f"{arch} serve summary " + json.dumps(dict(out, **CARD)))
        for name in ("flash_attention_fwd", "flash_decode"):
            records[name].setdefault("serve_launches", {})[arch] = (
                out["static"]["launches"][name])
        records["flash_decode"].setdefault("serve_launches_by_body", {})[
            arch] = out["static"]["k3_by_body"]
        records["flash_decode"].setdefault("serve_launches_by_groups", {})[
            arch] = out["static"]["k3_by_groups"]
        if "paged" in out:
            records["paged_flash_decode"].setdefault("serve_launches", {})[
                arch] = out["paged"]["launches"]["paged_flash_decode"]
            records["paged_flash_decode"].setdefault(
                "serve_launches_by_body", {})[arch] = out["paged"][
                    "k2_by_body"]
            records["paged_flash_decode"].setdefault(
                "serve_launches_by_groups", {})[arch] = out["paged"][
                    "k2_by_groups"]
    say("families launcher summary " + json.dumps(
        dict(families_launcher_phase(), **CARD)))
    for arch, n_layers in (("qwen2.5-3b", None), ("qwen3-moe-235b-a22b", 1)):
        out = family_step_phase(arch, n_layers)
        say(f"{arch} train step summary " + json.dumps(dict(out, **CARD)))
        records["flash_attention_fwd"].setdefault(
            "train_step_launches", {})[arch] = out["launches"]


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
    records.update(ssm_kernel_phase(160))
    resident = resident_check()
    for name in ("flash_decode", "paged_flash_decode"):
        records[name]["resident"] = resident[name]
    for name, part in gqa_phase(prompt_len, 128).items():
        records[name]["gqa_groups"] = part
    flash_grad_phase()
    tuned_summary, tuned = autotune_phase()
    say("autotune summary " + json.dumps(dict(tuned_summary, **CARD)))
    for name, entry in tuned.items():
        records[name]["tuned"] = entry
    counts, gen = serve_phase()
    records["flash_attention_fwd"]["launches"] = counts["flash_attention_fwd"]
    # the serving path: serve.run in float32, the timed generate in bf16
    by_variant = {v: sum(run[v] for run in
                         gen["flash_launches_by_variant"].values())
                  for v in ("simt", "wgmma", "tf32x3")}
    if min(by_variant["wgmma"], by_variant["tf32x3"]) < 1:
        fail(f"a K1 kernel was not launched on the serving path: {by_variant}")
    records["flash_attention_fwd"]["launches_by_variant"] = by_variant
    records["flash_attention_fwd_tf32x3"]["launches"] = by_variant["tf32x3"]
    records["flash_decode"]["launches"] = counts["flash_decode"]
    say("serve summary " + json.dumps(gen))
    records["paged_flash_decode"]["launches"], paged, measured = (
        paged_serve_phase())
    say("paged serve summary " + json.dumps(paged))
    fed_summary, fed = schedule_feedback_phase(measured)
    say("schedule feedback summary " + json.dumps(dict(fed_summary, **CARD)))
    say("sim summary " + json.dumps(sim_phase(fed)))
    mon, snap = monitor_phase()
    say("monitor summary " + json.dumps(dict(mon, **CARD)))
    rec = recovery_phase(snap)
    say("recovery summary " + json.dumps(dict(rec, **CARD)))
    for name in ("flash_attention_fwd", "paged_flash_decode"):
        records[name]["monitored_launches"] = mon["launches"][name]
    records["flash_attention_fwd_tf32x3"]["monitored_launches"] = (
        mon["trainer_k1_by_variant"]["tf32x3"])
    train = train_phase()
    # the launcher's float32 xlstm run: every scan on the 3xTF32 kernel
    records["mlstm_scan_tf32x3"]["launches"] = records["mlstm_scan_tf32x3"][
        "train_launches"] = train["xlstm-1.3b"][2]["tf32x3"]
    for name, rec in records.items():
        # launches on the dense training path for the attention kernels;
        # K4's records count their own kernel's (above and below)
        if name != "mlstm_scan" and name in train[ARCH][0]:
            rec["train_launches"] = train[ARCH][0][name]
    records["flash_attention_fwd_tf32x3"]["train_launches"] = (
        train[ARCH][3]["tf32x3"])
    for arch, (_, summary, _, _) in train.items():
        say(f"train summary {arch} " + json.dumps(summary))
    step = xlstm_step_phase()
    say("xlstm train step summary " + json.dumps(step))
    # K4 by kernel over the training runs: the float32 launcher run and the
    # published-config (bf16) step; "simt" serves no D of xlstm-1.3b
    scan_by_variant = {v: train["xlstm-1.3b"][2][v]
                       + step["launches_by_variant"][v]
                       for v in ("simt", "mma", "tf32x3")}
    if min(scan_by_variant["mma"], scan_by_variant["tf32x3"]) < 1:
        fail(f"a K4 kernel was not launched on the training path: "
             f"{scan_by_variant}")
    records["mlstm_scan"]["launches"] = records["mlstm_scan"][
        "train_launches"] = step["launches_by_variant"]["mma"]
    records["mlstm_scan"]["launches_by_variant"] = scan_by_variant
    qstep = qwen_step_phase()
    say("qwen train step summary " + json.dumps(dict(qstep, **CARD)))
    records["flash_attention_fwd"]["train_step_launches_by_variant"] = (
        qstep["launches_by_variant"])
    records["flash_attention_fwd_tf32x3"]["train_step_launches"] = (
        qstep["f32_launches_by_variant"]["tf32x3"])
    par = parallel_phase()
    records.update(par.pop("hd"))
    say("parallel summary " + json.dumps(dict(par, **CARD)))
    hd = hd_decode_phase()
    say("head-dim split decode summary " + json.dumps(dict(hd, **CARD)))
    for name, n in hd["bf16"]["launches"].items():
        records[name]["launches"] = n
        records[name]["launches_by_variant"] = (
            hd["bf16"]["launches_by_variant"][name])
        records[name]["float32_launches"] = hd["f32"]["launches"][name]
        records[name]["float32_launches_by_variant"] = (
            hd["f32"]["launches_by_variant"][name])
    # the timer's repair: K3 whole at the main decode shape read in phase 2
    # and again inside parallel_phase (hd_phase)
    k3_first = records["flash_decode"]["ms"]
    k3_par = records["decode_scores"]["main"]["bfloat16"]["K3_whole"]["ms"]
    records["flash_decode"]["ms_in_parallel_phase"] = k3_par
    say(f"K3 whole bf16 B=32 C={prompt_len + 128}: {k3_first:.4f} ms in "
        f"phase 2, {k3_par:.4f} ms inside parallel_phase (ratio "
        f"{k3_par / k3_first:.3f}, "
        f"{'within' if abs(k3_par / k3_first - 1) <= 0.2 else 'NOT within'}"
        f" 20%); {CARD['card']}")
    # counted in the sharded runs: K1 over the 3 train steps, K3 over the
    # 4 serve steps
    records["flash_attention_fwd"]["sharded_train_launches"] = (
        par["train"]["launches"])
    records["flash_decode"]["sharded_serve_launches"] = (
        par["serve"]["launches"])
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
    families(records, prompt_len)
    # K3's and K2's launches by block body on every path that held them
    # (_expect_decode_bodies): float32 at D 64 / 80 / 128 all on the 3xTF32
    # body, bf16 there all on the mma body
    for name in ("flash_decode", "paged_flash_decode"):
        paths = {what: got[name] for what, got in DECODE_BODIES.items()
                 if sum(got[name].values())}
        records[name]["launches_by_body"] = paths
        records[name]["float32_launches"] = f32 = sum(
            by["tf32x3"] for by in paths.values())
        if f32 < 1:
            fail(f"{name}: no launch on the float32 tensor-core body on a "
                 f"float32 path ({paths})")
        say(f"{name}: launches by body on its paths {json.dumps(paths)}")
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
