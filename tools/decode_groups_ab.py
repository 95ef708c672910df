"""Times K3 (``decode_attention``) and K2 (``paged_decode_attention``) in
bfloat16 on one GPU with the ``repro_torch`` of each source tree given, to
compare versions of the split-decode kernels (``csrc/split_decode.cuh``)
in one run.

    python3 tools/decode_groups_ab.py TREE [TREE ...] [--grid] [--out FILE]

Each TREE is the root of a checkout (``src/repro_torch`` inside it).  The
trees' kernels are built first, all at once, into ``TREE/build``; then
each tree is timed in a fresh subprocess with ``TREE/src`` first on the
path, in the order given, so ``parent change change parent`` compares two
commits on the same card.  Shapes (D 128 unless named; every slot valid,
no window; K2 over pages of 128 through shuffled block tables):

* G <= 8: qwen-distill-1.5B's 12 / 2 heads at B 32 x C 161 and B 64 x
  8192, h2o-danube's 32 / 8 heads at D 80, B 4 x 4096;
* G 12 (starcoder2-15b, 48 / 4) and 16 (qwen3-moe, 64 / 4): the serve
  shape B 8 x C 65, B 32 x C 161 and B 64 x 8192;
* with ``--grid``, also G 12 and 16 at D 128 and G 12 at D 64 (Hkv 4) at
  every B in 1, 2, 4, 8, 16, 32, 64 and C in 65, 161, 512, 1024, 2048,
  4096, 8192.

At G > 8, where the tree's launchers take explicit head groups
(``decode_attention.ops._cut``), the same body is also timed in one head
group and in two (uncounted ``_launch``, each at the split count the
wrappers' rule takes for those groups), beside the wrapper, whose groups
and split count are recorded.

Each time is the median of 50 launches, L2 flushed before each
(``autotune.bench.time_on_device``).  Prints one JSON line per tree with
the card's name and power limit, and writes the list to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

# (name, B, H, Hkv, D, C)
SHAPES = [("1.5B main", 32, 12, 2, 128, 161),
          ("1.5B long", 64, 12, 2, 128, 8192),
          ("danube D80", 4, 32, 8, 80, 4096),
          ("G12 serve", 8, 48, 4, 128, 65),
          ("G12 main", 32, 48, 4, 128, 161),
          ("G12 long", 64, 48, 4, 128, 8192),
          ("G16 serve", 8, 64, 4, 128, 65),
          ("G16 main", 32, 64, 4, 128, 161),
          ("G16 long", 64, 64, 4, 128, 8192)]
PAGE = 128
REPS = 50


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _child_build() -> None:
    from repro_torch.kernels import _build
    _build._finish({name: _build._start(name)
                    for name in ("flash_decode", "paged_flash_decode")})


GRID = [("grid", B, G * 4, 4, D, C) for G, D in ((12, 128), (16, 128),
                                                 (12, 64))
        for B in (1, 2, 4, 8, 16, 32, 64)
        for C in (65, 161, 512, 1024, 2048, 4096, 8192)]


def _child_time(grid: bool) -> dict:
    import math

    import torch
    from repro_torch.autotune.bench import time_on_device
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.paged_attention import ops as pops

    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    explicit = hasattr(ops, "_cut")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for name, B, H, Hkv, D, C in SHAPES + (GRID if grid else []):
        def rand(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(
                torch.bfloat16)
        q = rand(B, H, D)
        k, v = rand(B, C, Hkv, D), rand(B, C, Hkv, D)
        q_pos = torch.full((B,), C - 1, dtype=torch.int32, device="cuda")
        k_pos = torch.arange(C, dtype=torch.int32, device="cuda").expand(
            B, C).contiguous()
        maxp = -(-C // PAGE)
        P = B * maxp + 1
        kp, vp = rand(P, PAGE, Hkv, D), rand(P, PAGE, Hkv, D)
        bt = (torch.randperm(P - 1, generator=gen, device="cuda")[:B * maxp]
              + 1).reshape(B, maxp).to(torch.int32).contiguous()
        lengths = torch.full((B,), C, dtype=torch.int32, device="cuda")
        dense, paged = (q, k, v, q_pos, k_pos), (q, kp, vp, bt, lengths)
        G, scale = H // Hkv, 1.0 / math.sqrt(D)
        wrappers = {"K3": (ops.decode_attention, dense),
                    "K2": (pops.paged_decode_attention, paged)}
        for kernel, (wrapper, args) in wrappers.items():
            call = lambda: wrapper(*args)   # noqa: E731
            call()
            rec = {"ms": time_on_device(call, flush, REPS) * 1e3,
                   "n_split": wrapper.last_n_split}
            if explicit and G > 8:
                rec["head_groups"] = wrapper.last_groups[0]
                for label, ng in (("one_group", 1), ("two_group", 2)):
                    groups = ops._cut(G, ng)
                    if kernel == "K3":
                        n = ops._launch_splits(B, H, Hkv, D, C, q.dtype,
                                               n_sm, None, "mma", groups)
                        launch = (lambda n=n, ng=ng: ops._launch(
                            *args, None, scale, n, "mma", ng))
                    else:
                        n = pops._paged_splits(B, Hkv, maxp, PAGE, None,
                                               q.dtype, D, n_sm, G, None,
                                               "mma", groups)
                        launch = (lambda n=n, ng=ng: pops._launch(
                            *args, None, scale, n, "mma", ng))
                    rec[f"{label}_ms"] = time_on_device(launch, flush,
                                                        REPS) * 1e3
                    rec[f"{label}_n_split"] = n
            out[f"{kernel} {name} {(B, H, Hkv, D, C)}"] = rec
        del q, k, v, kp, vp, dense, paged, args
        torch.cuda.synchronize()
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--out")
    ap.add_argument("--grid", action="store_true")
    ap.add_argument("--child", choices=("build", "time"))
    args = ap.parse_args()
    if args.child == "build":
        _child_build()
        return
    if args.child == "time":
        print(json.dumps(_child_time(args.grid)), flush=True)
        return
    me = str(Path(__file__).resolve())

    def env(tree):
        return dict(os.environ, PYTHONPATH=str(Path(tree).resolve() / "src"))

    builds = [subprocess.Popen([sys.executable, me, "--child", "build"],
                               env=env(t)) for t in dict.fromkeys(args.trees)]
    if any(p.wait() for p in builds):
        sys.exit("decode_groups_ab: a build failed")
    card, runs = _card(), []
    for tree in args.trees:
        res = subprocess.run([sys.executable, me, "--child", "time"]
                             + ["--grid"] * args.grid, env=env(tree),
                             capture_output=True, text=True)
        if res.returncode:
            sys.exit(f"decode_groups_ab: {tree} failed:\n{res.stderr}")
        runs.append(dict(tree=tree, card=card,
                         times=json.loads(res.stdout.splitlines()[-1])))
        print(json.dumps(runs[-1]), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(runs, indent=1))


if __name__ == "__main__":
    main()
