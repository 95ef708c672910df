"""Times K3's two head-dim passes (``decode_scores``, ``decode_softmax_pv``,
``csrc/decode_hd.cu``) on one GPU with the ``repro_torch`` of each source
tree given, to compare versions of their bodies in one run.

    python3 tools/decode_hd_ab.py TREE [TREE ...] [--out FILE]

Each TREE is the root of a checkout (``src/repro_torch`` inside it).  The
trees' ``decode_hd`` libraries are built first, all at once, into
``TREE/build``; then each tree is timed in a fresh subprocess with
``TREE/src`` first on the path, in the order given, so ``parent change
change parent`` compares two commits on the same card.

Cells, in bfloat16 and float32, over one slice of the head dim taken
contiguous (as a rank holds it), the scores of pass 2 the plain pass 1's
over the whole head dim:

* qwen-distill-1.5B (12 / 2 heads, D 128, every slot attended) at B 64 x
  C 8192 and B 32 x C 161 (the smoke's decode shape), at m 2 and 16
  slices (Dl 64 and 8);
* starcoder2's G 12 (48 / 4 heads, D 128) at B 4 x C 700, rows attending
  0, 700, 311 and 5 slots (``chip_smoke.py::_hd_extra_check``'s case), at
  m 2, 4 and 16.

Each pass: the wrapper (``ms``, its body named), the first design's
``"simt"`` body through the uncounted launchers (``simt_ms``), the plain
version (``plain_ms``); pass 1 also one ``torch.einsum`` of q . k^T
(``einsum_ms``).  At G 12 pass 2 is also timed as two launches over the
two 6-head halves of each KV head's group (``halves_ms``): the same grid
in units of at most 8 heads, each reading the V slice, as a design of
8-row units would (the halves' scores copied out before timing).

Each time is the median of 20 launches, L2 flushed before each
(``autotune.bench.time_on_device``).  Prints one JSON line per tree with
the card's name and power limit, then (with more than one tree) each
tree's wrapper times against the first tree's, and writes the runs to
``--out``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import torch

REPS = 20
EMPTY = -(2 ** 30)
# (name, B, H, Hkv, D, C, attended slots of each row or None: all, m's)
CELLS = [("1.5B long", 64, 12, 2, 128, 8192, None, (2, 16)),
         ("1.5B main", 32, 12, 2, 128, 161, None, (2, 16)),
         ("G12", 4, 48, 4, 128, 700, (0, 700, 311, 5), (2, 4, 16))]
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _child_build() -> None:
    from repro_torch.kernels import _build
    _build._finish({"decode_hd": _build._start("decode_hd")})


def _child_time() -> dict:
    from repro_torch.autotune.bench import time_on_device
    from repro_torch.kernels.decode_attention import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")

    def ms(fn):
        fn()
        return time_on_device(fn, flush, REPS) * 1e3

    out = {}
    for name, B, H, Hkv, D, C, rows, ms_ in CELLS:
        valid = [C] * B if rows is None else list(rows)
        q_pos = torch.tensor([max(n, 1) - 1 for n in valid],
                             dtype=torch.int32, device="cuda")
        slot = torch.arange(C, dtype=torch.int32, device="cuda")[None]
        k_pos = torch.where(slot < torch.tensor(valid, device="cuda")[:, None],
                            slot, EMPTY).to(torch.int32).contiguous()
        for dname, dtype in DTYPES.items():
            q = torch.randn(B, H, D, generator=gen, device="cuda").to(dtype)
            k = torch.randn(B, C, Hkv, D, generator=gen,
                            device="cuda").to(dtype)
            v = torch.randn(B, C, Hkv, D, generator=gen,
                            device="cuda").to(dtype)
            s = ops.decode_scores_ref(q, k, scale=D ** -0.5)
            for m in ms_:
                Dl = D // m
                qs, ks, vs = (x[..., :Dl].contiguous() for x in (q, k, v))
                qg = qs.reshape(B, Hkv, H // Hkv, Dl)
                first = ops._scores_variant(qs, ks)
                second = ops._variant(vs.dtype, Dl, (vs,), ops._pv_geometry(
                    B, C, H, Hkv, Dl, vs.element_size(),
                    ops._sm_count(vs.device)) is not None)
                r1 = dict(
                    body=first,
                    ms=ms(lambda: ops.decode_scores(qs, ks, scale=D ** -0.5)),
                    simt_ms=ms(lambda: ops._launch_scores(qs, ks, D ** -0.5,
                                                          "simt")),
                    plain_ms=ms(lambda: ops.decode_scores_ref(
                        qs, ks, scale=D ** -0.5)),
                    einsum_ms=ms(lambda: torch.einsum("bhgd,bchd->bhgc", qg,
                                                      ks)))
                r2 = dict(
                    body=second,
                    ms=ms(lambda: ops.decode_softmax_pv(s, vs, q_pos, k_pos)),
                    n_split=ops.decode_softmax_pv.last_n_split,
                    simt_ms=ms(lambda: ops._launch_softmax_pv(
                        s, vs, q_pos, k_pos, None, "simt")),
                    plain_ms=ms(lambda: ops.decode_softmax_pv_ref(
                        s, vs, q_pos, k_pos)))
                if H // Hkv > 8:
                    half = H // Hkv // 2
                    sg = s.view(B, Hkv, 2, half, C)
                    parts = [sg[:, :, i].reshape(B, Hkv * half, C).contiguous()
                             for i in range(2)]

                    def halves():
                        for part in parts:
                            ops.decode_softmax_pv(part, vs, q_pos, k_pos)
                    r2["halves_ms"] = ms(halves)
                    del parts
                key = f"{name} {(B, H, Hkv, D, C)} {dname} m={m}"
                out[f"decode_scores {key}"] = r1
                out[f"decode_softmax_pv {key}"] = r2
                del qs, ks, vs, qg
            del q, k, v, s
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
    return out


def _compare(runs) -> dict:
    """Each tree's wrapper times against the first tree's, cell by cell
    (the mean of each tree's runs): the geometric mean of the ratios, by
    dtype, and every ratio."""
    times = {}
    for run in runs:
        for key, rec in run["times"].items():
            times.setdefault(run["tree"], {}).setdefault(key, []).append(
                rec["ms"])
    base = {k: sum(v) / len(v) for k, v in times.pop(runs[0]["tree"]).items()}
    out = {}
    for tree, cells in times.items():
        ratio = {k: sum(v) / len(v) / base[k] for k, v in cells.items()}
        out[tree] = dict(ratio={k: round(r, 4) for k, r in ratio.items()},
                         **{f"geomean_{d}": math.exp(sum(
                             math.log(r) for k, r in ratio.items()
                             if f" {d} " in k) / sum(
                             f" {d} " in k for k in ratio))
                            for d in DTYPES})
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--out")
    ap.add_argument("--child", choices=("build", "time"))
    args = ap.parse_args()
    if args.child == "build":
        _child_build()
        return
    if args.child == "time":
        print(json.dumps(_child_time()), flush=True)
        return
    me = str(Path(__file__).resolve())

    def env(tree):
        return dict(os.environ, PYTHONPATH=str(Path(tree).resolve() / "src"))

    builds = [subprocess.Popen([sys.executable, me, "--child", "build"],
                               env=env(t)) for t in dict.fromkeys(args.trees)]
    if any(p.wait() for p in builds):
        sys.exit("decode_hd_ab: a build failed")
    card, runs = _card(), []
    for tree in args.trees:
        res = subprocess.run([sys.executable, me, "--child", "time"],
                             env=env(tree), capture_output=True, text=True)
        if res.returncode:
            sys.exit(f"decode_hd_ab: {tree} failed:\n{res.stderr}")
        runs.append(dict(tree=tree, card=card,
                         times=json.loads(res.stdout.splitlines()[-1])))
        print(json.dumps(runs[-1]), flush=True)
    if len(set(args.trees)) > 1:
        print(json.dumps(dict(against=args.trees[0], **_compare(runs))))
    if args.out:
        Path(args.out).write_text(json.dumps(runs, indent=1))


if __name__ == "__main__":
    main()
