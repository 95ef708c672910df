"""Times K3 (``decode_attention``) and K2 (``paged_decode_attention``) in
bfloat16 (or float32, ``--dtype``) on one GPU with the ``repro_torch`` of
each source tree given, to compare versions of the split-decode kernels
(``csrc/split_decode.cuh``) and their split rule in one run.

    python3 tools/decode_groups_ab.py TREE [TREE ...] [--grid] [--splits]
                                      [--dtype float32] [--out FILE]

Each TREE is the root of a checkout (``src/repro_torch`` inside it).  The
trees' kernels are built first, all at once, into ``TREE/build``; then
each tree is timed in a fresh subprocess with ``TREE/src`` first on the
path, in the order given, so ``parent change change parent`` compares two
commits on the same card.  Shapes (D 128 unless named; every slot valid,
no window unless named; K2 over pages of 128 through shuffled block
tables):

* G <= 8: qwen-distill-1.5B's 12 / 2 heads at B 32 x C 161 and B 64 x
  8192, h2o-danube's 32 / 8 heads at D 80, B 4 x 4096;
* G 12 (starcoder2-15b, 48 / 4) and 16 (qwen3-moe, 64 / 4): the serve
  shape B 8 x C 65, B 32 x C 161 and B 64 x 8192;
* the serve shapes of ``chip_smoke.py``: whisper-small's cross-attention
  decode (B 8, 12 / 12 heads, D 64, 1500 frames), danube's ring (B 4,
  4096 slots, window 4096, queries at 3000, 4100, 4200 and 5000) and
  paged rows (lengths 4200, 4500, 300, 4097, window 4096), and the 1.5B
  paged step (32 slots of 2 pages, lengths 33 to 161; K2 only, given the
  longest length where the tree's wrapper takes ``max_len``);
* with ``--grid``, also G 12 and 16 at D 128 and G 12 at D 64 (Hkv 4) at
  every B in 1, 2, 4, 8, 16, 32, 64 and C in 65, 161, 512, 1024, 2048,
  4096, 8192.

With ``--dtype float32`` the same shapes run on the body
``_decode_body`` names for float32 (the float32 tensor-core body
``"tf32x3"`` at D 64 / 80 / 128, where the tree has one; the CUDA-core
body otherwise), and ``--grid`` is instead G 6 (Hkv 2) at D 128 and 64
and G 12 (Hkv 4) at D 128, at every B above and C in 161, 512, 1024,
2048, 4096, 8192.

Each record holds the wrapper's time, split count, head groups and the
blocks an SM holds of its body at those groups.  At G > 8 on the bf16
tensor-core body the same body is also timed in one head group and in
two (uncounted ``_launch``, each at the split count the tree's rule takes
for those groups).  With ``--splits`` every split count from 1 to
min(tiles, 16) is timed too (in float32 also every multiple of 4 up to
64), through the uncounted ``_launch``, at the wrapper's head groups
(``split_ms``), and at G > 8 on the tensor-core body in one group and in
two (``split_ms_by_groups``), each cell's body named (``body``); each
tree's line then says in how many cells the pick is within 5% of the
fastest count at its groups.

Each time is the median of 50 launches (20 for a split count), L2
flushed before each (``autotune.bench.time_on_device``).  Prints one JSON
line per tree with the card's name and power limit, then (with more than
one tree) each tree's times against the first tree's, and writes the
runs to ``--out``.  On any machine, no card:

    PYTHONPATH=src python3 tools/decode_groups_ab.py --compare RUNS_JSON
    PYTHONPATH=src python3 tools/decode_groups_ab.py --replay SWEEP_JSON \
        [SWEEP_JSON ...] [--heldout]

``--compare`` prints a saved run's comparison again.  ``--replay``
replays the split rule of the ``repro_torch`` on the path on the pooled
times of ``--splits`` runs: in how many cells the head groups and count
it gives are within 5% of the fastest count (of every count timed, and
of the counts it may take), and its geometric mean against each tree's
pick; ``--heldout`` adds a cross-validation of its constants against
the simplest rule (``_heldout``).
"""
from __future__ import annotations

import argparse
import inspect
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import torch

# (name, B, H, Hkv, D, C, window, rows): rows are K3's query positions
# (a ring cache of C slots written up to them) and K2's lengths; None:
# every slot valid
SHAPES = [("1.5B main", 32, 12, 2, 128, 161, None, None),
          ("1.5B long", 64, 12, 2, 128, 8192, None, None),
          ("danube D80", 4, 32, 8, 80, 4096, None, None),
          ("G12 serve", 8, 48, 4, 128, 65, None, None),
          ("G12 main", 32, 48, 4, 128, 161, None, None),
          ("G12 long", 64, 48, 4, 128, 8192, None, None),
          ("G16 serve", 8, 64, 4, 128, 65, None, None),
          ("G16 main", 32, 64, 4, 128, 161, None, None),
          ("G16 long", 64, 64, 4, 128, 8192, None, None),
          ("whisper cross", 8, 12, 12, 64, 1500, None, None)]
# K3 only, K2 only
DENSE = [("danube ring", 4, 32, 8, 80, 4096, 4096, [3000, 4100, 4200, 5000])]
PAGED = [("danube paged", 4, 32, 8, 80, 4608, 4096, [4200, 4500, 300, 4097]),
         ("1.5B paged step", 32, 12, 2, 128, 256, None,
          [33 + (128 * i) // 31 for i in range(32)])]
PAGE = 128
REPS = 50
SPLIT_REPS = 20
# the split counts a sweep times: every count up to 16, and in float32
# (whose bodies' rules may take more) the multiples of 4 beyond, to 64
SPLIT_COUNTS = {torch.bfloat16: range(1, 17),
                torch.float32: list(range(1, 17)) + list(range(20, 65, 4))}
EMPTY = -(2 ** 30)
def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _child_build() -> None:
    from repro_torch.kernels import _build
    _build._finish({name: _build._start(name)
                    for name in ("flash_decode", "paged_flash_decode")})


GRID = [("grid", B, G * 4, 4, D, C, None, None)
        for G, D in ((12, 128), (16, 128), (12, 64))
        for B in (1, 2, 4, 8, 16, 32, 64)
        for C in (65, 161, 512, 1024, 2048, 4096, 8192)]
GRID_F32 = [("grid", B, G * Hkv, Hkv, D, C, None, None)
            for G, Hkv, D in ((6, 2, 128), (6, 2, 64), (12, 4, 128))
            for B in (1, 2, 4, 8, 16, 32, 64)
            for C in (161, 512, 1024, 2048, 4096, 8192)]
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _rule_splits(kernel, ops, pops, B, H, Hkv, D, C, maxp, groups, dev):
    """The split count the tree's rule gives one bfloat16 launch in
    ``groups``: with the blocks an SM holds (``ops._resident``) where the
    tree has them, else through the rule of the trees before it."""
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    if hasattr(ops, "_resident"):
        entry = "flash_decode" if kernel == "K3" else "paged_flash_decode"
        res = ops._resident(entry, dev, torch.bfloat16, D, "mma", True)
        if kernel == "K3":
            return ops._launch_splits(B, H, Hkv, D, C, n_sm, res, None,
                                      "mma", groups)
        return pops._paged_splits(B, Hkv, D, maxp, PAGE, None, n_sm, res,
                                  H // Hkv, None, "mma", groups)
    if kernel == "K3":
        return ops._launch_splits(B, H, Hkv, D, C, torch.bfloat16, n_sm,
                                  None, "mma", groups)
    return pops._paged_splits(B, Hkv, maxp, PAGE, None, torch.bfloat16, D,
                              n_sm, H // Hkv, None, "mma", groups)


def _cases(name, B, H, Hkv, D, C, window, rows, gen, dtype):
    """The K3 and K2 calls of one cell: {kernel: (wrapper args, kwargs)}."""
    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    out = {}
    q = rand(B, H, D)
    if (name, B, H, Hkv, D, C, window, rows) not in PAGED:
        k, v = rand(B, C, Hkv, D), rand(B, C, Hkv, D)
        if rows is None:
            q_pos = torch.full((B,), C - 1, dtype=torch.int32, device="cuda")
            k_pos = torch.arange(C, dtype=torch.int32, device="cuda").expand(
                B, C).contiguous()
        else:
            q_pos = torch.tensor(rows, dtype=torch.int32, device="cuda")
            k_pos = torch.tensor(
                [[s if s <= qp else EMPTY for s in range(C)] if qp < C
                 else [qp - ((qp - s) % C) for s in range(C)]
                 for qp in rows], dtype=torch.int32, device="cuda")
        out["K3"] = ((q, k, v, q_pos, k_pos), dict(window=window))
    if (name, B, H, Hkv, D, C, window, rows) not in DENSE:
        maxp = -(-C // PAGE)
        P = B * maxp + 1
        kp, vp = rand(P, PAGE, Hkv, D), rand(P, PAGE, Hkv, D)
        bt = (torch.randperm(P - 1, generator=gen, device="cuda")[:B * maxp]
              + 1).reshape(B, maxp).to(torch.int32).contiguous()
        lens = [C] * B if rows is None else rows
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        kw = dict(window=window)
        if "max_len" in inspect.signature(
                _paged_wrapper()).parameters:
            kw["max_len"] = max(lens)
        out["K2"] = ((q, kp, vp, bt, lengths), kw)
    return out


def _paged_wrapper():
    from repro_torch.kernels.paged_attention.ops import paged_decode_attention
    return paged_decode_attention


def _child_time(grid: bool, splits: bool, dtype: torch.dtype) -> dict:
    from repro_torch.autotune.bench import time_on_device
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.paged_attention import ops as pops

    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {}
    grid = (GRID if dtype == torch.bfloat16 else GRID_F32) if grid else []
    for cell in SHAPES + DENSE + PAGED + grid:
        name, B, H, Hkv, D, C, window, rows = cell
        G, scale = H // Hkv, 1.0 / math.sqrt(D)
        maxp = -(-C // PAGE)
        body = ops._decode_body(dtype, D, True)
        # the bf16 tensor-core body's G > 8 groups
        wide = body == "mma"
        for kernel, (args, kw) in _cases(*cell, gen, dtype).items():
            wrapper = (ops.decode_attention if kernel == "K3"
                       else pops.paged_decode_attention)
            launcher = ops._launch if kernel == "K3" else pops._launch
            call = lambda: wrapper(*args, **kw)   # noqa: E731
            call()
            rec = {"ms": time_on_device(call, flush, REPS) * 1e3,
                   "n_split": wrapper.last_n_split,
                   "head_groups": wrapper.last_groups[0], "body": body}
            ng = rec["head_groups"]
            if hasattr(ops, "_resident"):
                entry = ("flash_decode" if kernel == "K3"
                         else "paged_flash_decode")
                rec["resident"] = ops._resident(
                    entry, dev, dtype, D, body, True)(-(-G // ng))

            def launch(n, ng):
                return lambda: launcher(*args, window, scale, n, body, ng)
            if G > 8 and wide:
                for label, groups in (("one_group", 1), ("two_group", 2)):
                    n = _rule_splits(kernel, ops, pops, B, H, Hkv, D, C,
                                     maxp, ops._cut(G, groups), dev)
                    rec[f"{label}_ms"] = time_on_device(
                        launch(n, groups), flush, REPS) * 1e3
                    rec[f"{label}_n_split"] = n
            if splits:
                reach = C if kernel == "K3" else maxp * PAGE
                if window is not None:
                    reach = min(reach, window)
                counts = [n for n in SPLIT_COUNTS[dtype]
                          if n <= -(-reach // 16)]
                rec["split_ms_by_groups"] = {
                    g: {n: time_on_device(launch(n, g), flush,
                                          SPLIT_REPS) * 1e3 for n in counts}
                    for g in ((1, 2) if G > 8 and wide else (ng,))}
                rec["split_ms"] = rec["split_ms_by_groups"][ng]
            out[f"{kernel} {name} {(B, H, Hkv, D, C)}"] = rec
            del args, kw
        torch.cuda.synchronize()
    return out


def _near_best(times: dict, within: float = 0.05):
    """(cells, cells whose pick is within ``within`` of the fastest split
    count) over the records that hold a split sweep."""
    cells = hits = 0
    for rec in times.values():
        sweep = rec.get("split_ms")
        if not sweep:
            continue
        cells += 1
        pick = sweep.get(rec["n_split"], sweep.get(str(rec["n_split"])))
        hits += pick is not None and pick <= (1 + within) * min(
            sweep.values())
    return cells, hits


def _compare(runs) -> dict:
    """Each tree's wrapper times against the first tree's, cell by cell
    (the mean of each tree's runs): the geometric mean of the ratios and
    the cells more than 3% slower."""
    times = {}
    for run in runs:
        for key, rec in run["times"].items():
            times.setdefault(run["tree"], {}).setdefault(key, []).append(
                rec["ms"])
    base = {k: sum(v) / len(v) for k, v in times.pop(runs[0]["tree"]).items()}
    out = {}
    for tree, cells in times.items():
        ratio = {k: sum(v) / len(v) / base[k] for k, v in cells.items()}
        out[tree] = dict(cells=len(ratio), geomean=math.exp(
            sum(map(math.log, ratio.values())) / len(ratio)),
            slower_3pct={k: round(r, 3) for k, r in ratio.items()
                         if r > 1.03})
    return out


def _pool(paths) -> list:
    """The cells of the ``--splits`` runs in ``paths``: per (dtype, cell)
    its shape, body and the blocks an SM holds of it (as the run recorded
    them, else the H100's table of the body), its split times at each
    grouping (the mean over every tree timed) and each tree's picks (head
    groups, count, the wrapper's time)."""
    from repro_torch.kernels.decode_attention import ops
    named = {c[0]: c for c in SHAPES + DENSE + PAGED}
    cells = {}
    for path in paths:
        for run in json.loads(Path(path).read_text()):
            dtype = run.get("dtype", "bfloat16")
            for key, rec in run["times"].items():
                if not rec.get("split_ms_by_groups"):
                    continue
                B, H, Hkv, D, C = (int(x) for x in
                                   key[key.index("(") + 1:-1].split(","))
                name = key[3:key.index(" (")]
                body = rec.get("body",
                               ops._decode_body(DTYPES[dtype], D, True))
                table = (getattr(ops, "H100_RESIDENT_TF32X3", {})
                         if body == "tf32x3" else ops.H100_RESIDENT)
                cell = cells.setdefault((dtype, key), dict(
                    kernel=key[:2], shape=(B, H, Hkv, D, C),
                    window_rows=named[name][6:] if name in named
                    else (None, None), body=body, resident=table.get(D),
                    times={}, picks={}))
                if "resident" in rec:
                    cell["resident"] = rec["resident"]
                for g, sweep in rec["split_ms_by_groups"].items():
                    for n, t in sweep.items():
                        cell["times"].setdefault((int(g), int(n)),
                                                 []).append(t)
                cell["picks"].setdefault(run["tree"], []).append(
                    (rec["head_groups"], rec["n_split"], rec["ms"]))
    for cell in cells.values():
        cell["times"] = {k: sum(v) / len(v) for k, v in
                         cell["times"].items()}
    return list(cells.values())


def _rule_pick(cell, ops, pops):
    """(NG, n_split, tiles): the head groups and split count the rule of
    the ``repro_torch`` on the path gives ``cell`` on the H100 (132 SMs),
    and the tiles it counts a row walks."""
    B, H, Hkv, D, C = cell["shape"]
    window, rows = cell["window_rows"]
    res, body = (lambda gc: cell["resident"]), cell["body"]
    if cell["kernel"] == "K3":
        groups = ops._launch_groups(B, H // Hkv, Hkv, D, C, 132, res, 8,
                                    body)
        return groups[0], ops._launch_splits(B, H, Hkv, D, C, 132, res,
                                             None, body, groups), -(-C // 16)
    maxp, max_len = -(-C // PAGE), max(rows) if rows else C
    groups = pops._paged_groups(B, H // Hkv, Hkv, D, maxp, PAGE, window,
                                132, res, None, body, max_len)
    return groups[0], pops._paged_splits(
        B, Hkv, D, maxp, PAGE, window, 132, res, H // Hkv, None, body, groups,
        max_len), -(-pops._span(maxp, PAGE, window, max_len) // 16)


def _score(cells) -> dict:
    """In how many ``cells`` the rule on the path lands within 5% of the
    fastest split count at the head groups it gives: of every count timed,
    and of the counts it may take (``allowed``: at least MIN_SPLIT_TILES
    tiles a split, at most the body's MAX_SPLITS, past EVERY_COUNT
    multiples of MERGE_UNROLL); and its geometric mean against each
    tree's pick."""
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.paged_attention import ops as pops
    hits = allowed = 0
    logs = {}
    for cell in cells:
        ng, n, tiles = _rule_pick(cell, ops, pops)
        sweep = {k[1]: t for k, t in cell["times"].items() if k[0] == ng}
        mine = sweep[min(n, max(sweep))]
        hits += mine <= 1.05 * min(sweep.values())
        allowed += mine <= 1.05 * min(
            t for m, t in sweep.items()
            if m == 1 or m <= min(tiles // ops.MIN_SPLIT_TILES,
                                  ops.MAX_SPLITS[cell["body"]])
            and (m <= ops.EVERY_COUNT or m % ops.MERGE_UNROLL == 0))
        for tree, picks in cell["picks"].items():
            for ng, n, ms in picks:     # the sweep's time, else the pick's
                logs.setdefault(tree, []).append(
                    math.log(mine / cell["times"].get((ng, n), ms)))
    return dict(cells=len(cells), within_5pct=hits,
                within_5pct_allowed=allowed, geomean_vs_pick={
        t: math.exp(sum(v) / len(v)) for t, v in logs.items()})


# the constants --heldout refits on half the cells, by body, and the
# values it tries
FIT_GRID = {"mma": {"STREAM_SHARE": (0.3, 0.4, 0.5, 0.6),
                    "WIDE_DIMS": (0, 32, 64),
                    "MERGE_STEPS": (1.0, 2.0, 4.0, 6.0),
                    "MERGE_READ_STEPS": (0.25, 0.5, 0.75, 1.0)},
            "core": {"BLOCK_STEPS": (0.0, 2.0, 4.0, 8.0),
                     "MERGE_STEPS": (1.0, 2.0, 4.0, 6.0),
                     "MERGE_READ_STEPS": (0.1, 0.2, 0.3, 0.5)},
            # MERGE_STEPS is every body's: the float32 tensor-core body's
            # own constants only
            "tf32x3": {"STREAM_SHARE": (0.4, 0.6, 0.8, 1.0),
                       "BLOCK_STEPS": (0.0, 2.0, 4.0, 8.0),
                       "MERGE_READ_STEPS": (0.1, 0.2, 0.3, 0.5)}}


def _whole_waves(B, Hkv, tiles, n_sm, resident, min_tiles, rows, D,
                 body="mma"):
    """The simplest rule tried against the cost model: the whole waves of
    the blocks an SM holds that fit, every split at least ``min_tiles``
    tiles, a count past the merge's unroll rounded down to a multiple of
    it."""
    from repro_torch.kernels.decode_attention import ops
    n = max(1, min(resident * n_sm // (B * Hkv), tiles // min_tiles,
                   ops.MAX_SPLITS[body]))
    return n - n % ops.MERGE_UNROLL if n >= ops.MERGE_UNROLL else n


def _heldout(cells, body: str, reps: int = 5) -> dict:
    """Cross-validate the rule on the path over ``cells`` of one body:
    ``reps`` times, cut the cells at random into two halves, refit the
    body's constants (FIT_GRID) on one half and count the other half's
    cells within 5% of the fastest count the rule may take, and the other
    way round; beside it, the shipped constants and ``_whole_waves`` on
    the same halves."""
    import itertools
    import random
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.paged_attention import ops as pops
    grid = FIT_GRID[body]

    def put(values):
        for name, v in zip(grid, values):
            if isinstance(getattr(ops, name), dict):
                getattr(ops, name)[body] = v
            else:
                setattr(ops, name, v)

    def hits(part, values):
        put(values)
        return _score(part)["within_5pct_allowed"]

    shipped = [getattr(ops, n)[body] if isinstance(getattr(ops, n), dict)
               else getattr(ops, n) for n in grid]
    rule, rng = ops._num_splits, random.Random(0)
    out = dict(cells=0, refit=0, shipped=0, whole_waves=0, fits=[])
    try:
        for _ in range(reps):
            order = rng.sample(cells, len(cells))
            for train, test in ((order[::2], order[1::2]),
                                (order[1::2], order[::2])):
                fit = max(itertools.product(*grid.values()),
                          key=lambda v: hits(train, v))
                out["fits"].append(fit)
                out["cells"] += len(test)
                out["refit"] += hits(test, fit)
                out["shipped"] += hits(test, shipped)
                ops._num_splits = pops._num_splits = _whole_waves
                out["whole_waves"] += _score(test)["within_5pct_allowed"]
                ops._num_splits = pops._num_splits = rule
    finally:
        ops._num_splits = pops._num_splits = rule
        put(shipped)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--out")
    ap.add_argument("--grid", action="store_true")
    ap.add_argument("--splits", action="store_true")
    ap.add_argument("--dtype", choices=tuple(DTYPES), default="bfloat16")
    ap.add_argument("--child", choices=("build", "time"))
    ap.add_argument("--replay", metavar="SWEEP_JSON", nargs="+")
    ap.add_argument("--heldout", action="store_true")
    ap.add_argument("--compare", metavar="RUNS_JSON")
    args = ap.parse_args()
    if args.compare:
        print(json.dumps(_compare(json.loads(Path(args.compare)
                                             .read_text()))))
        return
    if args.replay:
        cells = _pool(args.replay)
        for body in ("mma", "tf32x3", "core"):
            mine = [c for c in cells if c["body"] == body]
            if mine:
                print(json.dumps(dict(body=body, **_score(mine))))
                if args.heldout:
                    print(json.dumps(dict(body=body, heldout=_heldout(
                        mine, body))))
        return
    if args.child == "build":
        _child_build()
        return
    if args.child == "time":
        print(json.dumps(_child_time(args.grid, args.splits,
                                     DTYPES[args.dtype])), flush=True)
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
                             + ["--grid"] * args.grid
                             + ["--splits"] * args.splits
                             + ["--dtype", args.dtype], env=env(tree),
                             capture_output=True, text=True)
        if res.returncode:
            sys.exit(f"decode_groups_ab: {tree} failed:\n{res.stderr}")
        runs.append(dict(tree=tree, card=card, dtype=args.dtype,
                         times=json.loads(res.stdout.splitlines()[-1])))
        if args.splits:
            runs[-1]["pick_within_5pct"] = _near_best(runs[-1]["times"])
        print(json.dumps(runs[-1]), flush=True)
    if len(set(args.trees)) > 1:
        print(json.dumps(dict(against=args.trees[0], **_compare(runs))))
    if args.out:
        Path(args.out).write_text(json.dumps(runs, indent=1))


if __name__ == "__main__":
    main()
