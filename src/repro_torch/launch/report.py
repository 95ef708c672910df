"""The dry-run status, roofline and multi-pod tables from
experiments/dryrun_torch/*.json, the port of ``repro.launch.report``.

    PYTHONPATH=src python -m repro_torch.launch.report [--update PATH]

--update PATH rewrites the AUTOGEN block inside the markdown file PATH in
place (between the BEGIN / END markers below).  Every time in the tables
is modelled from the H100 SXM5 data sheet (``launch.roofline``), not
measured.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
RESULTS = ROOT / "experiments" / "dryrun_torch"

BEGIN = "<!-- AUTOGEN:DRYRUN BEGIN -->"
END = "<!-- AUTOGEN:DRYRUN END -->"

ARCH_ORDER = ["h2o-danube-1.8b", "starcoder2-15b", "yi-34b", "qwen2.5-3b",
              "whisper-small", "qwen3-moe-235b-a22b", "grok-1-314b",
              "xlstm-1.3b", "internvl2-2b", "hymba-1.5b",
              "qwen-distill-1.5b", "qwen-distill-7b", "qwen-distill-14b"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load():
    """Baseline cells only — hillclimb variants carry a __<tag> suffix
    (and an "overrides" field) and are reported in §Perf, not here."""
    cells = {}
    for p in sorted(RESULTS.glob("*.json")):
        c = json.loads(p.read_text())
        if c.get("overrides") or len(p.stem.split("__")) > 3:
            continue
        cells[(c["arch"], c["shape"], c["mesh"])] = c
    return cells


def fmt_s(x):
    if x is None:
        return "—"
    if x >= 0.01:
        return f"{x:.3f}"
    return f"{x:.2e}"


def tables() -> str:
    cells = load()
    out = []
    # ---- dry-run status matrix
    out.append("### Dry-run status (meta-device trace pass/fail per cell)\n")
    out.append("| arch | " + " | ".join(
        f"{s} (1pod / 2pod)" for s in SHAPE_ORDER) + " |")
    out.append("|---|" + "---|" * len(SHAPE_ORDER))
    for a in ARCH_ORDER:
        row = [a]
        for s in SHAPE_ORDER:
            marks = []
            for m in ("single", "multi"):
                c = cells.get((a, s, m))
                if c is None:
                    marks.append("…")
                elif c["status"] == "ok":
                    marks.append("✓")
                elif c["status"] == "skipped":
                    marks.append("n/a")
                else:
                    marks.append("✗")
            row.append(" / ".join(marks))
        out.append("| " + " | ".join(row) + " |")
    n_ok = sum(1 for c in cells.values() if c["status"] == "ok")
    n_skip = sum(1 for c in cells.values() if c["status"] == "skipped")
    out.append(f"\n{n_ok} cells traced, {n_skip} recorded n/a "
               "(long_500k × full-attention archs, per assignment).\n")

    # ---- roofline table (single-pod)
    out.append("### Roofline terms (single-pod 16×16; modelled, H100 SXM5 "
               "data sheet)\n")
    out.append("| arch | shape | compute s | memory s | collective s | "
               "bottleneck | MODEL/HLO | mem/dev GB | dominant collectives |")
    out.append("|---|---|---|---|---|---|---|---|---|")
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            c = cells.get((a, s, "single"))
            if not c or c["status"] != "ok":
                continue
            r = c["roofline"]
            colls = sorted(r["collectives"].items(), key=lambda kv: -kv[1])
            coll_s = ", ".join(f"{k} {v:.1f}GB" for k, v in colls[:2])
            out.append(
                f"| {a} | {s} | {fmt_s(r['t_compute'])} | "
                f"{fmt_s(r['t_memory'])} | {fmt_s(r['t_collective'])} | "
                f"{r['bottleneck']} | {r['useful_flops_ratio']:.2f} | "
                f"{(r.get('memory_per_dev_gb') or 0):.1f} | {coll_s} |")
    out.append("")

    # ---- multi-pod deltas
    out.append("### Multi-pod (2×16×16) deltas vs single-pod\n")
    out.append("| arch | shape | collective s (1pod → 2pod) | "
               "mem/dev GB (1pod → 2pod) |")
    out.append("|---|---|---|---|")
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            c1 = cells.get((a, s, "single"))
            c2 = cells.get((a, s, "multi"))
            if not (c1 and c2 and c1["status"] == c2["status"] == "ok"):
                continue
            r1, r2 = c1["roofline"], c2["roofline"]
            out.append(
                f"| {a} | {s} | {fmt_s(r1['t_collective'])} → "
                f"{fmt_s(r2['t_collective'])} | "
                f"{(r1.get('memory_per_dev_gb') or 0):.1f} → "
                f"{(r2.get('memory_per_dev_gb') or 0):.1f} |")
    out.append("")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.report")
    ap.add_argument("--update", metavar="PATH",
                    help="markdown file whose AUTOGEN block to rewrite")
    args = ap.parse_args(argv)
    text = tables()
    if args.update:
        path = Path(args.update)
        doc = path.read_text()
        pre, rest = doc.split(BEGIN, 1)
        _, post = rest.split(END, 1)
        path.write_text(pre + BEGIN + "\n" + text + "\n" + END + post)
        print(f"updated {path}")
    else:
        print(text)


if __name__ == "__main__":
    main()
