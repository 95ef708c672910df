"""Perf-regression harness: compare a run's ``BENCH_*.json`` payloads
against committed baselines with direction-aware tolerance bands (the
port's copy of ``repro.obs.regress``, host code).

Every benchmark in ``benchmarks/run.py`` emits a ``BENCH_<name>.json``
payload (``benchmarks/common.py:bench_payload``): free-form numeric
fields plus ``rows`` of ``"name,us,derived"`` CSV strings whose
``derived`` column carries ``key=value`` pairs.  This module flattens
both into a ``metric → value`` map, classifies each metric's *good*
direction from its name (throughput-like must not drop, latency-like
must not rise, unknown two-sided), and fails when the relative change
leaves the tolerance band.

Wall-clock metrics (the ``us`` CSV column, ``*_us`` keys, measured
seconds like table 5's solver times) are machine-dependent and skipped
unless ``--include-wallclock`` is passed; the gated surface is the
*deterministic* model/simulator-derived numbers.

CLI (also reachable as ``python -m repro_torch.obs regress``)::

    python -m repro_torch.obs regress --baselines benchmarks/baselines \
        --run /tmp/bench --tol 0.05 --report regress_report.json

exits 0 when every shared metric is inside its band, 2 on regression,
and prints a human (or ``--json``) report.  Regenerate baselines with
``python -m benchmarks.run --tiny --write-baselines`` (see
``benchmarks/common.py``).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from typing import Dict, List, Optional, Tuple

# key=value pairs inside a row's derived column: "throughput=42608
# tok/s", "ratio=1.16x", "hex=2.1s(paper 10.06)" all parse; units and
# parenthetical asides fall off the numeric match.
_KV_RE = re.compile(
    r"([A-Za-z_$][\w./$-]*)=([-+]?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?)")

# direction classification by substring of the *last* metric-name
# segment (checked lower-first so "stale" wins over nothing)
_LOWER_PATTERNS = ("latency", "stall", "dropped", "staleness", "stale",
                   "wait", "bubble", "cost", "evict", "preempt",
                   "copies", "uploads")
_HIGHER_PATTERNS = ("throughput", "tput", "ratio", "speedup",
                    "hit_rate", "hitrate", "g_eff", "geff", "occ",
                    "utilization", "util", "wgeo", "wsum", "reduction",
                    "identical", "coverage", "accept", "completed",
                    "t/s", "tok", "mfu", "eff")

# machine-dependent wall-clock metrics, skipped by default
_WALLCLOCK_PATTERNS = ("us", "time", "wall", "elapsed", "ours",
                       "w/o-search", "w/o-repartition", "sweep")


def classify_direction(key: str) -> str:
    """Which way is *good* for this metric: "higher", "lower", or
    "both" (unknown → two-sided band)."""
    last = key.rsplit("/", 1)[-1].lower()
    for p in _LOWER_PATTERNS:
        if p in last:
            return "lower"
    for p in _HIGHER_PATTERNS:
        if p in last:
            return "higher"
    return "both"


def is_wallclock(key: str) -> bool:
    kl = key.lower()
    last = kl.rsplit("/", 1)[-1]
    # patterns may themselves contain "/" (table 5's "w/o-search"
    # column), so also match them as whole trailing segments of the key
    return (last in _WALLCLOCK_PATTERNS
            or any(kl == p or kl.endswith("/" + p)
                   for p in _WALLCLOCK_PATTERNS)
            or last.endswith("_us") or last.endswith("_s")
            or any(last == p or last.startswith(p + "_")
                   for p in ("time", "wall", "elapsed")))


def extract_metrics(payload: Dict) -> Dict[str, float]:
    """Flatten a BENCH payload into ``metric name → float``.

    Top-level numeric fields keep their key (bools become 0/1 so
    ``token_identical`` flipping false is a catchable regression); each
    CSV row contributes ``{row_name}/{key}`` per ``key=value`` pair in
    its derived column.  Lists and nested dicts are ignored."""
    out: Dict[str, float] = {}
    for k, v in payload.items():
        if k in ("name", "rows"):
            continue
        if isinstance(v, bool):
            out[k] = 1.0 if v else 0.0
        elif isinstance(v, (int, float)) and v is not None:
            out[k] = float(v)
    for i, row in enumerate(payload.get("rows", []) or []):
        if isinstance(row, dict):
            rname = str(row.get("name", i))
            for k, v in row.items():
                if k == "name":
                    continue
                if isinstance(v, bool):
                    out[f"{rname}/{k}"] = 1.0 if v else 0.0
                elif isinstance(v, (int, float)) and v is not None:
                    out[f"{rname}/{k}"] = float(v)
            continue
        if not isinstance(row, str):
            continue
        parts = row.split(",", 2)
        if len(parts) < 3:
            continue
        rname, _us, derived = parts       # the us column is wall-clock
        for key, num in _KV_RE.findall(derived):
            try:
                out[f"{rname}/{key}"] = float(num)
            except ValueError:
                continue
    return out


def compare_metrics(base: Dict[str, float], cur: Dict[str, float],
                    tol: float,
                    include_wallclock: bool = False) -> List[Dict]:
    """Per-metric checks over the intersection of baseline and run.

    Returns one dict per shared metric with ``status`` in ``ok`` /
    ``improved`` / ``regressed`` / ``skipped``; metrics only in the
    baseline surface as ``missing``."""
    checks: List[Dict] = []
    for key in sorted(base):
        b = base[key]
        check: Dict = {"metric": key, "base": b,
                       "direction": classify_direction(key)}
        if key not in cur:
            check.update(cur=None, status="missing")
            checks.append(check)
            continue
        c = cur[key]
        check["cur"] = c
        if not include_wallclock and is_wallclock(key):
            check["status"] = "skipped"
            checks.append(check)
            continue
        rel = (c - b) / max(abs(b), 1e-12)
        check["rel_change"] = rel
        d = check["direction"]
        if d == "higher":
            status = ("regressed" if rel < -tol
                      else "improved" if rel > tol else "ok")
        elif d == "lower":
            status = ("regressed" if rel > tol
                      else "improved" if rel < -tol else "ok")
        else:
            status = "regressed" if abs(rel) > tol else "ok"
        check["status"] = status
        checks.append(check)
    return checks


def _load_payloads(dirpath: str) -> Dict[str, Tuple[str, Dict]]:
    """``payload name → (file, payload)`` for every BENCH_*.json."""
    out: Dict[str, Tuple[str, Dict]] = {}
    for f in sorted(glob.glob(os.path.join(dirpath, "BENCH_*.json"))):
        try:
            with open(f) as fh:
                payload = json.load(fh)
        except (OSError, ValueError):
            continue
        name = payload.get("name") or os.path.basename(f)[6:-5]
        out[name] = (f, payload)
    return out


def compare_dirs(baselines: str, run: str, tol: float = 0.05,
                 include_wallclock: bool = False,
                 strict: bool = False) -> Dict:
    """Compare every baseline payload against the run directory."""
    base_payloads = _load_payloads(baselines)
    run_payloads = _load_payloads(run)
    report: Dict = {"baselines": baselines, "run": run, "tol": tol,
                    "strict": strict, "payloads": [],
                    "missing_payloads": []}
    n_checks = n_reg = n_imp = n_missing = 0
    for name in sorted(base_payloads):
        bfile, bpayload = base_payloads[name]
        if name not in run_payloads:
            report["missing_payloads"].append(name)
            continue
        _, rpayload = run_payloads[name]
        checks = compare_metrics(extract_metrics(bpayload),
                                 extract_metrics(rpayload), tol,
                                 include_wallclock)
        reg = [c for c in checks if c["status"] == "regressed"]
        imp = [c for c in checks if c["status"] == "improved"]
        missing = [c for c in checks if c["status"] == "missing"]
        compared = [c for c in checks
                    if c["status"] not in ("skipped", "missing")]
        n_checks += len(compared)
        n_reg += len(reg)
        n_imp += len(imp)
        n_missing += len(missing)
        report["payloads"].append({
            "name": name, "baseline_file": bfile,
            "n_compared": len(compared), "n_regressed": len(reg),
            "n_improved": len(imp), "n_missing": len(missing),
            "checks": checks})
    report.update(
        n_payloads=len(report["payloads"]), n_checks=n_checks,
        n_regressions=n_reg, n_improvements=n_imp,
        n_missing_metrics=n_missing)
    report["ok"] = (n_reg == 0 and not (
        strict and (n_missing or report["missing_payloads"])))
    return report


def format_report(report: Dict) -> str:
    """Human-readable regression report."""
    lines: List[str] = []
    tol = report["tol"]
    for p in report["payloads"]:
        flagged = [c for c in p["checks"]
                   if c["status"] in ("regressed", "improved")]
        mark = "FAIL" if p["n_regressed"] else "ok"
        lines.append(f"[{mark:>4}] {p['name']}: {p['n_compared']} "
                     f"metrics, {p['n_regressed']} regressed, "
                     f"{p['n_improved']} improved, "
                     f"{p['n_missing']} missing")
        for c in flagged:
            arrow = {"higher": "≥", "lower": "≤",
                     "both": "≈"}[c["direction"]]
            lines.append(
                f"    {c['status']:>9} {c['metric']} ({arrow}): "
                f"{c['base']:g} → {c['cur']:g} "
                f"({c['rel_change']:+.1%}, tol ±{tol:.0%})")
    for name in report["missing_payloads"]:
        lines.append(f"[skip] {name}: no BENCH payload in run dir")
    verdict = "PASS" if report["ok"] else "REGRESSION"
    lines.append(
        f"{verdict}: {report['n_checks']} metrics across "
        f"{report['n_payloads']} payloads — "
        f"{report['n_regressions']} regressed, "
        f"{report['n_improvements']} improved"
        + (f", {len(report['missing_payloads'])} payloads not in run"
           if report["missing_payloads"] else ""))
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.obs regress",
        description="Compare BENCH_*.json payloads against committed "
                    "baselines; exit nonzero on regression.")
    ap.add_argument("--baselines", default="benchmarks/baselines",
                    help="directory of committed baseline payloads")
    ap.add_argument("--run", default=".",
                    help="directory of freshly produced payloads")
    ap.add_argument("--tol", type=float, default=0.05,
                    help="relative tolerance band (default 5%%)")
    ap.add_argument("--include-wallclock", action="store_true",
                    help="also gate machine-dependent wall-clock "
                         "metrics (off by default)")
    ap.add_argument("--strict", action="store_true",
                    help="missing payloads/metrics fail instead of "
                         "warn")
    ap.add_argument("--json", action="store_true",
                    help="print the JSON report instead of text")
    ap.add_argument("--report", metavar="PATH",
                    help="also write the JSON report to PATH")
    args = ap.parse_args(argv)

    if not os.path.isdir(args.baselines):
        print(f"error: baselines directory not found: {args.baselines}",
              file=sys.stderr)
        return 2
    report = compare_dirs(args.baselines, args.run, tol=args.tol,
                          include_wallclock=args.include_wallclock,
                          strict=args.strict)
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        print(format_report(report))
    return 0 if report["ok"] else 2


if __name__ == "__main__":
    sys.exit(main())
