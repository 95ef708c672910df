"""Offline trace analyzer: stage overlap, device utilization, and
conservation-ledger cross-checks from a Chrome-trace JSON (the port's copy
of ``repro.obs.analyze``).

``analyze_trace`` is pure (dict in, dict out) so tests and benchmarks
can call it on ``Tracer.to_chrome()`` without touching disk; the CLI
(``python -m repro_torch.obs analyze TRACE``) wraps it for CI gating.

Computed per trace:

  * per-stage utilization and **bubble fraction** (1 − merged-interval
    coverage / wall) on every ``stage`` track — overlapping spans from
    concurrent replicas count once, which is exactly the "is the stage
    ever idle" question AReaL-Hex's balancing argument is about;
  * per-replica/device utilization plus raw busy seconds (Σ span
    durations — the quantity the simulator's ledger also integrates);
  * **producer–consumer imbalance**: generation-vs-train utilization
    gap, the paper's idleness-vs-staleness tradeoff made visible;
  * **throughput cross-check**: Σ tokens over train spans ÷ wall must
    agree with the ledger's ``throughput_tps`` (the simulator's
    conservation accounting) within tolerance — instrumentation that
    drops events fails this gate;
  * staleness-vs-idleness summary joining the ledger's staleness stats
    with the trace-derived idle fractions.
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Dict, List, Optional, Tuple


def _coverage(intervals: List[Tuple[float, float]], lo: float,
              hi: float) -> float:
    """Total length of ``[lo, hi] ∩ ∪intervals`` (merge-then-sum)."""
    ivs = sorted((max(a, lo), min(b, hi)) for a, b in intervals)
    total = 0.0
    cur_a: Optional[float] = None
    cur_b = 0.0
    for a, b in ivs:
        if b <= a:
            continue
        if cur_a is None:
            cur_a, cur_b = a, b
        elif a <= cur_b:
            cur_b = max(cur_b, b)
        else:
            total += cur_b - cur_a
            cur_a, cur_b = a, b
    if cur_a is not None:
        total += cur_b - cur_a
    return total


def analyze_trace(trace: Dict[str, Any]) -> Dict[str, Any]:
    """Analyze a Chrome-trace dict (see module docstring for the report
    contents).  Group/track names are recovered from the ``M`` metadata
    events ``Tracer.to_chrome`` emits."""
    events = trace.get("traceEvents", [])
    procs: Dict[int, str] = {}
    threads: Dict[Tuple[int, int], str] = {}
    for ev in events:
        if ev.get("ph") != "M":
            continue
        if ev.get("name") == "process_name":
            procs[ev["pid"]] = ev["args"]["name"]
        elif ev.get("name") == "thread_name":
            threads[(ev["pid"], ev["tid"])] = ev["args"]["name"]

    # (group, track) -> [(t0, t1, name, args)] in seconds
    spans: Dict[Tuple[str, str], List[Tuple[float, float, str, Dict]]] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        g = procs.get(ev["pid"], str(ev["pid"]))
        tk = threads.get((ev["pid"], ev.get("tid", 0)),
                         str(ev.get("tid", 0)))
        t0 = float(ev["ts"]) / 1e6
        t1 = t0 + float(ev.get("dur", 0.0)) / 1e6
        spans.setdefault((g, tk), []).append(
            (t0, t1, ev.get("name", ""), ev.get("args") or {}))

    ledger = (trace.get("otherData") or {}).get("ledger") or {}
    all_iv = [(a, b) for v in spans.values() for (a, b, _, _) in v]
    t_lo = min((a for a, _ in all_iv), default=0.0)
    t_hi = max((b for _, b in all_iv), default=0.0)
    # the ledger's wall clock is authoritative when present: launched-but
    # -untrained generation spans legitimately extend past the run's end
    wall = float(ledger.get("wall_time_s", t_hi - t_lo))
    wall = max(wall, 1e-12)
    win = (t_lo, t_lo + wall)

    stages: Dict[str, Dict[str, float]] = {}
    replicas: Dict[str, Dict[str, float]] = {}
    for (g, tk), v in sorted(spans.items()):
        busy = _coverage([(a, b) for a, b, _, _ in v], *win)
        entry = {"spans": len(v), "busy_s": busy, "utilization": busy / wall,
                 "bubble_fraction": 1.0 - busy / wall,
                 "raw_busy_s": sum(b - a for a, b, _, _ in v)}
        if g == "stage":
            stages[tk] = entry
        elif g == "replica":
            replicas[tk] = entry

    # ---- throughput cross-check against the conservation ledger
    train_tokens = sum(float(args.get("tokens", 0))
                       for (_, _, _, args) in spans.get(("stage", "train"),
                                                        []))
    tput: Dict[str, Optional[float]] = {
        "trace_tokens": train_tokens,
        "trace_tps": train_tokens / wall,
        "ledger_tokens": None, "ledger_tps": None, "rel_err": None,
    }
    lt = ledger.get("throughput_tps")
    if lt:
        tput["ledger_tokens"] = float(ledger.get("tokens_consumed", 0.0))
        tput["ledger_tps"] = float(lt)
        tput["rel_err"] = abs(tput["trace_tps"] - float(lt)) / float(lt)

    # ---- trace-derived device busy-time vs the ledger's integral
    gen_busy: Dict[str, Optional[float]] = {
        "trace_s": sum(r["raw_busy_s"] for r in replicas.values()),
        "ledger_s": None, "rel_err": None,
    }
    lb = ledger.get("gen_busy_s")
    if lb:
        gen_busy["ledger_s"] = float(lb)
        gen_busy["rel_err"] = abs(gen_busy["trace_s"] - float(lb)) / float(lb)

    # ---- p50/p95/p99 of span durations per stage track (trace-side
    # complement of the registry histograms' interpolated quantiles)
    for name, s in stages.items():
        durs = sorted(b - a for a, b, _, _ in spans[("stage", name)])
        for key, q in (("p50_s", 0.50), ("p95_s", 0.95),
                       ("p99_s", 0.99)):
            s[key] = durs[min(int(q * len(durs)), len(durs) - 1)]

    gen_u = stages.get("generation", {}).get("utilization", 0.0)
    train_u = stages.get("train", {}).get("utilization", 0.0)
    report: Dict[str, Any] = {
        "wall_s": wall,
        "t0_s": t_lo,
        "stages": stages,
        "replicas": replicas,
        "throughput": tput,
        "gen_busy": gen_busy,
        "imbalance": {
            "generation_utilization": gen_u,
            "train_utilization": train_u,
            "gap": gen_u - train_u,
            "ratio": gen_u / train_u if train_u > 0 else None,
        },
        "staleness_vs_idleness": {
            "mean_staleness": ledger.get("mean_staleness"),
            "max_staleness": ledger.get("max_staleness"),
            "dropped": ledger.get("dropped"),
            "stalls_capacity": ledger.get("stalls_capacity"),
            "stalls_data": ledger.get("stalls_data"),
            "generation_idle_fraction": 1.0 - gen_u,
            "train_idle_fraction": 1.0 - train_u,
        },
        "ledger": ledger,
    }
    return report


def summarize_metrics(snapshot: Dict[str, Any]) -> Dict[str, Any]:
    """Condense a ``MetricsRegistry.snapshot()`` dict for reporting:
    counters and gauges pass through, histograms reduce to count / mean
    / interpolated p50/p95/p99 (computed here if the snapshot predates
    quantile export)."""
    from .metrics import QUANTILE_KEYS, hist_quantile
    hists: Dict[str, Any] = {}
    for name, h in snapshot.get("histograms", {}).items():
        count = h.get("count", 0)
        entry = {"count": count,
                 "mean": (h.get("sum", 0.0) / count) if count else 0.0}
        for key, q in QUANTILE_KEYS:
            entry[key] = h.get(key, hist_quantile(h, q))
        hists[name] = entry
    return {"counters": dict(snapshot.get("counters", {})),
            "gauges": dict(snapshot.get("gauges", {})),
            "histograms": hists}


def check_report(report: Dict[str, Any], *, min_stages: int = 0,
                 max_tput_err: float = 0.01) -> List[str]:
    """CI gate: returns a list of failure strings (empty = pass)."""
    fails: List[str] = []
    nz = sum(1 for s in report["stages"].values() if s["utilization"] > 0.0)
    if nz < min_stages:
        fails.append(f"only {nz} stage track(s) with nonzero utilization "
                     f"(need >= {min_stages})")
    err = report["throughput"].get("rel_err")
    if err is not None and err > max_tput_err:
        fails.append(f"trace-derived throughput disagrees with the "
                     f"conservation ledger: rel_err={err:.4f} > "
                     f"{max_tput_err}")
    berr = report["gen_busy"].get("rel_err")
    if berr is not None and berr > max_tput_err:
        fails.append(f"trace-derived device busy-time disagrees with the "
                     f"ledger: rel_err={berr:.4f} > {max_tput_err}")
    return fails


def _human(report: Dict[str, Any]) -> str:
    lines = [f"wall: {report['wall_s']:.3f}s"]
    lines.append("stage                 util    bubble   busy_s   spans")
    for name, s in sorted(report["stages"].items()):
        lines.append(f"  {name:<18}  {s['utilization']:6.1%}  "
                     f"{s['bubble_fraction']:6.1%}  {s['busy_s']:8.2f} "
                     f"{s['spans']:6d}")
    if report["replicas"]:
        us = [r["utilization"] for r in report["replicas"].values()]
        lines.append(f"replicas: {len(us)}  util "
                     f"min={min(us):.1%} mean={sum(us) / len(us):.1%} "
                     f"max={max(us):.1%}")
    imb = report["imbalance"]
    lines.append(f"producer-consumer: gen={imb['generation_utilization']:.1%}"
                 f" train={imb['train_utilization']:.1%}"
                 f" gap={imb['gap']:+.1%}")
    tput = report["throughput"]
    if tput["rel_err"] is not None:
        lines.append(f"throughput: trace={tput['trace_tps']:.1f} tok/s "
                     f"ledger={tput['ledger_tps']:.1f} tok/s "
                     f"rel_err={tput['rel_err']:.4f}")
    sv = report["staleness_vs_idleness"]
    if sv["mean_staleness"] is not None:
        lines.append(f"staleness: mean={sv['mean_staleness']:.2f} "
                     f"max={sv['max_staleness']} dropped={sv['dropped']} "
                     f"| idle gen={sv['generation_idle_fraction']:.1%} "
                     f"train={sv['train_idle_fraction']:.1%}")
    mx = report.get("metrics")
    if mx and mx.get("histograms"):
        lines.extend(_hist_lines(mx))
    return "\n".join(lines)


def _hist_lines(mx: Dict[str, Any]) -> List[str]:
    lines = ["histogram              count      mean       p50"
             "       p95       p99"]
    for name, h in sorted(mx["histograms"].items()):
        lines.append(f"  {name:<20} {h['count']:6d}  {h['mean']:8.3f}"
                     f"  {h['p50']:8.3f}  {h['p95']:8.3f}"
                     f"  {h['p99']:8.3f}")
    return lines


def _human_metrics(mx: Dict[str, Any]) -> str:
    """Standalone registry-snapshot summary (no trace)."""
    lines: List[str] = []
    for kind in ("counters", "gauges"):
        for name, v in sorted(mx.get(kind, {}).items()):
            lines.append(f"{kind[:-1]:<8} {name:<24} {v:g}")
    if mx.get("histograms"):
        lines.extend(_hist_lines(mx))
    return "\n".join(lines) or "(empty snapshot)"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Offline analysis of repro_torch.obs Chrome-trace JSON.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    a = sub.add_parser("analyze",
                       help="per-stage utilization, bubbles, ledger "
                            "cross-checks; nonzero exit on gate failure")
    a.add_argument("trace", nargs="?",
                   help="Chrome-trace JSON written by Tracer.dump "
                        "(optional when only --metrics is inspected)")
    a.add_argument("--json", action="store_true",
                   help="emit the full report as JSON instead of a summary")
    a.add_argument("--min-stages", type=int, default=0,
                   help="fail unless >= N stage tracks have nonzero "
                        "utilization")
    a.add_argument("--max-tput-err", type=float, default=0.01,
                   help="max relative error vs the conservation ledger")
    a.add_argument("--metrics", metavar="PATH",
                   help="registry snapshot JSON (from --metrics on a "
                        "launcher) to summarize alongside the trace: "
                        "counters, gauges, histogram p50/p95/p99")
    args = ap.parse_args(argv)
    if not args.trace and not args.metrics:
        ap.error("a trace file and/or --metrics PATH is required")

    if args.trace:
        with open(args.trace) as f:
            trace = json.load(f)
        report = analyze_trace(trace)
    else:
        report = None
    if args.metrics:
        with open(args.metrics) as f:
            metrics = summarize_metrics(json.load(f))
    else:
        metrics = None

    if report is None:
        # metrics-only inspection: no trace gates to check
        if args.json:
            print(json.dumps({"metrics": metrics, "failures": []},
                             indent=2, sort_keys=True, default=str))
        else:
            print(_human_metrics(metrics))
        return 0

    if metrics is not None:
        report["metrics"] = metrics
    fails = check_report(report, min_stages=args.min_stages,
                         max_tput_err=args.max_tput_err)
    if args.json:
        print(json.dumps({"report": report, "failures": fails},
                         indent=2, sort_keys=True, default=str))
    else:
        print(_human(report))
        for f_ in fails:
            print(f"FAIL: {f_}")
    return 1 if fails else 0
