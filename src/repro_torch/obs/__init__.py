"""Observability of the port (a copy of ``repro.obs``).

* ``obs.log`` — the launchers' structured logger.
* ``obs.trace.Tracer`` — spans, instants and counters on one timebase,
  exported as Chrome-trace JSON.  Simulators stamp sim-time seconds; the
  ``PagedEngine`` and ``AsyncGRPOTrainer`` on the card stamp
  ``tracer.now()`` wall-clock seconds.  Never share one tracer across the
  two timebases.
* ``obs.metrics.MetricsRegistry`` — counters, gauges and fixed-bucket
  histograms with snapshot / delta export.
* ``obs.slo`` and ``obs.monitor.HealthMonitor`` — rolling-window
  detectors (straggler, buffer depth, staleness burn, stage bubble,
  admission SLO, snapshot age) that raise typed ``Alert``s online.  The
  simulators poll the monitor on a sim-time cadence; the trainer and the
  paged engine feed it from the card's wall clock.
* ``obs.analyze`` — per-stage utilization and bubble fraction,
  per-replica busy time and the throughput cross-check against the
  simulator's ledger, from a Chrome-trace dict::

      from repro_torch.obs import Tracer, analyze_trace, check_report
      from repro_torch.sim import AsyncRLSimulator, SimConfig

      tracer = Tracer()
      res = AsyncRLSimulator(plan, P, SimConfig(trace=tracer)).run()
      assert check_report(analyze_trace(tracer.to_chrome())) == []

* ``obs.regress`` — compare a run's ``BENCH_*.json`` payloads against
  committed baselines with direction-aware tolerance bands.

CLI: ``python -m repro_torch.obs analyze TRACE`` and ``python -m
repro_torch.obs regress --baselines DIR --run DIR`` (exit 0, or 2 on a
regression).

Every hook is behind ``if ... is not None``: a run without a tracer,
registry or monitor is bit-identical to one with them attached.
"""
from .analyze import analyze_trace, check_report, summarize_metrics
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      hist_frac_ge, hist_quantile, snapshot_delta)
from .monitor import Alert, HealthMonitor, MonitorConfig
from .regress import compare_dirs, compare_metrics, extract_metrics
from .slo import BurnWindow, SLOSpec, burn_rate, classify_burn
from .trace import TraceError, Tracer

__all__ = [
    "Alert",
    "BurnWindow",
    "Counter",
    "Gauge",
    "HealthMonitor",
    "Histogram",
    "MetricsRegistry",
    "MonitorConfig",
    "SLOSpec",
    "TraceError",
    "Tracer",
    "analyze_trace",
    "burn_rate",
    "check_report",
    "classify_burn",
    "compare_dirs",
    "compare_metrics",
    "extract_metrics",
    "hist_frac_ge",
    "hist_quantile",
    "snapshot_delta",
    "summarize_metrics",
]
