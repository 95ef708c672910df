"""In-process trace recorder, the port of ``repro.obs.trace``: spans,
instants and counters on one monotonic timebase, exported as Chrome-trace
/ Perfetto JSON.

* **Low overhead.**  Recording one event is a tuple append; no dict is
  built and no timestamp converted until :meth:`Tracer.to_chrome`.  Every
  instrumentation site is guarded by ``if tracer is not None``, so a
  disabled tracer costs one comparison and the traced code draws the same
  random numbers and gives bit-identical results
  (``tests/test_torch_trace.py``).
* **One timebase per tracer.**  Runtime components (``PagedEngine``,
  ``AsyncGRPOTrainer``) stamp events with :meth:`Tracer.now`, wall-clock
  seconds since the tracer was made.
* **Groups and tracks.**  Every event lives on a ``(group, track)`` pair,
  which the export maps to a Chrome ``(pid, tid)`` with ``process_name`` /
  ``thread_name`` metadata, so Perfetto draws one swimlane per track:

    ==========  ========================  ==============================
    group       track                     emitted by
    ==========  ========================  ==============================
    stage       generation/train/sync     AsyncGRPOTrainer (produce,
                                          train_step, publish)
    engine      loop/decode/prefill/      PagedEngine (wall clock)
                admission/weights/pages
    ==========  ========================  ==============================
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple


class TraceError(RuntimeError):
    """Raised on mismatched ``begin``/``end`` nesting."""


class Tracer:
    """Append-only event recorder; see the module docstring for the
    group/track conventions and the one-timebase rule."""

    def __init__(self, meta: Optional[Dict[str, Any]] = None):
        self._wall0 = time.perf_counter()
        # (ph, group, track, name, t_s, dur_s, args) — Chrome phase
        # letters: X complete-span, B/E begin/end, i instant, C counter.
        self._events: List[Tuple] = []
        self._open: Dict[Tuple[str, str], List[str]] = {}
        # streaming consumers (e.g. the health monitor): called with the
        # raw event tuple fields on every record.  Empty by default, so
        # the recording hot path stays a tuple append plus one falsy
        # check.
        self._sinks: List[Any] = []
        # free-form run metadata (e.g. the simulator's conservation
        # ledger) — exported under Chrome's "otherData" key so the
        # analyzer can cross-check trace-derived quantities against it.
        self.meta: Dict[str, Any] = dict(meta or {})

    # ------------------------------------------------------------ recording
    def now(self) -> float:
        """Wall-clock seconds since tracer creation (runtime timebase).
        Simulators must NOT use this — they pass sim-time directly."""
        return time.perf_counter() - self._wall0

    def add_sink(self, fn: Any) -> None:
        """Register a streaming consumer called as
        ``fn(ph, group, track, name, t, dur, args)`` on every recorded
        event (the health monitor's ``on_trace_event`` fits this)."""
        self._sinks.append(fn)

    def _feed(self, ev: Tuple) -> None:
        for fn in self._sinks:
            fn(*ev)

    def span(self, group: str, track: str, name: str, t: float,
             dur: float, **args: Any) -> None:
        """A complete span ``[t, t+dur)`` (seconds) on ``group/track``."""
        self._events.append(("X", group, track, name, t, dur, args))
        if self._sinks:
            self._feed(self._events[-1])

    def begin(self, group: str, track: str, name: str, t: float,
              **args: Any) -> None:
        """Open a nested span; close with :meth:`end` on the same track."""
        self._open.setdefault((group, track), []).append(name)
        self._events.append(("B", group, track, name, t, 0.0, args))
        if self._sinks:
            self._feed(self._events[-1])

    def end(self, group: str, track: str, t: float, **args: Any) -> str:
        """Close the innermost open span on ``group/track``."""
        stack = self._open.get((group, track))
        if not stack:
            raise TraceError(f"end() without begin() on {group}/{track}")
        name = stack.pop()
        self._events.append(("E", group, track, name, t, 0.0, args))
        if self._sinks:
            self._feed(self._events[-1])
        return name

    def instant(self, group: str, track: str, name: str, t: float,
                **args: Any) -> None:
        self._events.append(("i", group, track, name, t, 0.0, args))
        if self._sinks:
            self._feed(self._events[-1])

    def counter(self, group: str, name: str, t: float,
                **values: float) -> None:
        """A sampled counter series (stacked area chart in Perfetto)."""
        self._events.append(("C", group, name, name, t, 0.0, values))
        if self._sinks:
            self._feed(self._events[-1])

    # ------------------------------------------------------------- querying
    @property
    def n_events(self) -> int:
        return len(self._events)

    def open_spans(self) -> Dict[Tuple[str, str], List[str]]:
        """Tracks with unclosed ``begin``s (innermost last); empty when
        every begin/end pair matched — the nesting invariant tests use
        this."""
        return {k: list(v) for k, v in self._open.items() if v}

    def spans(self, group: Optional[str] = None,
              track: Optional[str] = None
              ) -> Iterator[Tuple[str, float, float, Dict[str, Any]]]:
        """Iterate complete spans as ``(name, t, dur, args)``."""
        for ph, g, tk, name, t, dur, args in self._events:
            if ph != "X":
                continue
            if group is not None and g != group:
                continue
            if track is not None and tk != track:
                continue
            yield (name, t, dur, args)

    # -------------------------------------------------------------- export
    def to_chrome(self) -> Dict[str, Any]:
        """Export to the Chrome trace-event *object* format (loadable in
        Perfetto / chrome://tracing).  Seconds become microseconds here;
        groups/tracks become pids/tids with name metadata."""
        pids: Dict[str, int] = {}
        tids: Dict[Tuple[str, str], int] = {}
        out: List[Dict[str, Any]] = []

        def pid(g: str) -> int:
            p = pids.get(g)
            if p is None:
                p = pids[g] = len(pids) + 1
                out.append({"ph": "M", "name": "process_name", "pid": p,
                            "tid": 0, "args": {"name": g}})
            return p

        def tid(g: str, tk: str) -> int:
            t = tids.get((g, tk))
            if t is None:
                p = pid(g)
                t = tids[(g, tk)] = len(tids) + 1
                out.append({"ph": "M", "name": "thread_name", "pid": p,
                            "tid": t, "args": {"name": tk}})
            return t

        for ph, g, tk, name, t, dur, args in self._events:
            ev: Dict[str, Any] = {"ph": ph, "name": name, "pid": pid(g),
                                  "tid": tid(g, tk), "ts": t * 1e6,
                                  "args": dict(args)}
            if ph == "X":
                ev["dur"] = dur * 1e6
            elif ph == "i":
                ev["s"] = "t"          # thread-scoped instant
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "otherData": dict(self.meta)}

    def dump(self, path: str) -> str:
        """Write the Chrome-trace JSON to ``path``; returns ``path``."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, default=str)
        return path
