"""Observability of the port: the launchers' structured logger
(``obs.log``), the metrics registry (``obs.metrics``) and the trace
recorder (``obs.trace.Tracer``)."""
from .trace import TraceError, Tracer

__all__ = ["TraceError", "Tracer"]
