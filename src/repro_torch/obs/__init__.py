"""repro_torch.obs — always-on span tracing and the metrics registry.

The port's copy of the reference ``repro.obs`` core: the ring-buffered
:class:`SpanTracer` over five fixed lanes with Chrome-trace export, and
the :class:`MetricsRegistry` that ``stats()`` providers register into.
Process-wide defaults are reached through :func:`tracer` and
:func:`metrics`; tests swap them with :func:`set_tracer` /
:func:`set_metrics` (each returns the previous instance).
"""
from __future__ import annotations

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracer import (LANE_ADAPT, LANE_CHECKPOINT, LANE_COMPUTE,
                                    LANE_ID, LANE_KV_SPILL, LANE_POLICY_SWAP,
                                    LANES, SpanTracer, export_chrome_trace)

__all__ = [
    "MetricsRegistry", "SpanTracer",
    "LANES", "LANE_ID", "LANE_COMPUTE", "LANE_POLICY_SWAP", "LANE_KV_SPILL",
    "LANE_CHECKPOINT", "LANE_ADAPT", "export_chrome_trace",
    "tracer", "metrics", "set_tracer", "set_metrics",
]

_tracer = SpanTracer()
_metrics = MetricsRegistry()


def tracer() -> SpanTracer:
    """The process-wide default tracer (always on)."""
    return _tracer


def metrics() -> MetricsRegistry:
    """The process-wide default metrics registry."""
    return _metrics


def set_tracer(t: SpanTracer) -> SpanTracer:
    global _tracer
    old, _tracer = _tracer, t
    return old


def set_metrics(m: MetricsRegistry) -> MetricsRegistry:
    global _metrics
    old, _metrics = _metrics, m
    return old
