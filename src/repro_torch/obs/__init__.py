"""repro_torch.obs — always-on span tracing, the metrics registry, the
audit log and the memory ledger.

The port's copy of the reference ``repro.obs`` core: the ring-buffered
:class:`SpanTracer` over eight fixed lanes with Chrome-trace export (the
reference's five, and the port's ``trainer``, ``monitor`` and ``obs``
host lanes), its device clock and its ranges in the profiler's trace, the
:class:`MetricsRegistry` that ``stats()`` providers register into, the
:class:`AuditLog` of structured events (fault injection, link-health
transitions, engine retries and fallbacks) and the :class:`MemoryLedger`
that the transfer engine and the KV spill report staged bytes to, and
the per-iteration swap/compute overlap efficiency
(:mod:`repro_torch.obs.overlap`), and the schema validators of exported
traces and metrics (:mod:`repro_torch.obs.validate`; the post-mortem
report is :mod:`repro_torch.obs.report`).
Process-wide defaults are reached through :func:`tracer`, :func:`metrics`,
:func:`audit` and :func:`ledger`; tests swap them with :func:`set_tracer`
/ :func:`set_metrics` / :func:`set_audit` / :func:`set_ledger` (each
returns the previous instance).
"""
from __future__ import annotations

from repro_torch.obs.audit import AuditLog
from repro_torch.obs.memledger import LEDGER_TRACKS, MemoryLedger
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.overlap import (interval_union, overlap_efficiency,
                                     window_efficiency)
from repro_torch.obs.tracer import (LANE_ADAPT, LANE_CHECKPOINT, LANE_COMPUTE,
                                    LANE_ID, LANE_KV_SPILL, LANE_MONITOR,
                                    LANE_OBS, LANE_POLICY_SWAP, LANE_TRAINER,
                                    LANES, SpanTracer, export_chrome_trace,
                                    mark_seconds, profiler_range)
from repro_torch.obs.validate import (validate_chrome_trace,
                                      validate_metrics_jsonl)

__all__ = [
    "AuditLog", "MemoryLedger", "MetricsRegistry", "SpanTracer",
    "LEDGER_TRACKS",
    "LANES", "LANE_ID", "LANE_COMPUTE", "LANE_POLICY_SWAP", "LANE_KV_SPILL",
    "LANE_CHECKPOINT", "LANE_ADAPT", "LANE_TRAINER", "LANE_MONITOR",
    "LANE_OBS", "export_chrome_trace", "mark_seconds", "profiler_range",
    "interval_union", "overlap_efficiency", "window_efficiency",
    "validate_chrome_trace", "validate_metrics_jsonl",
    "tracer", "metrics", "audit", "ledger",
    "set_tracer", "set_metrics", "set_audit", "set_ledger",
]

_tracer = SpanTracer()
_metrics = MetricsRegistry()
_audit = AuditLog()
_ledger = MemoryLedger()


def tracer() -> SpanTracer:
    """The process-wide default tracer (always on)."""
    return _tracer


def metrics() -> MetricsRegistry:
    """The process-wide default metrics registry."""
    return _metrics


def audit() -> AuditLog:
    """The process-wide default audit log."""
    return _audit


def ledger() -> MemoryLedger:
    """The process-wide default memory ledger (always on)."""
    return _ledger


def set_tracer(t: SpanTracer) -> SpanTracer:
    global _tracer
    old, _tracer = _tracer, t
    return old


def set_metrics(m: MetricsRegistry) -> MetricsRegistry:
    global _metrics
    old, _metrics = _metrics, m
    return old


def set_audit(a: AuditLog) -> AuditLog:
    global _audit
    old, _audit = _audit, a
    return old


def set_ledger(l: MemoryLedger) -> MemoryLedger:
    global _ledger
    old, _ledger = _ledger, l
    return old
