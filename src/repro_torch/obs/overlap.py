"""Swap/compute overlap efficiency (repro_torch.obs).  A numpy copy of
``repro/obs/overlap.py``.

The paper's Fig.-7-style claim — swap traffic adds no end-to-end time
*when effectively overlapped* — becomes a measured number here:

    overlap_efficiency = hidden transfer time / total transfer time

where a transfer second is *hidden* iff it lies under the union of
compute spans in the same window.  1.0 means the link never ran while
compute was idle (perfect overlap); 0.0 means every transfer second was
exposed on the critical path.  Windows with no transfer traffic report
``None`` (nothing to hide — not the same as perfect overlap).

The computation is numpy interval arithmetic over the tracer's ring
buffer: O(n log n) in retained spans, run once per iteration boundary on
bounded input, so it honors the always-on budget.

On a CUDA device the efficiency is a device measurement: the runtime
asks for the tracer's ``device`` records (``window_efficiency(...,
device=True)``), which lie on the device's timeline put on the tracer's
clock (``obs.tracer``'s module doc).  The compute records are the
trainer's dispatch phases, from CUDA events on the compute stream (the
forward, the backward, the unscale, the clip and the update); the
transfer records are the engine's copies, from the start and done events
around each on its class's stream.  On the CPU, where every copy runs at
its issue, the compute and transfer spans of the host clock are used, as
the reference does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.obs.tracer import (_KIND_DEVICE, _KIND_SPAN, LANE_COMPUTE,
                                    TRANSFER_LANES, SpanTracer)


def interval_union(spans: np.ndarray) -> np.ndarray:
    """Merge an ``(n, 2)`` array of [t0, t1) intervals into a disjoint,
    sorted ``(m, 2)`` union."""
    if spans.size == 0:
        return spans.reshape(0, 2)
    spans = spans[np.argsort(spans[:, 0])]
    starts, ends = spans[:, 0], spans[:, 1]
    # an interval starts a new merged run iff it begins after the running
    # max end of everything before it
    run_end = np.maximum.accumulate(ends)
    new_run = np.ones(len(spans), bool)
    new_run[1:] = starts[1:] > run_end[:-1]
    run_id = np.cumsum(new_run) - 1
    m = int(run_id[-1]) + 1
    ends_out = np.full(m, -np.inf)
    np.maximum.at(ends_out, run_id, ends)
    out = np.empty((m, 2), np.float64)
    out[:, 0] = starts[new_run]
    out[:, 1] = ends_out
    return out


def _overlap_with_union(spans: np.ndarray, union: np.ndarray) -> float:
    """Total seconds of ``spans`` covered by the disjoint ``union``."""
    if spans.size == 0 or union.size == 0:
        return 0.0
    total = 0.0
    u0, u1 = union[:, 0], union[:, 1]
    for t0, t1 in spans:
        if t1 <= t0:
            continue
        lo = np.searchsorted(u1, t0, side="right")
        hi = np.searchsorted(u0, t1, side="left")
        if hi > lo:
            seg0 = np.maximum(u0[lo:hi], t0)
            seg1 = np.minimum(u1[lo:hi], t1)
            total += float(np.clip(seg1 - seg0, 0.0, None).sum())
    return total


def overlap_efficiency(compute: np.ndarray,
                       transfer: np.ndarray) -> Tuple[Optional[float], float, float]:
    """(efficiency, transfer_seconds, hidden_seconds) for explicit span
    arrays.  Efficiency is None when there was no transfer traffic."""
    total = float(np.clip(transfer[:, 1] - transfer[:, 0], 0.0, None).sum()) \
        if transfer.size else 0.0
    if total <= 0.0:
        return None, 0.0, 0.0
    hidden = _overlap_with_union(transfer, interval_union(compute))
    hidden = min(hidden, total)
    return hidden / total, total, hidden


def window_efficiency(tracer: SpanTracer, t0: float, t1: float,
                      device: bool = False
                      ) -> Tuple[Optional[float], float, float]:
    """Overlap efficiency over the wall-clock window [t0, t1): transfer
    spans are clipped to the window; compute spans crossing the boundary
    still hide what they cover inside it.  ``device``: the tracer's
    device records of those lanes in place of its spans (module doc)."""
    kinds = (_KIND_DEVICE,) if device else (_KIND_SPAN,)
    compute = tracer.spans(lanes=(LANE_COMPUTE,), kinds=kinds)
    transfer = tracer.spans(lanes=TRANSFER_LANES, kinds=kinds)
    if transfer.size:
        m = (transfer[:, 1] > t0) & (transfer[:, 0] < t1)
        transfer = np.clip(transfer[m], t0, t1)
    if compute.size:
        m = (compute[:, 1] > t0) & (compute[:, 0] < t1)
        compute = compute[m]
    return overlap_efficiency(compute, transfer)
