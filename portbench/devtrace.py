"""Reading a ``torch.profiler`` window of whole training steps.

``read(prof, window_s)`` gives the seconds in which a kernel or copy ran
on the device (the union of their intervals), every kernel's device time
by name, the time inside the harness's ``APPLY`` ranges in which a kernel
ran (``apply_s``), the ten device operations that took most
time and the ten longest idle gaps, each named by the innermost host
operation that was running at its middle.  A range's own mark on the
device's timeline (a user annotation) is no device work and is left out.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

# the host range around each apply dispatch of the traced steps
APPLY = "portbench.apply"
# device events that are copies, not kernels
COPIES = ("Memcpy", "Memset")

# device time by kind, from kernel names: cuBLAS products, K1 both ways
# (csrc/flash_attention_{fwd,bwd}.cu), PyTorch's elementwise and reduction
# kernels; the rest is "other"
KINDS = (("k1_bwd", ("bwd_delta", "bwd_dkdv", "bwd_dq")),
         ("k1_fwd", ("flash_fwd",)),
         ("gemm", ("nvjet", "gemm", "cutlass", "xmma")),
         ("elementwise", ("elementwise",)),
         ("reduce", ("reduce",)))


def by_kind(kernels: Dict[str, float]) -> Dict[str, float]:
    out = {k: 0.0 for k, _ in KINDS}
    out["other"] = 0.0
    for name, t in kernels.items():
        kind = next((k for k, words in KINDS
                     if any(w in name.lower() for w in words)), "other")
        out[kind] += t
    return out


def _merged(intervals: List[Tuple[float, float]]) -> List[List[float]]:
    """The covered runs of [start, end) intervals, in order."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _union(intervals: List[Tuple[float, float]]) -> Tuple[float, list]:
    """(covered length, the gaps between covered runs) of [start, end)
    intervals."""
    runs = _merged(intervals)
    return (sum(e - s for s, e in runs),
            [(a[1], b[0]) for a, b in zip(runs, runs[1:])])


def ranged_busy_s(host_events, kernels: List[Tuple[float, float]],
                  name: str = APPLY) -> Optional[float]:
    """The time inside the host ranges called ``name`` in which a kernel
    ran on the device.  The harness ends each such range with a device
    sync after a dispatch that starts on an idle device, so every kernel
    it launched runs inside it and nothing else does.  None where there
    is no such range or no kernel ran in one."""
    ranges = [(e.time_range.start, e.time_range.end) for e in host_events
              if e.name == name]
    if not ranges:
        return None
    runs = _merged(kernels)
    starts = [r[0] for r in runs]
    total = 0.0
    for r0, r1 in ranges:
        i = max(bisect.bisect_right(starts, r0) - 1, 0)
        while i < len(runs) and runs[i][0] < r1:
            total += max(0.0, min(runs[i][1], r1) - max(runs[i][0], r0))
            i += 1
    return total * 1e-6 if total > 0 else None              # microseconds


def read(prof, window_s: float) -> dict:
    from torch.autograd import DeviceType
    dev, host, host_events, kernels = [], [], [], []
    by_name: Dict[str, float] = {}
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end       # microseconds
        if e.device_type == DeviceType.CUDA:
            if e.name == APPLY or getattr(e, "is_user_annotation", False):
                continue
            dev.append((s, t))
            if not e.name.startswith(COPIES):
                kernels.append((s, t))
            by_name[e.name] = by_name.get(e.name, 0.0) + (t - s) * 1e-6
        elif e.device_type == DeviceType.CPU:
            host.append((s, t, e.name))
            host_events.append(e)
    if not dev:
        return {"window_s": window_s, "busy_s": 0.0, "kernels": {},
                "by_kind": {}, "apply_s": None,
                "breakdown": {"device_ops": [], "idle_gaps": []}}
    busy_us, gaps = _union(dev)
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = []
    for g0, g1 in gaps[:10]:
        mid = (g0 + g1) / 2
        inner = [h for h in host if h[0] <= mid <= h[1]]
        name = min(inner, key=lambda h: h[1] - h[0])[2] if inner else "none"
        idle.append([name, (g1 - g0) * 1e-6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": window_s, "busy_s": busy_us * 1e-6,
            "kernels": by_name, "by_kind": by_kind(by_name),
            "apply_s": ranged_busy_s(host_events, kernels),
            "breakdown": {"device_ops": [[n, t] for n, t in top],
                          "idle_gaps": idle}}
