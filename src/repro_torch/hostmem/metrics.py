"""Aggregated host-memory tier counters: port of ``repro/hostmem/metrics.py``.

One dict, stable keys, cheap to collect — surfaced through
``Server.stats()["hostmem"]`` and ``ChameleonRuntime.stats()["hostmem"]``
so dashboards and benchmarks read the same numbers.
"""
from __future__ import annotations


def collect(tier) -> dict:
    """Snapshot every component of a :class:`~repro_torch.hostmem.HostMemTier`."""
    out = {
        "pool": tier.pool.stats(),
        "engine": tier.engine.stats(),
        "bwmodel": {
            "calibrated": tier.bwmodel.is_calibrated,
            "constant_gbps": tier.bwmodel.constant_gbps,
            "points": len(tier.bwmodel.curve()),
        },
    }
    if tier.kvspill is not None:
        out["kvspill"] = tier.kvspill.stats()
    return out


def format_summary(stats: dict) -> str:
    """Human-readable tier summary.  Tolerant of partial snapshots: a
    cold-start tier (engine with no classes populated yet, bwmodel with
    zero points, missing kvspill) must format, not crash — the summary is
    printed from CLI ``finally`` blocks where a raise would mask the real
    error."""
    p = stats.get("pool") or {}
    e = stats.get("engine") or {}
    lines = [
        f"pool: {p.get('bytes_in_use', 0) / 2**20:.1f} MiB live "
        f"(hwm {p.get('peak_bytes_in_use', 0) / 2**20:.1f} MiB) / "
        f"{p.get('bytes_reserved', 0) / 2**20:.1f} MiB reserved, "
        f"hit-rate {p.get('hit_rate', 0.0):.1%}, "
        f"frag {p.get('fragmentation', 0.0):.1%}",
        f"engine: {e.get('n_out', 0)} out "
        f"({e.get('bytes_out', 0) / 2**20:.1f} MiB, "
        f"{e.get('gbps_out', 0.0):.2f} GB/s), {e.get('n_in', 0)} in "
        f"({e.get('bytes_in', 0) / 2**20:.1f} MiB, "
        f"{e.get('gbps_in', 0.0):.2f} GB/s)",
    ]
    for cls, c in (e.get("classes") or {}).items():
        queued = c.get("queued_bytes", 0)
        if not (c.get("n_out") or c.get("n_in") or queued):
            continue
        line = (
            f"  {cls}: {c.get('n_out', 0)} out / {c.get('n_in', 0)} in, "
            f"{(c.get('bytes_out', 0) + c.get('bytes_in', 0)) / 2**20:.1f}"
            f" MiB, stall {c.get('stall_s', 0.0) * 1e3:.1f} ms "
            f"({c.get('stall_transfers', 0)} waits), "
            f"released@op {c.get('released_at_op', 0)}")
        if queued:
            line += (f", queued {c.get('queue_depth', 0)} "
                     f"({queued / 2**20:.1f} MiB)")
        if c.get("hwm_queued_bytes"):
            line += (f", backlog hwm "
                     f"{c['hwm_queued_bytes'] / 2**20:.1f} MiB")
        lines.append(line)
    bw = stats.get("bwmodel") or {}
    points = bw.get("points", 0)
    if bw.get("calibrated") and points:
        lines.append("bwmodel: calibrated, %d points" % points)
    else:
        lines.append("bwmodel: constant %.1f GB/s"
                     % bw.get("constant_gbps", 0.0))
    if "kvspill" in stats:
        k = stats["kvspill"]
        lines.append(f"kvspill: {k.get('n_spills', 0)} spills / "
                     f"{k.get('n_restores', 0)} restores, "
                     f"{k.get('bytes_spilled', 0) / 2**20:.1f} MiB out, "
                     f"live {k.get('live_bytes', 0) / 2**20:.1f} MiB "
                     f"(hwm {k.get('hwm_live_bytes', 0) / 2**20:.1f} MiB)")
    return "\n".join(lines)
