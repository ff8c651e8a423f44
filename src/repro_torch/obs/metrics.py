"""Unified metrics registry (repro_torch.obs).

Before this module every subsystem grew its own ``stats()`` dict —
``hostmem.metrics.collect``, ``engine.stats``, ``Server.latency_stats``,
``ChameleonRuntime.stats`` — and every consumer (benchmarks, the launch
CLIs, dashboards) stitched them together ad hoc.  The registry gives
them one schema:

  * **counters** — monotonically increasing ints (``counter(name)``);
  * **gauges** — last-write-wins floats with a bounded ``(t, value)``
    ring series per gauge (``gauge(name, v)``), so a snapshot carries
    recent history without unbounded growth;
  * **providers** — named callables returning a stats dict, evaluated
    lazily at snapshot time.  Subsystems register their existing
    ``stats()`` methods (``register_provider("hostmem", tier.stats)``)
    and the registry never copies their internals between snapshots.

``snapshot()`` returns one JSON-safe dict; ``write_jsonl`` appends it to
a file — the periodic snapshot writer the trainer drives on a step
cadence and the nightly workflow uploads as an artifact.  A provider
that raises contributes ``{"error": ...}`` instead of killing the
snapshot (observability must not take down the observed).
"""
from __future__ import annotations

import collections
import json
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.obs.tracer import _json_safe

SNAPSHOT_KEYS = ("time", "seq", "counters", "gauges", "series", "providers")


class MetricsRegistry:
    def __init__(self, series_len: int = 256):
        self.series_len = int(series_len)
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        self._series: Dict[str, Deque[Tuple[float, float]]] = {}
        self._providers: Dict[str, Callable[[], dict]] = {}
        self._lock = threading.Lock()
        self._seq = 0

    # ----------------------------------------------------------- recording
    def counter(self, name: str, inc: int = 1) -> int:
        with self._lock:
            v = self._counters.get(name, 0) + int(inc)
            self._counters[name] = v
            return v

    def gauge(self, name: str, value: float, t: Optional[float] = None) -> None:
        with self._lock:
            self._gauges[name] = float(value)
            s = self._series.get(name)
            if s is None:
                s = self._series[name] = collections.deque(
                    maxlen=self.series_len)
            s.append((time.time() if t is None else t, float(value)))

    def series(self, name: str) -> List[Tuple[float, float]]:
        with self._lock:
            return list(self._series.get(name, ()))

    # ----------------------------------------------------------- providers
    def register_provider(self, name: str, fn: Callable[[], dict]) -> None:
        """Attach (or replace — a re-built subsystem re-registers under
        the same name) a stats provider."""
        with self._lock:
            self._providers[name] = fn

    def unregister_provider(self, name: str) -> None:
        with self._lock:
            self._providers.pop(name, None)

    def provider_names(self) -> List[str]:
        with self._lock:
            return sorted(self._providers)

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> dict:
        with self._lock:
            self._seq += 1
            out = {
                "time": time.time(),
                "seq": self._seq,
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "series": {k: list(v) for k, v in self._series.items()},
                "providers": {},
            }
            providers = list(self._providers.items())
        for name, fn in providers:
            try:
                out["providers"][name] = _json_safe(fn())
            except Exception as e:  # noqa: BLE001 — never kill the snapshot
                out["providers"][name] = {"error": repr(e)}
        return out

    def write_jsonl(self, path: str, snap: Optional[dict] = None) -> dict:
        """Append one snapshot as a JSONL line."""
        snap = snap if snap is not None else self.snapshot()
        with open(path, "a") as f:
            f.write(json.dumps(_json_safe(snap)) + "\n")
        return snap

    # --------------------------------------------------------------- admin
    def clear(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._series.clear()
            self._providers.clear()
            self._seq = 0

    def stats(self) -> dict:
        with self._lock:
            return {"counters": len(self._counters),
                    "gauges": len(self._gauges),
                    "providers": len(self._providers),
                    "snapshots": self._seq}
