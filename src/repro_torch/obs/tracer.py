"""Ring-buffered, always-on span tracer (repro_torch.obs).

The paper's overlap claim ("no additional end-to-end overhead when
effectively overlapped", §7) and its profiler claim ("cheap enough to
leave on", Table 1) are both *timeline* statements — they can only be
checked by looking at when transfers ran relative to compute.  This
tracer records that timeline at a cost low enough to stay enabled in
production, in the same spirit as the monitoring hot path:

  * **bounded memory** — all numeric span state lives in preallocated
    numpy ring buffers sized at construction; recording span number
    ``capacity + k`` overwrites slot ``k``.  Nothing grows per op.
  * **bounded interning** — span *names* are interned into a dict capped
    at ``max_names``; overflow names collapse into ``"<other>"`` so a
    pathological caller cannot grow the tracer through dynamic names.
    Dynamic detail (tags, byte counts) goes into the per-slot ``arg``
    payload, which lives in a fixed-length list (ring-overwritten too).
  * **monotonic clock** — ``time.perf_counter`` throughout; export
    normalizes to the earliest retained timestamp.

Lanes are fixed: one per traffic class of the transfer engine plus
``compute`` (step execution) and ``adapt`` (the profile→drift→adapt→
apply machinery).  Fixed lanes keep the record a single uint8 and give
the Chrome-trace export a stable thread layout.

Export is Chrome trace-event JSON (``ph: "X"`` complete events plus
``ph: "C"`` counters), openable in Perfetto or ``chrome://tracing`` —
see :func:`export_chrome_trace`.
"""
from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# Fixed lane set: engine traffic classes + compute + adaptation machinery.
LANE_COMPUTE = "compute"
LANE_POLICY_SWAP = "policy_swap"
LANE_KV_SPILL = "kv_spill"
LANE_CHECKPOINT = "checkpoint"
LANE_ADAPT = "adapt"
LANES: Tuple[str, ...] = (LANE_COMPUTE, LANE_POLICY_SWAP, LANE_KV_SPILL,
                          LANE_CHECKPOINT, LANE_ADAPT)
LANE_ID: Dict[str, int] = {name: i for i, name in enumerate(LANES)}

# transfer lanes considered "hideable under compute" by the overlap metric
TRANSFER_LANES: Tuple[str, ...] = (LANE_POLICY_SWAP, LANE_KV_SPILL,
                                   LANE_CHECKPOINT)

_KIND_SPAN = 0
_KIND_INSTANT = 1

_OTHER_NAME = "<other>"


class SpanTracer:
    """Fixed-capacity span recorder.  Thread-safe: the engine records from
    both the training thread and the checkpoint writer thread."""

    def __init__(self, capacity: int = 1 << 15, max_names: int = 1024):
        assert capacity >= 16
        self.capacity = int(capacity)
        self.max_names = int(max_names)
        self._lane = np.zeros(self.capacity, np.uint8)
        self._kind = np.zeros(self.capacity, np.uint8)
        self._name = np.zeros(self.capacity, np.int32)
        self._t0 = np.zeros(self.capacity, np.float64)
        self._t1 = np.zeros(self.capacity, np.float64)
        self._iter = np.full(self.capacity, -1, np.int64)
        self._arg: List[Any] = [None] * self.capacity
        self._names: Dict[str, int] = {}
        self._name_list: List[str] = []
        self._n = 0                      # total records ever (monotonic)
        self._lock = threading.Lock()
        self.current_iter = -1           # stamped onto every record
        self.enabled = True

    # ------------------------------------------------------------ interning
    def _name_id(self, name: str) -> int:
        nid = self._names.get(name)
        if nid is None:
            if len(self._name_list) >= self.max_names:
                nid = self._names.get(_OTHER_NAME)
                if nid is None:
                    nid = self._intern(_OTHER_NAME)
                return nid
            nid = self._intern(name)
        return nid

    def _intern(self, name: str) -> int:
        nid = len(self._name_list)
        self._names[name] = nid
        self._name_list.append(name)
        return nid

    # ------------------------------------------------------------ recording
    def record(self, lane: str, name: str, t0: float, t1: float,
               arg: Any = None) -> None:
        """Record one completed span.  ``t0``/``t1`` are perf_counter
        readings taken by the caller (so the record call itself is not
        inside the measured interval)."""
        if not self.enabled:
            return
        lid = LANE_ID[lane]
        with self._lock:
            i = self._n % self.capacity
            self._lane[i] = lid
            self._kind[i] = _KIND_SPAN
            self._name[i] = self._name_id(name)
            self._t0[i] = t0
            self._t1[i] = t1
            self._iter[i] = self.current_iter
            self._arg[i] = arg
            self._n += 1

    def instant(self, lane: str, name: str, t: Optional[float] = None,
                arg: Any = None) -> None:
        """Record a zero-duration marker (Chrome ``ph: "i"``)."""
        if not self.enabled:
            return
        ts = time.perf_counter() if t is None else t
        lid = LANE_ID[lane]
        with self._lock:
            i = self._n % self.capacity
            self._lane[i] = lid
            self._kind[i] = _KIND_INSTANT
            self._name[i] = self._name_id(name)
            self._t0[i] = ts
            self._t1[i] = ts
            self._iter[i] = self.current_iter
            self._arg[i] = arg
            self._n += 1

    @contextmanager
    def span(self, lane: str, name: str, arg: Any = None):
        """Context manager form; records on exit (exceptions included)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(lane, name, t0, time.perf_counter(), arg)

    def set_iteration(self, it: int) -> None:
        self.current_iter = int(it)

    # ------------------------------------------------------------- reading
    def _valid(self) -> np.ndarray:
        """Indices of retained records in recording order."""
        n = min(self._n, self.capacity)
        if self._n <= self.capacity:
            return np.arange(n)
        head = self._n % self.capacity
        return np.concatenate([np.arange(head, self.capacity),
                               np.arange(0, head)])

    def spans(self, lanes: Optional[Sequence[str]] = None,
              it: Optional[int] = None,
              kinds: Tuple[int, ...] = (_KIND_SPAN,)) -> np.ndarray:
        """Retained spans as an ``(n, 2)`` float array of (t0, t1),
        optionally filtered by lane set and iteration stamp."""
        with self._lock:
            idx = self._valid()
            mask = np.isin(self._kind[idx], list(kinds))
            if lanes is not None:
                lids = [LANE_ID[l] for l in lanes]
                mask &= np.isin(self._lane[idx], lids)
            if it is not None:
                mask &= self._iter[idx] == it
            idx = idx[mask]
            return np.stack([self._t0[idx], self._t1[idx]], axis=1)

    def records(self) -> List[dict]:
        """Retained records as dicts (export / debugging path — not hot)."""
        with self._lock:
            out = []
            for i in self._valid():
                out.append({
                    "lane": LANES[self._lane[i]],
                    "kind": ("span" if self._kind[i] == _KIND_SPAN
                             else "instant"),
                    "name": self._name_list[self._name[i]],
                    "t0": float(self._t0[i]),
                    "t1": float(self._t1[i]),
                    "iter": int(self._iter[i]),
                    "arg": self._arg[i],
                })
            return out

    # --------------------------------------------------------------- admin
    def clear(self) -> None:
        with self._lock:
            self._n = 0
            self._iter.fill(-1)
            self._arg = [None] * self.capacity
            self._names.clear()
            self._name_list.clear()
            self.current_iter = -1

    def stats(self) -> dict:
        with self._lock:
            return {
                "n_spans": self._n,
                "retained": min(self._n, self.capacity),
                "dropped": max(self._n - self.capacity, 0),
                "capacity": self.capacity,
                "names": len(self._name_list),
            }


# ------------------------------------------------------------------ export
def _json_safe(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (tuple, list)):
        return [_json_safe(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return repr(v)


def chrome_trace_events(tracer: SpanTracer,
                        counters: Optional[Dict[str, Iterable[Tuple[float, float]]]] = None
                        ) -> List[dict]:
    """Chrome trace-event list: thread-name metadata per lane, ``X``
    complete events for spans, ``i`` instants, and ``C`` counter tracks
    (e.g. per-iteration overlap efficiency)."""
    recs = tracer.records()
    t_min = min([r["t0"] for r in recs]
                + [t for vs in (counters or {}).values() for t, _ in vs],
                default=0.0)
    ev: List[dict] = []
    for i, lane in enumerate(LANES):
        ev.append({"name": "thread_name", "ph": "M", "pid": 0, "tid": i,
                   "args": {"name": lane}})
        ev.append({"name": "thread_sort_index", "ph": "M", "pid": 0,
                   "tid": i, "args": {"sort_index": i}})
    for r in recs:
        tid = LANE_ID[r["lane"]]
        ts = (r["t0"] - t_min) * 1e6
        args = {"iter": r["iter"]}
        if r["arg"] is not None:
            args["detail"] = _json_safe(r["arg"])
        if r["kind"] == "span":
            ev.append({"name": r["name"], "cat": r["lane"], "ph": "X",
                       "ts": ts, "dur": max((r["t1"] - r["t0"]) * 1e6, 0.0),
                       "pid": 0, "tid": tid, "args": args})
        else:
            ev.append({"name": r["name"], "cat": r["lane"], "ph": "i",
                       "ts": ts, "s": "t", "pid": 0, "tid": tid,
                       "args": args})
    for cname, values in (counters or {}).items():
        for t, v in values:
            ev.append({"name": cname, "ph": "C", "pid": 0,
                       "ts": (t - t_min) * 1e6,
                       "args": {"value": _json_safe(v)}})
    return ev


def export_chrome_trace(path: str, tracer: SpanTracer,
                        counters: Optional[Dict[str, Iterable[Tuple[float, float]]]] = None,
                        meta: Optional[dict] = None) -> str:
    """Write ``path`` as a Chrome trace-event JSON object (the dict form,
    so ``otherData`` can carry run metadata).  Open it in Perfetto
    (https://ui.perfetto.dev) or ``chrome://tracing``."""
    obj = {
        "traceEvents": chrome_trace_events(tracer, counters),
        "displayTimeUnit": "ms",
        "otherData": _json_safe({"tracer": tracer.stats(),
                                 **(meta or {})}),
    }
    with open(path, "w") as f:
        json.dump(obj, f)
    return path
