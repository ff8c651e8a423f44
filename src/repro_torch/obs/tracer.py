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
``compute`` (step execution), ``adapt`` (the profile→drift→adapt→
apply machinery), ``trainer`` (the trainer's host work between its
dispatches), ``monitor`` (Chameleon's Lightweight-mode books) and ``obs``
(the runtime's close of its observation window).  Fixed lanes keep the
record a single uint8 and give the Chrome-trace export a stable thread
layout.

Each record keeps its **parent**: the innermost span open on the
recording thread when it was recorded, so a layer's self time is its
span less the part its children cover.

**One clock for the host and the device.**  A ``device`` record is an
interval on the device's timeline put on the tracer's clock.  An
*anchor* is a CUDA timing event recorded while the device is idle,
with the host's ``perf_counter`` read just after the record
(:meth:`SpanTracer.anchor`); a later timing event ``e`` maps to
``t_anchor + anchor.elapsed_time(e) / 1e3``.  :meth:`SpanTracer.record_device`
queues an event pair with the anchor current at the call, and
:meth:`SpanTracer.resolve` turns the queued pairs whose events have
completed into records, so no host sync is added for them.  On the CPU a
device record is a plain host interval (:meth:`SpanTracer.mark` reads the
host clock there).  ``stats()["device_s"]`` sums the device records by
``<lane>.<name>``.

**Ranges in the profiler's trace.**  While ``torch.profiler`` records,
each :meth:`SpanTracer.span` also opens a profiler range named
``<lane>.<name>`` (``<prefix>.<name>`` on a thread given a prefix:
the adaptation worker's are ``adapt.worker``), and
:func:`profiler_range` opens one of any name; the gate is the
profiler's own state.  They are ``RecordFunctionFast`` ranges, which do
not pass through a ``TorchDispatchMode``, so they never enter a recorded
op stream (``core.tokenizer`` also skips the ``profiler`` ops that a
``record_function`` range dispatches).

Export is Chrome trace-event JSON (``ph: "X"`` complete events plus
``ph: "C"`` counters), openable in Perfetto or ``chrome://tracing`` —
see :func:`export_chrome_trace`: the host's records are process 0
(``host``), the device records process 1 (``device``), one row a lane
each, on one time base.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

# Fixed lane set: engine traffic classes + compute + adaptation machinery.
LANE_COMPUTE = "compute"
LANE_POLICY_SWAP = "policy_swap"
LANE_KV_SPILL = "kv_spill"
LANE_CHECKPOINT = "checkpoint"
LANE_ADAPT = "adapt"
LANE_TRAINER = "trainer"
LANE_MONITOR = "monitor"
LANE_OBS = "obs"
LANES: Tuple[str, ...] = (LANE_COMPUTE, LANE_POLICY_SWAP, LANE_KV_SPILL,
                          LANE_CHECKPOINT, LANE_ADAPT, LANE_TRAINER,
                          LANE_MONITOR, LANE_OBS)
LANE_ID: Dict[str, int] = {name: i for i, name in enumerate(LANES)}

# transfer lanes considered "hideable under compute" by the overlap metric
TRANSFER_LANES: Tuple[str, ...] = (LANE_POLICY_SWAP, LANE_KV_SPILL,
                                   LANE_CHECKPOINT)

_KIND_SPAN = 0
_KIND_INSTANT = 1
_KIND_DEVICE = 2
_KIND_NAMES = ("span", "instant", "device")

_OTHER_NAME = "<other>"
DEVICE_PID = 1                   # the Chrome export's device process

# a point on the device's timeline: a CUDA timing event, or on the CPU a
# host clock reading
Mark = Any

_NULL_RANGE = contextlib.nullcontext()


def _profiling() -> bool:
    return torch.autograd._profiler_enabled()


def profiler_range(name: str):
    """A range named ``name`` in the profiler's trace while
    ``torch.profiler`` records, else nothing (module doc)."""
    if _profiling():
        return torch._C._profiler._RecordFunctionFast(name)
    return _NULL_RANGE


def mark_seconds(start: Mark, end: Mark) -> float:
    """Seconds from ``start`` to ``end``: two completed timing events, or
    two host clock readings."""
    if isinstance(start, float):
        return end - start
    return start.elapsed_time(end) / 1e3


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
        self._parent = np.full(self.capacity, -1, np.int32)
        self._arg: List[Any] = [None] * self.capacity
        self._names: Dict[str, int] = {}
        self._name_list: List[str] = []
        self._n = 0                      # total records ever (monotonic)
        self._lock = threading.Lock()
        self._local = threading.local()  # open spans, range prefix
        # the device clock: (anchor event, host time), and the device
        # records waiting for their events
        self._anchor: Optional[Tuple[Any, float]] = None
        self._pending: List[tuple] = []
        # device seconds and records by (lane id, name id)
        self._device_s: Dict[Tuple[int, int], float] = {}
        self._device_n: Dict[Tuple[int, int], int] = {}
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
    def _open(self) -> list:
        """The names of the spans open on this thread, innermost last."""
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _put(self, lane: str, kind: int, name: str, t0: float, t1: float,
             arg: Any, parent: Optional[str], it: Optional[int] = None
             ) -> None:
        lid = LANE_ID[lane]
        with self._lock:
            i = self._n % self.capacity
            nid = self._name_id(name)
            self._lane[i] = lid
            self._kind[i] = kind
            self._name[i] = nid
            self._t0[i] = t0
            self._t1[i] = t1
            self._iter[i] = self.current_iter if it is None else it
            self._parent[i] = -1 if parent is None else self._name_id(parent)
            self._arg[i] = arg
            self._n += 1
            if kind == _KIND_DEVICE:
                key = (lid, nid)
                self._device_s[key] = self._device_s.get(key, 0.0) + t1 - t0
                self._device_n[key] = self._device_n.get(key, 0) + 1

    def record(self, lane: str, name: str, t0: float, t1: float,
               arg: Any = None) -> None:
        """Record one completed span.  ``t0``/``t1`` are perf_counter
        readings taken by the caller (so the record call itself is not
        inside the measured interval).  Its parent is the innermost span
        open on this thread."""
        if not self.enabled:
            return
        stack = self._open()
        self._put(lane, _KIND_SPAN, name, t0, t1, arg,
                  stack[-1] if stack else None)

    def instant(self, lane: str, name: str, t: Optional[float] = None,
                arg: Any = None) -> None:
        """Record a zero-duration marker (Chrome ``ph: "i"``)."""
        if not self.enabled:
            return
        ts = time.perf_counter() if t is None else t
        stack = self._open()
        self._put(lane, _KIND_INSTANT, name, ts, ts, arg,
                  stack[-1] if stack else None)

    @contextmanager
    def span(self, lane: str, name: str, arg: Any = None):
        """Context manager form; records on exit (exceptions included).
        While ``torch.profiler`` records, the span is also a profiler
        range (module doc)."""
        stack = self._open()
        rng = (torch._C._profiler._RecordFunctionFast(
                   f"{getattr(self._local, 'prefix', lane)}.{name}")
               if _profiling() else _NULL_RANGE)
        with rng:
            stack.append(name)
            t0 = time.perf_counter()
            try:
                yield
            finally:
                t1 = time.perf_counter()
                stack.pop()
                self.record(lane, name, t0, t1, arg)

    def set_thread_prefix(self, prefix: str) -> None:
        """Name this thread's profiler ranges ``<prefix>.<name>``."""
        self._local.prefix = prefix

    def set_iteration(self, it: int) -> None:
        self.current_iter = int(it)

    # --------------------------------------------------------- device clock
    @staticmethod
    def mark(device: torch.device) -> Mark:
        """A point on ``device``'s timeline: a timing event recorded on
        its current stream, or on the CPU the host clock."""
        if device.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        return ev

    def anchor(self, device: torch.device) -> Mark:
        """:meth:`mark`, which on a CUDA device also becomes the clock's
        anchor when the current stream was idle at its record (or when
        there is none yet): the host clock read just after the record is
        then the device's time of the event."""
        if device.type != "cuda":
            return time.perf_counter()
        stream = torch.cuda.current_stream(device)
        idle = stream.query()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        if idle or self._anchor is None:
            self.set_anchor(ev, time.perf_counter())
        return ev

    def set_anchor(self, event, t: float) -> None:
        """Anchor the device clock at ``event``, a timing event the device
        passed at host time ``t``."""
        self._anchor = (event, float(t))

    @property
    def anchored(self) -> bool:
        """There is an anchor, and the device has passed it."""
        a = self._anchor
        return a is not None and a[0].query()

    def device_time(self, event) -> float:
        """A completed timing event's time on the tracer's clock, through
        the current anchor."""
        a_ev, a_t = self._anchor
        return a_t + a_ev.elapsed_time(event) / 1e3

    def record_device(self, lane: str, name: str, start: Mark, end: Mark,
                      arg: Any = None) -> None:
        """Record the device interval from ``start`` to ``end``: two timing
        events, queued with the current anchor until :meth:`resolve`
        finds them complete (dropped when there is no anchor), or two
        host clock readings, recorded at once.  Its parent is the
        innermost span open on this thread at the call.  The queue holds
        at most ``capacity`` pairs: where nothing resolves it, the oldest
        is dropped."""
        if not self.enabled:
            return
        stack = self._open()
        parent = stack[-1] if stack else None
        if isinstance(start, float):
            self._put(lane, _KIND_DEVICE, name, start, end, arg, parent)
            return
        if self._anchor is None:
            return
        with self._lock:
            if len(self._pending) >= self.capacity:
                del self._pending[0]
            self._pending.append((lane, name, start, end, arg, self._anchor,
                                  self.current_iter, parent))

    def resolve(self) -> int:
        """Record the queued device intervals whose events have completed,
        each through the anchor current at its :meth:`record_device`;
        returns how many stay queued.  Never waits for the device."""
        with self._lock:
            pending, self._pending = self._pending, []
        keep = []
        for p in pending:
            lane, name, start, end, arg, (a_ev, a_t), it, parent = p
            if not (end.query() and a_ev.query()):
                keep.append(p)
                continue
            self._put(lane, _KIND_DEVICE, name,
                      a_t + a_ev.elapsed_time(start) / 1e3,
                      a_t + a_ev.elapsed_time(end) / 1e3, arg, parent, it)
        with self._lock:
            self._pending[:0] = keep
            return len(self._pending)

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
        """Retained spans (or records of ``kinds``) as an ``(n, 2)`` float
        array of (t0, t1), optionally filtered by lane set and iteration
        stamp."""
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
                p = int(self._parent[i])
                out.append({
                    "lane": LANES[self._lane[i]],
                    "kind": _KIND_NAMES[self._kind[i]],
                    "name": self._name_list[self._name[i]],
                    "t0": float(self._t0[i]),
                    "t1": float(self._t1[i]),
                    "iter": int(self._iter[i]),
                    "parent": self._name_list[p] if p >= 0 else None,
                    "arg": self._arg[i],
                })
            return out

    # --------------------------------------------------------------- admin
    def clear(self) -> None:
        with self._lock:
            self._n = 0
            self._iter.fill(-1)
            self._parent.fill(-1)
            self._arg = [None] * self.capacity
            self._names.clear()
            self._name_list.clear()
            self._pending = []
            self._anchor = None
            self._device_s.clear()
            self._device_n.clear()
            self.current_iter = -1

    def stats(self) -> dict:
        """Counts of the ring, and ``device_s`` / ``device_n``: the
        seconds and the number of the device records ever resolved, by
        ``<lane>.<name>``."""
        with self._lock:
            key = lambda k: f"{LANES[k[0]]}.{self._name_list[k[1]]}"
            return {
                "n_spans": self._n,
                "retained": min(self._n, self.capacity),
                "dropped": max(self._n - self.capacity, 0),
                "capacity": self.capacity,
                "names": len(self._name_list),
                "pending": len(self._pending),
                "device_s": {key(k): v for k, v in self._device_s.items()},
                "device_n": {key(k): v for k, v in self._device_n.items()},
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
    (e.g. per-iteration overlap efficiency).  Device records, where there
    are any, are process 1 (``device``), one thread a lane, on the same
    time base as the host's process 0."""
    tracer.resolve()
    recs = tracer.records()
    t_min = min([r["t0"] for r in recs]
                + [t for vs in (counters or {}).values() for t, _ in vs],
                default=0.0)
    ev: List[dict] = []
    pids = [0] + ([DEVICE_PID] if any(r["kind"] == "device" for r in recs)
                  else [])
    for pid in pids:
        if pid == DEVICE_PID:
            ev.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": "device"}})
        for i, lane in enumerate(LANES):
            ev.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": i, "args": {"name": lane}})
            ev.append({"name": "thread_sort_index", "ph": "M", "pid": pid,
                       "tid": i, "args": {"sort_index": i}})
    for r in recs:
        tid = LANE_ID[r["lane"]]
        ts = (r["t0"] - t_min) * 1e6
        args = {"iter": r["iter"]}
        if r["arg"] is not None:
            args["detail"] = _json_safe(r["arg"])
        if r["parent"] is not None:
            args["parent"] = r["parent"]
        if r["kind"] == "instant":
            ev.append({"name": r["name"], "cat": r["lane"], "ph": "i",
                       "ts": ts, "s": "t", "pid": 0, "tid": tid,
                       "args": args})
        else:
            ev.append({"name": r["name"], "cat": r["lane"], "ph": "X",
                       "ts": ts, "dur": max((r["t1"] - r["t0"]) * 1e6, 0.0),
                       "pid": DEVICE_PID if r["kind"] == "device" else 0,
                       "tid": tid, "args": args})
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
