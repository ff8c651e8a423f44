"""Async transfer engine: prioritized per-traffic-class streams over the
pinned pool.  Port of ``repro/hostmem/engine.py``.

The host link is shared by three kinds of traffic with very different
latency requirements, so the engine keeps one D2H/H2D stream pair **per
traffic class** — on a CUDA device, one pair of real CUDA streams each:

  * ``policy_swap`` — activation swaps scheduled by the policy (§5.4);
    latency-critical: a late swap-in stalls the training step directly;
  * ``kv_spill``    — serving-side decode-slot spill/restore;
  * ``checkpoint``  — bulk checkpoint drains; huge, latency-tolerant.

A transfer has two moments.  It is **issued** when it is submitted: on a
CUDA device the class's stream waits on an event recorded on the current
stream (so the copy sees every write that was submitted before it), the
copy is enqueued with ``non_blocking=True`` between two timing events,
and submission returns at once.  On the CPU, which only the tests ask
for, the copy runs synchronously at issue.  It is **retired** when the
engine's scheduler says so, exactly as the reference runs a copy: when the
class window (``depth``, default 2 = double buffering) overflows —
submitting transfer *k+depth* forces transfer *k* to retire — or when
someone waits on the event.  Retirement picks the head of the
highest-priority non-empty class queue (strict priority at transfer
granularity), so the counters, windows and forced retires are the
reference's.  Within a class, completion order is FIFO per direction —
what a hardware copy stream guarantees.

On a CUDA device the copies of every class are already on their streams
when the scheduler runs, and share the link as the hardware schedules
them: strict priority orders only the host's retirements, the engine's
books on a copy (its ledger note, trace span, counters and health), which
read the copy's done-event.  There ``stall_transfers``, ``preemptions``
and ``forced_retires`` count that host-side order, not an order on the
link, and ``stall_s`` (link seconds spent on other classes) is not
accrued: the engine does not measure how long another class's copy
overlapped a waiting class's copy on the link (each copy's own time is
measured; their overlap on the shared link is not).  A retire whose copy
has not completed blocks the host on its done-event; ``host_waits`` and
``host_wait_s`` count those.  The policy's copies take none inside a grad
dispatch: a release op retires only copies already done (below), a
swap-in of an unretired swap-out is chained on the device (its H2D stream
waits on the D2H's done-event), and the executor retires the rest after
the step has synchronised (``core.executor``).  On the CPU, where each copy runs
at issue, all of them are the reference's.

The contention signals the simulator prices are measured on a CUDA
device.  ``queued_delay`` counts only copies whose done-event has not
completed (``Event.query``): a copy that finished on its stream is no
backlog, even before the host retires it.  Both ``queued_delay`` and
``sustained_contention`` price bytes with the calibrated curve of the
copy's direction (``link_models``, set by ``HostMemTier.calibrate``),
else with the engine's own measured rate in that direction (bytes over
the CUDA-event time of the copies it has retired), else with
``LINK_GBPS``.  On the CPU they price as the reference does, bit for bit.

Retiring a copy synchronises its done-event and only then lets go of what
the copy used: a swap-in returns its pinned slab to the pool there, and on
the CPU a swap-out drops its source there.  The policy's free-times map
onto swap-outs via :meth:`plan_release` (``release_op``), and the
execution path drives them via :meth:`advance_op`.  On a CUDA device:

  * a swap-out's source tensors are marked with ``record_stream`` on the
    class's D2H stream and dropped at issue (the ``recordStream`` release
    point of paper §5.4.2): the allocator does not hand out a device
    temporary such as an int8 payload until the copy that reads it is
    done, and frees it as soon as it is, not at a later retirement;
  * at a swap-out's release op a copy already done retires, and one still
    running retires later, at a release op that finds it done or when the
    class is drained (``released_late``): neither the host nor the device
    waits for it there.  The reference's drop point in stream order (hold
    the source until the release op, where the current stream waits on
    the copy and the source drops) was measured and left: on an NVIDIA
    H100 at 2 x 3072 tokens it stalled the compute stream 17-25 ms a step
    (the D2H queue runs behind the simulator's promised ops) and raised
    the step's allocated peak by 136 MB, while ``record_stream`` with no
    host wait took no allocator retry (PERF.md, §6; tools/p4_host.py).

A caller that will overwrite a swap-out's source in place (the KV spill
overwrites the slot row) calls :meth:`fence` first: the current stream
then waits on the copy's done-event, on the device, without a host
synchronisation.

``ev.seconds`` is the copy's own time from the CUDA events around it on
its stream (on the CPU, the host clock around the synchronous copy), and
feeds the attached :class:`~repro_torch.hostmem.bwmodel.BandwidthModel`,
so steady-state traffic keeps the measured curve fresh; the simulator can
price link *contention* from the live per-class backlog via
:meth:`queued_delay`.

Where a copy lies in the trace: on a CUDA device, once the tracer's
device clock is anchored (the trainer anchors it at each grad dispatch),
each retired copy is a ``device`` record of its class's lane, from its
start event to its done event on the device's timeline
(``obs.tracer``), with (tag, bytes, queue wait) as its ``arg``, the
queue wait running from its submission on the host to its start on the
device; the memory ledger notes it at its done event's time.  Otherwise
(the CPU, or a card with no anchor) it is a host span from its issue to
its issue plus its time, the queue wait from its submission to its
issue.

The engine is thread-safe (one re-entrant lock around queue mutation).
"""
from __future__ import annotations

import collections
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple, Union

import torch

from repro_torch import faults, obs
from repro_torch.common.config import ResilienceConfig
from repro_torch.common.device import resolve_device
from repro_torch.faults.health import MEM_CLASS, HealthMonitor
from repro_torch.hostmem.pool import (HostBlock, Payload, PinnedSlabPool,
                                      as_bytes, payload_nbytes)

SWAP_OUT = "out"                 # device -> host
SWAP_IN = "in"                   # host -> device


class TransferError(RuntimeError):
    """A D2H/H2D copy failed (link fault, dropped DMA, device error)."""

# Traffic classes, highest priority first (index == priority level).
TC_POLICY_SWAP = "policy_swap"
TC_KV_SPILL = "kv_spill"
TC_CHECKPOINT = "checkpoint"
TRAFFIC_CLASSES: Tuple[str, ...] = (TC_POLICY_SWAP, TC_KV_SPILL,
                                    TC_CHECKPOINT)
PRIORITY: Dict[str, int] = {c: i for i, c in enumerate(TRAFFIC_CLASSES)}

# The host link of an NVIDIA H100 80GB HBM3 (700 W), measured through this
# engine by chip_smoke.py's calibrate phase: 512 MiB device to host in
# 14.2 ms, host to device in 12.5 ms (PERF.md §5).  The contention
# estimate falls back to it where nothing better is known.
LINK_GBPS: Dict[str, float] = {SWAP_OUT: 37.8, SWAP_IN: 42.9}
_EST_FALLBACK_GBPS = LINK_GBPS[SWAP_OUT]   # the CPU's, without a bwmodel

# arrival-rate EWMA time constant: how much enqueue history "sustained
# contention" remembers.  ~2 s spans several iterations of the reduced
# configs while forgetting a finished drain within a few constants.
ARRIVAL_TAU_S = 2.0


@dataclass
class TransferEvent:
    eid: int
    kind: str                    # SWAP_OUT | SWAP_IN
    tag: str
    nbytes: int
    cls: str = TC_POLICY_SWAP    # traffic class (stream selector)
    done: bool = False
    failed: bool = False         # terminal failure (swap-out: retained in HBM)
    seconds: float = 0.0         # measured copy time once done
    block: Optional[HostBlock] = None   # staging slab (owned until swap-in)
    # swap-in: the device tensor, allocated when the copy is issued; read
    # it after wait() or, on the device, after fence()
    result: Any = None
    release_op: int = -1         # policy-planned release point (§5.4.2)
    t_submit: float = 0.0        # perf_counter at submission (queue wait)
    _source: Any = field(default=None, repr=False)   # held to retire (CPU)
    _callbacks: List[Callable] = field(default_factory=list, repr=False)
    _free_block: bool = field(default=True, repr=False)  # swap-in frees slab
    # terminal failure of the issue step, handled when the event retires
    _error: Optional[BaseException] = field(default=None, repr=False)
    # (start, done) CUDA events around an issued device copy
    _cuda: Optional[Tuple[Any, Any]] = field(default=None, repr=False)
    _t_issue: float = field(default=0.0, repr=False)  # host clock at issue
    _stall_s: float = field(default=0.0, repr=False)  # injected link stall
    _released: bool = field(default=False, repr=False)  # its release op came
    # swap-in: the swap-out it was chained after on the device, retired
    # first so the books see the bytes leave before they come back
    _after: Optional["TransferEvent"] = field(default=None, repr=False)

    @property
    def failed_at_issue(self) -> bool:
        """The copy already failed for good when it was issued (retries
        run at issue); ``failed`` is set only when the event retires."""
        return self._error is not None

    def on_done(self, fn: Callable[["TransferEvent"], None]) -> None:
        if self.done:
            fn(self)
        else:
            self._callbacks.append(fn)


@dataclass
class ClassCounters:
    """Per-traffic-class byte/time/stall accounting."""
    n_out: int = 0
    n_in: int = 0
    bytes_out: int = 0
    bytes_in: int = 0
    time_out_s: float = 0.0
    time_in_s: float = 0.0
    forced_retires: int = 0      # completions forced by this class's window
    # host seconds those forced retires waited; on a CUDA device, retires
    # that blocked the host on a copy not yet done, and their seconds; and
    # swap-outs not retired at their release op (still copying, or queued
    # behind one that is) (read by the executor; not in ``as_dict``, whose
    # keys are the reference's)
    forced_wait_s: float = 0.0
    host_waits: int = 0
    host_wait_s: float = 0.0
    released_late: int = 0
    stall_s: float = 0.0         # link time spent on other classes while
    stall_transfers: int = 0     # ... this class had a transfer waiting
                                 # (stall_s on the CPU only: module doc)
    preemptions: int = 0         # times this class jumped a lower-class head
    # swap-outs released by advance_op at their release op (§5.4.2):
    # retired there, or on a CUDA device retired later (``released_late``)
    released_at_op: int = 0
    retries: int = 0             # copy attempts re-issued after an error
    timeouts: int = 0            # copies slower than the health limit
    failures: int = 0            # terminal failures after retries exhausted
    hwm_queued_bytes: int = 0    # high-water mark of the class backlog

    def as_dict(self) -> dict:
        return {
            "n_out": self.n_out, "n_in": self.n_in,
            "bytes_out": self.bytes_out, "bytes_in": self.bytes_in,
            "time_out_s": self.time_out_s, "time_in_s": self.time_in_s,
            "forced_retires": self.forced_retires,
            "stall_s": self.stall_s,
            "stall_transfers": self.stall_transfers,
            "preemptions": self.preemptions,
            "released_at_op": self.released_at_op,
            "retries": self.retries,
            "timeouts": self.timeouts,
            "failures": self.failures,
            "hwm_queued_bytes": self.hwm_queued_bytes,
        }


class TransferEngine:
    def __init__(self, pool: PinnedSlabPool, *, depth: int = 2,
                 bwmodel=None,
                 class_depths: Optional[Dict[str, int]] = None,
                 resilience: Optional[ResilienceConfig] = None,
                 device: Union[str, torch.device, None] = None):
        assert depth >= 1
        self.pool = pool
        # swap-ins land here; ``cuda`` unless the caller asks for the CPU
        self.device = resolve_device(device)
        self._streams: Dict[Tuple[str, str], Any] = {}   # (cls, kind) -> stream
        self.depth = depth
        self.bwmodel = bwmodel
        self.resilience = resilience or ResilienceConfig()
        rs = self.resilience
        # the extra "memory" pseudo-class carries budget-headroom pressure
        # from the obs memory ledger into the same FSM the ladder reads
        self.health = HealthMonitor(
            TRAFFIC_CLASSES + (MEM_CLASS,), degrade_score=rs.degrade_score,
            fail_score=rs.fail_score,
            recover_successes=rs.recover_successes,
            residual_limit=rs.residual_limit, decay=rs.health_decay)
        self._depths = {c: depth for c in TRAFFIC_CLASSES}
        for c, d in (class_depths or {}).items():
            self._check_class(c)
            self._depths[c] = max(int(d), 1)
        self._pending: Dict[Tuple[str, str], Deque[TransferEvent]] = {
            (c, k): collections.deque()
            for c in TRAFFIC_CLASSES for k in (SWAP_OUT, SWAP_IN)}
        self._eid = 0
        # an execution (``core.executor``) whose books on its policy copies
        # are open after its step; settled before the next one begins
        self.open_execution = None
        # per-class arrival-rate EWMA (bytes/s enqueued): exponential
        # decay over ARRIVAL_TAU_S, updated at every submit — the input
        # to sustained_contention(), which prices steady other-class
        # traffic into policy generation instead of only the
        # point-in-time backlog queued_delay() sees
        self._arr_rate_bps: Dict[str, float] = {c: 0.0
                                                for c in TRAFFIC_CLASSES}
        self._arr_mean_bytes: Dict[str, float] = {c: 0.0
                                                  for c in TRAFFIC_CLASSES}
        self._arr_last_t: Dict[str, float] = {c: 0.0
                                              for c in TRAFFIC_CLASSES}
        self._planned_release: Dict[str, int] = {}
        # per-direction calibrated link curves (HostMemTier.calibrate) and
        # [bytes, seconds] of the CUDA copies retired in each direction:
        # what the contention estimates price bytes with on the card
        self.link_models: Dict[str, Any] = {}
        self._retired_link: Dict[str, List[float]] = {
            SWAP_OUT: [0, 0.0], SWAP_IN: [0, 0.0]}
        self._lock = threading.RLock()
        self.current_op = -1             # execution-path op cursor
        self.by_class: Dict[str, ClassCounters] = {
            c: ClassCounters() for c in TRAFFIC_CLASSES}
        # ---- aggregate counters ----
        self.n_out = self.n_in = 0
        self.bytes_out = self.bytes_in = 0
        self.time_out_s = self.time_in_s = 0.0
        self.forced_retires = 0          # completions forced by a full window
        # ---- recovery counters (repro_torch.faults) ----
        self.n_retries = 0               # re-issued copy attempts
        self._n_latency_obs = 0          # completed copies fed to health
        self.n_timeouts = 0              # copies over the health time limit
        self.n_failed_out = 0            # swap-outs retained in HBM
        self.n_failed_in = 0             # swap-ins with data unavailable
        self.n_sync_fallback_in = 0      # swap-ins served by synchronous copy
        self.n_hbm_fallback_in = 0       # swap-ins short-circuited from HBM

    @staticmethod
    def _check_class(cls: str) -> str:
        if cls not in PRIORITY:
            raise ValueError(f"unknown traffic class {cls!r}; "
                             f"expected one of {TRAFFIC_CLASSES}")
        return cls

    # --------------------------------------------------------- submission
    def submit_swap_out(self, array: Payload, tag: str = "",
                        cls: str = TC_POLICY_SWAP) -> TransferEvent:
        """Issue a D2H copy of ``array`` on the class's stream and queue its
        retirement.  ``array`` is a tensor, or a sequence of contiguous
        tensors staged back to back into one slab (one transfer)."""
        self._check_class(cls)
        nbytes = payload_nbytes(array)
        with self._lock:
            self._eid += 1
            ev = TransferEvent(self._eid, SWAP_OUT, tag, nbytes, cls=cls,
                               t_submit=time.perf_counter(), _source=array)
            ev.release_op = self._planned_release.get(tag, -1)
            self._issue(ev)
            self._enqueue(ev)
        return ev

    def submit_swap_in(self, block_or_event, tag: str = "",
                       free_block: bool = True,
                       cls: Optional[str] = None) -> TransferEvent:
        """Queue an H2D copy restoring a staged block to the device.

        Accepts a still-queued swap-out event: the dependency is
        auto-chained (it must have staged its bytes before they can come
        back).  On a CUDA device a swap-out whose copy was issued is
        chained on the device: the class's H2D stream waits on its
        done-event, and neither copy blocks the host.  Otherwise the
        swap-out is retired first.
        """
        with self._lock:
            after = None
            if isinstance(block_or_event, TransferEvent):
                src = block_or_event
                if cls is None:
                    cls = src.cls
                if not src.done:
                    if self._on_device(src):
                        self._stream(self._check_class(cls),
                                     SWAP_IN).wait_event(src._cuda[1])
                        after = src
                    else:
                        self.wait(src)            # auto-chain the dependency
                if src.failed and src.result is not None:
                    # the swap-out never left HBM (terminal D2H failure →
                    # source retained): the swap-in short-circuits to the
                    # retained device reference — bit-exact, zero copies
                    self._eid += 1
                    ev = TransferEvent(self._eid, SWAP_IN,
                                       tag or src.tag, src.nbytes,
                                       cls=self._check_class(cls),
                                       done=True, result=src.result,
                                       t_submit=time.perf_counter())
                    self.n_hbm_fallback_in += 1
                    obs.audit().event("engine.hbm_fallback_in",
                                      cls=ev.cls, tag=ev.tag[:48],
                                      nbytes=ev.nbytes)
                    return ev
                blk = src.block
            else:
                blk = block_or_event
            cls = self._check_class(cls or TC_POLICY_SWAP)
            if blk is None:
                raise ValueError(
                    "swap-in requires a staged block: the source swap-out's "
                    "slab was already consumed (freed or swapped in)")
            self._eid += 1
            ev = TransferEvent(self._eid, SWAP_IN, tag or blk.tag, blk.nbytes,
                               cls=cls, block=blk,
                               t_submit=time.perf_counter(),
                               _free_block=free_block, _after=after)
            self._issue(ev)
            self._enqueue(ev)
        return ev

    def _note_arrival(self, cls: str, nbytes: int, now: float) -> None:
        """Decay-then-add rate update: each arrival contributes
        ``nbytes / tau`` and decays exponentially, so the estimator
        converges to the true sustained bytes/s of a steady stream."""
        last = self._arr_last_t[cls]
        rate = self._arr_rate_bps[cls]
        if last > 0.0:
            rate *= math.exp(-(now - last) / ARRIVAL_TAU_S)
        self._arr_rate_bps[cls] = rate + nbytes / ARRIVAL_TAU_S
        mean = self._arr_mean_bytes[cls]
        self._arr_mean_bytes[cls] = (nbytes if mean == 0.0
                                     else 0.8 * mean + 0.2 * nbytes)
        self._arr_last_t[cls] = now

    def _enqueue(self, ev: TransferEvent) -> None:
        self._note_arrival(ev.cls, ev.nbytes, ev.t_submit)
        q = self._pending[(ev.cls, ev.kind)]
        q.append(ev)
        cc = self.by_class[ev.cls]
        qb = sum(e.nbytes for k in (SWAP_OUT, SWAP_IN)
                 for e in self._pending[(ev.cls, k)])
        if qb > cc.hwm_queued_bytes:
            cc.hwm_queued_bytes = qb
        while len(q) > self._depths[ev.cls]:  # class window overflow
            t0 = time.perf_counter()
            ran = self._step(ev.kind, waiting_cls=ev.cls)
            if ran is not None and ran.cls == ev.cls:
                # count only this class's own retirement — higher-priority
                # transfers jumping ahead are stall, not window pressure
                self.forced_retires += 1
                cc = self.by_class[ev.cls]
                cc.forced_retires += 1
                cc.forced_wait_s += time.perf_counter() - t0

    # ---------------------------------------------------------- execution
    def _step(self, kind: str,
              waiting_cls: Optional[str] = None) -> Optional[TransferEvent]:
        """Run the head of the highest-priority non-empty ``kind`` queue
        (strict priority, transfer-granularity preemption).  When a class
        is known to be waiting on the link, link time spent serving other
        classes is charged to its stall counters."""
        best = None
        for c in TRAFFIC_CLASSES:            # priority order
            q = self._pending[(c, kind)]
            if q:
                best = (c, q)
                break
        if best is None:
            return None
        c, q = best
        ev = q.popleft()
        if waiting_cls is not None and c != waiting_cls:
            # a higher-priority class jumped ahead of the waiting one
            w = self.by_class[waiting_cls]
            w.stall_transfers += 1
            self.by_class[c].preemptions += 1
        self._execute(ev)
        if (waiting_cls is not None and c != waiting_cls
                and self.device.type != "cuda"):
            # on the card the copy ran on its own stream, concurrently with
            # the waiting class's: its seconds were not the waiter's stall
            self.by_class[waiting_cls].stall_s += ev.seconds
        return ev

    # ------------------------------------------------------------ issuing
    def _stream(self, cls: str, kind: str):
        """The class's CUDA stream for ``kind`` (created at first use)."""
        st = self._streams.get((cls, kind))
        if st is None:
            st = self._streams[(cls, kind)] = torch.cuda.Stream(self.device)
        return st

    def _current_stream(self):
        return torch.cuda.current_stream(self.device)

    def _record_current(self, timing: bool = False):
        ev = torch.cuda.Event(enable_timing=timing)
        ev.record(self._current_stream())
        return ev

    def _on_device(self, ev: TransferEvent) -> bool:
        """``ev``'s copy was issued on a CUDA stream (its result, if any,
        is there once its done-event is)."""
        return self.device.type == "cuda" and ev._cuda is not None

    def _on_link(self, ev: TransferEvent) -> bool:
        """``ev``'s copy is still running on its CUDA stream."""
        return self._on_device(ev) and not ev._cuda[1].query()

    def _d2h(self, ev: TransferEvent) -> None:
        """Stage ``ev._source`` into its slab.  On a CUDA device the copy is
        enqueued on the class's D2H stream after everything already
        submitted on the current stream (the last write of the source);
        the source tensors are then marked as used by that stream and
        dropped, so their memory returns to the caching allocator once the
        copy is done."""
        if self.device.type != "cuda":
            ev.block.write(ev._source)
            return
        stream = self._stream(ev.cls, SWAP_OUT)
        stream.wait_event(self._record_current())
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(stream):
            start.record(stream)
            ev.block.write(ev._source, non_blocking=True)
            done.record(stream)
        ev._cuda = (start, done)
        for t in ([ev._source] if isinstance(ev._source, torch.Tensor)
                  else ev._source):
            if t.is_cuda:
                t.record_stream(stream)
        ev._source = None

    def _h2d(self, ev: TransferEvent, host: torch.Tensor) -> torch.Tensor:
        """Bring a staged payload back.  On a CUDA device the result is
        allocated on the current stream and filled on the class's H2D
        stream once the current stream's earlier work is done (the memory
        may be a block that work just freed)."""
        if self.device.type != "cuda":
            return host.clone()
        out = torch.empty(host.shape, dtype=host.dtype, device=self.device)
        stream = self._stream(ev.cls, SWAP_IN)
        stream.wait_event(self._record_current())
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(stream):
            start.record(stream)
            out.copy_(host, non_blocking=True)
            done.record(stream)
        ev._cuda = (start, done)
        return out

    def _copy_once(self, ev: TransferEvent) -> None:
        """One copy attempt, with the repro_torch.faults hook points.
        Raises on failure; the staging slab survives across attempts.  A
        swap-out *verifies* the payload was staged, so a dropped D2H is
        caught while the source is still held — the data can never be lost
        between retries."""
        f = faults.inject("engine.transfer_stall", key=ev.tag)
        if f is not None and f.seconds > 0:
            time.sleep(f.seconds)
            ev._stall_s = f.seconds
        if ev.kind == SWAP_OUT:
            if ev.block is None:
                ev.block = self.pool.alloc(ev.nbytes, tag=ev.tag)
            if faults.inject("engine.transfer_error", key=ev.tag) is not None:
                raise TransferError(f"injected D2H failure ({ev.tag!r})")
            if faults.inject("engine.transfer_drop", key=ev.tag) is None:
                self._d2h(ev)
            if ev.block.shape is None:   # staging never landed (dropped DMA)
                raise TransferError(f"D2H for {ev.tag!r} staged nothing")
        else:
            if faults.inject("engine.transfer_error", key=ev.tag) is not None:
                raise TransferError(f"injected H2D failure ({ev.tag!r})")
            host = ev.block.typed()
            if faults.inject("engine.transfer_drop", key=ev.tag) is not None:
                raise TransferError(f"H2D for {ev.tag!r} dropped")
            ev.result = self._h2d(ev, host)

    def _issue(self, ev: TransferEvent) -> None:
        """Start the copy, retrying a failed attempt with backoff.  A
        terminal failure is kept on the event and handled when it retires,
        so completion stays FIFO per class even under faults."""
        rs = self.resilience
        attempts = 0
        while True:
            t0 = time.perf_counter()
            try:
                self._copy_once(ev)
                break
            except Exception as err:     # noqa: BLE001 — injected or organic
                if not rs.enabled:
                    raise                # legacy behavior: surface directly
                attempts += 1
                if attempts > rs.max_retries:
                    # without its traceback: the traceback's frames reach
                    # the caller's (an autograd pack hook's forward frames
                    # and their activations), and through the saved
                    # tensor's C++ graph node this event again, a cycle
                    # the collector cannot see, so a failed copy kept a
                    # whole step's activations alive (P10)
                    ev._error = err.with_traceback(None)
                    if ev.kind == SWAP_OUT and not isinstance(ev._source,
                                                              torch.Tensor):
                        # chunks may be views of state the caller reuses
                        # at once: retain the bytes the slab would hold
                        ev._source = torch.cat(
                            [as_bytes(c.detach().contiguous())
                             for c in ev._source])
                    return
                self.n_retries += 1
                self.by_class[ev.cls].retries += 1
                self.health.note_retry(ev.cls)
                obs.audit().event("engine.retry", cls=ev.cls, dir=ev.kind,
                                  tag=ev.tag[:48], attempt=attempts,
                                  error=repr(err)[:120])
                delay = min(rs.retry_backoff_s * (2 ** (attempts - 1)),
                            rs.backoff_cap_s)
                if delay > 0:
                    time.sleep(delay)
        ev._t_issue = t0
        ev.seconds = time.perf_counter() - t0    # the CPU's synchronous copy

    def fence(self, ev: TransferEvent, timed: bool = False
              ) -> Optional[Tuple[Any, Any]]:
        """Make work submitted from now on to the current stream wait until
        ``ev``'s copy is done, on the device and without a host sync: then
        a swap-out's source may be overwritten, or a swap-in's result read.
        A no-op on the CPU, where copies are synchronous.  A copy that failed
        for good at issue has no result until it retires (a swap-in's is the
        synchronous fallback copy): it is retired here, with a host wait.

        ``timed``: a timing event is recorded on the current stream just
        before the wait, and ``(need, done)`` is returned, the two events
        whose ``need.elapsed_time(done)``, once both have completed, is how
        long the stream waited for the copy (a negative time: not at all).
        None where the stream did not wait on the device."""
        if ev.failed_at_issue and not ev.done:
            self.wait(ev)
        elif ev._cuda is not None and not ev.done:
            done = ev._cuda[1]
            need = self._record_current(timing=True) if timed else None
            self._current_stream().wait_event(done)
            return (need, done) if timed else None
        return None

    # ---------------------------------------------------------- retiring
    def _fail_transfer(self, ev: TransferEvent, err: BaseException) -> None:
        """Terminal failure after retries: degrade, don't crash.

        Swap-out: retain the source on the device (the block simply never
        leaves it; a later swap-in short-circuits) — bit-exact at the cost
        of budget headroom.  Swap-in: fall back to a synchronous copy from
        the slab that bypasses the class stream; only if even the slab
        read fails is the original error surfaced (the payload genuinely
        does not exist)."""
        cc = self.by_class[ev.cls]
        self.health.note_error(ev.cls)
        if ev.kind == SWAP_OUT:
            if ev.block is not None and not ev.block.freed:
                self.pool.free(ev.block)     # exactly-once slab release
            ev.block = None
            ev.result, ev._source = ev._source, None
            ev.failed = True
            ev.done = True
            self.n_failed_out += 1
            cc.failures += 1
            obs.audit().event("engine.swap_out_failed", cls=ev.cls,
                              tag=ev.tag[:48], nbytes=ev.nbytes,
                              error=repr(err)[:120])
            obs.metrics().counter("engine_failed_out")
            # the retained tensor never left the device: the ledger replays
            # it as resident and flags the iteration's conservation check
            obs.ledger().note_transfer("out", ev.cls, ev.tag, ev.nbytes,
                                       failed=True, release_op=ev.release_op)
        else:
            try:
                host = ev.block.read()
            except Exception:
                ev.failed = True
                ev.done = True
                self.n_failed_in += 1
                cc.failures += 1
                obs.audit().event("engine.swap_in_failed", cls=ev.cls,
                                  tag=ev.tag[:48], nbytes=ev.nbytes,
                                  error=repr(err)[:120])
                obs.ledger().note_transfer("in", ev.cls, ev.tag, ev.nbytes,
                                           failed=True)
                raise err
            ev.result = host.to(self.device)     # synchronous copy
            if ev._free_block:
                self.pool.free(ev.block)
            ev.done = True
            self.n_sync_fallback_in += 1
            obs.audit().event("engine.sync_fallback_in", cls=ev.cls,
                              tag=ev.tag[:48], nbytes=ev.nbytes,
                              error=repr(err)[:120])
            obs.ledger().note_transfer("in", ev.cls, ev.tag, ev.nbytes)
        for fn in ev._callbacks:
            fn(ev)
        ev._callbacks.clear()

    def _note_latency(self, ev: TransferEvent, residual: Optional[float]
                      ) -> None:
        """Feed the health machine: a copy far over the bandwidth-model
        prediction (or the absolute floor) is a timeout, anything else a
        clean success carrying its residual."""
        rs = self.resilience
        self._n_latency_obs += 1
        if self._n_latency_obs <= rs.health_warmup_transfers:
            # cold start: predictions are not trustworthy yet, and the
            # first copies pay stream creation and slab pinning — count
            # them as plain successes, no residual
            self.health.note_success(ev.cls, None)
            return
        limit = rs.timeout_floor_s
        if residual is not None:
            limit = max(limit, rs.timeout_factor * (ev.seconds / residual))
        if ev.seconds > limit:
            self.n_timeouts += 1
            self.by_class[ev.cls].timeouts += 1
            self.health.note_timeout(ev.cls)
            obs.audit().event("engine.timeout", cls=ev.cls, tag=ev.tag[:48],
                              seconds=round(ev.seconds, 4),
                              limit=round(limit, 4))
        else:
            self.health.note_success(ev.cls, residual)

    def _execute(self, ev: TransferEvent) -> None:
        """Retire ``ev``: wait for its copy, release what the copy used,
        and account for it."""
        src, ev._after = ev._after, None
        if src is not None:              # its swap-out first, FIFO
            q = self._pending[(src.cls, SWAP_OUT)]
            while not src.done and q:
                self._execute(q.popleft())
        if ev._error is not None:
            self._fail_transfer(ev, ev._error)
            return
        if ev._cuda is not None:
            start, done = ev._cuda
            if not done.query():         # the host blocks on the copy
                t0 = time.perf_counter()
                done.synchronize()
                cc = self.by_class[ev.cls]
                cc.host_waits += 1
                cc.host_wait_s += time.perf_counter() - t0
            link_s = start.elapsed_time(done) / 1e3
            ev.seconds = link_s + ev._stall_s
            r = self._retired_link[ev.kind]
            r[0] += ev.nbytes
            r[1] += link_s
        if ev.kind == SWAP_OUT:
            ev._source = None            # the CPU's release point
        elif ev._free_block:
            self.pool.free(ev.block)     # the H2D has read the slab
        ev.done = True
        t0 = ev._t_issue
        t1 = t0 + ev.seconds
        # trace lane == traffic class: one Chrome-trace row per stream.
        # start→done is the copy itself; the queue wait is submit→start,
        # on a card to the copy's start on its stream (module doc)
        tr = obs.tracer()
        name = "swap_out" if ev.kind == SWAP_OUT else "swap_in"
        if ev._cuda is not None and tr.anchored:
            start, done = ev._cuda
            t1 = tr.device_time(done)
            wait = max(tr.device_time(start) - ev.t_submit, 0.0)
            tr.record_device(ev.cls, name, start, done,
                             arg=(ev.tag, ev.nbytes, round(wait, 6)))
        else:
            tr.record(ev.cls, name, t0, t1,
                      arg=(ev.tag, ev.nbytes,
                           round(max(t0 - ev.t_submit, 0.0), 6)
                           if ev.t_submit else 0.0))
        obs.ledger().note_transfer(ev.kind, ev.cls, ev.tag, ev.nbytes,
                                   release_op=ev.release_op, t=t1)
        cc = self.by_class[ev.cls]
        if ev.kind == SWAP_OUT:
            self.n_out += 1
            self.bytes_out += ev.nbytes
            self.time_out_s += ev.seconds
            cc.n_out += 1
            cc.bytes_out += ev.nbytes
            cc.time_out_s += ev.seconds
        else:
            self.n_in += 1
            self.bytes_in += ev.nbytes
            self.time_in_s += ev.seconds
            cc.n_in += 1
            cc.bytes_in += ev.nbytes
            cc.time_in_s += ev.seconds
        residual = None
        if self.bwmodel is not None:
            # residual against the *pre-sample* curve, then feed the EMA;
            # the uncalibrated constant fallback wildly underestimates
            # dispatch-bound copies, so its residuals are not evidence
            pred = self.bwmodel.transfer_time(ev.nbytes)
            if pred > 0 and self.bwmodel.is_calibrated:
                residual = ev.seconds / pred
            self.bwmodel.observe(ev.nbytes, ev.seconds)
        if self.resilience.enabled:
            self._note_latency(ev, residual)
        for fn in ev._callbacks:
            fn(ev)
        ev._callbacks.clear()

    # ------------------------------------------------------------ waiting
    def wait(self, ev: TransferEvent) -> TransferEvent:
        """Retire transfers (strict priority across classes, FIFO within
        ``ev``'s class) until ``ev`` completes."""
        with self._lock:
            while not ev.done:
                if self._step(ev.kind, waiting_cls=ev.cls) is None:
                    raise RuntimeError(f"event {ev.eid} lost from queue")
        return ev

    def synchronize(self) -> None:
        """Retire everything in flight: strict priority first, submission
        order within a class."""
        with self._lock:
            while True:
                heads = [(PRIORITY[c], q[0].eid, c, k)
                         for (c, k), q in self._pending.items() if q]
                if not heads:
                    return
                _, _, c, k = min(heads)
                self._execute(self._pending[(c, k)].popleft())

    def drain_class(self, cls: str) -> int:
        """Retire every queued transfer of one class (e.g. the checkpoint
        writer flushing its drain).  Higher-priority traffic still jumps
        ahead transfer-by-transfer; returns the number of transfers run."""
        self._check_class(cls)
        n = 0
        with self._lock:
            for kind in (SWAP_OUT, SWAP_IN):
                while self._pending[(cls, kind)]:
                    self._step(kind, waiting_cls=cls)
                    n += 1
        return n

    def set_class_depth(self, cls: str, depth: int) -> None:
        """Widen a class's in-flight window (never shrinks it): a bulk
        drain raises its own depth so submission stays non-blocking and
        the whole drain remains preemptible by higher classes."""
        self._check_class(cls)
        with self._lock:
            self._depths[cls] = max(self._depths[cls], int(depth))

    @property
    def in_flight(self) -> int:
        return sum(len(q) for q in self._pending.values())

    def class_in_flight(self, cls: str) -> int:
        self._check_class(cls)
        return sum(len(self._pending[(cls, k)]) for k in (SWAP_OUT, SWAP_IN))

    # --------------------------------------- policy free-time hand-off
    def plan_release(self, tag: str, op_index: int) -> None:
        """Record the op at which the simulator promised the D2H for ``tag``
        retires (PolicyEntry.swap_out_done_op) — later swap-outs carry it."""
        self._planned_release[tag] = op_index

    def clear_planned_releases(self) -> None:
        """Drop all planned release points (a new policy supersedes them)."""
        self._planned_release.clear()

    def planned_releases(self) -> Dict[str, int]:
        return dict(self._planned_release)

    # -------------------------------------- §5.4.2 execution-path feedback
    def begin_iteration(self) -> None:
        """Reset the op cursor at an iteration boundary."""
        with self._lock:
            self.current_op = -1

    def advance_op(self, op_index: int) -> int:
        """The execution path reached ``op_index``: release every queued
        swap-out whose simulator-promised ``release_op`` has arrived, so
        its HBM reference drops at the promised op instead of lingering
        until first reuse (on a CUDA device the reference was dropped at
        issue, and the memory is free once the copy is done).  Queues are
        walked in FIFO order from the head, as far as the release ops have
        come.  A copy that is done retires; on a CUDA device one still
        running retires at a later call that finds it done, or when the
        class is drained, with no wait (the module doc).  Returns the
        number of transfers released."""
        n = 0
        with self._lock:
            self.current_op = max(self.current_op, op_index)
            for c in TRAFFIC_CLASSES:
                q = self._pending[(c, SWAP_OUT)]
                cc = self.by_class[c]
                i = 0
                while i < len(q) and 0 <= q[i].release_op <= self.current_op:
                    ev = q[i]
                    retire = i == 0 and not self._on_link(ev)
                    if retire:
                        q.popleft()
                        self._execute(ev)
                    else:
                        i += 1
                    if ev._released:
                        continue
                    ev._released = True
                    cc.released_at_op += 1
                    obs.tracer().instant(c, "release@op",
                                         arg=(ev.release_op, ev.tag))
                    n += 1
                    if not retire:
                        cc.released_late += 1
        return n

    # ------------------------------------------- contention introspection
    def _est_seconds(self, nbytes: int, kind: str = SWAP_OUT) -> float:
        """Link seconds for ``nbytes`` in direction ``kind`` (module doc)."""
        if self.device.type != "cuda":
            if self.bwmodel is not None:
                return self.bwmodel.transfer_time(nbytes)
            return nbytes / (_EST_FALLBACK_GBPS * 1e9)
        model = self.link_models.get(kind)
        if model is not None and model.is_calibrated:
            return model.transfer_time(nbytes)
        done_bytes, done_s = self._retired_link[kind]
        if done_bytes > 0 and done_s > 0:
            return nbytes * done_s / done_bytes
        return nbytes / (LINK_GBPS[kind] * 1e9)

    def _backlog(self, cls: str, kind: str) -> List[TransferEvent]:
        """The queued ``cls``/``kind`` copies still occupying the link: on
        a CUDA device those whose done-event has not completed (a copy
        whose issue failed never reached the link); on the CPU every
        queued copy, as the reference counts them."""
        q = self._pending[(cls, kind)]
        if self.device.type != "cuda":
            return list(q)
        return [e for e in q if e._cuda is not None and not e._cuda[1].query()]

    def queued_delay(self, cls: str = TC_POLICY_SWAP,
                     kind: str = SWAP_OUT) -> float:
        """Estimated seconds a *new* ``cls`` transfer would wait on the
        link right now: the backlog of same-or-higher-priority traffic
        plus (non-preemptive, transfer-granularity) head-of-line blocking
        by at most one lower-priority transfer."""
        self._check_class(cls)
        pri = PRIORITY[cls]
        with self._lock:
            ahead = 0.0
            hol = 0.0
            for c in TRAFFIC_CLASSES:
                q = self._backlog(c, kind)
                if not q:
                    continue
                if PRIORITY[c] <= pri:
                    ahead += sum(self._est_seconds(e.nbytes, kind) for e in q)
                else:
                    hol = max(hol, self._est_seconds(q[0].nbytes, kind))
        return ahead + hol

    def arrival_rate_bps(self, cls: str, now: Optional[float] = None
                         ) -> float:
        """Current EWMA of bytes/s enqueued on ``cls`` (decayed to now)."""
        self._check_class(cls)
        with self._lock:
            last = self._arr_last_t[cls]
            rate = self._arr_rate_bps[cls]
            if last <= 0.0 or rate <= 0.0:
                return 0.0
            now = now if now is not None else time.perf_counter()
            return rate * math.exp(-max(now - last, 0.0) / ARRIVAL_TAU_S)

    def sustained_contention(self, cls: str = TC_POLICY_SWAP) -> float:
        """Fraction of link time *other* traffic classes occupy in steady
        state: Σ arrival_rate × est-seconds-per-byte over every class but
        ``cls``, clamped to [0, 0.95].  Scheduling is strict-priority at
        transfer granularity, so sustained lower-priority traffic still
        costs ``cls`` one head-of-line block per dispatch — in steady
        state that erosion approaches the other classes' link occupancy,
        which is what this prices (a rate, not the backlog snapshot
        ``queued_delay`` sees).  A class's bytes are priced as
        device-to-host copies, the slower direction on the card."""
        self._check_class(cls)
        now = time.perf_counter()
        occ = 0.0
        with self._lock:
            for c in TRAFFIC_CLASSES:
                if c == cls:
                    continue
                last = self._arr_last_t[c]
                rate = self._arr_rate_bps[c]
                if last <= 0.0 or rate <= 0.0:
                    continue
                rate *= math.exp(-max(now - last, 0.0) / ARRIVAL_TAU_S)
                mean = self._arr_mean_bytes[c] or 1.0
                spb = self._est_seconds(int(mean)) / mean
                occ += rate * spb
        return min(max(occ, 0.0), 0.95)

    def queued_bytes(self, cls: str) -> int:
        """Bytes sitting in ``cls``'s queues right now — the backlog the
        simulator prices via :meth:`queued_delay`, exposed as a gauge."""
        self._check_class(cls)
        with self._lock:
            return sum(e.nbytes for k in (SWAP_OUT, SWAP_IN)
                       for e in self._pending[(cls, k)])

    def backlog_snapshot(self) -> Dict[str, dict]:
        """One consistent per-class view of the live link backlog —
        what an adaptation snapshot (``adapt.snapshot``) freezes so the
        background variant search prices the contention that existed
        when drift settled, not whatever the engine is doing later.
        ``queued_delay`` here is the same estimate :meth:`queued_delay`
        returns, computed for every class under a single lock hold."""
        out: Dict[str, dict] = {}
        now = time.perf_counter()
        with self._lock:
            backlog = {c: self._backlog(c, SWAP_OUT) for c in TRAFFIC_CLASSES}
            est = {c: sum(self._est_seconds(e.nbytes) for e in backlog[c])
                   for c in TRAFFIC_CLASSES}
            heads = {c: (self._est_seconds(backlog[c][0].nbytes)
                         if backlog[c] else 0.0)
                     for c in TRAFFIC_CLASSES}
            # per-class link occupancy (arrival-rate EWMA × seconds/byte),
            # decayed to now — frozen alongside the backlog so adaptation
            # prices sustained contention, not just the point-in-time queue
            load = {}
            for c in TRAFFIC_CLASSES:
                last, rate = self._arr_last_t[c], self._arr_rate_bps[c]
                if last <= 0.0 or rate <= 0.0:
                    load[c] = (0.0, 0.0)
                    continue
                rate *= math.exp(-max(now - last, 0.0) / ARRIVAL_TAU_S)
                mean = self._arr_mean_bytes[c] or 1.0
                load[c] = (rate, rate * self._est_seconds(int(mean)) / mean)
            for cls in TRAFFIC_CLASSES:
                pri = PRIORITY[cls]
                ahead = sum(est[c] for c in TRAFFIC_CLASSES
                            if PRIORITY[c] <= pri)
                hol = max((heads[c] for c in TRAFFIC_CLASSES
                           if PRIORITY[c] > pri), default=0.0)
                occ = sum(load[c][1] for c in TRAFFIC_CLASSES if c != cls)
                out[cls] = {
                    "queued_delay": ahead + hol,
                    "queue_depth": sum(len(self._pending[(cls, k)])
                                       for k in (SWAP_OUT, SWAP_IN)),
                    "queued_bytes": sum(e.nbytes for k in (SWAP_OUT, SWAP_IN)
                                        for e in self._pending[(cls, k)]),
                    "arrival_bps": load[cls][0],
                    "occupancy": min(max(occ, 0.0), 0.95),
                }
        return out

    # -------------------------------------------------------------- stats
    def stats(self) -> dict:
        tput = lambda b, s: b / s / 1e9 if s > 0 else 0.0   # noqa: E731
        with self._lock:
            classes = {}
            total_queued = 0
            for c, cc in self.by_class.items():
                d = cc.as_dict()
                # live backlog gauges: depth (transfers) and bytes queued —
                # queued_delay prices this backlog into the simulator, the
                # gauges make it visible to stats consumers too
                d["queue_depth"] = sum(
                    len(self._pending[(c, k)]) for k in (SWAP_OUT, SWAP_IN))
                d["queued_bytes"] = sum(
                    e.nbytes for k in (SWAP_OUT, SWAP_IN)
                    for e in self._pending[(c, k)])
                d["arrival_bps"] = self._arr_rate_bps[c]
                total_queued += d["queued_bytes"]
                classes[c] = d
            return {
                "n_out": self.n_out, "n_in": self.n_in,
                "bytes_out": self.bytes_out, "bytes_in": self.bytes_in,
                "time_out_s": self.time_out_s, "time_in_s": self.time_in_s,
                "gbps_out": tput(self.bytes_out, self.time_out_s),
                "gbps_in": tput(self.bytes_in, self.time_in_s),
                "in_flight": self.in_flight,
                "queued_bytes": total_queued,
                "forced_retires": self.forced_retires,
                "planned_releases": len(self._planned_release),
                "current_op": self.current_op,
                "retries": self.n_retries,
                "timeouts": self.n_timeouts,
                "failed_out": self.n_failed_out,
                "failed_in": self.n_failed_in,
                "sync_fallback_in": self.n_sync_fallback_in,
                "hbm_fallback_in": self.n_hbm_fallback_in,
                "health": self.health.stats(),
                "classes": classes,
            }
