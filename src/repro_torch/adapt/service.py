"""Adaptation service (repro_torch.adapt): inline, async and speculative.

Port of ``repro/adapt/service.py``.  ``inline`` is the paper's placement:
the runtime measures one GenPolicy variant per iteration on the training
thread, and the service only keeps the bookkeeping (the variant list, the
winner, one latency record per adaptation).

In ``async`` and ``speculative``, drift never stalls an iteration:
detection *enqueues* an :class:`AdaptJob` (an immutable
:class:`AdaptSnapshot` plus the generation epoch it belongs to) and the
training loop keeps serving the old policy while a single daemon worker
runs :meth:`AdaptationPipeline.run` against the snapshot.

**The worker never touches the card.**  In the reference the snapshot
may carry a traced program that the worker profiles.  An eager step has
no trace: its profile is a replay of the grad dispatch on the device
(``ChameleonRuntime._baseline_profile``), and a replay launched from the
worker would run beside the training step, which together need more
memory than the budget, and would pollute the allocator's peaks that
``profile_step`` reads.  So the runtime materializes the profile on the
training thread before it submits, and :meth:`submit` refuses a snapshot
whose profile is a callable.  The worker runs numpy only.

**Swap-in protocol.**  The worker publishes each completed
:class:`AdaptResult` to a single-slot mailbox (newest wins — a stale
unconsumed result is replaced, and counted as discarded).  The runtime
polls the mailbox only at the iteration boundary, after the end-of-
iteration engine sweep of the policy that just ran, so an install never
races the saved-tensor-hook copies of the old policy.  Every result
carries the epoch of the job that produced it; :meth:`invalidate`
(called on every new drift event) bumps the monotone generation counter
so in-flight results for a superseded stream are discarded at publish or
poll time — whichever sees the mismatch first.  The source fingerprint
rides along too: a result only installs onto the stream it was computed
for.

**Speculative pre-generation.**  Completed adaptations feed a
first-order recurrence predictor over iteration fingerprints
(train→eval interleaves and sequence-length buckets are periodic:
...A,B,A,B...).  When the successor of the fingerprint just adapted is
known and its snapshot is still retained, the worker pre-generates that
policy during idle background time and parks it outside the mailbox; the
next phase switch installs it with **zero** GenPolicy steps and nothing
in flight.

**Crash hygiene.**  A worker exception must never kill training: the
loop catches it, emits an ``adaptation.failed`` audit event and metrics
counter, publishes the conservative fallback for the job's snapshot
(guaranteed to fit by construction), and keeps consuming jobs.  If the
thread itself ever dies, :meth:`submit` re-arms it.  The fault sites
``adapt.hang`` and ``adapt.worker`` (``repro_torch.faults``) drive both.
"""
from __future__ import annotations

import collections
import queue
import sys
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

from repro_torch import faults, obs
from repro_torch.adapt.pipeline import AdaptationPipeline, AdaptResult
from repro_torch.adapt.snapshot import AdaptSnapshot

_SHUTDOWN = None                         # queue sentinel
MODES = ("inline", "async", "speculative")
# The interpreter's switch interval while the worker searches (the
# reference's is 1 ms).  An eager step enters Python for every op of its
# backward (the recorder's dispatch mode, the saved-tensor hooks), and each
# entry waits up to this long for the worker to drop the GIL: at 1 ms a
# 0.2 s variant added 0.19 s to an overlapped 0.37 s step on the card.
SEARCH_SWITCH_INTERVAL_S = 1e-4


@dataclass
class AdaptJob:
    snapshot: AdaptSnapshot
    epoch: int
    speculative: bool = False


class RecurrencePredictor:
    """First-order transition table over iteration fingerprints: after
    adapting to stream ``A``, predict the stream that followed ``A`` last
    time.  Bounded: only the last ``history`` transitions are kept."""

    def __init__(self, history: int = 64):
        self._succ: "collections.OrderedDict[str, str]" = \
            collections.OrderedDict()
        self._last: Optional[str] = None
        self.history = max(int(history), 1)

    def observe(self, fp_exact: Optional[str]) -> None:
        if not fp_exact:
            return
        if self._last is not None and self._last != fp_exact:
            self._succ[self._last] = fp_exact
            self._succ.move_to_end(self._last)
            while len(self._succ) > self.history:
                self._succ.popitem(last=False)
        self._last = fp_exact

    def predict(self, fp_exact: Optional[str]) -> Optional[str]:
        return self._succ.get(fp_exact) if fp_exact else None


class AdaptationService:
    """Owns the adaptation state machine around the pipeline: the inline
    variant bookkeeping (GenPolicy list, pending measurement, knob
    seeding) *and* the async worker/mailbox/speculative machinery.  One
    instance per runtime; thread ownership is strict — the runtime calls
    everything except ``_worker_loop``."""

    def __init__(self, pipeline: AdaptationPipeline, mode: str = "inline",
                 *, max_parked: int = 8, max_snapshots: int = 16,
                 history: int = 64, pace_s: float = 0.0,
                 pace_cap_s: float = 1.0):
        if mode not in MODES:
            raise ValueError(f"adaptation mode {mode!r} not in {MODES}")
        self.pipeline = pipeline
        self.mode = mode
        # GIL-cooperative pacing between worker-side variant simulations:
        # at least pace_s, at least one snapshot t_iter, capped, so an
        # overlapped training step contends with at most one variant
        self.pace_s = max(float(pace_s), 0.0)
        self.pace_cap_s = max(float(pace_cap_s), 0.0)
        # ---- shared adaptation bookkeeping (both placements)
        self.variants: List = []
        self.best = None
        self.adaptations: List[dict] = []
        self._adapt_mark: Optional[Tuple[int, float]] = None
        self._last_decision = None
        # ---- async machinery
        self.epoch = 0                   # generation counter (monotone)
        self._mb_lock = threading.Lock()
        # stat counters are bumped from both the runtime thread and the
        # worker (e.g. n_jobs via submit vs a chained speculative enqueue)
        self._ct_lock = threading.Lock()
        self._mailbox: Optional[AdaptResult] = None
        self._jobs: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._live_exact: Optional[str] = None
        # speculative: parked results + retained snapshots, LRU-bounded
        self._parked: "collections.OrderedDict[str, AdaptResult]" = \
            collections.OrderedDict()
        self._snapshots: "collections.OrderedDict[str, AdaptSnapshot]" = \
            collections.OrderedDict()
        self.max_parked = max(int(max_parked), 1)
        self.max_snapshots = max(int(max_snapshots), 1)
        self.predictor = RecurrencePredictor(history)
        self.n_jobs = self.n_published = self.n_discarded = 0
        self.n_failed = self.n_installed = 0
        self.n_spec_jobs = self.n_spec_hits = 0
        # hung-worker watchdog (repro_torch.faults): wall-clock of the live
        # (non-speculative) job's submission; cleared on poll/invalidate
        self._live_submit_t: Optional[float] = None
        self.n_watchdog = 0

    # --------------------------------------------------------- accounting
    def begin(self, step_idx: int) -> None:
        """Open the adaptation-latency window (idempotent until closed)."""
        if self._adapt_mark is None:
            self._adapt_mark = (step_idx, time.perf_counter())

    def finish(self, tier: str, step_idx: int) -> None:
        """Close the adaptation-latency window opened by :meth:`begin`."""
        if self._adapt_mark is None:
            return
        start_step, t0 = self._adapt_mark
        self._adapt_mark = None
        rec = {
            "trigger_step": start_step,
            "end_step": step_idx,
            "steps": step_idx - start_step,
            "seconds": time.perf_counter() - t0,
            "tier": tier,
            "genpolicy_steps": len(self.variants),
        }
        self.adaptations.append(rec)
        obs.audit().event("adaptation.done", tier=tier,
                          trigger_step=start_step, end_step=step_idx,
                          seconds=round(rec["seconds"], 6),
                          genpolicy_steps=rec["genpolicy_steps"])
        obs.metrics().counter("adaptations")
        obs.metrics().gauge("adaptation_seconds", rec["seconds"])

    def reset_search(self) -> None:
        self.variants, self.best = [], None

    # ------------------------------------------------------ async: intake
    def _ensure_worker(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._worker_loop, name="adapt-worker", daemon=True)
            self._worker.start()

    def invalidate(self, reason: str = "drift") -> int:
        """A new drift event supersedes everything in flight: bump the
        generation counter and drop any unconsumed mailbox result."""
        self.epoch += 1
        self._live_submit_t = None
        with self._mb_lock:
            stale, self._mailbox = self._mailbox, None
        if stale is not None:
            self._discard(stale, f"invalidate:{reason}")
        return self.epoch

    def submit(self, snap: AdaptSnapshot, *, speculative: bool = False
               ) -> AdaptJob:
        """Enqueue one adaptation job for the worker (re-arming it if a
        previous crash killed the thread).  The job is stamped with the
        current epoch; results from older epochs never install.  The
        snapshot's profile must be materialized (a ``ProfileData``, or
        None for a pipeline that needs none): a callable one would replay
        the grad dispatch on the worker, beside the training step."""
        if callable(snap.profile):
            raise TypeError(
                "AdaptationService.submit: the snapshot's profile is a "
                "callable; materialize it on the training thread (a replay "
                "on the worker would run beside the training step)")
        self._ensure_worker()
        if snap.iter_exact:
            self._snapshots[snap.iter_exact] = snap
            self._snapshots.move_to_end(snap.iter_exact)
            while len(self._snapshots) > self.max_snapshots:
                self._snapshots.popitem(last=False)
            if not speculative:
                self._live_exact = snap.iter_exact
        if not speculative:
            self._live_submit_t = time.monotonic()
        job = AdaptJob(snap, self.epoch, speculative)
        with self._ct_lock:
            self.n_jobs += 1
            self.n_spec_jobs += int(speculative)
        obs.audit().event("adaptation.enqueue", step=snap.step,
                          epoch=job.epoch, speculative=speculative,
                          fp=(snap.iter_exact or "")[:12],
                          t_iter=round(snap.t_iter, 6))
        obs.metrics().counter("adaptation_jobs")
        self._jobs.put(job)
        return job

    # ------------------------------------------------------ async: worker
    def _worker_loop(self) -> None:
        while True:
            job = self._jobs.get()
            if job is _SHUTDOWN:
                self._jobs.task_done()
                return
            try:
                self._run_job(job)
            except Exception as e:  # noqa: BLE001 — never kill training
                self._on_failure(job, e)
            finally:
                self._jobs.task_done()

    def _run_job(self, job: AdaptJob) -> None:
        f = faults.inject("adapt.hang", key=str(job.snapshot.step))
        if f is not None and f.seconds > 0:
            time.sleep(f.seconds)       # hung worker: watchdog territory
        if faults.inject("adapt.worker", key=str(job.snapshot.step)):
            raise RuntimeError(
                f"injected adaptation-worker crash (step {job.snapshot.step})")
        if not job.speculative and job.epoch != self.epoch:
            # superseded while queued: don't burn background time on it
            with self._ct_lock:
                self.n_discarded += 1
            obs.audit().event("adaptation.discard", why="stale-epoch",
                              epoch=job.epoch, live_epoch=self.epoch,
                              step=job.snapshot.step)
            return
        pace = 0.0
        if self.pace_s > 0.0:
            pace = min(max(self.pace_s, job.snapshot.t_iter),
                       self.pace_cap_s)
        # while the search runs, drop the interpreter switch interval
        # (process-wide, restored after) so the training thread's
        # dispatch never waits a full default 5 ms GIL slice behind a
        # pure-Python stretch of policy generation
        prev_switch = sys.getswitchinterval()
        sys.setswitchinterval(min(prev_switch, SEARCH_SWITCH_INTERVAL_S))
        # in the profiler's trace this thread's ranges are the worker's, so
        # a gap on the training thread is never put down to it
        obs.tracer().set_thread_prefix("adapt.worker")
        try:
            with obs.tracer().span(obs.LANE_ADAPT,
                                   "adapt_worker" if not job.speculative
                                   else "adapt_speculative",
                                   arg=job.snapshot.step):
                res = self.pipeline.run(job.snapshot, pace_s=pace)
        finally:
            sys.setswitchinterval(prev_switch)
        res.epoch = job.epoch
        res.speculative = job.speculative
        if job.speculative:
            self._park(res)
        else:
            self._publish(res)
            self._maybe_speculate(res)

    def _on_failure(self, job: AdaptJob, err: Exception) -> None:
        with self._ct_lock:
            self.n_failed += 1
        obs.audit().event("adaptation.failed", step=job.snapshot.step,
                          epoch=job.epoch, speculative=job.speculative,
                          error=repr(err)[:200])
        obs.metrics().counter("adaptation_failures")
        if job.speculative:
            return                       # nothing depends on a parked result
        try:
            prof = job.snapshot.profile   # may be None if profiling crashed
            applied = self.pipeline.executor.conservative(prof)
            self._publish(AdaptResult(
                applied=applied, swap=None, knob=None,
                kind="conservative-fallback", tier="failed",
                predicted_t=float("inf"), profile=prof,
                iter_exact=job.snapshot.iter_exact,
                step=job.snapshot.step, epoch=job.epoch))
        except Exception:  # noqa: BLE001 — give up on this job, stay alive
            pass

    # --------------------------------------------------- async: publish
    def _publish(self, res: AdaptResult) -> None:
        with self._mb_lock:
            if res.epoch != self.epoch:
                stale = res
                replaced = None
            else:
                replaced, self._mailbox = self._mailbox, res
                stale = None
        if stale is not None:
            self._discard(stale, "stale-epoch")
            return
        if replaced is not None:
            self._discard(replaced, "superseded")
        with self._ct_lock:
            self.n_published += 1
        obs.audit().event("adaptation.publish", kind=res.kind,
                          tier=res.tier, epoch=res.epoch, step=res.step,
                          knob=res.knob, n_variants=res.n_variants,
                          predicted_t=(round(res.predicted_t, 6)
                                       if res.predicted_t != float("inf")
                                       else None))
        obs.metrics().counter("adaptation_published")

    def _discard(self, res: AdaptResult, why: str) -> None:
        with self._ct_lock:
            self.n_discarded += 1
        obs.audit().event("adaptation.discard", why=why, epoch=res.epoch,
                          live_epoch=self.epoch, step=res.step,
                          kind=res.kind)
        obs.metrics().counter("adaptation_discarded")

    def poll(self) -> Optional[AdaptResult]:
        """Take the mailbox result if it is still current (epoch matches
        and it was computed for the live stream).  Called by the runtime
        at the iteration boundary only."""
        with self._mb_lock:
            res, self._mailbox = self._mailbox, None
        if res is None:
            return None
        if res.epoch != self.epoch:
            self._discard(res, "stale-epoch")
            return None
        if (res.iter_exact and self._live_exact
                and res.iter_exact != self._live_exact):
            self._discard(res, "fingerprint-mismatch")
            return None
        with self._ct_lock:
            self.n_installed += 1
        self._live_submit_t = None
        return res

    def watchdog(self, timeout_s: float) -> bool:
        """True when the live (non-speculative) job has been in flight
        longer than ``timeout_s`` — a hung or lost worker.  Fires at most
        once per job (the runtime responds by invalidating the epoch and
        un-wedging the ADAPTING stage); 0 disables."""
        t = self._live_submit_t
        if timeout_s <= 0 or t is None:
            return False
        if time.monotonic() - t <= timeout_s:
            return False
        self._live_submit_t = None
        with self._ct_lock:
            self.n_watchdog += 1
        obs.audit().event("adaptation.watchdog", timeout_s=timeout_s,
                          queue_depth=self._jobs.qsize(),
                          worker_alive=bool(self._worker is not None
                                            and self._worker.is_alive()))
        obs.metrics().counter("adaptation_watchdog")
        return True

    # ------------------------------------------------- async: speculative
    def _park(self, res: AdaptResult) -> None:
        if not res.iter_exact:
            return
        self._parked[res.iter_exact] = res
        self._parked.move_to_end(res.iter_exact)
        while len(self._parked) > self.max_parked:
            self._parked.popitem(last=False)
        obs.audit().event("adaptation.publish", kind=res.kind,
                          tier=res.tier, epoch=res.epoch, step=res.step,
                          knob=res.knob, speculative=True,
                          parked=len(self._parked))

    def _maybe_speculate(self, res: AdaptResult) -> None:
        """After a real adaptation completes, pre-generate the predicted
        successor stream's policy if we still hold its snapshot."""
        if self.mode != "speculative":
            return
        self.predictor.observe(res.iter_exact)
        self._speculate_successor(res.iter_exact)

    def _speculate_successor(self, fp_exact: Optional[str]) -> None:
        if self.mode != "speculative" or not fp_exact:
            return
        nxt = self.predictor.predict(fp_exact)
        if (nxt and nxt != fp_exact and nxt not in self._parked
                and nxt in self._snapshots):
            snap = self._snapshots[nxt]
            job = AdaptJob(snap, self.epoch, speculative=True)
            with self._ct_lock:
                self.n_jobs += 1
                self.n_spec_jobs += 1
            obs.audit().event("adaptation.enqueue", step=snap.step,
                              epoch=job.epoch, speculative=True,
                              fp=nxt[:12], why="recurrence-predicted")
            self._jobs.put(job)

    def take_speculative(self, fp_exact: Optional[str]
                         ) -> Optional[AdaptResult]:
        """Pop a parked pre-generated result for the observed stream.
        Accepting it is a conscious act at the boundary, so it is
        re-stamped with the live epoch."""
        if not fp_exact:
            return None
        res = self._parked.pop(fp_exact, None)
        if res is None:
            return None
        res.epoch = self.epoch
        self._live_exact = fp_exact
        with self._ct_lock:
            self.n_spec_hits += 1
            self.n_installed += 1
        obs.metrics().counter("adaptation_speculative_hits")
        # chain: a hit on B means the B->successor policy is wanted next
        self.predictor.observe(fp_exact)
        self._speculate_successor(fp_exact)
        return res

    def note_adapted(self, fp_exact: Optional[str]) -> None:
        """Feed the recurrence predictor from the training thread (used
        for phases resolved without a worker round-trip, e.g. a
        speculative install or an inline adaptation in mixed flows)."""
        self.predictor.observe(fp_exact)

    # ------------------------------------------------------------- admin
    def drain(self, timeout: float = 30.0) -> bool:
        """Block until every submitted job has been fully processed
        (tests/bench).  Returns False on timeout."""
        deadline = time.monotonic() + timeout
        while self._jobs.unfinished_tasks:       # pragma: no branch
            if time.monotonic() > deadline:
                return False
            time.sleep(0.002)
        return True

    def close(self) -> None:
        if self._worker is not None and self._worker.is_alive():
            self._jobs.put(_SHUTDOWN)
            self._worker.join(timeout=5.0)

    def stats(self) -> dict:
        return {
            "mode": self.mode,
            "epoch": self.epoch,
            "jobs": self.n_jobs,
            "published": self.n_published,
            "discarded": self.n_discarded,
            "failed": self.n_failed,
            "installed": self.n_installed,
            "speculative_jobs": self.n_spec_jobs,
            "speculative_hits": self.n_spec_hits,
            "watchdog_fired": self.n_watchdog,
            "parked": len(self._parked),
            "snapshots": len(self._snapshots),
            "queue_depth": self._jobs.qsize(),
            "worker_alive": bool(self._worker is not None
                                 and self._worker.is_alive()),
        }
