"""ChameleonRuntime — ties profiler, stage machine, policy generator and
executor into the per-iteration loop (paper Fig. 2).

Port of ``repro/core/runtime.py``, with the reference's protocol (driven
by ``repro_torch.runtime.trainer.Trainer``):

    rt = ChameleonRuntime(cham_cfg, step_builder, device=...)
    rt.prepare(example_args)                  # WarmUp fit (Algo 3, proactive)
    for it in range(steps):
        t0 = time()
        fn = rt.step_fn()                     # current applied policy
        out = fn(*args); sync()               # the grad dispatch
        t_grad = time() - t0 - copy_stall     # (fn.execution.last)
        rt.record_dispatch("train", fn, args) # Lightweight-mode op stream
        ... (any extra dispatches: eval, optimizer-skip, ... recorded too)
        rt.end_iteration(time() - t0, t_grad) # Algo 1 stage machine

During GenPolicy the runtime generates one policy variant per step (varying
the logical-layer grouping knob) and, after n steps, keeps the variant with
the best measured iteration time — the paper's §7.1 "generates five policies
and selects the one with the best runtime performance".  The adaptation
pipeline (classification, cached-policy re-association, variant
construction, store write-back) lives in ``repro_torch.adapt``; this
module keeps the iteration-loop state machine and the install points.
With ``cfg.adapt.mode`` set to ``async`` or ``speculative`` the settled
WarmUp enqueues an :class:`~repro_torch.adapt.AdaptSnapshot` to the
background :class:`~repro_torch.adapt.AdaptationService` instead of
running GenPolicy iterations inline; the worker's result installs at the
next iteration boundary (after the engine sweep of the policy that just
ran), so drift never stalls an iteration.  The snapshot's profile is
materialized here, on the training thread (``_snapshot``): it is a replay
on the device, memoized by arg shapes (async keeps that memo across
WarmUp re-entries) or taken from ``_profile_lru`` for a recurring
stream, so a stream's first visit pays one replay in every placement and
later visits a dict hit.  ``_baseline_profile`` raises off the thread
that built the runtime: the worker runs numpy only.

What eager PyTorch changes:

  * **The op stream is recorded, not traced.**  ``step_fn()`` and
    ``recorded(fn)`` return dispatches that run under the Lightweight
    recorder (``core.tokenizer.OpStreamRecorder``);
    ``record_dispatch(name, fn, args)`` appends the stream ``fn``'s last
    call recorded.  ``_args_key`` reads tensor shapes and dtypes (a
    module's parameters, a batch's arrays; a Python number is its type).
  * **The detailed profile is a replay.**  The reference traces the
    baseline program (``_baseline_jaxpr``) and walks its jaxpr.  Here
    ``_baseline_profile`` runs the grad dispatch once more on the last
    train args, under the baseline policy (plain autograd) and the
    Detailed mode (``core.profiler.profile_step``), outputs discarded
    (``.grad`` is left None, no optimizer or loss-scale state is
    touched), memoized by arg-shape key like the reference's
    ``_baseprof_cache`` — so a GenPolicy episode pays one extra grad
    dispatch, counted in ``adaptation_overhead_s``.  Limit: under a
    budget the baseline cannot physically fit (ROADMAP.md item 4c's Table
    4) the replay itself would not fit; it must then run under the
    conservative policy.
  * **The profile is priced at the grad dispatch's own time** (a
    departure).  The reference prices the grad step's profile at the
    whole iteration's ``t_iter`` (its trainer times the grad step, the
    optimizer step, the eval and the loss-scale update together), so Eq. 1
    spreads the optimizer step's and the eval's time over the grad step's
    ops and every logical layer's transfer budget is inflated by about
    ``t_iter / t_grad`` (ROADMAP.md F7; on the card the grad dispatch of
    ``llama2-paper`` takes 0.52-0.67 of its iteration, P4).
    ``end_iteration(t_iter, t_grad)`` takes the trainer's
    ``t_grad``, the grad dispatch from its start to its synchronised end
    less that dispatch's measured copy stall (``core.executor``: a
    stalling variant does not widen its own budgets), and the GenPolicy
    step, the async snapshot and the kickoff price the replayed profile at
    it; the variants' ``measured_t`` and the async snapshot's own
    ``t_iter``, which paces the worker's variants, stay the iteration's
    (paper §7.1's selection by measured iteration time).  A caller that
    gives no ``t_grad`` prices at ``t_iter``, as the reference does.  The
    replay's own wall is not used: the Detailed mode inflates it.
  * **Swaps are real.**  The applied policy runs through the executor
    (``core.executor``): saved-tensor hooks offload its sites on the
    engine's ``policy_swap`` class and bring them back at the planned ops.
    The reference's ``_mirror_policy_swaps`` (``core/runtime.py:510``),
    which routes the policy's schedule through the engine as stand-in
    copies, is therefore not ported: it would double the traffic.  The
    engine feedback, the memory ledger's ``close_iteration`` and the
    degradation ladder read the real transfer events; after the dispatch
    the end-of-iteration sweep (``advance_op`` past the last planned
    release, ``begin_iteration``) stays.
  * The executor's own copies and recomputation are invisible to both the
    recorder and the profile, so an applied policy never reads as a
    sequence change.

``obs`` spans of the iteration's books: ``monitor.record_dispatch``,
``monitor.signature`` (the signature update and Algo 1's
``machine.observe``), ``monitor.release_sweep``, ``obs.close_window``
and ``adapt.poll`` (the async result's install), beside ``adapt.prepare``,
``adapt.genpolicy_step`` and ``adapt.select_best``.  ``stats()`` gives
two parts of ``profiling_overhead_s``: ``recorder_s``, the recorder's own
time (``OpStreamRecorder.overhead_s``), and ``obs_close_s``, the time of
``_close_obs_window``.  On a CUDA device the window's overlap efficiency
reads the tracer's device records (``obs.overlap``), resolved when the
window closes.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import obs
# PolicyVariant / VARIANT_KNOBS live in repro_torch.adapt.pipeline;
# re-exported here because callers import them from the runtime module
from repro_torch.adapt import (VARIANT_KNOBS, AdaptResult, AdaptSnapshot,
                               AdaptationPipeline, AdaptationService,
                               PolicyVariant)
from repro_torch.common.config import ChameleonConfig
from repro_torch.common.device import resolve_device
from repro_torch.core import tokenizer
from repro_torch.core.executor import AppliedPolicy, Executor
from repro_torch.core.memtrace import build_timeline
from repro_torch.core.oom import warmup_offload_sites
from repro_torch.core.policy import (ChameleonOOMError, SwapPolicy,
                                     projected_peak)
from repro_torch.core.profiler import ProfileData, profile_step
from repro_torch.core.stages import Stage, StageMachine
from repro_torch.faults.health import MEM_CLASS
from repro_torch.faults.ladder import (RUNG_CONSERVATIVE, RUNG_FULL,
                                       RUNG_NAMES, RUNG_TRIMMED,
                                       DegradationLadder, trim_swap)
from repro_torch.policystore import DriftClassifier, PolicyStore, Tier

__all__ = ["ChameleonRuntime", "PolicyVariant", "VARIANT_KNOBS"]


class _Dispatch:
    """A function that runs under the runtime's recorder; ``last_stream``
    is the op stream of its last call."""

    def __init__(self, fn: Callable, recorder: tokenizer.OpStreamRecorder,
                 applied: Optional[AppliedPolicy] = None, execution=None):
        self.fn = fn
        self.recorder = recorder
        self.applied = applied
        self.execution = execution       # the policy's Execution, or None
        self.last_stream: Optional[tokenizer.TokenStream] = None

    def __call__(self, *args, **kwargs):
        with self.recorder.iteration() as it:
            out = self.fn(*args, **kwargs)
        self.last_stream = it.stream
        return out


def _leaves(x):
    if isinstance(x, torch.nn.Module):
        yield from x.parameters()
    elif isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    else:
        yield x


class ChameleonRuntime:
    def __init__(self, cfg: ChameleonConfig,
                 step_builder: Callable[[Optional[Any]], Callable],
                 budget: Optional[int] = None, hostmem=None, *,
                 device: Union[str, torch.device, None] = None):
        self.cfg = cfg
        self.budget = budget if budget is not None else cfg.hbm_budget_bytes
        self.step_builder = step_builder
        self.executor = Executor(cfg)
        self.device = resolve_device(device)
        if hostmem is None and cfg.enabled and cfg.hostmem.enabled:
            from repro_torch.hostmem import HostMemTier
            hostmem = HostMemTier.from_chameleon(cfg, device=self.device)
        self.hostmem = hostmem
        self.recorder = tokenizer.OpStreamRecorder()
        self._recorder_seen_s = 0.0          # recorder time already counted
        self._last_dispatch: Optional[_Dispatch] = None
        # the detailed profile of the baseline grad dispatch per arg-shape
        # key: a replay of the dispatch (module doc), memoized
        self._baseprof_cache: Dict[Tuple, ProfileData] = {}
        self.replays = 0                     # grad dispatches replayed
        # the replay runs on the card: only the thread that built the
        # runtime (the training thread) may run one, never the worker
        self._owner_thread = threading.get_ident()
        # detailed profiles of streams adapted before, keyed by iteration
        # fingerprint: a recurring stream's snapshot carries the profile
        # its last install used, at the price it was adapted at (the grad
        # dispatch's time, or the iteration's where none was given)
        self._profile_lru: "collections.OrderedDict[str, ProfileData]" = \
            collections.OrderedDict()
        self._profile_lru_cap = 8
        # async: the policy last installed for each train arg-shape key
        # (with its plan profile), recalled when that bucket's arguments
        # come back (step_fn)
        self._shape_policy: Dict[Tuple, Tuple[AppliedPolicy,
                                              Optional[ProfileData]]] = {}
        self.applied: AppliedPolicy = self.executor.baseline()
        self.profile: Optional[ProfileData] = None
        self.baseline_profile: Optional[ProfileData] = None
        self._iter_streams: List[tokenizer.TokenStream] = []
        # incremental iteration signature: histogram/length deltas are
        # applied only for dispatch slots whose content hash changed
        self._sig_acc = tokenizer.SignatureAccumulator()
        self._example_args: Optional[tuple] = None
        self._last_train_args: Optional[tuple] = None
        self._pending_variant: Optional[PolicyVariant] = None
        self.step_idx = 0
        self.history: List[dict] = []
        self.profiling_overhead_s = 0.0      # steady-state Lightweight mode
        self.adaptation_overhead_s = 0.0     # episodic (GenPolicy/store/fit)
        self.obs_close_s = 0.0               # _close_obs_window, a part
        # ---- policystore: persistent fingerprint-keyed adaptation cache
        self.store: Optional[PolicyStore] = None
        self.drift: Optional[DriftClassifier] = None
        if cfg.enabled and cfg.policystore.enabled:
            self.store = PolicyStore(cfg.policystore)
            self.drift = DriftClassifier(cfg.policystore)
        # ---- adaptation pipeline + placement (repro_torch.adapt)
        adapt_mode = cfg.adapt.mode if cfg.enabled else "inline"
        self.pipeline = AdaptationPipeline(cfg, self.executor,
                                           store=self.store, drift=self.drift,
                                           hostmem=self.hostmem)
        self.service = AdaptationService(
            self.pipeline, adapt_mode, max_parked=cfg.adapt.max_parked,
            max_snapshots=cfg.adapt.max_snapshots, history=cfg.adapt.history,
            pace_s=cfg.adapt.pace_s, pace_cap_s=cfg.adapt.pace_cap_s)
        self.machine = StageMachine(cfg, async_mode=adapt_mode != "inline")
        # ---- degradation ladder (repro_torch.faults): link health drives
        # the applied policy down full → trimmed → conservative → no_swap
        # and probe-driven recovery climbs it back up
        self.ladder: Optional[DegradationLadder] = None
        self._full_applied: Optional[AppliedPolicy] = None
        self._probe_src: Optional[torch.Tensor] = None
        if cfg.enabled and self.hostmem is not None and cfg.resilience.enabled:
            self.ladder = DegradationLadder(
                hold_iterations=cfg.resilience.ladder_hold_iterations,
                probe_interval=cfg.resilience.probe_interval)
        self._gen_knobs: Tuple[float, ...] = VARIANT_KNOBS
        self._last_sig: Optional[tokenizer.Signature] = None
        # dispatch-shape drift: same primitives, different memory profile
        # (seq-len bucket cycling) — invisible to the op stream, so the
        # runtime tracks the train dispatch's arg shapes itself
        self._train_shape: Optional[Tuple] = None
        self._prev_train_shape: Optional[Tuple] = None
        self._last_decision = None           # DriftDecision of this adaptation
        # per-iteration swap/compute overlap (repro_torch.obs)
        self._iter_t0 = time.perf_counter()
        self.overlap_history: collections.deque = collections.deque(
            maxlen=512)
        obs.tracer().set_iteration(self.step_idx)

    # ------------------------------------------- adaptation state (service)
    @property
    def variants(self) -> List[PolicyVariant]:
        return self.service.variants

    @variants.setter
    def variants(self, v) -> None:
        self.service.variants = list(v)

    @property
    def best(self) -> Optional[PolicyVariant]:
        return self.service.best

    @best.setter
    def best(self, v) -> None:
        self.service.best = v

    @property
    def adaptations(self) -> List[dict]:
        return self.service.adaptations

    # ------------------------------------------------------------ helpers
    def _args_key(self, args) -> Tuple:
        return tuple(
            (tuple(x.shape), str(x.dtype).replace("torch.", ""))
            if isinstance(x, torch.Tensor) else (None, type(x).__name__)
            for x in _leaves(args))

    def _baseline_profile(self, args, t_iter: float) -> ProfileData:
        """The detailed profile of the grad dispatch under the baseline
        policy: a replay on ``args`` (memoized by arg shapes), priced at
        ``t_iter``.  Raises off the thread that built the runtime."""
        key = ("baseline",) + self._args_key(args)
        prof = self._baseprof_cache.get(key)
        if prof is None:
            if threading.get_ident() != self._owner_thread:
                raise RuntimeError(
                    "ChameleonRuntime._baseline_profile: a replay of the grad "
                    "dispatch may run only on the thread that built the "
                    "runtime, not beside its training step")
            fn = self.step_builder(None)
            prof = profile_step(lambda: fn(*args), device=self.device,
                                static_bytes=self._static_bytes(args))
            self.replays += 1
            self._baseprof_cache[key] = prof
        return dataclasses.replace(prof, t_iter=float(t_iter))

    def _static_bytes(self, args) -> Optional[int]:
        """The static base of a profile: on a CUDA device the allocator's
        resident bytes (``profile_step`` reads them: parameters, optimizer
        state, the batch, all that the budget must hold); on the CPU, which
        has no device memory to read, the bytes of the dispatch's inputs —
        what the reference counts (its traced step's arguments)."""
        if self.device.type == "cuda":
            return None
        seen = {}
        for x in _leaves(args):
            if isinstance(x, torch.Tensor):
                st = x.untyped_storage()
                seen[st._cdata] = st.nbytes()
        return sum(seen.values())

    def _plan_profile(self) -> Optional[ProfileData]:
        return self.profile or self.baseline_profile

    def _get_step(self, applied: AppliedPolicy) -> _Dispatch:
        """The recorded grad dispatch running ``applied``, its prefetch ops
        planned from the current profile (every profile of one arg-shape
        key holds the same storages)."""
        eng = self.hostmem.engine if self.hostmem is not None else None
        ex = self.executor.execution(applied, eng, self._plan_profile())
        return _Dispatch(self.step_builder(ex), self.recorder, applied, ex)

    def recorded(self, fn: Callable) -> _Dispatch:
        """``fn`` running under the Lightweight recorder, for the
        iteration's other dispatches (optimizer step, eval)."""
        return _Dispatch(fn, self.recorder)

    # -------------------------------------------------------------- setup
    def prepare(self, example_args: tuple) -> AppliedPolicy:
        """WarmUp entry: proactive Algo-3 fit so the first iterations never
        OOM while profiling data accumulates.  With a policy store attached
        the observed program is fingerprinted first: a reuse-tier hit
        applies the cached policy directly (no WarmUp wait, no GenPolicy),
        a warm-start hit seeds the upcoming variant search."""
        self._example_args = example_args
        if not self.cfg.enabled:
            return self.applied
        self.service.begin(self.step_idx)
        with obs.tracer().span(obs.LANE_ADAPT, "prepare", arg=self.step_idx):
            prof = self._baseline_profile(example_args, 1.0)  # memory only
            self.baseline_profile = prof              # warm-up fit
            tl = build_timeline(prof)
            if self.store is not None and self._try_policystore(prof, tl):
                return self.applied            # reuse tier: cached policy
            if tl.peak > self.budget:
                try:
                    sites = warmup_offload_sites(prof, self.cfg, self.budget)
                    self.applied = AppliedPolicy(
                        None, sites,
                        self.executor.site_universe(prof) - sites, set(),
                        "warmup:" + ",".join(sorted(sites)))
                    kind = "warmup"
                except ChameleonOOMError:
                    self.applied = self.executor.conservative(prof)
                    kind = "conservative"
            else:
                self.applied = self.executor.baseline()
                kind = "baseline"
            self._audit_apply(kind)
        return self.applied

    def _audit_apply(self, kind: str, knob: Optional[float] = None) -> None:
        """Audit-log the policy taking effect (repro_torch.obs drift trail)."""
        if self.ladder is not None:
            # a fresh adaptation supersedes any ladder degradation: it is
            # the new rung-0 policy, and if the link is still bad the
            # swap traffic re-degrades health and the ladder re-descends
            self._full_applied = self.applied
            self.ladder.reset(self.step_idx, "new-policy")
        obs.audit().event(
            "policy.apply", policy_kind=kind, step=self.step_idx,
            policy=self.applied.fingerprint[:48], knob=knob,
            n_offload=len(self.applied.offload),
            release_plan=len(self.applied.release_plan))

    # ------------------------------------ policystore (repro_torch.policystore)
    def _try_policystore(self, prof: ProfileData, tl) -> bool:
        """Classify the observed program against the store (pipeline code)
        and *install* the outcome (runtime's job).  Returns True when a
        reuse-tier hit applied a cached policy (callers skip the WarmUp
        fit); warm-start/regen configure the variant search and return
        False."""
        fp, decision = self.pipeline.classify(
            prof, self.budget,
            bwmodel=self.hostmem.bwmodel if self.hostmem else None)
        if decision.tier is Tier.REUSE:
            rec = decision.record
            exact = rec is not None and fp.exact in (
                rec.prepare_fingerprint.exact, rec.fingerprint.exact)
            hit = self.pipeline.apply_cached(rec, prof, tl, self.budget,
                                             exact_hit=exact)
            if hit is not None:
                self._last_decision = decision
                self.applied = hit.applied
                if hit.profile is not None:
                    # the schedule remapped: engine feedback follows it
                    self.profile = hit.profile
                    if self.hostmem is not None:
                        self.executor.bind_release_points(
                            self.applied, self.hostmem.engine)
                        self.hostmem.engine.begin_iteration()
                self.store.touch(rec)
                self.machine.force_stable(self.step_idx, "policystore-reuse")
                self.machine.n_genpolicy = None
                self._gen_knobs = VARIANT_KNOBS
                self._audit_apply("reuse", knob=rec.knob if rec else None)
                self._finish_adaptation("reuse")
                return True
            decision = self.drift.demote(decision, "match-miss")
        self._last_decision = decision
        self._gen_knobs = self.pipeline.warm_knobs(decision)
        self.machine.n_genpolicy = (len(self._gen_knobs) - 1
                                    if self._gen_knobs != VARIANT_KNOBS
                                    else None)
        return False

    def _store_result(self) -> None:
        """Write the adaptation winner back to the store, keyed by the
        profiled train-step stream (cold-start exact hit) and carrying the
        full iteration signature (mid-run drift similarity)."""
        if self.store is None or self.best is None or self.profile is None:
            return
        iter_fp = None
        if self._last_sig is not None and len(self._last_sig):
            iter_fp = self.pipeline.iteration_fingerprint(self._last_sig)
        rec = self.pipeline.build_record(
            self.best, self.profile, self.budget, iter_fp=iter_fp,
            bwmodel=self.hostmem.bwmodel if self.hostmem else None)
        self.store.put(rec)
        obs.audit().event(
            "policy.store_put", key=rec.key[:12],
            policy_kind=rec.policy_kind, knob=self.best.knob,
            measured_t=round(self.best.measured_t or 0.0, 6),
            step=self.step_idx)

    def _finish_adaptation(self, tier: str) -> None:
        """Close the adaptation-latency window opened by ``prepare``."""
        self.service.finish(tier, self.step_idx)

    # ------------------------------------------------------ per-iteration
    def step_fn(self, args: Optional[tuple] = None) -> Callable:
        """The grad dispatch under the current applied policy, recorded;
        its ``execution`` (None for a plain policy) keeps the executor's
        counters.  Given the dispatch's ``args`` in an async placement, a
        recurring shape bucket runs the policy last installed for it at
        once: the drift is seen only after a step, and the previous
        bucket's policy on these shapes moves its bytes in a step too short
        to hide them.  An eager dispatch knows its arguments before it
        runs; the reference's traced step learns its shapes when it runs."""
        if args is not None and self.machine.async_mode:
            self._recall_shape_policy(self._args_key(args))
        d = self._last_dispatch
        if d is None or d.applied is not self.applied:
            d = self._last_dispatch = self._get_step(self.applied)
        return d

    def _recall_shape_policy(self, key: Tuple) -> None:
        memo = self._shape_policy.get(key)
        if key == self._train_shape or memo is None or memo[0] is self.applied:
            return
        self.applied, prof = memo
        if prof is not None:
            self.profile = prof
        self._bind_release_plan(self.applied.swap)
        self._audit_apply("shape-recall")

    def record_dispatch(self, name: str, fn: Callable, args: tuple) -> None:
        """Lightweight mode: the op stream ``fn``'s last call recorded
        (``fn`` from :meth:`step_fn` or :meth:`recorded`)."""
        t0 = time.perf_counter()
        stream = getattr(fn, "last_stream", None)
        if stream is None:
            raise ValueError(
                f"record_dispatch({name!r}): the function did not run under "
                "the recorder; dispatch through rt.step_fn() or "
                "rt.recorded(fn)")
        with obs.tracer().span(obs.LANE_MONITOR, "record_dispatch",
                               arg=name):
            self._iter_streams.append(stream)
            fn.last_stream = None
            # the recorder's own bookkeeping during the dispatch
            rec_s = self.recorder.overhead_s
            self.profiling_overhead_s += rec_s - self._recorder_seen_s
            self._recorder_seen_s = rec_s
            if name == "train":
                self._last_train_args = args
                self._train_shape = self._args_key(args)  # shapes/dtypes
        self.profiling_overhead_s += time.perf_counter() - t0

    def end_iteration(self, t_iter: float,
                      t_grad: Optional[float] = None) -> Stage:
        """Close the iteration: ``t_iter`` is its measured time, ``t_grad``
        the grad dispatch's own (module doc), which prices the detailed
        profile; without it the profile is priced at ``t_iter``."""
        t0 = time.perf_counter()
        tracer = obs.tracer()
        t_price = t_iter if t_grad is None else t_grad
        # the policy that *this* iteration executed — _genpolicy_step /
        # _select_best may replace self.applied for the next one below
        ran = self.applied
        with tracer.span(obs.LANE_MONITOR, "signature", arg=self.step_idx):
            sig = self._sig_acc.update(self._iter_streams)
            self._iter_streams = []
            self._last_sig = sig
            prev_stage = self.machine.stage
            stage = self.machine.observe(sig, self.step_idx)
        # shape drift (same op stream, different shapes -> different memory
        # profile): Algo 1 cannot see it, so re-enter WarmUp ourselves; the
        # policystore keys buckets separately (per-site byte aggregates) so
        # a recurring bucket reuses its own cached policy
        shape_drift = (self.cfg.enabled
                       and self._prev_train_shape is not None
                       and self._train_shape is not None
                       and self._train_shape != self._prev_train_shape)
        if shape_drift and stage is not Stage.WARMUP:
            stage = self.machine.to_warmup(self.step_idx, "shape-change")
        self._prev_train_shape = self._train_shape
        self.step_idx += 1

        # a variant ran this iteration: record its measured time
        if self._pending_variant is not None:
            self._pending_variant.measured_t = t_iter
            self._pending_variant = None

        # episodic adaptation work (Detailed profiling, variant selection,
        # policystore write/lookup, re-prepare) is accounted separately
        # from the steady-state Lightweight-mode bookkeeping
        t_adapt = time.perf_counter()
        if stage is Stage.GENPOLICY:
            self._genpolicy_step(t_price)
        elif stage is Stage.STABLE and prev_stage is Stage.GENPOLICY:
            self._select_best()
        elif stage is Stage.ADAPTING and prev_stage is not Stage.ADAPTING:
            # async placement: the sequence settled — hand the background
            # worker an immutable snapshot (or install a parked
            # speculative result on the spot) and keep iterating
            self._async_kickoff(t_iter, t_price)
        elif stage is Stage.WARMUP and (prev_stage is not Stage.WARMUP
                                        or shape_drift):
            # sequence (or dispatch shape) changed: back to the
            # conservative fit (Fig 2 loop)
            self.service.reset_search()
            if self.machine.async_mode:
                # supersede anything in flight for the old stream
                self.service.invalidate("shape-drift" if shape_drift
                                        else "seq-change")
            if self._example_args is not None:
                args = self._last_train_args or self._example_args
                if not self.machine.async_mode:
                    # inline: re-profile from scratch, as the paper's loop
                    # does; async keeps the shape-keyed replays, so a
                    # recurring bucket's re-entry costs a dict hit
                    self._baseprof_cache.clear()
                self.prepare(args)
        adapt_dt = time.perf_counter() - t_adapt
        self.adaptation_overhead_s += adapt_dt
        # §5.4.2 execution feedback: the executed policy's swap-outs were
        # retired by advance_op at their promised ops during the dispatch;
        # sweep any planned release still queued (the iteration's op
        # stream has fully executed) and reset the op cursor
        if self.hostmem is not None and ran.release_plan:
            with tracer.span(obs.LANE_MONITOR, "release_sweep"):
                eng = self.hostmem.engine
                eng.advance_op(max(ran.release_plan.values()))
                eng.begin_iteration()
        # async swap-in point: only after the executed policy's planned
        # releases were swept may a worker result replace self.applied
        if self.machine.stage is Stage.ADAPTING:
            t_install = time.perf_counter()
            with tracer.span(obs.LANE_ADAPT, "poll", arg=self.step_idx):
                self._poll_adaptation()
            self.adaptation_overhead_s += time.perf_counter() - t_install
        # degradation ladder (repro_torch.faults): react to link health
        # after this iteration's transfers; GenPolicy iterations are
        # skipped — the variant search overwrites self.applied anyway and
        # _select_best's install resets the ladder
        if self.ladder is not None and stage is not Stage.GENPOLICY:
            t_ladder = time.perf_counter()
            self._ladder_step()
            self.adaptation_overhead_s += time.perf_counter() - t_ladder
        self.history.append({"step": self.step_idx, "stage": stage.value,
                             "policy": self.applied.fingerprint,
                             "t_iter": t_iter, "t_grad": t_grad})
        t_close = time.perf_counter()
        with tracer.span(obs.LANE_OBS, "close_window", arg=self.step_idx):
            self._close_obs_window(ran)
        self.obs_close_s += time.perf_counter() - t_close
        self.profiling_overhead_s += (time.perf_counter() - t0) - adapt_dt
        return stage

    def _poll_adaptation(self) -> None:
        res = self.service.poll()
        if res is not None:
            self._install_result(res, "adapt-installed")
        elif self.service.watchdog(self.cfg.resilience.adapt_timeout_s):
            # hung or lost worker: supersede its epoch (a late result
            # can never install) and un-wedge the stage machine; the
            # current policy keeps serving (it fit before the drift)
            self.service.invalidate("worker-timeout")
            self.machine.complete_adapting(self.step_idx, "adapt-timeout")
            self._finish_adaptation("timeout")

    def _close_obs_window(self, ran: Optional[AppliedPolicy] = None) -> None:
        """Per-iteration overlap efficiency: how much of this window's
        engine transfer time was hidden under compute (on a CUDA device
        the tracer's device records, resolved first: ``obs.overlap``).
        Then close the memory ledger's window for the policy that ran:
        realized-peak replay, the predicted-vs-realized scoreboard, byte
        conservation, and budget-headroom feedback into the health FSM."""
        obs.tracer().resolve()
        t1 = time.perf_counter()
        eff, transfer_s, hidden_s = obs.window_efficiency(
            obs.tracer(), self._iter_t0, t1,
            device=self.device.type == "cuda")
        if transfer_s > 0.0:
            self.overlap_history.append({
                "step": self.step_idx, "t": t1,
                "efficiency": eff, "transfer_s": transfer_s,
                "hidden_s": hidden_s})
            obs.metrics().gauge("overlap_efficiency", eff, t=t1)
        obs.metrics().counter("iterations")
        rec = obs.ledger().close_iteration(
            self.step_idx,
            profile=self._plan_profile(),
            swap=ran.swap if ran is not None else None,
            budget=self.budget,
            pool_stats=(self.hostmem.pool.stats()
                        if self.hostmem is not None else None),
            t=t1)
        self._memledger_feedback(rec)
        self._iter_t0 = t1
        obs.tracer().set_iteration(self.step_idx)

    def _memledger_feedback(self, rec: dict) -> None:
        """Ledger → health FSM: sustained margin erosion (realized peak
        above plan with the budget headroom nearly gone) degrades the
        ``memory`` pseudo-class, so the ladder backs the policy off
        *before* an OOM.  On a clean run realized == projected and the
        class decays back to healthy like any link."""
        if self.hostmem is None or self.ladder is None:
            return
        health = self.hostmem.engine.health
        if MEM_CLASS not in health.links:
            return
        headroom, error = rec.get("headroom_frac"), rec.get("peak_error")
        if headroom is None or error is None:
            # nothing scored (warmup / conservative rung: no swap plan to
            # compare against) — counts as a comfortable iteration
            health.note_success(MEM_CLASS)
            return
        severe = headroom < 0.0
        mild = (error > 0.0
                and headroom < self.cfg.resilience.headroom_degrade_frac)
        if severe or mild:
            health.note_pressure(MEM_CLASS, severe=severe)
            obs.audit().event("memory.pressure", step=rec["step"],
                              severe=severe, headroom=round(headroom, 4),
                              error=round(error, 4))
        else:
            health.note_success(MEM_CLASS)

    # -------------------------------- degradation ladder (repro_torch.faults)
    def _ladder_step(self) -> None:
        """Consult link health and move the applied policy along the
        ladder (full → trimmed → conservative → no_swap and back)."""
        lad = self.ladder
        eng = self.hostmem.engine
        if lad.should_probe(self.step_idx):
            self._health_probe(eng)
        move = lad.decide(eng.health.worst(), self.step_idx)
        if move is not None:
            self._apply_rung(move)

    def _health_probe(self, eng) -> None:
        """Small round-trip copies through the engine: at a reduced rung
        the applied policy may generate no link traffic at all, so these
        probes are what feeds the health machine's recovery streak (and,
        on a still-bad link, its error score)."""
        rs = self.cfg.resilience
        if self._probe_src is None:
            self._probe_src = torch.zeros(max(rs.probe_bytes, 1),
                                          dtype=torch.uint8,
                                          device=self.device)
        ok = 0
        for _ in range(max(rs.probe_burst, 1)):
            try:
                ev = eng.wait(eng.submit_swap_out(self._probe_src,
                                                  "health_probe"))
                if ev.failed:
                    continue             # failure already fed health
                eng.wait(eng.submit_swap_in(ev, "health_probe"))
                ok += 1
            except Exception:  # noqa: BLE001 — probes must never raise
                pass
        obs.audit().event("ladder.probe", step=self.step_idx,
                          rung=self.ladder.name, ok=ok,
                          burst=max(rs.probe_burst, 1),
                          health=self.hostmem.engine.health.worst())

    def _apply_rung(self, rung: int) -> None:
        """Rebuild ``self.applied`` for the rung the ladder moved to.
        Rungs that cannot be built from available state fall through to
        the next more conservative one."""
        prof = self._plan_profile()
        applied: Optional[AppliedPolicy] = None
        if rung == RUNG_FULL:
            applied = self._full_applied or self.applied
        elif rung == RUNG_TRIMMED:
            full = self._full_applied or self.applied
            if prof is not None and full is not None and full.swap is not None:
                kept = trim_swap(prof, full.swap, self.budget,
                                 self.cfg.resilience.trim_drop_fraction)
                if kept is not None:
                    swap = SwapPolicy(
                        kept, projected_peak(prof, kept),
                        full.swap.baseline_peak, full.swap.budget,
                        full.swap.stall_time, full.swap.t_iter,
                        full.swap.n_ops,
                        contention_s=full.swap.contention_s,
                        occupancy=getattr(full.swap, "occupancy", 0.0))
                    applied = self.executor.lower(swap, prof)
        if applied is None and rung in (RUNG_TRIMMED, RUNG_CONSERVATIVE):
            # conservative WarmUp rung: the Algo-3 passive fit — no
            # per-tensor schedule, no release plan, guaranteed to fit
            if prof is not None:
                try:
                    sites = warmup_offload_sites(prof, self.cfg, self.budget)
                    applied = AppliedPolicy(
                        None, sites,
                        self.executor.site_universe(prof) - sites, set(),
                        "ladder-warmup:" + ",".join(sorted(sites)))
                except ChameleonOOMError:
                    applied = self.executor.conservative(prof)
            else:
                applied = self.executor.conservative(None)
        if applied is None:              # RUNG_NO_SWAP (or nothing else)
            applied = self.executor.baseline()
        self.applied = applied
        self.executor.bind_release_points(applied, self.hostmem.engine)
        self.hostmem.engine.begin_iteration()
        obs.audit().event(
            "ladder.apply", step=self.step_idx, rung=RUNG_NAMES[rung],
            policy=applied.fingerprint[:48],
            swap_entries=(len(applied.swap.entries) if applied.swap else 0),
            release_plan=len(applied.release_plan))

    # ----------------------------------------------------- GenPolicy path
    def _genpolicy_step(self, t_price: float) -> None:
        args = self._last_train_args or self._example_args
        if args is None:
            return
        knob_next = self._gen_knobs[len(self.variants) % len(self._gen_knobs)]
        with obs.tracer().span(obs.LANE_ADAPT, "genpolicy_step",
                               arg=knob_next):
            self._genpolicy_step_body(args, t_price)

    def _genpolicy_step_body(self, args, t_price: float) -> None:
        prof = self._baseline_profile(args, t_price)  # Detailed mode
        self.profile = prof
        knob = self._gen_knobs[len(self.variants) % len(self._gen_knobs)]
        hm = self.hostmem
        # bwmodel prices transfer sizes and the engine prices the live
        # per-class link backlog for every variant; free-times are handed
        # to the engine only for the variant that wins (_select_best)
        var = self.pipeline.variant(prof, knob, self.budget,
                                    bwmodel=hm.bwmodel if hm else None,
                                    engine=hm.engine if hm else None)
        self.variants.append(var)
        self._pending_variant = var
        self.applied = var.applied                 # next iteration runs it

    def _select_best(self) -> None:
        with obs.tracer().span(obs.LANE_ADAPT, "select_best",
                               arg=len(self.variants)):
            timed = [v for v in self.variants if v.measured_t is not None]
            if timed:
                self._select_best_timed(timed)
                self._audit_apply("genpolicy", knob=self.best.knob)
            tier = (self._last_decision.tier.value
                    if self._last_decision is not None else Tier.REGEN.value)
            self._finish_adaptation(tier)
            self._last_decision = None
            self._gen_knobs = VARIANT_KNOBS    # next adaptation starts cold
            self.machine.n_genpolicy = None
            if timed:
                self._store_result()

    def _select_best_timed(self, timed: List[PolicyVariant]) -> None:
        self.best = min(timed, key=lambda v: v.measured_t)
        self.applied = self.best.applied
        self._bind_release_plan(self.best.swap)

    def _bind_release_plan(self, swap: Optional[SwapPolicy]) -> None:
        """§5.4.2 hand-off: only the applied policy's release points reach
        the engine; the executor drives engine.advance_op over them so
        swapped buffers are freed at the promised op."""
        if self.hostmem is None or swap is None:
            return
        self.applied.release_plan = {
            SwapPolicy.entry_tag(e): e.swap_out_done_op
            for e in swap.entries if e.swap_out_done_op >= 0}
        self.executor.bind_release_points(self.applied, self.hostmem.engine)
        self.hostmem.engine.begin_iteration()

    # ------------------------------------ async placement (repro_torch.adapt)
    def _snapshot(self, args, t_iter: float,
                  t_price: float) -> AdaptSnapshot:
        """Freeze this adaptation's inputs.  The profile is materialized
        here, on the training thread: the ``_profile_lru`` entry of a
        stream adapted before, else the replay (memoized by arg shapes)
        priced at ``t_price`` (``end_iteration``'s).  The snapshot's own
        ``t_iter`` is the iteration's measured time, as the reference's:
        the worker paces its variants by it."""
        hm = self.hostmem
        iter_fp = iter_exact = None
        if self._last_sig is not None and len(self._last_sig):
            iter_fp = self.pipeline.iteration_fingerprint(self._last_sig)
            iter_exact = self._stream_key(iter_fp.exact)
        prof = (self._profile_lru.get(iter_exact)
                if iter_exact is not None else None)
        if prof is None:
            prof = self._baseline_profile(args, t_price)
        return AdaptSnapshot(
            profile=prof, t_iter=t_iter, budget=self.budget,
            bwmodel=hm.bwmodel.snapshot() if hm else None,
            contention_s=hm.engine.queued_delay() if hm else 0.0,
            backlog=hm.engine.backlog_snapshot() if hm else {},
            gen_knobs=(),                  # worker classifies + seeds itself
            iter_exact=iter_exact, iter_fp=iter_fp, step=self.step_idx)

    def _stream_key(self, fp_exact: str) -> str:
        """The live stream's identity: the iteration fingerprint and the
        train dispatch's arg shapes.  A traced program's tokens change
        with the sequence length; an eager op stream does not, so two
        sequence-length buckets would share one fingerprint, one retained
        snapshot and one profile without the shapes."""
        return hashlib.sha1(
            f"{fp_exact}|{self._train_shape}".encode()).hexdigest()

    def _async_kickoff(self, t_iter: float, t_price: float) -> None:
        """ADAPTING entry: install a parked speculative result if the
        observed stream has one (zero GenPolicy steps, nothing in flight),
        otherwise enqueue the snapshot for the worker."""
        args = self._last_train_args or self._example_args
        if args is None:
            return
        snap = self._snapshot(args, t_iter, t_price)
        self.service.begin(self.step_idx)
        hit = self.service.take_speculative(snap.iter_exact)
        if hit is not None:
            self._install_result(hit, "speculative-hit")
            return
        self.service.submit(snap)

    def _install_result(self, res: AdaptResult, why: str) -> None:
        """Swap-in: adopt a completed (worker or parked speculative)
        adaptation at the iteration boundary, as ``_select_best_timed``
        installs an inline winner: applied policy, engine release points,
        stage transition, accounting."""
        self.applied = res.applied
        if res.profile is not None:
            self.profile = res.profile
            if res.iter_exact:           # a recurrence skips the profile
                self._profile_lru[res.iter_exact] = res.profile
                self._profile_lru.move_to_end(res.iter_exact)
                while len(self._profile_lru) > self._profile_lru_cap:
                    self._profile_lru.popitem(last=False)
        self.best = PolicyVariant(res.applied, res.swap,
                                  res.knob if res.knob is not None else 1.0,
                                  measured_t=None)
        self._bind_release_plan(res.swap)
        self._shape_policy[self._train_shape] = (self.applied,
                                                 self._plan_profile())
        self.machine.complete_adapting(self.step_idx, why)
        self.machine.n_genpolicy = None
        self._gen_knobs = VARIANT_KNOBS
        self._audit_apply(res.kind, knob=res.knob)
        self.service.note_adapted(res.iter_exact)
        self.service.finish(res.tier, self.step_idx)
        self._last_decision = None

    def close(self) -> None:
        """Stop the background worker (a no-op inline)."""
        self.service.close()

    # ----------------------------------------------------------- reports
    def stats(self) -> dict:
        return {
            "stage": self.machine.stage.value,
            "transitions": list(self.machine.transitions),
            "n_variants": len(self.variants),
            "best_knob": self.best.knob if self.best else None,
            "applied": self.applied.fingerprint,
            "release_plan": len(self.applied.release_plan),
            "contention_s": (self.best.swap.contention_s
                             if self.best and self.best.swap else 0.0),
            "profiling_overhead_s": self.profiling_overhead_s,
            # two parts of it: the recorder's own time, the window close
            "recorder_s": self.recorder.overhead_s,
            "obs_close_s": self.obs_close_s,
            "adaptation_overhead_s": self.adaptation_overhead_s,
            "replays": self.replays,
            "ladder": self.ladder.stats() if self.ladder else None,
            "signature": self._sig_acc.stats(),
            "hostmem": self.hostmem.stats() if self.hostmem else None,
            "policystore": self.policystore_stats(),
            "adapt": self.service.stats(),
            "obs": self.obs_stats(),
        }

    def obs_stats(self) -> dict:
        """Tracing/overlap summary (repro_torch.obs).  ``overlap``
        aggregates the per-iteration swap/compute overlap-efficiency
        history; iterations with no engine traffic are excluded
        (``measured`` counts the ones that had transfers, ``iterations``
        every closed window)."""
        effs = [h["efficiency"] for h in self.overlap_history
                if h["efficiency"] is not None]
        return {
            "overlap": {
                "last": effs[-1] if effs else None,
                "mean": float(np.mean(effs)) if effs else None,
                "measured": len(effs),
                "iterations": self.step_idx,
                "transfer_s": float(sum(h["transfer_s"]
                                        for h in self.overlap_history)),
                "hidden_s": float(sum(h["hidden_s"]
                                      for h in self.overlap_history)),
            },
            "tracer": obs.tracer().stats(),
            "audit": obs.audit().counts(),
            "memory": obs.ledger().stats(),
        }

    def policystore_stats(self) -> Optional[dict]:
        """Per-tier hit counters, store state, and adaptation latencies."""
        if self.store is None:
            return None
        gp = sum(1 for h in self.history if h["stage"] == Stage.GENPOLICY.value)
        return {
            "store": self.store.stats(),
            "tiers": self.drift.stats(),
            "adaptations": list(self.adaptations),
            "genpolicy_steps_total": gp,
        }
