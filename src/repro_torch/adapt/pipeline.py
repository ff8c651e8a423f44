"""Adaptation pipeline (repro_torch.adapt): the §5 cycle as pure computation.

A copy of ``repro/adapt/pipeline.py``: numpy over a ``ProfileData``, so
the same profile and budget give the reference's variants, records and
decisions.  The runtime calls its parts inline; the async worker
(``AdaptationService``) calls :meth:`AdaptationPipeline.run`.

Everything the old 600-line ``ChameleonRuntime`` did between "drift
settled" and "policy chosen" lives here, factored so the *same code*
runs in all three placements (``inline`` / ``async`` / ``speculative``):

  * :meth:`classify` — fingerprint the profiled program and route it to
    a drift tier against the policy store;
  * :meth:`apply_cached` — §6.1 fuzzy re-association of a cached policy
    with the observed program (reuse tier), with the same verification
    guards as the inline path and **no engine side effects** — binding
    release points is the caller's install step;
  * :meth:`variant` — one GenPolicy variant for one grouping knob
    (Detailed profile → Algo-2 generation → lowering), byte-identical to
    what an inline GenPolicy iteration builds for the same inputs;
  * :meth:`run` — the whole cycle against an immutable
    :class:`~repro_torch.adapt.snapshot.AdaptSnapshot`: classify, reuse if the
    store allows it, otherwise generate every knob's variant and select
    by simulator-predicted time.  This is what the background worker
    executes — and, because it is deterministic in the snapshot, what
    the equivalence tests replay synchronously to assert async ≡ inline
    for identical inputs.

Selection differs between placements by necessity: inline runs each
variant for one real iteration and keeps the best *measured* time
(§7.1); a background worker cannot run candidates on the training
stream, so it ranks by the simulator's predicted stall (same ordering
the generator optimizes).  Policy *construction* is shared either way.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

from repro_torch import obs
from repro_torch.adapt.snapshot import AdaptSnapshot
from repro_torch.core.executor import AppliedPolicy, Executor
from repro_torch.core.matching import remap_policy
from repro_torch.core.memtrace import build_timeline
from repro_torch.core.policy import (ChameleonOOMError, SwapPolicy,
                                     generate_policy, projected_peak)
from repro_torch.core.profiler import ProfileData
from repro_torch.policystore import (PolicyRecord, Tier,
                                     fingerprint_profile,
                                     fingerprint_signature)

# grouping knobs tried across the n GenPolicy steps (variant selection)
VARIANT_KNOBS = (1.0, 2.0, 0.5, 4.0, 0.25)


@dataclass
class PolicyVariant:
    applied: AppliedPolicy
    swap: Optional[SwapPolicy]
    knob: float
    measured_t: Optional[float] = None


@dataclass
class CachedApply:
    """A reuse-tier hit, lowered but not yet installed."""
    applied: AppliedPolicy
    profile: Optional[ProfileData]       # set when the schedule remapped
    record: PolicyRecord


@dataclass
class AdaptResult:
    """What the pipeline concluded for one snapshot.  ``epoch`` is
    stamped by the service; the install step checks it against the live
    generation counter before trusting anything here."""
    applied: AppliedPolicy
    swap: Optional[SwapPolicy]
    knob: Optional[float]
    kind: str                            # reuse | genpolicy | baseline |
    tier: str                            # conservative(-fallback)
    predicted_t: float
    profile: Optional[ProfileData]
    iter_exact: Optional[str]            # source-stream fingerprint
    step: int = 0                        # snapshot step (job identity)
    epoch: int = -1
    n_variants: int = 0
    speculative: bool = False


class AdaptationPipeline:
    """Stateless with respect to the iteration loop: holds only the
    long-lived collaborators (config, executor, store, drift classifier,
    host tier).  All of them are individually thread-safe, so pipeline
    methods may run on the training thread or the worker."""

    def __init__(self, cfg, executor: Executor, store=None, drift=None,
                 hostmem=None):
        self.cfg = cfg
        self.executor = executor
        self.store = store
        self.drift = drift
        self.hostmem = hostmem

    # -------------------------------------------------------- fingerprints
    def fingerprint(self, prof: ProfileData):
        ps = self.cfg.policystore
        return fingerprint_profile(prof, n_perms=ps.minhash_perms,
                                   shingle=ps.shingle)

    def iteration_fingerprint(self, sig):
        ps = self.cfg.policystore
        return fingerprint_signature(sig, n_perms=ps.minhash_perms,
                                     shingle=ps.shingle)

    # ------------------------------------------------------ classification
    def classify(self, prof: ProfileData, budget: int, bwmodel=None):
        """Drift-tier the profiled program.  ``bwmodel`` should be the
        model the adaptation prices with (live for inline, the snapshot
        copy for async) so the bw-drift guard compares like with like."""
        fp = self.fingerprint(prof)
        decision = self.drift.classify(fp, self.store, budget=budget,
                                       bwmodel=bwmodel)
        return fp, decision

    def apply_cached(self, record: PolicyRecord, prof: ProfileData, tl,
                     budget: int, exact_hit: bool = False
                     ) -> Optional[CachedApply]:
        """Re-associate a cached policy with the observed program (§6.1
        fuzzy matching) and lower it.  None -> the record does not carry
        over (low match hit-rate, or a cached no-swap decision that no
        longer fits) and the caller falls back a tier."""
        swap = record.swap_policy()
        if swap is None:
            if record.policy_kind == "conservative":
                # the winner was the offload-all fallback: guaranteed to
                # fit by construction, but it carries no remappable
                # evidence — only the *identical* program may reuse it
                if not exact_hit:
                    return None
                return CachedApply(self.executor.conservative(prof), None,
                                   record)
            # cached adaptation concluded the baseline fits — verify that
            # still holds for the observed program before trusting it
            if tl.peak > budget:
                return None
            return CachedApply(self.executor.baseline(), None, record)
        entries, hit = remap_policy(swap, record.profile_stub(), prof)
        if not entries or hit < self.cfg.policystore.min_reuse_hit_rate:
            return None
        # a partially remapped schedule offloads fewer bytes than the one
        # that was priced to fit — re-verify against the observed timeline
        # before trusting it (same guard as the cached-baseline path)
        projected = projected_peak(prof, entries)
        if projected > budget:
            return None
        new_swap = dataclasses.replace(swap, entries=entries,
                                       projected_peak=projected,
                                       baseline_peak=tl.peak, budget=budget)
        return CachedApply(self.executor.lower(new_swap, prof), prof, record)

    @staticmethod
    def warm_knobs(decision) -> Tuple[float, ...]:
        """Knob sequence for one adaptation: a warm-start hit seeds the
        search from the cached winner + one alternative (converges in 1-2
        GenPolicy steps instead of five, §7.1); otherwise the full bank."""
        if (decision is not None and decision.tier is Tier.WARM_START
                and decision.record is not None):
            seed = decision.record.knob
            alt = next((k for k in VARIANT_KNOBS if k != seed),
                       VARIANT_KNOBS[0])
            return (seed, alt)
        return VARIANT_KNOBS

    # ------------------------------------------------------------ variants
    def variant(self, prof: ProfileData, knob: float, budget: int, *,
                bwmodel=None, engine=None, tl=None) -> PolicyVariant:
        """One GenPolicy variant: Algo-2 generation under ``knob`` groups
        per phase.  ``bwmodel``/``engine`` price transfers and link
        backlog — live objects inline, frozen snapshot views async.  A
        fresh policy whose timeline replay (``projected_peak``) is still
        over the budget is not lowered: Algo 2 stops when its MRL is empty,
        and the MRL counts a swap from the tensor's birth where the replay
        counts it from the end of its swap-out.  Such a variant is the
        conservative fallback, as under ``ChameleonOOMError``, so another
        knob's variant that fits wins the ranking (the reference lowers it
        as it is)."""
        groups = max(1, int((prof.scan_layers or 32) * knob))
        cfg_v = dataclasses.replace(self.cfg, groups_per_phase=groups)
        tl = tl if tl is not None else build_timeline(prof)
        try:
            if tl.peak > budget:
                swap = generate_policy(
                    prof, cfg_v, budget, timeline=tl, bwmodel=bwmodel,
                    engine=engine, register_free_times=False)
                if swap.projected_peak > budget:
                    raise ChameleonOOMError(
                        f"the policy replays to {swap.projected_peak} bytes, "
                        f"over the budget of {budget}")
                applied = self.executor.lower(swap, prof)
            else:
                swap, applied = None, self.executor.baseline()
        except ChameleonOOMError:
            swap, applied = None, self.executor.conservative(prof)
        return PolicyVariant(applied, swap, knob)

    @staticmethod
    def predicted_time(var: PolicyVariant, prof: ProfileData) -> float:
        """Simulator-predicted iteration time for ranking variants when
        they cannot each run a measured iteration (async placement).  A
        conservative fallback ranks last — it only wins unopposed."""
        if var.swap is not None:
            return prof.t_iter + var.swap.stall_time
        if var.applied.offload:              # conservative (offload-all)
            return float("inf")
        return prof.t_iter                   # baseline fits as-is

    # ----------------------------------------------------------- write-back
    def build_record(self, best: PolicyVariant, prof: ProfileData,
                     budget: int, iter_fp=None, bwmodel=None,
                     measured_t: Optional[float] = None) -> PolicyRecord:
        """The store record for an adaptation winner, keyed by the
        profiled train-step stream and carrying the full iteration
        signature when one is available (mid-run drift similarity)."""
        prep_fp = self.fingerprint(prof)
        kind = ("swap" if best.swap is not None
                else "conservative" if best.applied.offload
                else "baseline")
        return PolicyRecord.from_policy(
            fingerprint=iter_fp if iter_fp is not None else prep_fp,
            prepare_fingerprint=prep_fp, swap=best.swap,
            candidates=prof.candidates, n_ops=prof.n_ops, knob=best.knob,
            measured_t=(measured_t if measured_t is not None
                        else best.measured_t or 0.0),
            budget=budget, bwmodel=bwmodel, policy_kind=kind)

    # ------------------------------------------------------------ full run
    def run(self, snap: AdaptSnapshot, *, pace_s: float = 0.0) -> AdaptResult:
        """The whole adaptation cycle against one immutable snapshot.
        Deterministic in the snapshot: running it on the worker thread or
        synchronously on the training thread yields the same policy —
        ``pace_s`` (worker-only) inserts sleeps between variant
        simulations and never changes the selection."""
        prof = snap.ensure_profile()
        tl = build_timeline(prof)
        decision = None
        if self.store is not None and self.drift is not None:
            fp, decision = self.classify(prof, snap.budget,
                                         bwmodel=snap.bwmodel)
            if decision.tier is Tier.REUSE:
                rec = decision.record
                exact = rec is not None and fp.exact in (
                    rec.prepare_fingerprint.exact, rec.fingerprint.exact)
                hit = self.apply_cached(rec, prof, tl, snap.budget,
                                        exact_hit=exact)
                if hit is not None:
                    self.store.touch(rec)
                    return AdaptResult(
                        applied=hit.applied,
                        swap=hit.applied.swap, knob=rec.knob,
                        kind="reuse", tier=Tier.REUSE.value,
                        predicted_t=prof.t_iter, profile=hit.profile,
                        iter_exact=snap.iter_exact, step=snap.step)
                decision = self.drift.demote(decision, "match-miss")
        knobs = snap.gen_knobs or self.warm_knobs(decision)
        engine = snap.engine_view()
        variants: List[PolicyVariant] = []
        for i, knob in enumerate(knobs):
            if pace_s > 0.0 and i:       # yield the GIL to the training
                time.sleep(pace_s)       # thread between simulations
            with obs.tracer().span(obs.LANE_ADAPT, "genpolicy_variant",
                                   arg=knob):
                variants.append(self.variant(prof, knob, snap.budget,
                                             bwmodel=snap.bwmodel,
                                             engine=engine, tl=tl))
        best = min(variants,
                   key=lambda v: (self.predicted_time(v, prof), v.knob))
        predicted = self.predicted_time(best, prof)
        kind = ("genpolicy" if best.swap is not None
                else "conservative" if best.applied.offload else "baseline")
        tier = (decision.tier.value if decision is not None
                else Tier.REGEN.value)
        if self.store is not None:
            rec = self.build_record(
                best, prof, snap.budget, iter_fp=snap.iter_fp,
                bwmodel=snap.bwmodel,
                measured_t=predicted if predicted != float("inf") else 0.0)
            self.store.put(rec)
            obs.audit().event(
                "policy.store_put", key=rec.key[:12],
                policy_kind=rec.policy_kind,
                knob=best.knob, measured_t=round(rec.measured_t, 6),
                step=snap.step)
        return AdaptResult(
            applied=best.applied, swap=best.swap, knob=best.knob,
            kind=kind, tier=tier, predicted_t=predicted, profile=prof,
            iter_exact=snap.iter_exact, step=snap.step,
            n_variants=len(variants))
