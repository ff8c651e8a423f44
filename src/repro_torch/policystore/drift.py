"""Tiered drift response (repro_torch.policystore).

A numpy copy of ``repro/policystore/drift.py`` (no JAX in it):
fingerprints, records and decisions equal the reference's for the same
inputs.

An observed op sequence is routed to one of three adaptation tiers:

  * **REUSE** — similarity at or above the reuse threshold (or an exact
    fingerprint hit): the cached policy is re-associated with the new
    program via ``core/matching.py`` and applied directly, skipping
    GenPolicy entirely (O(lookup) adaptation);
  * **WARM_START** — moderate similarity: GenPolicy still runs, but its
    variant search is seeded from the cached record's winning knob and
    shortened to 1–2 steps instead of the paper's five (§7.1);
  * **REGEN** — low similarity or an empty store: the full cold
    WarmUp→GenPolicy path; the result is written back to the store.

Thresholds come from :class:`~repro_torch.common.config.PolicyStoreConfig`.
On top of the calibrated similarity score, two *gates* guard against
structural drift the score can under-penalize:

  * length-ratio floors — a layer-count or model change roughly rescales
    the stream length, but its shingle set (scans repeat the same
    n-grams) and histogram direction barely move, so reuse additionally
    requires ``len_ratio >= reuse_len_ratio`` and warm-start
    ``len_ratio >= warm_len_ratio``;
  * invalidation guards (:meth:`DriftClassifier.classify`) — a record
    generated under a different HBM budget, or under a bandwidth curve
    that has since drifted beyond ``bw_drift_limit`` at any measured
    size, is capped at WARM_START: its schedule may no longer fit or
    overlap, but its knob is still a good search seed.

The runtime demotes REUSE to WARM_START itself when fuzzy matching
cannot re-associate enough entries (``min_reuse_hit_rate``) — the
classifier scores *sequences*, matching validates *tensors*.
"""
from __future__ import annotations

import enum
import threading
from dataclasses import dataclass
from typing import Optional

from repro_torch import obs
from repro_torch.policystore.fingerprint import Fingerprint, length_ratio
from repro_torch.policystore.store import PolicyRecord, PolicyStore


class Tier(enum.Enum):
    REUSE = "reuse"
    WARM_START = "warm_start"
    REGEN = "regen"


@dataclass
class DriftDecision:
    tier: Tier
    record: Optional[PolicyRecord]
    similarity: float
    reason: str = ""


def bandwidth_drift(record: PolicyRecord, bwmodel) -> float:
    """Worst-case ratio between the live link curve and the record's
    snapshot across the snapshot's measured sizes (1.0 = unchanged;
    2.0 = some size is now 2x slower or 2x faster than when the policy
    was priced).  An *uncalibrated* live model prices with the constant
    fallback — not evidence of drift — so it compares as unchanged."""
    if (bwmodel is None or not record.bw_curve
            or not getattr(bwmodel, "is_calibrated", False)):
        return 1.0
    worst = 1.0
    for size, then_s in record.bw_curve:
        now_s = bwmodel.transfer_time(size)
        if then_s <= 0 or now_s <= 0:
            continue
        r = now_s / then_s
        worst = max(worst, r, 1.0 / r)
    return worst


class DriftClassifier:
    def __init__(self, cfg):
        self.cfg = cfg
        self.counters = {t.value: 0 for t in Tier}
        self.counters["demoted"] = 0
        # classify runs on the repro_torch.adapt worker while the runtime's
        # inline paths (and stats readers) touch the same counters
        self._lock = threading.Lock()

    # ------------------------------------------------------------- tiers
    def classify(self, fp: Fingerprint, store: PolicyStore, *,
                 budget: Optional[int] = None,
                 bwmodel=None) -> DriftDecision:
        rec, sim = store.nearest(fp)
        if rec is None:
            return self._count(self._audit(
                fp, DriftDecision(Tier.REGEN, None, 0.0, "store empty")))
        lr = max(length_ratio(fp, rec.prepare_fingerprint),
                 length_ratio(fp, rec.fingerprint))
        tier = Tier.REGEN
        reason = f"sim={sim:.3f}"
        if sim >= self.cfg.reuse_threshold and lr >= self.cfg.reuse_len_ratio:
            tier = Tier.REUSE
        elif (sim >= self.cfg.warm_threshold
              and lr >= self.cfg.warm_len_ratio):
            tier = Tier.WARM_START
        else:
            reason += f" len_ratio={lr:.3f}"

        # ---- invalidation guards: never REUSE across a changed budget
        # or a drifted link curve — the cached schedule was priced for a
        # different machine state; its knob still seeds the search.
        if tier is Tier.REUSE:
            if budget is not None and rec.budget and budget != rec.budget:
                tier = Tier.WARM_START
                reason += f" budget {rec.budget}->{budget}"
            else:
                bw = bandwidth_drift(rec, bwmodel)
                if bw > self.cfg.bw_drift_limit:
                    tier = Tier.WARM_START
                    reason += f" bw_drift={bw:.2f}"
        return self._count(self._audit(
            fp, DriftDecision(tier, rec, sim, reason)))

    def demote(self, decision: DriftDecision, why: str = "") -> DriftDecision:
        """REUSE failed at apply time (matching hit-rate too low): fall to
        WARM_START around the same record.  The original tier's count is
        taken back — it never actually applied — so the per-tier counters
        always sum to the number of adaptations."""
        with self._lock:
            self.counters[decision.tier.value] -= 1
            self.counters["demoted"] += 1
            self.counters[Tier.WARM_START.value] += 1
        obs.audit().event(
            "drift.demote", why=why,
            from_tier=decision.tier.value, to_tier=Tier.WARM_START.value,
            similarity=round(decision.similarity, 6),
            record=decision.record.key[:12] if decision.record else None)
        return DriftDecision(Tier.WARM_START, decision.record,
                             decision.similarity,
                             (decision.reason + " " + why).strip())

    @staticmethod
    def _audit(fp: Fingerprint, d: DriftDecision) -> DriftDecision:
        obs.audit().event(
            "drift.classify", tier=d.tier.value,
            similarity=round(d.similarity, 6), reason=d.reason,
            fp=fp.exact[:12], fp_length=fp.length,
            record=d.record.key[:12] if d.record else None)
        return d

    def _count(self, d: DriftDecision) -> DriftDecision:
        with self._lock:
            self.counters[d.tier.value] += 1
        return d

    def stats(self) -> dict:
        with self._lock:
            return dict(self.counters)
