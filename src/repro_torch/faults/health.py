"""Per-traffic-class link health state machine (repro_torch.faults.health):
port of ``repro/faults/health.py``.

Each traffic class of the transfer engine gets a three-state machine

    healthy  →  degraded  →  failed
       ↑____________|___________|      (recovery via clean successes)

fed by the engine's recovery machinery: every retry, terminal transfer
failure, and timeout (measured copy time far above the bandwidth-model
prediction — a large *residual*) adds to an error score; every clean
transfer decays it.  Thresholds on the score drive the transitions, and
transitions are the *input* to the degradation ladder in
``core/runtime.py`` — the ladder never looks at raw faults, only at
health states, so any anomaly source (injected or organic) degrades the
swap policy through one narrow interface.

Scores rather than raw counters: a single transient timeout on an
otherwise healthy link decays away within ``recover_successes`` clean
transfers, while a burst pushes the class to ``degraded``/``failed``
quickly.  All transitions emit ``health.transition`` audit events and a
``link_health.<class>`` gauge.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Iterable, Optional

from repro_torch import obs

HEALTHY = "healthy"
DEGRADED = "degraded"
FAILED = "failed"
_LEVEL = {HEALTHY: 0, DEGRADED: 1, FAILED: 2}

#: pseudo traffic class carrying HBM budget-headroom pressure from the
#: obs memory ledger — same FSM, same ladder interface as link faults,
#: so the runtime degrades on shrinking margin *before* an OOM
MEM_CLASS = "memory"


@dataclass
class LinkHealth:
    """Score + counters for one traffic class."""
    cls: str
    state: str = HEALTHY
    score: float = 0.0
    clean_streak: int = 0
    n_errors: int = 0
    n_retries: int = 0
    n_timeouts: int = 0
    n_slow: int = 0
    n_pressure: int = 0
    n_transitions: int = 0

    def as_dict(self) -> dict:
        return {"state": self.state, "score": round(self.score, 3),
                "clean_streak": self.clean_streak,
                "n_errors": self.n_errors, "n_retries": self.n_retries,
                "n_timeouts": self.n_timeouts, "n_slow": self.n_slow,
                "n_pressure": self.n_pressure,
                "n_transitions": self.n_transitions}


class HealthMonitor:
    """Tracks :class:`LinkHealth` per traffic class.

    Weights: a terminal error counts 1.0, a timeout 1.0, a retry 0.5 and
    a slow-but-successful transfer (residual above ``residual_limit``)
    0.25.  A clean success multiplies the score by ``decay`` and, after
    ``recover_successes`` consecutive cleans with the score back under
    the healthy threshold, re-promotes the class.
    """

    def __init__(self, classes: Iterable[str], *,
                 degrade_score: float = 2.0, fail_score: float = 6.0,
                 recover_successes: int = 8, residual_limit: float = 8.0,
                 decay: float = 0.7):
        self.degrade_score = float(degrade_score)
        self.fail_score = float(fail_score)
        self.recover_successes = int(recover_successes)
        self.residual_limit = float(residual_limit)
        self.decay = float(decay)
        self._lock = threading.Lock()
        self.links: Dict[str, LinkHealth] = {
            c: LinkHealth(c) for c in classes}

    # ------------------------------------------------------------ inputs
    def note_success(self, cls: str, residual: Optional[float] = None) -> None:
        """A transfer completed cleanly; ``residual`` = measured/predicted
        copy time from the bandwidth model (None when uncalibrated)."""
        with self._lock:
            lk = self.links[cls]
            if residual is not None and residual > self.residual_limit:
                lk.n_slow += 1
                lk.score += 0.25
                lk.clean_streak = 0
                self._reconsider(lk)
                return
            lk.score *= self.decay
            lk.clean_streak += 1
            self._reconsider(lk)

    def note_retry(self, cls: str) -> None:
        self._bump(cls, 0.5, "n_retries")

    def note_timeout(self, cls: str) -> None:
        self._bump(cls, 1.0, "n_timeouts")

    def note_error(self, cls: str) -> None:
        self._bump(cls, 1.0, "n_errors")

    def note_pressure(self, cls: str, severe: bool = False) -> None:
        """Memory-margin pressure from the obs ledger: *severe* (realized
        peak past the budget) scores like a terminal error; *mild*
        (realized peak above plan, headroom nearly gone) accumulates, so
        sustained margin erosion degrades the class while a one-off blip
        decays away."""
        self._bump(cls, 1.0 if severe else 0.35, "n_pressure")

    def _bump(self, cls: str, weight: float, counter: str) -> None:
        with self._lock:
            lk = self.links[cls]
            setattr(lk, counter, getattr(lk, counter) + 1)
            lk.score += weight
            lk.clean_streak = 0
            self._reconsider(lk)

    # ------------------------------------------------------- transitions
    def _reconsider(self, lk: LinkHealth) -> None:
        if lk.score >= self.fail_score:
            target = FAILED
        elif lk.score >= self.degrade_score:
            target = DEGRADED
        elif (lk.state != HEALTHY
              and lk.clean_streak >= self.recover_successes
              and lk.score < self.degrade_score * 0.5):
            target = HEALTHY
        elif lk.state == FAILED and lk.score < self.degrade_score:
            # decayed out of the failed band but not yet earned healthy
            target = DEGRADED
        else:
            return
        if target == lk.state:
            return
        old, lk.state = lk.state, target
        lk.n_transitions += 1
        obs.audit().event("health.transition", cls=lk.cls, frm=old,
                          to=target, score=round(lk.score, 3),
                          errors=lk.n_errors, timeouts=lk.n_timeouts,
                          retries=lk.n_retries)
        obs.metrics().gauge(f"link_health.{lk.cls}", _LEVEL[target])

    # ----------------------------------------------------------- queries
    def state(self, cls: str) -> str:
        return self.links[cls].state

    def worst(self) -> str:
        """Most-degraded state across classes — the ladder's input."""
        with self._lock:
            return max((lk.state for lk in self.links.values()),
                       key=_LEVEL.__getitem__, default=HEALTHY)

    def stats(self) -> dict:
        with self._lock:
            return {c: lk.as_dict() for c, lk in self.links.items()}
