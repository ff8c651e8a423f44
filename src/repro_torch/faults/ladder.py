"""Health-driven degradation ladder for the swap path
(repro_torch.faults.ladder).  A copy of ``repro/faults/ladder.py``.

When link health (``repro_torch.faults.health``) reports trouble, the runtime
steps the applied policy down a fixed ladder of progressively more
conservative rungs instead of crashing or wedging:

    0 full          — the adaptation winner, unchanged
    1 trimmed       — same policy minus its lowest-value swaps (by
                      simulator score), re-verified against the budget
                      with ``projected_peak`` — less link traffic, same
                      fit guarantee
    2 conservative  — the WarmUp passive-swap fit (Algo 3 via
                      ``warmup_offload_sites``): no per-tensor schedule,
                      no planned release points, guaranteed-fit
    3 no_swap       — the save-sites baseline: the host link is not
                      trusted with anything

Descent is one rung per decision while health reads ``failed`` (with a
small hold between moves so retries can settle), to at least ``trimmed``
while ``degraded``.  Recovery is probe-driven: at a reduced rung the
runtime periodically issues small round-trip copies through the engine
(the only traffic a conservative rung generates), and once the health
machine has decayed back to ``healthy`` the ladder climbs one rung —
the climb itself is the real probe, since a still-bad link immediately
re-degrades and the ladder steps back down.

This module owns rung state + transition policy and the swap-trimming
helper; *applying* a rung (rebuilding the jitted step) is the runtime's
job (``ChameleonRuntime._apply_rung``: in the port it installs the
rung's applied policy for the executor's next grad dispatch).
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch import obs
from repro_torch.faults.health import DEGRADED, FAILED, HEALTHY

RUNG_NAMES = ("full", "trimmed", "conservative", "no_swap")
RUNG_FULL, RUNG_TRIMMED, RUNG_CONSERVATIVE, RUNG_NO_SWAP = range(4)


class DegradationLadder:
    def __init__(self, *, hold_iterations: int = 2, probe_interval: int = 8):
        self.rung = RUNG_FULL
        self.hold_iterations = int(hold_iterations)
        self.probe_interval = int(probe_interval)
        self._last_move = -(1 << 30)
        self.last_probe = -(1 << 30)
        self.transitions: List[dict] = []
        self.n_descents = 0
        self.n_ascents = 0

    # ------------------------------------------------------------ policy
    def decide(self, worst: str, step: int) -> Optional[int]:
        """Map the worst per-class health state to a rung move.  Returns
        the new rung, or None when the ladder holds position."""
        if worst == FAILED:
            if (self.rung < RUNG_NO_SWAP
                    and step - self._last_move >= self.hold_iterations):
                return self._move(self.rung + 1, step, "health-failed")
            return None
        if worst == DEGRADED:
            if self.rung < RUNG_TRIMMED:
                return self._move(RUNG_TRIMMED, step, "health-degraded")
            return None
        # healthy: climb one rung once the health machine has recovered
        # (its recover_successes streak already debounces this)
        if (self.rung > RUNG_FULL
                and step - self._last_move >= self.hold_iterations):
            return self._move(self.rung - 1, step, "recovery-probe")
        return None

    def reset(self, step: int, why: str = "new-policy") -> None:
        """Snap back to the full rung (a fresh adaptation installed: it
        becomes the new rung-0 policy and earns a clean start)."""
        if self.rung != RUNG_FULL:
            self._move(RUNG_FULL, step, why)

    def should_probe(self, step: int) -> bool:
        """At a reduced rung the applied policy may generate no link
        traffic at all, so health would stay frozen; the runtime issues a
        probe burst whenever this fires."""
        if self.rung == RUNG_FULL:
            return False
        if step - self.last_probe < self.probe_interval:
            return False
        self.last_probe = step
        return True

    def _move(self, rung: int, step: int, why: str) -> int:
        old, self.rung = self.rung, rung
        self._last_move = step
        if rung > old:
            self.n_descents += 1
        else:
            self.n_ascents += 1
        self.transitions.append({"step": step, "frm": RUNG_NAMES[old],
                                 "to": RUNG_NAMES[rung], "why": why})
        obs.audit().event("ladder.transition", step=step,
                          frm=RUNG_NAMES[old], to=RUNG_NAMES[rung], why=why)
        obs.metrics().gauge("ladder_rung", rung)
        return rung

    # ------------------------------------------------------------- stats
    @property
    def name(self) -> str:
        return RUNG_NAMES[self.rung]

    def stats(self) -> dict:
        return {"rung": self.rung, "name": self.name,
                "descents": self.n_descents, "ascents": self.n_ascents,
                "transitions": list(self.transitions[-16:])}


def trim_swap(prof, swap, budget: int, max_drop_fraction: float = 0.5):
    """Drop as many of the lowest-score entries as the budget allows
    (capped at ``max_drop_fraction`` of the schedule) and return the
    kept entries, or None when nothing can be dropped.

    Dropping an entry removes its off-device window, so the projected
    peak is monotonically non-decreasing in the number dropped — binary
    search finds the largest feasible drop count in O(log n) timeline
    replays."""
    from repro_torch.core.policy import projected_peak
    if swap is None or not swap.entries:
        return None
    entries = sorted(swap.entries, key=lambda e: (e.score, e.uid))
    cap = int(len(entries) * max_drop_fraction)
    if cap <= 0:
        return None
    lo, hi = 0, cap                    # drop counts known-good / candidate
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if projected_peak(prof, entries[mid:]) <= budget:
            lo = mid
        else:
            hi = mid - 1
    if lo == 0:
        return None
    return entries[lo:]
