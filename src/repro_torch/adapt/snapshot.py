"""Immutable adaptation inputs (repro_torch.adapt).

Port of ``repro/adapt/snapshot.py``.  An :class:`AdaptSnapshot` freezes
everything the §5 adaptation cycle reads, at the moment drift settles, so
the background worker never touches live runtime state:

  * the Detailed-mode :class:`~repro_torch.core.profiler.ProfileData` of
    the grad dispatch, already materialized, priced at its own
    ``t_iter``: the grad dispatch's measured time where the trainer gives
    one (a departure, ``core.runtime``'s module doc), else the
    iteration's, as in the reference.  The reference may carry a traced
    jaxpr here and let the worker profile it; an eager step has none, and
    its profile is a replay of the dispatch on the device
    (``ChameleonRuntime._baseline_profile``), which only the training
    thread may run;
  * the iteration's measured time (``t_iter``), as in the reference: the
    worker paces its variants by it;
  * a *copy* of the bandwidth-model curve
    (:meth:`~repro_torch.hostmem.bwmodel.BandwidthModel.snapshot`);
  * the transfer engine's per-class backlog at snapshot time
    (``queued_delay`` seconds + per-class queued bytes and occupancy);
  * the HBM budget and the grouping knobs the search will try;
  * the iteration fingerprint the snapshot was taken from.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from repro_torch.core.profiler import ProfileData


class FrozenBacklog:
    """Engine stand-in for snapshot-time contention: answers
    ``queued_delay`` with the frozen per-class estimate so
    ``generate_policy`` prices the backlog the snapshot saw, not whatever
    the live engine is doing when the worker happens to run."""

    def __init__(self, delays: Optional[Dict[str, float]] = None,
                 default: float = 0.0,
                 occupancy: Optional[Dict[str, float]] = None):
        self._delays = dict(delays or {})
        self._default = float(default)
        self._occupancy = dict(occupancy or {})

    def queued_delay(self, cls: str = "policy_swap",
                     kind: str = "swap_out") -> float:
        return self._delays.get(cls, self._default)

    def sustained_contention(self, cls: str = "policy_swap") -> float:
        """Frozen per-class link occupancy at snapshot time."""
        return self._occupancy.get(cls, 0.0)


@dataclass
class AdaptSnapshot:
    """One adaptation's frozen inputs, immutable after construction."""
    profile: Optional[ProfileData] = None
    # the iteration's measured time, which paces the worker's variants;
    # the profile carries its own price (``profile.t_iter``: the grad
    # dispatch's time less its copy stall where the trainer gave one)
    t_iter: float = 1.0
    budget: int = 0                      # HBM budget (bytes)
    bwmodel: Any = None                  # frozen BandwidthModel copy (or None)
    contention_s: float = 0.0            # queued_delay at snapshot time
    backlog: Dict[str, dict] = field(default_factory=dict)  # per-class gauges
    gen_knobs: Tuple[float, ...] = ()    # grouping knobs the search tries
    iter_exact: Optional[str] = None     # live-stream fingerprint (exact hash)
    iter_fp: Any = None                  # full iteration Fingerprint (or None)
    step: int = 0                        # step the snapshot was taken at

    def ensure_profile(self) -> ProfileData:
        """The Detailed-mode profile (materialized on the training thread)."""
        if self.profile is None:
            raise ValueError("snapshot carries no profile")
        return self.profile

    def engine_view(self) -> FrozenBacklog:
        """The frozen-contention engine stand-in for policy generation."""
        delays = {c: float(d.get("queued_delay", 0.0))
                  for c, d in self.backlog.items()}
        occ = {c: float(d.get("occupancy", 0.0))
               for c, d in self.backlog.items()}
        return FrozenBacklog(delays, default=self.contention_s,
                             occupancy=occ)
