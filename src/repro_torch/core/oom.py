"""WarmUp-stage OOM handling (paper §6.3 + Appendix B, Algo 3).

PyTorch Chameleon handles OOM *reactively* mid-iteration (free in-flight swap
blocks -> stream-event sync -> GMLake defragment -> passive swap -> retry).
The reference runs the same loop *proactively* on a profile: project the peak
from the reconstructed timeline, and while it exceeds the budget, passively
swap the candidate whose size is closest to the outstanding deficit (Algo 3
line 9's closest-size rule), then re-project. This is a numpy copy of
``repro/core/oom.py``; here the profile is one recorded eager step
(``core.profiler.profile_step``). The result is the conservative WarmUp
policy under which the first iterations are guaranteed to fit — profiling
data stays intact, training never crashes (the paper's goal).
"""
from __future__ import annotations

from typing import List, Optional, Set, Tuple

import numpy as np

from repro_torch.common.config import ChameleonConfig
from repro_torch.core.memtrace import build_timeline
from repro_torch.core.policy import ChameleonOOMError
from repro_torch.core.profiler import ProfileData, TensorInstance


def _projected_peak(prof: ProfileData, absent: Set[int]) -> int:
    n = prof.n_ops
    delta = np.zeros(n + 2, np.int64)
    for t in prof.tensors:
        if t.uid in absent:
            continue  # passively swapped: off-device for its idle span
        b = min(max(t.birth, 0), n)
        d = min(max(t.death, b), n + 1)
        delta[b] += t.nbytes
        delta[d] -= t.nbytes
    return int(np.cumsum(delta)[: n + 1].max(initial=0)) + prof.static_bytes


def passive_swap_fit(prof: ProfileData, cfg: ChameleonConfig,
                     budget: Optional[int] = None
                     ) -> Tuple[Set[int], int, List[TensorInstance]]:
    """Algo 3 loop at trace granularity.

    Returns (uids passively swapped, projected peak, swap order)."""
    budget = budget if budget is not None else cfg.hbm_budget_bytes
    candidates = sorted(prof.candidates, key=lambda t: -t.nbytes)
    absent: Set[int] = set()
    order: List[TensorInstance] = []
    peak = _projected_peak(prof, absent)
    while peak > budget:
        deficit = peak - budget
        pool = [t for t in candidates if t.uid not in absent]
        if not pool:
            raise ChameleonOOMError(
                f"passive swap exhausted: still {deficit/2**30:.2f} GiB over")
        # closest-size-to-required-block rule (Algo 3 PassiveSwap)
        pick = min(pool, key=lambda t: (abs(t.nbytes - deficit), t.uid))
        absent.add(pick.uid)
        order.append(pick)
        peak = _projected_peak(prof, absent)
    return absent, peak, order


def warmup_offload_sites(prof: ProfileData, cfg: ChameleonConfig,
                         budget: Optional[int] = None) -> Set[str]:
    """Site-level view of the passive-swap selection (scan-mode apply)."""
    absent, _, order = passive_swap_fit(prof, cfg, budget)
    return {t.site for t in order if t.site}
