"""Candidate List construction and scoring (paper §5.3, Eq. 2).

A numpy copy of ``repro/core/candidates.py``: given one ``ProfileData`` it
computes what the reference computes, bit for bit
(``tests/test_torch_planning.py``).

Candidates are tagged residual instances whose lifetime overlaps outstanding
MREs and whose size is large enough to use host-link bandwidth efficiently.
``Score = N̂_MRE + C · Ŝ`` with both terms normalized over the current CL.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Set

import numpy as np

from repro_torch.common.config import ChameleonConfig
from repro_torch.core.mrl import MRL
from repro_torch.core.profiler import ProfileData, TensorInstance

MIN_SWAP_BYTES = 1 << 16   # below this, PCIe setup cost dominates (§5.3)


@dataclass
class Candidate:
    tensor: TensorInstance
    n_mre: int
    score: float


def build_candidate_list(prof: ProfileData, mrl: MRL, cfg: ChameleonConfig,
                         exclude: Set[int] = frozenset(),
                         min_bytes: int = MIN_SWAP_BYTES) -> List[Candidate]:
    pool = [t for t in prof.candidates
            if t.uid not in exclude and t.nbytes >= min_bytes]
    counts = mrl.covered_counts(
        np.fromiter((t.birth for t in pool), np.int64, len(pool)),
        np.fromiter((t.death for t in pool), np.int64, len(pool)))
    # a lifetime that doesn't overlap the peak region is no candidate (§5.3)
    raw = [(t, n) for t, n in zip(pool, counts.tolist()) if n]
    if not raw:
        return []
    max_mre = max(n for _, n in raw) or 1
    max_size = max(t.nbytes for t, _ in raw) or 1
    out = [Candidate(t, n, n / max_mre + cfg.score_coef_c * t.nbytes / max_size)
           for t, n in raw]
    out.sort(key=lambda c: (-c.score, c.tensor.uid))
    return out
