"""Memory Reduction List (paper §5.2).

A numpy copy of ``repro/core/mrl.py``: given one ``ProfileData`` it
computes what the reference computes, bit for bit
(``tests/test_torch_planning.py``).

One entry per operator inside an over-budget region:
``op index -> bytes that must be absent from device memory at that op``.
Kept as parallel numpy arrays; the simulator decrements ranges as swaps are
scheduled (§5.4.1) and the policy loop (Algo 2) runs until the list clears.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.memtrace import MemoryTimeline, over_budget_ops


@dataclass
class MRL:
    ops: np.ndarray        # sorted op indices with an MRE
    required: np.ndarray   # remaining required reduction per op (bytes)

    @classmethod
    def from_timeline(cls, tl: MemoryTimeline, budget: int) -> "MRL":
        ops, req = over_budget_ops(tl, budget)
        return cls(ops, req.astype(np.int64))

    def is_empty(self) -> bool:
        return bool(np.all(self.required <= 0))

    @property
    def remaining_ops(self) -> np.ndarray:
        return self.ops[self.required > 0]

    # ops is sorted, so the [birth, death) window is one searchsorted
    # slice instead of two O(n) boolean masks; Algo 2's inner loop reads
    # every candidate's count at once through covered_counts
    def _window(self, birth: int, death: int) -> slice:
        lo = int(np.searchsorted(self.ops, birth, side="left"))
        hi = int(np.searchsorted(self.ops, death, side="left"))
        return slice(lo, max(hi, lo))

    def covered_count(self, birth: int, death: int) -> int:
        """Number of outstanding MREs inside [birth, death)."""
        w = self._window(birth, death)
        return int(np.count_nonzero(self.required[w] > 0))

    def covered_counts(self, births: np.ndarray, deaths: np.ndarray
                       ) -> np.ndarray:
        """:meth:`covered_count` of many [birth, death) windows at once:
        one prefix count of the outstanding MREs, two searchsorted calls."""
        lo = np.searchsorted(self.ops, births, side="left")
        hi = np.maximum(np.searchsorted(self.ops, deaths, side="left"), lo)
        c = np.concatenate(([0], np.cumsum(self.required > 0)))
        return c[hi] - c[lo]

    def decrement(self, birth: int, death: int, nbytes: int) -> None:
        """Tensor of `nbytes` leaves the device for ops in [birth, death)."""
        self.required[self._window(birth, death)] -= nbytes

    def max_required(self) -> int:
        return int(self.required.max(initial=0))
