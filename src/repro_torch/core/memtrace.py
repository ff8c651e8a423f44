"""No-swap memory-timeline reconstruction (paper Fig. 3).

A numpy copy of ``repro/core/memtrace.py``: given one ``ProfileData`` it
computes what the reference computes, bit for bit
(``tests/test_torch_planning.py``).

From tensor liveness we rebuild the device-memory usage curve the program
*would* have without any swap — the input to MRL construction.  Static
memory (params/optimizer state) is a constant base handled by ZeRO; the
curve here is the dynamic (activation) component, exactly the split the
paper makes versus DeepSpeed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from repro_torch.core.profiler import ProfileData, TensorInstance


@dataclass
class MemoryTimeline:
    usage: np.ndarray          # bytes in use *before* executing op i (len n_ops+1)
    static_bytes: int
    peak: int
    peak_op: int

    def total(self, i: int) -> int:
        return int(self.usage[i]) + self.static_bytes


def build_timeline(prof: ProfileData, include_static: bool = True) -> MemoryTimeline:
    n = prof.n_ops
    delta = np.zeros(n + 2, np.int64)
    for t in prof.tensors:
        b = min(max(t.birth, 0), n)
        d = min(max(t.death, b), n + 1)
        delta[b] += t.nbytes
        delta[d] -= t.nbytes
    usage = np.cumsum(delta)[: n + 1]
    peak_op = int(np.argmax(usage))
    peak = int(usage[peak_op])
    static = prof.static_bytes if include_static else 0
    return MemoryTimeline(usage, static, peak + static, peak_op)


def over_budget_ops(tl: MemoryTimeline, budget: int) -> Tuple[np.ndarray, np.ndarray]:
    """(op indices, required reduction bytes) where usage exceeds budget."""
    total = tl.usage.astype(np.int64) + tl.static_bytes
    idx = np.nonzero(total > budget)[0]
    return idx, (total[idx] - budget)
