"""End-to-end policy generation (paper Algo. 2) and the SwapPolicy object
the Executor applies.

A numpy copy of ``repro/core/policy.py``: given one ``ProfileData`` it
computes what the reference computes, bit for bit
(``tests/test_torch_planning.py``).

Algo 2: while the MRL is non-empty, rebuild the CL (scores depend on the
remaining MREs), run the simulator over it, and extend the policy.  If the
CL comes back empty with MREs outstanding, training cannot fit even with
swap — raise (the caller's WarmUp OOM loop may still downshift batch or
enable remat, see core.oom).  Finally §5.4.2 computes swap-out completion
times for early memory release.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

import numpy as np

from repro_torch.common.config import ChameleonConfig
from repro_torch.core.candidates import build_candidate_list
from repro_torch.core.memtrace import MemoryTimeline, build_timeline
from repro_torch.core.mrl import MRL
from repro_torch.core.profiler import ProfileData
from repro_torch.core.simulator import PolicyEntry, Simulator


class ChameleonOOMError(RuntimeError):
    """No candidate set can bring the program under the memory budget."""


@dataclass
class SwapPolicy:
    entries: List[PolicyEntry]
    projected_peak: int            # bytes after applying the policy
    baseline_peak: int
    budget: int
    stall_time: float
    t_iter: float
    n_ops: int
    fingerprint: str = ""
    contention_s: float = 0.0      # link backlog priced at generation time
    occupancy: float = 0.0         # sustained other-class link occupancy

    def __post_init__(self):
        sites = sorted({(e.site, e.layer) for e in self.entries})
        self.fingerprint = f"swap[{len(self.entries)}]" + ",".join(
            f"{s}:{l}" for s, l in sites[:64])

    # ---- site-level view (scan-mode application granularity) ----------
    def site_fractions(self, prof: ProfileData) -> Dict[str, float]:
        per_site_total: Dict[str, int] = {}
        for t in prof.candidates:
            if t.site:
                per_site_total[t.site] = per_site_total.get(t.site, 0) + 1
        picked: Dict[str, int] = {}
        for e in self.entries:
            if e.site:
                picked[e.site] = picked.get(e.site, 0) + 1
        return {s: picked.get(s, 0) / n for s, n in per_site_total.items() if n}

    def offload_sites(self, prof: ProfileData, threshold: float = 0.5) -> Set[str]:
        """Sites to offload when applying at scan granularity."""
        return {s for s, f in self.site_fractions(prof).items()
                if f >= threshold}

    @property
    def swapped_bytes(self) -> int:
        return sum(e.nbytes for e in self.entries)

    # ---- §5.4.2 free-time hand-off to the host-memory tier -------------
    @staticmethod
    def entry_tag(e: PolicyEntry) -> str:
        return f"{e.site or 'tensor'}:{e.layer}:{e.uid}"

    def register_free_times(self, engine) -> int:
        """Hand the simulator-planned release points to a
        ``repro_torch.hostmem.engine.TransferEngine`` so swap-out completion
        events carry them (the custom-recordStream analogue)."""
        for e in self.entries:
            engine.plan_release(self.entry_tag(e), e.swap_out_done_op)
        return len(self.entries)

    def summary(self) -> str:
        gib = 1 / 2 ** 30
        return (f"SwapPolicy: {len(self.entries)} tensors, "
                f"{self.swapped_bytes * gib:.2f} GiB swapped, "
                f"peak {self.baseline_peak * gib:.2f} -> "
                f"{self.projected_peak * gib:.2f} GiB "
                f"(budget {self.budget * gib:.2f}), "
                f"stall {self.stall_time * 1e3:.1f} ms")


def projected_peak(prof: ProfileData, entries: List[PolicyEntry]) -> int:
    """Dynamic-memory peak with the swapped tensors absent between
    swap-out completion and swap-in pre-trigger (timeline replay).  Used
    both for a freshly generated policy and to re-verify a cached policy
    remapped onto a new program (the policy store's reuse tier, ROADMAP.md
    queue 1 item 4b)."""
    n = prof.n_ops
    delta = np.zeros(n + 2, np.int64)
    by_uid = {e.uid: e for e in entries}
    for t in prof.tensors:
        b = min(max(t.birth, 0), n)
        d = min(max(t.death, b), n + 1)
        e = by_uid.get(t.uid)
        if e is not None:
            out = min(max(e.swap_out_done_op, b), d)
            back = min(max(e.swap_in_op, out), d)
            delta[b] += t.nbytes
            delta[out] -= t.nbytes
            delta[back] += t.nbytes
            delta[d] -= t.nbytes
        else:
            delta[b] += t.nbytes
            delta[d] -= t.nbytes
    usage = np.cumsum(delta)[: n + 1]
    return int(usage.max(initial=0)) + prof.static_bytes


def generate_policy(prof: ProfileData, cfg: ChameleonConfig,
                    budget: Optional[int] = None,
                    timeline: Optional[MemoryTimeline] = None,
                    bwmodel=None, engine=None,
                    register_free_times: bool = True) -> SwapPolicy:
    budget = budget if budget is not None else cfg.hbm_budget_bytes
    tl = timeline or build_timeline(prof)
    mrl = MRL.from_timeline(tl, budget)
    # the engine prices per-class link contention (queued checkpoint /
    # kv-spill drains shrink the early overlap windows) — an idle or
    # absent engine reproduces the paper's idle-link assumption exactly
    sim = Simulator(prof, tl.peak_op, cfg, bwmodel=bwmodel, engine=engine)
    entries: List[PolicyEntry] = []
    chosen: Set[int] = set()

    while not mrl.is_empty():                       # Algo 2 line 2
        cl = build_candidate_list(prof, mrl, cfg, exclude=chosen)
        if not cl:                                  # Algo 2 line 8
            raise ChameleonOOMError(
                f"MRL not clearable: {mrl.max_required()/2**30:.2f} GiB "
                f"over budget with no remaining candidates")
        new = sim.simulate(cl, mrl)
        if not new:
            raise ChameleonOOMError("simulator could not place any candidate")
        for e in new:
            chosen.add(e.uid)
        entries.extend(new)

    sim.set_free_time(entries)                      # Algo 2 line 11 (§5.4.2)

    projected = projected_peak(prof, entries)

    pol = SwapPolicy(entries, projected, tl.peak, budget,
                     sim.stall_time, prof.t_iter, prof.n_ops,
                     contention_s=sim.contention_s,
                     occupancy=sim.occupancy)
    if engine is not None and register_free_times:  # hostmem free-time hand-off
        pol.register_free_times(engine)
    return pol
