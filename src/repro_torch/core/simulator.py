"""Global swap simulator (paper §5.4).

A numpy copy of ``repro/core/simulator.py``: given one ``ProfileData`` it
computes what the reference computes, bit for bit
(``tests/test_torch_planning.py``).

Logical layers: the operator stream is split into evenly sized groups per
phase (forward = ops before the memory peak, backward+optimizer = after).
Eq. 1 assigns every group the average group time
``T̄_group = T_iter / N_iter × N_group`` — the Fig-4 insight that makes the
whole system work *without per-operator timings*.  Each layer's
``remaining_time`` is the transfer budget that can overlap its compute.

Swap-in (§5.4.1): search **backward** from the logical layer preceding the
tensor's first backward use, stopping at the peak, for a layer with
``T_remaining > T_swap`` (Eq. 3: ``T_swap = S/B``).  If nothing fits, the
highest-score candidate is still swapped (stalled) right before first use —
preferable to OOM.

Swap-out (§5.4.2): triggered at last forward use; completion layer found
searching **forward** for spare transfer budget; this release point feeds the
custom-recordStream analogue (early reuse) and the Fig-8 metric.

Hot-path layout: per-layer transfer budgets live in one float64 numpy
array (``LogicalLayer.remaining_time`` is a view into it), layer starts in
one int64 array, so the backward/forward budget searches are single
``flatnonzero`` calls over slices instead of Python loops, and transfer
times are memoized per tensor size.  GenPolicy runs the simulator once per
variant (2–5 per adaptation), so this is what bounds per-variant cost.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.common.config import ChameleonConfig
from repro_torch.core.candidates import Candidate
from repro_torch.core.mrl import MRL
from repro_torch.core.profiler import ProfileData


class LogicalLayer:
    """One logical layer; ``remaining_time`` reads/writes the simulator's
    shared per-layer budget array, so vectorized searches and this object
    view never disagree."""

    __slots__ = ("index", "start_op", "end_op", "kind", "candidates", "_rem")

    def __init__(self, index: int, start_op: int, end_op: int, kind: str,
                 rem: np.ndarray):
        self.index = index
        self.start_op = start_op
        self.end_op = end_op
        self.kind = kind
        self.candidates: List[int] = []   # tensor uids
        self._rem = rem

    @property
    def remaining_time(self) -> float:
        return float(self._rem[self.index])

    @remaining_time.setter
    def remaining_time(self, v: float) -> None:
        self._rem[self.index] = v

    def __repr__(self):
        return (f"LogicalLayer({self.index}, [{self.start_op},{self.end_op})"
                f", {self.kind}, rem={self.remaining_time:.3g})")


@dataclass
class PolicyEntry:
    uid: int
    site: Optional[str]
    layer: int                    # scan slice index of the residual
    nbytes: int
    birth: int
    death: int
    swap_in_op: int               # op index where swap-in is pre-triggered
    swap_out_done_op: int = -1    # op index where swap-out completes
    stalled: bool = False
    score: float = 0.0

    @property
    def t_swap(self):             # filled by simulator for reporting
        return getattr(self, "_t_swap", 0.0)


def _phase_splits(lo: int, hi: int, g: int) -> np.ndarray:
    """Boundaries of ``min(g, hi-lo)`` near-equal groups of [lo, hi)."""
    total = hi - lo
    g = min(g, total)
    # first `total % g` groups get one extra op (same as serial divmod fill)
    return lo + np.concatenate(
        [[0], np.cumsum(np.full(g, total // g)
                        + (np.arange(g) < total % g))])


class Simulator:
    def __init__(self, prof: ProfileData, peak_op: int, cfg: ChameleonConfig,
                 bwmodel=None, engine=None):
        self.prof = prof
        self.cfg = cfg
        self.peak_op = peak_op
        self.bandwidth = cfg.host_link_gbps * 1e9        # B in Eq. 3
        # measured host-link curve (repro_torch.hostmem.bwmodel) — when calibrated
        # it prices transfers size-dependently instead of with the constant
        self.bwmodel = bwmodel
        self._tswap_cache: Dict[int, float] = {}
        # live transfer engine (repro_torch.hostmem.engine): its per-class backlog
        # prices link *contention* — the paper's Eq. 3 assumes an idle link,
        # but a queued checkpoint/kv-spill drain eats into the transfer
        # budget of the earliest logical layers
        self.contention_s = (engine.queued_delay() if engine is not None
                             else 0.0)
        # sustained contention: the engine's per-class arrival-rate EWMA
        # gives the fraction of link time other traffic classes occupy in
        # steady state — a *rate*, not the point-in-time backlog above
        # (which only sees what happens to be queued at generation time)
        occ = 0.0
        if engine is not None:
            sc = getattr(engine, "sustained_contention", None)
            if sc is not None:
                occ = float(sc())
        self.occupancy = occ
        self.layers = self._build_layers()
        self._peak_layer = self.layer_of(self.peak_op)
        self._charge_contention()
        if occ > 0.0 and self._remaining.size:
            # every overlap window loses the sustained-traffic fraction
            self._remaining *= (1.0 - occ)
        self.stall_time = 0.0

    def _charge_contention(self) -> None:
        """Deduct the current link backlog from the earliest layers'
        transfer budgets: the link is busy draining it when the iteration
        starts, so early overlap windows are not actually free."""
        left = self.contention_s
        if left <= 0.0 or not self.layers:
            return
        # prefix drain in one pass: layer i keeps the part of its budget
        # that the backlog (spread over the cumulative prefix) leaves over
        rem = self._remaining
        cum = np.cumsum(rem)
        np.subtract(np.clip(cum - left, 0.0, None),
                    np.clip(cum - rem - left, 0.0, None), out=rem)

    # ------------------------------------------------------------- layers
    def _build_layers(self) -> List[LogicalLayer]:
        n = self.prof.n_ops
        t_op = self.prof.t_iter / max(n, 1)              # Eq. 1 per-op average
        G = self.cfg.groups_per_phase or self.prof.scan_layers or 32
        bounds: List[np.ndarray] = []
        kinds: List[str] = []
        for lo, hi, kind in ((0, self.peak_op, "FWD"), (self.peak_op, n, "BWD")):
            if hi - lo <= 0:
                continue
            b = _phase_splits(lo, hi, G)
            bounds.append(b)
            kinds.extend([kind] * (b.size - 1))
        if not bounds:
            self._remaining = np.zeros(0, np.float64)
            self._starts_arr = np.zeros(0, np.int64)
            return []
        starts = np.concatenate([b[:-1] for b in bounds])
        ends = np.concatenate([b[1:] for b in bounds])
        kinds[-1] = "OPT"
        self._remaining = (ends - starts).astype(np.float64) * t_op
        self._starts_arr = starts.astype(np.int64)
        return [LogicalLayer(i, int(s), int(e), k, self._remaining)
                for i, (s, e, k) in enumerate(zip(starts, ends, kinds))]

    def layer_of(self, op: int) -> int:
        i = int(np.searchsorted(self._starts_arr, op, side="right")) - 1
        return max(0, min(i, len(self.layers) - 1))

    def layers_of(self, ops: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`layer_of` for an array of op indices."""
        i = np.searchsorted(self._starts_arr, ops, side="right") - 1
        return np.clip(i, 0, max(len(self.layers) - 1, 0))

    def t_swap(self, nbytes: int) -> float:
        ts = self._tswap_cache.get(nbytes)
        if ts is None:
            if self.bwmodel is not None and self.bwmodel.is_calibrated:
                ts = self.bwmodel.transfer_time(nbytes)   # measured curve
            else:
                # Eq. 3 constant, derated by the autotuner's measured
                # link efficiency when a bandwidth model carries one
                eff = getattr(self.bwmodel, "link_efficiency", 1.0)
                ts = nbytes / (self.bandwidth * eff)
            self._tswap_cache[nbytes] = ts
        return ts

    # -------------------------------------------------- §5.4.1 swap-in
    def place_swap_in(self, cand: Candidate) -> Optional[PolicyEntry]:
        t = cand.tensor
        ts = self.t_swap(t.nbytes)
        first_use_layer = self.layer_of(t.death)
        # backward search over (peak_layer, first_use_layer): one
        # flatnonzero over the budget slice, picking the latest fit
        lo = self._peak_layer + 1
        fit = np.flatnonzero(self._remaining[lo:first_use_layer] > ts)
        if fit.size == 0:
            return None
        li = lo + int(fit[-1])
        lay = self.layers[li]
        self._remaining[li] -= ts
        lay.candidates.append(t.uid)
        e = PolicyEntry(t.uid, t.site, t.layer, t.nbytes, t.birth,
                        t.death, swap_in_op=lay.start_op,
                        score=cand.score)
        e._t_swap = ts
        return e

    def place_stalled(self, cand: Candidate) -> PolicyEntry:
        """Fallback: swap anyway right before first use, accept the stall."""
        t = cand.tensor
        ts = self.t_swap(t.nbytes)
        li = max(self.layer_of(t.death) - 1, 0)
        lay = self.layers[li]
        stall = max(0.0, ts - max(self._remaining[li], 0.0))
        self._remaining[li] -= ts
        lay.candidates.append(t.uid)
        self.stall_time += stall
        e = PolicyEntry(t.uid, t.site, t.layer, t.nbytes, t.birth, t.death,
                        swap_in_op=lay.start_op, stalled=True,
                        score=cand.score)
        e._t_swap = ts
        return e

    # ------------------------------------------------- Algo 2 inner loop
    def simulate(self, cl: List[Candidate], mrl: MRL) -> List[PolicyEntry]:
        entries: List[PolicyEntry] = []
        placed_any = False
        # The MRL and the layer budgets change only where a candidate is
        # placed, so each candidate's covered count and whether any layer
        # of its backward search fits are read from arrays refreshed after
        # a placement; place_swap_in then runs only for a candidate that
        # fits.  Most candidates of a tight budget fit nowhere.
        n = len(cl)
        births = np.fromiter((c.tensor.birth for c in cl), np.int64, n)
        deaths = np.fromiter((c.tensor.death for c in cl), np.int64, n)
        t_swaps = [self.t_swap(c.tensor.nbytes) for c in cl]
        lo = self._peak_layer + 1
        spans = (self.layers_of(deaths) - lo).tolist()
        empty, covered, fits = mrl.is_empty(), None, None
        for i, cand in enumerate(cl):
            if empty:
                break
            if covered is None:
                covered = mrl.covered_counts(births, deaths).tolist()
                # fits[k]: the largest budget of layers lo .. lo + k
                fits = np.maximum.accumulate(self._remaining[lo:]).tolist()
            if covered[i] == 0:
                continue
            k = spans[i]
            if k <= 0 or not fits[k - 1] > t_swaps[i]:
                continue
            e = self.place_swap_in(cand)
            t = cand.tensor
            # §5.4.1: decrement tensor size from MREs across its lifecycle
            mrl.decrement(t.birth, e.swap_in_op, t.nbytes)
            entries.append(e)
            placed_any = True
            empty, covered = mrl.is_empty(), None
        if not placed_any and cl and not mrl.is_empty():
            # nobody fits without stalls: paper picks the top-score candidate
            cand = cl[0]
            e = self.place_stalled(cand)
            mrl.decrement(cand.tensor.birth, e.swap_in_op, cand.tensor.nbytes)
            entries.append(e)
        return entries

    # ------------------------------------------------ §5.4.2 swap-out
    def set_free_time(self, entries: List[PolicyEntry]) -> None:
        if not entries:
            return
        order = sorted(entries, key=lambda e: e.birth)
        lis = self.layers_of(
            np.fromiter((e.birth for e in order), np.int64, len(order)))
        for e, li in zip(order, lis):
            ts = self.t_swap(e.nbytes)
            li = int(li)
            # forward search: earliest layer from birth with spare budget
            fit = np.flatnonzero(self._remaining[li:] > ts)
            if fit.size:
                lj = li + int(fit[0])
                self._remaining[lj] -= ts
                done = self.layers[lj]
            else:                 # saturated: completes at end of fwd stream
                done = self.layers[self._peak_layer]
            e.swap_out_done_op = done.end_op

    # --------------------------------------------------------- reporting
    def reuse_intervals(self, entries: List[PolicyEntry]) -> np.ndarray:
        """Ops between swap-out dispatch and memory release — the custom
        recordStream releases at swap_out_done_op (simulator-known), the
        naive recordStream analogue holds until first backward use."""
        return np.asarray([max(e.swap_out_done_op - e.birth, 0)
                           for e in entries], np.int64)

    def naive_reuse_intervals(self, entries: List[PolicyEntry]) -> np.ndarray:
        return np.asarray([max(e.death - e.birth, 0) for e in entries],
                          np.int64)
