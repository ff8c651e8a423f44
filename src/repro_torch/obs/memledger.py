"""Per-iteration realized HBM occupancy ledger (repro_torch.obs.memledger):
port of ``repro/obs/memledger.py``, numpy logic unchanged.

``Simulator``/``projected_peak`` predict what the peak *should* be;
nothing so far reconstructed what it *was*.  The ledger closes that
loop: subsystems feed it the observed events of each iteration — the
executed policy's mirrored swap copies and their ``advance_op`` release
points, engine copy/release outcomes per traffic class, KV-spill and
checkpoint staging, pool slab counters — and at the iteration boundary
it replays them into a per-op realized-occupancy timeline, mirroring
``core/memtrace.build_timeline`` but from observations instead of
profiled predictions.

Derived per iteration:

  * **realized peak** + top-k tensor/layer attribution at the peak op;
  * **predicted-vs-realized peak error** — the Simulator accuracy
    scoreboard (``memory.peak_error`` gauge, ``memory.peak`` audit
    events).  On a clean run every observed swap-out retires at its
    promised release op, so realized == projected exactly; the error is
    precisely the execution's divergence from the plan (failed
    swap-outs retained in HBM, late releases);
  * **budget headroom** (``memory.headroom_frac``) — consumed by the
    runtime's health FSM so the degradation ladder reacts to shrinking
    margin *before* an OOM;
  * **byte conservation** — allocated == resident + freed across
    pool/engine/kvspill per iteration, with leak suspects named
    (terminal transfer failures, pool imbalance).

Occupancy is also kept as bounded counter-track series
(:data:`LEDGER_TRACKS`: ``hbm_dynamic``, ``swapped_out``, ``host_pool``,
``kv_spill``) for Perfetto export alongside the span lanes.

Layering: this module sits at the bottom of the stack with the other
``repro_torch.obs`` pillars — it never imports ``repro_torch.core`` or
``repro_torch.hostmem``; profiles, swap policies and pool stats arrive as
duck-typed arguments, and traffic classes are matched by name.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np

# Perfetto counter tracks exported next to the span lanes.
LEDGER_TRACKS: Tuple[str, ...] = ("hbm_dynamic", "swapped_out",
                                  "host_pool", "kv_spill")

# engine traffic-class names (matched by string — obs is below hostmem)
_CLS_POLICY = "policy_swap"
_CLS_KV = "kv_spill"
_CLS_CKPT = "checkpoint"
_CLS_TRACK = {_CLS_POLICY: "swapped_out", _CLS_KV: "kv_spill"}

#: keys every per-iteration ledger record carries (schema-pinned)
RECORD_KEYS = ("step", "t", "realized_peak", "realized_dynamic_peak",
               "peak_op", "projected_peak", "peak_error", "headroom_frac",
               "budget", "attribution", "n_swap_entries", "n_observed",
               "n_failed", "n_unobserved", "conservation")
CONSERVATION_KEYS = ("ok", "allocated", "freed", "resident_delta",
                     "suspects")


def _entry_tag(e) -> str:
    """Identical to ``SwapPolicy.entry_tag`` (duplicated — no core import)."""
    return f"{getattr(e, 'site', None) or 'tensor'}:{e.layer}:{e.uid}"


def _clamp(v: int, lo: int, hi: int) -> int:
    return min(max(v, lo), hi)


class MemoryLedger:
    """Observed-event HBM accounting.  All state is bounded (ring buffers
    per track / per iteration record), so the ledger stays always-on like
    the tracer and the audit log."""

    def __init__(self, max_iterations: int = 512,
                 track_points: int = 4096, max_window_events: int = 8192,
                 top_k: int = 5):
        self.top_k = int(top_k)
        self._lock = threading.Lock()
        self._tracks: Dict[str, Deque[Tuple[float, float]]] = {
            name: collections.deque(maxlen=track_points)
            for name in LEDGER_TRACKS}
        # host-resident staged bytes per engine traffic class (running)
        self._staged: Dict[str, int] = {}
        # swap-out outcomes observed this window: tag -> {failed, release_op}
        self._observed: Dict[str, dict] = {}
        self._window_failed: List[dict] = []
        self._max_window_events = int(max_window_events)
        self.iterations: Deque[dict] = collections.deque(
            maxlen=max_iterations)
        # replay cache: the base (no-swap) delta array + uid index per
        # profile, rebuilt only when the profile object changes
        self._cache_key: Optional[tuple] = None
        self._cache: Optional[tuple] = None
        self._prev_pool: Optional[dict] = None
        # ---- counters ----
        self.n_events = 0
        self.n_events_dropped = 0        # window overflow (cap, never grows)
        self.n_leak_suspects = 0
        self.n_iterations = 0

    # ------------------------------------------------------- event feed
    def note_transfer(self, kind: str, cls: str, tag: str, nbytes: int, *,
                      failed: bool = False, release_op: int = -1,
                      t: Optional[float] = None) -> None:
        """An engine copy retired (``kind`` = ``"out"``/``"in"``).  Failed
        transfers become leak suspects for this window; successful ones
        move the per-class staged-byte gauges and, for policy-swap
        D2H copies, record the observed outcome the replay consumes."""
        nbytes = int(nbytes)
        with self._lock:
            self.n_events += 1
            if failed:
                if len(self._window_failed) < self._max_window_events:
                    self._window_failed.append({
                        "tag": tag[:64], "cls": cls, "dir": kind,
                        "nbytes": nbytes,
                        "reason": f"swap_{kind}_failed"})
                else:
                    self.n_events_dropped += 1
                if kind == "out" and cls == _CLS_POLICY:
                    self._note_observed(tag, failed=True,
                                        release_op=release_op)
                return
            if kind == "out":
                self._staged[cls] = self._staged.get(cls, 0) + nbytes
                if cls == _CLS_POLICY:
                    self._note_observed(tag, failed=False,
                                        release_op=release_op)
            else:
                self._staged[cls] = max(
                    self._staged.get(cls, 0) - nbytes, 0)
            self._point(cls, t)

    def note_release(self, cls: str, tag: str, nbytes: int,
                     t: Optional[float] = None) -> None:
        """Staged host bytes returned to the pool *without* an H2D copy
        (KV-spill discard, checkpoint writer collecting its slabs)."""
        with self._lock:
            self.n_events += 1
            self._staged[cls] = max(
                self._staged.get(cls, 0) - int(nbytes), 0)
            self._point(cls, t)

    def _note_observed(self, tag: str, *, failed: bool,
                       release_op: int) -> None:
        if len(self._observed) < self._max_window_events:
            self._observed[tag] = {"failed": failed,
                                   "release_op": int(release_op)}
        else:
            self.n_events_dropped += 1

    def _point(self, cls: str, t: Optional[float]) -> None:
        track = _CLS_TRACK.get(cls)
        if track is not None:
            self._tracks[track].append(
                (time.perf_counter() if t is None else t,
                 float(self._staged.get(cls, 0))))

    # -------------------------------------------------- iteration close
    def close_iteration(self, step: int, *, profile=None, swap=None,
                        budget: Optional[int] = None,
                        pool_stats: Optional[dict] = None,
                        t: Optional[float] = None) -> dict:
        """Close the iteration window: replay the observed events into a
        realized-occupancy timeline, score it against the executed
        policy's ``projected_peak``, run the byte-conservation check, and
        append the four counter-track points.  Returns the iteration
        record (also kept in the bounded ``iterations`` ring)."""
        t = time.perf_counter() if t is None else t
        with self._lock:
            observed, self._observed = self._observed, {}
            failed, self._window_failed = self._window_failed, []
            staged_policy = self._staged.get(_CLS_POLICY, 0)
            staged_kv = self._staged.get(_CLS_KV, 0)
        realized = self._realize(profile, swap, observed)
        (dyn_peak, peak_op, static, attribution,
         n_obs, n_fail, n_unobs) = realized
        realized_peak = dyn_peak + static
        projected = None
        error = None
        headroom = None
        if swap is not None and profile is not None:
            projected = int(getattr(swap, "projected_peak", 0)) or None
            if projected:
                error = (realized_peak - projected) / projected
            if budget:
                headroom = (budget - realized_peak) / budget
        conservation = self._conserve(pool_stats, failed)
        rec = {
            "step": int(step), "t": t,
            "realized_peak": int(realized_peak),
            "realized_dynamic_peak": int(dyn_peak),
            "peak_op": int(peak_op),
            "projected_peak": projected,
            "peak_error": error,
            "headroom_frac": headroom,
            "budget": int(budget) if budget else None,
            "attribution": attribution,
            "n_swap_entries": (len(swap.entries)
                               if swap is not None else 0),
            "n_observed": n_obs, "n_failed": n_fail,
            "n_unobserved": n_unobs,
            "conservation": conservation,
        }
        host_pool = (pool_stats or {}).get("bytes_in_use", 0)
        with self._lock:
            self.n_iterations += 1
            self.iterations.append(rec)
            self._tracks["hbm_dynamic"].append((t, float(dyn_peak)))
            self._tracks["swapped_out"].append((t, float(staged_policy)))
            self._tracks["host_pool"].append((t, float(host_pool)))
            self._tracks["kv_spill"].append((t, float(staged_kv)))
            if not conservation["ok"]:
                self.n_leak_suspects += len(conservation["suspects"])
        self._publish(rec)
        return rec

    # ------------------------------------------------------- the replay
    def _base(self, profile):
        """Cached no-swap delta array + uid->tensor index for a profile."""
        key = (id(profile), profile.n_ops, len(profile.tensors))
        if self._cache_key != key:
            n = int(profile.n_ops)
            delta = np.zeros(n + 2, np.int64)
            by_uid = {}
            for tt in profile.tensors:
                b = _clamp(tt.birth, 0, n)
                d = _clamp(tt.death, b, n + 1)
                delta[b] += tt.nbytes
                delta[d] -= tt.nbytes
                by_uid[tt.uid] = tt
            self._cache_key, self._cache = key, (delta, by_uid)
        return self._cache

    def _realize(self, profile, swap, observed: Dict[str, dict]):
        """Per-op realized occupancy: the profiled tensor liveness with
        off-device windows applied only for swap entries whose D2H was
        *observed* to complete (at the observed release op) — a failed
        swap-out was retained in HBM and contributes no reduction;
        entries the mirror cap kept unobserved fall back to their
        planned windows."""
        if profile is None:
            return 0, 0, 0, [], 0, 0, 0
        n = int(profile.n_ops)
        base, by_uid = self._base(profile)
        delta = base.copy()
        off: Dict[Any, Tuple[int, int]] = {}
        n_obs = n_fail = n_unobs = 0
        for e in (swap.entries if swap is not None else ()):
            tt = by_uid.get(e.uid)
            if tt is None:
                continue
            ob = observed.get(_entry_tag(e))
            if ob is None:
                out_op, back = e.swap_out_done_op, e.swap_in_op
                n_unobs += 1
            elif ob["failed"]:
                n_fail += 1
                continue                     # retained in HBM
            else:
                out_op = (ob["release_op"] if ob["release_op"] >= 0
                          else e.swap_out_done_op)
                back = e.swap_in_op
                n_obs += 1
            b = _clamp(tt.birth, 0, n)
            d = _clamp(tt.death, b, n + 1)
            out_op = _clamp(out_op, b, d)
            back = _clamp(back, out_op, d)
            if back > out_op:
                delta[out_op] -= tt.nbytes
                delta[back] += tt.nbytes
                off[e.uid] = (out_op, back)
        usage = np.cumsum(delta)[: n + 1]
        peak_op = int(np.argmax(usage)) if usage.size else 0
        dyn_peak = int(usage[peak_op]) if usage.size else 0
        resident = []
        for tt in profile.tensors:
            b = _clamp(tt.birth, 0, n)
            d = _clamp(tt.death, b, n + 1)
            if not b <= peak_op < d:
                continue
            w = off.get(tt.uid)
            if w is not None and w[0] <= peak_op < w[1]:
                continue                     # off-device at the peak
            resident.append(tt)
        resident.sort(key=lambda tt: -tt.nbytes)
        attribution = [{"tag": _entry_tag(tt), "nbytes": int(tt.nbytes),
                        "layer": int(getattr(tt, "layer", -1)),
                        "site": getattr(tt, "site", None)}
                       for tt in resident[: self.top_k]]
        return (dyn_peak, peak_op, int(profile.static_bytes), attribution,
                n_obs, n_fail, n_unobs)

    # -------------------------------------------------- byte conservation
    def _conserve(self, pool_stats: Optional[dict],
                  failed: List[dict]) -> dict:
        """allocated == resident + freed, per iteration: the pool's
        cumulative alloc/free byte counters must exactly explain the
        resident-byte delta since the last close; any terminal transfer
        failure this window is a named leak suspect."""
        suspects = list(failed)
        allocated = freed = resident_delta = 0
        if pool_stats is not None:
            prev = self._prev_pool or {}
            allocated = (pool_stats.get("bytes_alloc_total", 0)
                         - prev.get("bytes_alloc_total", 0))
            freed = (pool_stats.get("bytes_freed_total", 0)
                     - prev.get("bytes_freed_total", 0))
            resident_delta = (pool_stats.get("bytes_in_use", 0)
                              - prev.get("bytes_in_use", 0))
            if allocated - freed != resident_delta:
                suspects.append({
                    "tag": "pool", "cls": "pool", "dir": "-",
                    "nbytes": allocated - freed - resident_delta,
                    "reason": "pool_imbalance"})
            self._prev_pool = {
                k: pool_stats.get(k, 0)
                for k in ("bytes_alloc_total", "bytes_freed_total",
                          "bytes_in_use")}
        return {"ok": not suspects, "allocated": int(allocated),
                "freed": int(freed), "resident_delta": int(resident_delta),
                "suspects": suspects}

    # ------------------------------------------------------- publication
    def _publish(self, rec: dict) -> None:
        """memory.* gauges + audit events (late obs import: this module
        is itself part of the repro_torch.obs package)."""
        from repro_torch import obs
        m = obs.metrics()
        m.gauge("memory.realized_peak", rec["realized_peak"], t=rec["t"])
        if rec["projected_peak"] is not None:
            m.gauge("memory.projected_peak", rec["projected_peak"],
                    t=rec["t"])
        if rec["peak_error"] is not None:
            m.gauge("memory.peak_error", rec["peak_error"], t=rec["t"])
        if rec["headroom_frac"] is not None:
            m.gauge("memory.headroom_frac", rec["headroom_frac"],
                    t=rec["t"])
        cons = rec["conservation"]
        obs.audit().event(
            "memory.peak", step=rec["step"],
            realized=rec["realized_peak"], projected=rec["projected_peak"],
            error=(round(rec["peak_error"], 4)
                   if rec["peak_error"] is not None else None),
            peak_op=rec["peak_op"], n_failed=rec["n_failed"])
        if not cons["ok"]:
            m.counter("memory.leak_suspects", len(cons["suspects"]))
            obs.audit().event(
                "memory.leak_suspect", step=rec["step"],
                n=len(cons["suspects"]),
                suspects=[s["tag"] for s in cons["suspects"][:8]],
                reasons=sorted({s["reason"] for s in cons["suspects"]}))

    # ------------------------------------------------------------ queries
    def counter_tracks(self) -> Dict[str, List[Tuple[float, float]]]:
        """The four occupancy tracks in ``chrome_trace_events``'
        ``counters=`` shape (name -> [(t, value), ...])."""
        with self._lock:
            return {name: list(pts) for name, pts in self._tracks.items()}

    def scoreboard(self) -> dict:
        """Simulator accuracy over the retained iterations: how far the
        realized peak landed from ``projected_peak``."""
        with self._lock:
            scored = [r for r in self.iterations
                      if r["peak_error"] is not None]
        errs = [abs(r["peak_error"]) for r in scored]
        worst = max(scored, key=lambda r: abs(r["peak_error"]),
                    default=None)
        return {
            "n": len(scored),
            "mean_abs_error": float(np.mean(errs)) if errs else None,
            "max_abs_error": float(max(errs)) if errs else None,
            "worst_step": worst["step"] if worst else None,
            "last_error": scored[-1]["peak_error"] if scored else None,
        }

    def staged_bytes(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._staged)

    def last(self) -> Optional[dict]:
        with self._lock:
            return self.iterations[-1] if self.iterations else None

    def stats(self) -> dict:
        last = self.last()
        return {
            "iterations": self.n_iterations,
            "events": self.n_events,
            "events_dropped": self.n_events_dropped,
            "leak_suspects": self.n_leak_suspects,
            "staged_bytes": self.staged_bytes(),
            "scoreboard": self.scoreboard(),
            "last": ({k: last[k] for k in
                      ("step", "realized_peak", "projected_peak",
                       "peak_error", "headroom_frac", "n_failed")}
                     if last else None),
        }

    def clear(self) -> None:
        with self._lock:
            for pts in self._tracks.values():
                pts.clear()
            self._staged.clear()
            self._observed.clear()
            self._window_failed.clear()
            self.iterations.clear()
            self._cache_key = self._cache = None
            self._prev_pool = None
            self.n_events = self.n_events_dropped = 0
            self.n_leak_suspects = self.n_iterations = 0
