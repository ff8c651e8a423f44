"""Adaptation service (repro_torch.adapt), inline placement.

Port of ``repro/adapt/service.py`` for ``mode="inline"``, the reference
mode: the adaptation runs on the training thread, one measured variant
per GenPolicy iteration, exactly as the paper describes.  The service
keeps the adaptation bookkeeping the runtime reads through its
``variants`` / ``best`` / ``adaptations`` properties — the GenPolicy
variant list, the selected winner, and one latency record per
adaptation (trigger step, end step, seconds, tier, GenPolicy steps) —
and the reference's ``stats()`` keys.

The ``async`` and ``speculative`` placements (job queue, background
worker, single-slot mailbox, generation-counter staleness, speculative
pre-generation) come with ROADMAP.md queue 1 item 8: constructing the
service in either mode raises until then.
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

from repro_torch import obs
from repro_torch.adapt.pipeline import AdaptationPipeline

MODES = ("inline", "async", "speculative")


class AdaptationService:
    """The adaptation bookkeeping around the pipeline (inline placement)."""

    def __init__(self, pipeline: AdaptationPipeline, mode: str = "inline",
                 *, max_parked: int = 8, max_snapshots: int = 16,
                 history: int = 64, pace_s: float = 0.0,
                 pace_cap_s: float = 0.25):
        if mode not in MODES:
            raise ValueError(f"adaptation mode {mode!r} not in {MODES}")
        if mode != "inline":
            raise NotImplementedError(
                f"adaptation mode {mode!r} (the background worker) comes "
                "with ROADMAP.md queue 1 item 8; the port adapts inline")
        self.pipeline = pipeline
        self.mode = mode
        self.variants: List = []
        self.best = None
        self.adaptations: List[dict] = []
        self._adapt_mark: Optional[Tuple[int, float]] = None

    # --------------------------------------------------------- accounting
    def begin(self, step_idx: int) -> None:
        """Open the adaptation-latency window (idempotent until closed)."""
        if self._adapt_mark is None:
            self._adapt_mark = (step_idx, time.perf_counter())

    def finish(self, tier: str, step_idx: int) -> None:
        """Close the adaptation-latency window opened by :meth:`begin`."""
        if self._adapt_mark is None:
            return
        start_step, t0 = self._adapt_mark
        self._adapt_mark = None
        rec = {
            "trigger_step": start_step,
            "end_step": step_idx,
            "steps": step_idx - start_step,
            "seconds": time.perf_counter() - t0,
            "tier": tier,
            "genpolicy_steps": len(self.variants),
        }
        self.adaptations.append(rec)
        obs.audit().event("adaptation.done", tier=tier,
                          trigger_step=start_step, end_step=step_idx,
                          seconds=round(rec["seconds"], 6),
                          genpolicy_steps=rec["genpolicy_steps"])
        obs.metrics().counter("adaptations")
        obs.metrics().gauge("adaptation_seconds", rec["seconds"])

    def reset_search(self) -> None:
        self.variants, self.best = [], None

    def close(self) -> None:
        """No worker to stop inline."""

    def stats(self) -> dict:
        return {
            "mode": self.mode,
            "epoch": 0,
            "jobs": 0,
            "published": 0,
            "discarded": 0,
            "failed": 0,
            "installed": 0,
            "speculative_jobs": 0,
            "speculative_hits": 0,
            "watchdog_fired": 0,
            "parked": 0,
            "snapshots": 0,
            "queue_depth": 0,
            "worker_alive": False,
        }
