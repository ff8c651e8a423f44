"""Stage-adjusting module (paper Algo. 1).

WarmUp --(m stable steps)--> GenPolicy --(n steps)--> Stable; any significant
operator-sequence change (length diff >= 5% OR cosine < 95%) resets to
WarmUp.  During GenPolicy the profiler runs in Detailed mode and a fresh
policy is generated each step; the best-performing of the n policies becomes
the long-term policy (§7.1).

A copy of ``repro/core/stages.py``: the same signatures give the same
transitions (``tests/test_torch_monitor.py``).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch import obs
from repro_torch.common.config import ChameleonConfig
from repro_torch.core.tokenizer import Signature, sig_similarity


class Stage(enum.Enum):
    WARMUP = "WarmUp"
    GENPOLICY = "GenPolicy"
    STABLE = "Stable"
    # async placement (ROADMAP.md queue 1 items 4b and 8): the sequence
    # has settled and the variant search is running on the background
    # worker — profiling stays Lightweight and iterations keep serving
    # the old policy
    ADAPTING = "Adapting"


@dataclass
class StageMachine:
    cfg: ChameleonConfig
    stage: Stage = Stage.WARMUP
    stable_step: int = 0
    prev_seq: Optional[Signature] = None
    transitions: list = field(default_factory=list)
    # per-adaptation override of Algo 1's `n` (None -> cfg value): a
    # policystore warm start shrinks the GenPolicy variant search to the
    # seeded knobs instead of the full five
    n_genpolicy: Optional[int] = None
    # async placement (ROADMAP.md queue 1 items 4b and 8): a settled
    # WarmUp enters ADAPTING (worker searches in the background) instead
    # of GENPOLICY (inline measured search); complete_adapting() moves on
    # to STABLE when the runtime installs the worker's result at an
    # iteration boundary
    async_mode: bool = False

    def observe(self, op_seq, step: int = -1) -> Stage:
        """Algo 1: feed one iteration's operator sequence — either a raw
        token array or an (incrementally maintained) ``Signature``.  With
        signatures the length-diff + cosine test runs in histogram space:
        O(changed dispatches) steady state, never O(n_ops)."""
        if not isinstance(op_seq, Signature):
            op_seq = Signature.from_tokens(np.asarray(op_seq))
        if self.prev_seq is None:
            self.prev_seq = op_seq
            self._log(step, "init", self.stage)
            return self.stage

        n_gen = (self.n_genpolicy if self.n_genpolicy is not None
                 else self.cfg.n_genpolicy_steps)
        len_diff, cos = sig_similarity(op_seq, self.prev_seq)
        stable = (len_diff < self.cfg.len_change_threshold
                  and cos > self.cfg.cos_sim_threshold)
        prev_stage = self.stage
        if stable:
            self.stable_step += 1
            if prev_stage is Stage.WARMUP and self.stable_step > self.cfg.m_warmup_stable:
                # async: hold in ADAPTING (Lightweight profiling, old
                # policy serving) until the worker's result installs
                self.stage = (Stage.ADAPTING if self.async_mode
                              else Stage.GENPOLICY)
                self.stable_step = 0
            elif (prev_stage is Stage.GENPOLICY
                  and self.stable_step > n_gen):
                self.stage = Stage.STABLE
        else:
            self.stage, self.stable_step = Stage.WARMUP, 0
        if self.stage is not prev_stage:
            self._log(step, "stable" if stable else "seq-change", self.stage)
        self.prev_seq = op_seq
        return self.stage

    def to_warmup(self, step: int = -1, why: str = "shape-change") -> Stage:
        """Out-of-band reset: the runtime saw drift the token stream
        cannot express (e.g. a dispatch-shape change — same primitives,
        different memory profile) and restarts adaptation."""
        prev = self.stage
        self.stage, self.stable_step = Stage.WARMUP, 0
        if prev is not Stage.WARMUP:
            self._log(step, why, self.stage)
        return self.stage

    def force_stable(self, step: int = -1, why: str = "forced") -> Stage:
        """Jump straight to Stable: the policystore's reuse tier applied a
        cached policy, so neither the WarmUp wait nor GenPolicy is needed
        for this adaptation."""
        prev = self.stage
        self.stage, self.stable_step = Stage.STABLE, 0
        if prev is not Stage.STABLE:
            self._log(step, why, self.stage)
        return self.stage

    def complete_adapting(self, step: int = -1,
                          why: str = "adapt-installed") -> Stage:
        """Async adaptation finished: the runtime installed the worker's
        (or a parked speculative) result at an iteration boundary."""
        prev = self.stage
        self.stage, self.stable_step = Stage.STABLE, 0
        if prev is not Stage.STABLE:
            self._log(step, why, self.stage)
        return self.stage

    @property
    def mode(self) -> str:
        """Profiler mode implied by the stage (§4).  ADAPTING stays
        Lightweight — Detailed replays run on the worker, off-thread."""
        return "detailed" if self.stage is Stage.GENPOLICY else "lightweight"

    def _log(self, step, why, to):
        self.transitions.append((step, why, to.value))
        # audit + trace: every stage move is an inspectable event and a
        # marker on the adapt lane (name set is bounded: one per stage)
        obs.audit().event("stage.transition", step=step, why=why,
                          to=to.value)
        obs.tracer().instant(obs.LANE_ADAPT, f"stage:{to.value}",
                             arg=(step, why))
