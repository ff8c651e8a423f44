"""Straggler detection (large-scale posture).

Port of ``repro/runtime/straggler.py`` (plain Python, copied).

Per-step wall times feed an EWMA mean/variance; a step (or a host, when
per-host timings are reported by the launcher's heartbeat channel) whose
time exceeds ``mean + k·std`` is flagged.  Mitigation hooks:
  * report   — structured event for the orchestrator
  * rebalance — shrink the flagged host's data shard (skew map)
  * evict    — request elastic restart without the host (checkpoint+resume)
On this single-host container the detector is exercised by tests with
injected delays; the mitigation callbacks are the integration surface.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


@dataclass
class StragglerEvent:
    step: int
    host: int
    t: float
    mean: float
    std: float


@dataclass
class StragglerDetector:
    threshold_sigma: float = 3.0
    alpha: float = 0.05                  # EWMA decay
    warmup: int = 5                      # ignore first steps (compiles)
    on_straggler: Optional[Callable[[StragglerEvent], None]] = None
    _mean: Dict[int, float] = field(default_factory=dict)
    _var: Dict[int, float] = field(default_factory=dict)
    _n: Dict[int, int] = field(default_factory=dict)
    events: List[StragglerEvent] = field(default_factory=list)

    def observe(self, step: int, t: float, host: int = 0) -> bool:
        n = self._n.get(host, 0)
        self._n[host] = n + 1
        if n == 0:
            self._mean[host], self._var[host] = t, 0.0
            return False
        mean, var = self._mean[host], self._var[host]
        std = math.sqrt(var)
        is_straggler = (n >= self.warmup and std > 0
                        and t > mean + self.threshold_sigma * std)
        if is_straggler:
            ev = StragglerEvent(step, host, t, mean, std)
            self.events.append(ev)
            if self.on_straggler:
                self.on_straggler(ev)
            # don't poison the EWMA with the outlier
            return True
        d = t - mean
        self._mean[host] = mean + self.alpha * d
        self._var[host] = (1 - self.alpha) * (var + self.alpha * d * d)
        return False

    def skew_map(self, host_times: Dict[int, float]) -> Dict[int, float]:
        """Relative data-shard weights inversely proportional to speed."""
        inv = {h: 1.0 / max(t, 1e-9) for h, t in host_times.items()}
        z = sum(inv.values())
        return {h: v / z for h, v in inv.items()}
