"""Deterministic seeded fault injection (repro_torch.faults): port of
``repro/faults/plan.py``.

A :class:`FaultPlan` is a schedule of :class:`FaultSpec` rules keyed by
**site** (a string naming a hook point threaded through the swap path —
see :data:`SITES`) and **iteration**.  Whether a given hook invocation
fires is decided by a keyed blake2b hash over ``(seed, site, iteration,
occurrence-index)`` — the schedule is a pure function of the seed, so a
chaos scenario replays identically across processes and machines, and a
failing nightly run can be reproduced locally from its seed alone.

Arming is process-global (:func:`arm` / :func:`disarm`), mirroring how
``repro_torch.obs`` exposes its tracer: production hook points call
:func:`inject` unconditionally, and with no plan armed that is one
module-attribute load and a ``None`` check (the reference measures it
below noise on its transfer hot path; the port has not measured it).
Hooks therefore stay compiled in; there is no "fault build".

Every fired fault is recorded on the plan (bounded) and emitted as a
``fault.injected`` audit event, so a chaos run's evidence trail shows
exactly which fault produced which retry/degradation downstream.
"""
from __future__ import annotations

import hashlib
import json
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch import obs

# Hook points threaded through the swap path.  A spec's ``site`` must be
# one of these (checked at construction so a typo'd scenario fails fast).
SITES: Tuple[str, ...] = (
    "engine.transfer_error",    # D2H/H2D copy raises mid-transfer
    "engine.transfer_stall",    # copy delayed by ``seconds`` (link stall)
    "engine.transfer_drop",     # copy silently does nothing (lost DMA)
    "pool.alloc",               # pinned allocation fails outright
    "pool.pressure",            # host memory pressure: fresh slabs denied
    "store.load",               # policy record unreadable at load
    "store.put",                # record/index write fails mid-put
    "adapt.worker",             # adaptation worker raises
    "adapt.hang",               # adaptation worker hangs for ``seconds``
    "ckpt.write",               # checkpoint shard write fails
)


@dataclass(frozen=True)
class FaultSpec:
    """One injection rule: fire at ``site`` with probability ``prob`` per
    hook invocation, inside the iteration window [start, stop), at most
    ``max_fires`` times.  ``seconds`` parameterizes stall/hang faults."""
    site: str
    prob: float = 1.0
    start: int = 0
    stop: Optional[int] = None
    max_fires: Optional[int] = None
    seconds: float = 0.0

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"expected one of {SITES}")

    def to_json(self) -> dict:
        return {"site": self.site, "prob": self.prob, "start": self.start,
                "stop": self.stop, "max_fires": self.max_fires,
                "seconds": self.seconds}

    @classmethod
    def from_json(cls, d: dict) -> "FaultSpec":
        return cls(site=d["site"], prob=float(d.get("prob", 1.0)),
                   start=int(d.get("start", 0)),
                   stop=(None if d.get("stop") is None else int(d["stop"])),
                   max_fires=(None if d.get("max_fires") is None
                              else int(d["max_fires"])),
                   seconds=float(d.get("seconds", 0.0)))


@dataclass
class Fault:
    """What a fired hook returns to its call site."""
    site: str
    iteration: int
    seconds: float = 0.0
    key: str = ""


def _u01(seed: int, site: str, iteration: int, occ: int, key: str) -> float:
    """Deterministic uniform draw in [0, 1) for one hook invocation."""
    h = hashlib.blake2b(
        f"{seed}:{site}:{iteration}:{occ}:{key}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") / 2.0 ** 64


class FaultPlan:
    """Seeded schedule of fault specs, armed process-wide via :func:`arm`.

    Thread-safe: hook points fire from the training thread, the adaptation
    worker, and the checkpoint writer concurrently."""

    LOG_CAP = 4096

    def __init__(self, specs: List[FaultSpec], seed: int = 0):
        self.seed = int(seed)
        self.specs = list(specs)
        self.iteration = 0
        self._occ: Dict[Tuple[str, int], int] = {}   # (site, iter) -> calls
        self.fired: Dict[str, int] = {}              # site -> fires
        self._spec_fires: Dict[int, int] = {}        # spec idx -> fires
        self.log: List[dict] = []
        self._lock = threading.Lock()
        self._by_site: Dict[str, List[Tuple[int, FaultSpec]]] = {}
        for i, s in enumerate(self.specs):
            self._by_site.setdefault(s.site, []).append((i, s))

    # ----------------------------------------------------------- schedule
    def set_iteration(self, it: int) -> None:
        self.iteration = int(it)

    def fire(self, site: str, key: str = "") -> Optional[Fault]:
        specs = self._by_site.get(site)
        if not specs:
            return None
        with self._lock:
            it = self.iteration
            occ = self._occ.get((site, it), 0)
            self._occ[(site, it)] = occ + 1
            for idx, s in specs:
                if it < s.start or (s.stop is not None and it >= s.stop):
                    continue
                if (s.max_fires is not None
                        and self._spec_fires.get(idx, 0) >= s.max_fires):
                    continue
                if _u01(self.seed, site, it, occ, key) >= s.prob:
                    continue
                self._spec_fires[idx] = self._spec_fires.get(idx, 0) + 1
                self.fired[site] = self.fired.get(site, 0) + 1
                f = Fault(site, it, seconds=s.seconds, key=key)
                if len(self.log) < self.LOG_CAP:
                    self.log.append({"site": site, "iteration": it,
                                     "occ": occ, "key": key,
                                     "seconds": s.seconds})
                break
            else:
                return None
        obs.audit().event("fault.injected", site=site, iteration=it,
                          occ=occ, key=key[:64], seconds=s.seconds)
        obs.metrics().counter("faults_injected")
        return f

    def total_fired(self) -> int:
        with self._lock:
            return sum(self.fired.values())

    def stats(self) -> dict:
        with self._lock:
            return {"seed": self.seed, "specs": len(self.specs),
                    "iteration": self.iteration,
                    "fired": dict(self.fired),
                    "total_fired": sum(self.fired.values())}

    # ------------------------------------------------------ serialization
    def to_json(self) -> dict:
        return {"seed": self.seed,
                "specs": [s.to_json() for s in self.specs]}

    @classmethod
    def from_json(cls, d: dict) -> "FaultPlan":
        return cls([FaultSpec.from_json(s) for s in d.get("specs", [])],
                   seed=int(d.get("seed", 0)))

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            return cls.from_json(json.load(f))

    # ------------------------------------------------------ conveniences
    @classmethod
    def everywhere(cls, seed: int = 0, prob: float = 0.05,
                   seconds: float = 0.01, start: int = 0,
                   stop: Optional[int] = None,
                   max_fires_per_site: Optional[int] = None) -> "FaultPlan":
        """One spec per site — the chaos benchmark's all-sites scenario."""
        return cls([FaultSpec(site, prob=prob, seconds=seconds, start=start,
                              stop=stop, max_fires=max_fires_per_site)
                    for site in SITES], seed=seed)


# -------------------------------------------------------- process arming
_ACTIVE: Optional[FaultPlan] = None


def arm(plan: FaultPlan) -> FaultPlan:
    """Make ``plan`` the process-wide fault schedule."""
    global _ACTIVE
    _ACTIVE = plan
    obs.audit().event("fault.armed", seed=plan.seed, specs=len(plan.specs))
    return plan


def disarm() -> Optional[FaultPlan]:
    """Remove the armed plan (hooks go back to zero-cost no-ops)."""
    global _ACTIVE
    old, _ACTIVE = _ACTIVE, None
    if old is not None:
        obs.audit().event("fault.disarmed", total_fired=old.total_fired())
    return old


def active() -> Optional[FaultPlan]:
    return _ACTIVE


def armed() -> bool:
    return _ACTIVE is not None


def inject(site: str, key: str = "") -> Optional[Fault]:
    """The production hook point.  With no plan armed this is one global
    read and a ``None`` check — cheap enough to leave in hot paths."""
    p = _ACTIVE
    if p is None:
        return None
    return p.fire(site, key)


def tick(iteration: int) -> None:
    """Advance the armed plan's iteration cursor (driven by the trainer);
    no-op when disarmed."""
    p = _ACTIVE
    if p is not None:
        p.set_iteration(iteration)


class injected:
    """Context manager for tests: arm a plan, disarm on exit."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan

    def __enter__(self) -> FaultPlan:
        return arm(self.plan)

    def __exit__(self, *exc) -> None:
        disarm()
