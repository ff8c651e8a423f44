"""repro_torch.faults — deterministic fault injection and the link-health
state machine it exercises.

Port of ``repro.faults`` without the degradation ladder:

  * :mod:`repro_torch.faults.plan` — seeded :class:`FaultPlan` schedules
    with process-global arming; hook points (:func:`inject`) are threaded
    through the transfer engine and the pinned pool, and are no-ops when
    no plan is armed;
  * :mod:`repro_torch.faults.health` — per-traffic-class link health state
    machine (healthy → degraded → failed) fed by the engine's retry /
    timeout / bandwidth-residual signals.

The ladder (``repro/faults/ladder.py``) steps an applied swap policy down
and needs the policy's projected peak, so it comes with the policy slice
(ROADMAP.md queue 1, slice 4).
"""
from repro_torch.faults.health import (DEGRADED, FAILED, HEALTHY, MEM_CLASS,
                                       HealthMonitor, LinkHealth)
from repro_torch.faults.plan import (SITES, Fault, FaultPlan, FaultSpec,
                                     active, arm, armed, disarm, inject,
                                     injected, tick)

__all__ = [
    "SITES", "Fault", "FaultPlan", "FaultSpec",
    "arm", "armed", "active", "disarm", "inject", "injected", "tick",
    "HEALTHY", "DEGRADED", "FAILED", "MEM_CLASS", "HealthMonitor",
    "LinkHealth",
]
