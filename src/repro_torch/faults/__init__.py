"""repro_torch.faults — deterministic fault injection and the link-health
state machine it exercises.

Port of ``repro.faults``:

  * :mod:`repro_torch.faults.plan` — seeded :class:`FaultPlan` schedules
    with process-global arming; hook points (:func:`inject`) are threaded
    through the transfer engine and the pinned pool, and are no-ops when
    no plan is armed;
  * :mod:`repro_torch.faults.health` — per-traffic-class link health state
    machine (healthy → degraded → failed) fed by the engine's retry /
    timeout / bandwidth-residual signals;
  * :mod:`repro_torch.faults.ladder` — the degradation ladder the runtime
    steps the applied policy down when health degrades (full → trimmed →
    conservative → no_swap) and climbs back up via recovery probes.
"""
from repro_torch.faults.health import (DEGRADED, FAILED, HEALTHY, MEM_CLASS,
                                       HealthMonitor, LinkHealth)
from repro_torch.faults.ladder import (RUNG_CONSERVATIVE, RUNG_FULL,
                                       RUNG_NAMES, RUNG_NO_SWAP,
                                       RUNG_TRIMMED, DegradationLadder,
                                       trim_swap)
from repro_torch.faults.plan import (SITES, Fault, FaultPlan, FaultSpec,
                                     active, arm, armed, disarm, inject,
                                     injected, tick)

__all__ = [
    "SITES", "Fault", "FaultPlan", "FaultSpec",
    "arm", "armed", "active", "disarm", "inject", "injected", "tick",
    "HEALTHY", "DEGRADED", "FAILED", "MEM_CLASS", "HealthMonitor",
    "LinkHealth", "DegradationLadder", "trim_swap", "RUNG_NAMES",
    "RUNG_FULL", "RUNG_TRIMMED", "RUNG_CONSERVATIVE", "RUNG_NO_SWAP",
]
