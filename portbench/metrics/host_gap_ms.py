"""The card idle between the trainer's dispatches, profiler off: the mean
over the window of a step's wall time less its dispatches' device time,
in ms.  The dispatches' device time is the change over the window of the
tracer's device records of the ``compute`` lane (the trainer's phases
``fwd``, ``bwd``, ``unscale``, ``clip``, ``adamw_update`` and ``eval``,
from CUDA events on the compute stream), which ``rt.stats()`` carries
under ``["obs"]["tracer"]["device_s"]``: a run with Chameleon off, or of
a program without those records, reads nothing."""


def read(rec):
    rt = rec["runtime"]
    if rt is None:
        return None
    before, after = (rt[k]["obs"]["tracer"].get("device_s")
                     for k in ("before", "after"))
    if not after:
        return None
    spent = sum(v - before.get(k, 0.0) for k, v in after.items()
                if k.startswith("compute."))
    steps = rec["steps"]
    return (sum(s["wall_s"] for s in steps) - spent) / len(steps) * 1e3
