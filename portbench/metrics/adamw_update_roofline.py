"""AdamW's bytes bound over the update's own device time, profiler off,
in %: the least time one update takes at HBM bandwidth
(``yardstick.adamw_bytes``) for each update the window ran, over the
change over the window of the tracer's ``compute.adamw_update`` device
records (from the clipping's end to the update's end on the compute
stream; the clipping is left out), which ``rt.stats()`` carries under
``["obs"]["tracer"]``: a run with Chameleon off, or of a program without
those records, reads nothing."""
from portbench import yardstick

KEY = "compute.adamw_update"


def read(rec):
    rt = rec["runtime"]
    if rt is None:
        return None
    before, after = (rt[k]["obs"]["tracer"] for k in ("before", "after"))
    if KEY not in after.get("device_s", {}):
        return None
    t = after["device_s"][KEY] - before.get("device_s", {}).get(KEY, 0.0)
    n = after["device_n"][KEY] - before.get("device_n", {}).get(KEY, 0)
    if n <= 0 or t <= 0:
        return None
    bound = yardstick.adamw_bytes(rec["cfg"]) / yardstick.PEAK_HBM_BYTES_S
    return 100.0 * n * bound / t
