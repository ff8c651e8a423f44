"""AdamW's bytes bound over the update's device time, in %: the least
time one update takes at HBM bandwidth (``yardstick.adamw_bytes``), for
each traced step that applied one, over the time in which a kernel ran
inside those steps' apply dispatches (``devtrace.APPLY``: the clipping
and the update, each dispatch ended by a device sync)."""
from portbench import yardstick


def read(rec):
    tr = rec["trace"]
    if tr is None or not tr.get("apply_s"):
        return None
    n = sum(1 for s in tr["steps"] if not s["skipped"])
    if not n:
        return None
    bound = yardstick.adamw_bytes(rec["cfg"]) / yardstick.PEAK_HBM_BYTES_S
    return 100.0 * n * bound / tr["apply_s"]
