"""The adaptation's host time a step over the window (the runtime's
``adaptation_overhead_s``: drift handling, store lookups, installs), in
ms."""


def read(rec):
    rt = rec["runtime"]
    if rt is None:
        return None
    spent = rt["after"]["adaptation_overhead_s"] - rt["before"][
        "adaptation_overhead_s"]
    return spent / len(rec["steps"]) * 1e3
