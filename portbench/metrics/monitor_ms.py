"""The monitor's host time a step over the window (the runtime's
``profiling_overhead_s``: the recorder and Algo 1's bookkeeping), in ms."""


def read(rec):
    rt = rec["runtime"]
    if rt is None:
        return None
    spent = rt["after"]["profiling_overhead_s"] - rt["before"][
        "profiling_overhead_s"]
    return spent / len(rec["steps"]) * 1e3
