"""The runtime's close of its observation window a step over the window
(``obs_close_s``: the overlap efficiency over the tracer's records and the
memory ledger's replay, a part of ``profiling_overhead_s``), in ms."""


def read(rec):
    rt = rec["runtime"]
    if rt is None or "obs_close_s" not in rt["after"]:
        return None
    spent = rt["after"]["obs_close_s"] - rt["before"]["obs_close_s"]
    return spent / len(rec["steps"]) * 1e3
