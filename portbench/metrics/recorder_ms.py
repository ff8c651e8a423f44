"""The Lightweight recorder's own host time a step over the window (the
runtime's ``recorder_s``, ``OpStreamRecorder.overhead_s``: a part of
``profiling_overhead_s``), in ms."""


def read(rec):
    rt = rec["runtime"]
    if rt is None or "recorder_s" not in rt["after"]:
        return None
    spent = rt["after"]["recorder_s"] - rt["before"]["recorder_s"]
    return spent / len(rec["steps"]) * 1e3
