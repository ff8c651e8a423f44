"""Every token of every step in the window over the window's wall time."""


def read(rec):
    return sum(s["batch"] * s["seq"] for s in rec["steps"]) / rec["window_s"]
