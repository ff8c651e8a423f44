"""The share of the traced steps' wall time in which no kernel or copy ran
on the device, in %."""


def read(rec):
    tr = rec["trace"]
    if tr is None or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
