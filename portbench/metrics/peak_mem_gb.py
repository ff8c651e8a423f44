"""The allocator's peak over the window (reset at its start), in GB."""


def read(rec):
    return rec["peak_bytes"] / 1e9 if rec["peak_bytes"] else None
