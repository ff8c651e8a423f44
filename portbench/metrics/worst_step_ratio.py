"""The window's worst step over the median step of its bucket."""
import statistics


def read(rec):
    by = {}
    for s in rec["steps"]:
        by.setdefault(s["bucket"], []).append(s["wall_s"])
    return max(max(w) / statistics.median(w) for w in by.values())
