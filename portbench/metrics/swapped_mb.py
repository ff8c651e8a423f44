"""Bytes the executor staged to the host a step over the window, in MB."""


def read(rec):
    rows = [s["exec"] for s in rec["steps"] if s.get("exec")]
    if not rows:
        return None
    return sum(r["staged_bytes"] for r in rows) / len(rec["steps"]) / 1e6
