"""The executor's measured copy stall a step over the window's steps that
ran a policy (``Execution.last["copy_stall_s"]``, read after the step's
sync), in ms."""


def read(rec):
    rows = [s["exec"] for s in rec["steps"] if s.get("exec")]
    if not rows:
        return None
    return sum(r["copy_stall_s"] for r in rows) / len(rec["steps"]) * 1e3
