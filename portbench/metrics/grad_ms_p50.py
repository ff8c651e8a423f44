"""The median grad dispatch of the window's steps (the trainer's
``grad_times``: from the dispatch to its synchronised end, less its copy
stall), in ms."""
import statistics


def read(rec):
    return statistics.median(s["grad_s"] for s in rec["steps"]) * 1e3
