"""The 90th percentile of the window's step wall times, in ms."""
import numpy as np


def read(rec):
    return float(np.percentile([s["wall_s"] for s in rec["steps"]], 90)) * 1e3
