"""The comparison that decides ``correct``.

Both sides give the same readings of the steps the reference follows:
``losses`` (each of the first three steps' loss), ``grad`` (every leaf's
norm of the first step's gradient as the optimizer gets it, after
clipping) and ``change`` (every leaf's norm of its change after three
steps).  A cell whose window runs what the first three steps do not (a
longer bucket, a swap policy) adds ``late``, one step of set-up that runs
it, which the reference reaches by following every step from the seed's
weights: its ``loss``, every leaf's ``grad`` and every leaf's ``change``
from the seed's weights after its update.  The numbers compared:

  * ``loss``: the largest relative gap of a step's loss;
  * ``grad`` / ``change`` / ``late_grad`` / ``late_change``: the worst
    leaf's gap between the program's norm and the reference's, over the
    larger of the reference's norm of that leaf and of the median leaf;
  * ``late_loss``: the late step's relative loss gap;
  * ``late_grad_median``: the median leaf's gap of the late step's
    gradient (its worst leaf, ``late_grad``, is one small leaf's rounding
    and swings from seed to seed);
  * ``route_gap`` (an expert model): the reference follows the experts the
    program's routers chose, and this is the widest gap by which a chosen
    expert's router logit lies below the reference's own K-th largest (0
    where every choice is in the reference's top K; None where the
    program's choices were not one a token and layer).

``change`` and ``late_change`` leave out the leaves whose reference
gradient in the first step is under a thousandth of the median leaf's:
their gradient is zero but for rounding (a key's bias under softmax), and
AdamW moves them by the rounding alone.
"""
from __future__ import annotations

import statistics
from typing import Dict, Mapping, Optional, Tuple

QUIET = 1e-3


def leaf_gaps(got: Mapping[str, float], want: Mapping[str, float],
              skip=frozenset()) -> Dict[str, float]:
    """Every leaf's gap: |got - want| over the larger of want and the
    median leaf's want."""
    names = [n for n in want if n not in skip]
    med = statistics.median(want[n] for n in names)
    return {n: abs(got[n] - want[n]) / max(want[n], med, 1e-30)
            for n in names}


def worst_leaf(got: Mapping[str, float], want: Mapping[str, float],
               skip=frozenset()) -> Tuple[float, str]:
    """(the worst leaf's gap, its name)."""
    gaps = leaf_gaps(got, want, skip)
    name = max(gaps, key=gaps.get)
    return gaps[name], name


def quiet_leaves(ref_grad: Mapping[str, float]) -> frozenset:
    med = statistics.median(ref_grad.values())
    return frozenset(n for n, g in ref_grad.items() if g < QUIET * med)


def numbers(prog: Mapping, ref: Mapping) -> Dict[str, dict]:
    """Every number compared, with the leaf it was read at."""
    n = len(prog["losses"])
    out = {"loss": {"value": max(abs(a - b) / abs(b) for a, b in
                                 zip(prog["losses"], ref["losses"][:n]))}}
    g, leaf = worst_leaf(prog["grad"], ref["grad"])
    out["grad"] = {"value": g, "leaf": leaf}
    skip = quiet_leaves(ref["grad"])
    c, leaf = worst_leaf(prog["change"], ref["change"], skip)
    out["change"] = {"value": c, "leaf": leaf, "left_out": sorted(skip)}
    if "route_gap" in ref:
        out["route_gap"] = {"value": ref["route_gap"]}
    if prog.get("late") is not None:
        p, r = prog["late"], ref["late"]
        out["late_loss"] = {"value": abs(p["loss"] - r["loss"])
                            / abs(r["loss"])}
        g, leaf = worst_leaf(p["grad"], r["grad"])
        out["late_grad"] = {"value": g, "leaf": leaf}
        out["late_grad_median"] = {"value": statistics.median(
            leaf_gaps(p["grad"], r["grad"]).values())}
        c, leaf = worst_leaf(p["change"], r["change"], skip)
        out["late_change"] = {"value": c, "leaf": leaf}
    return out


def judge(nums: Mapping[str, dict], limits: Mapping[str, Optional[float]]
          ) -> Tuple[bool, Dict[str, dict]]:
    """(correct, the numbers with their limits).  A number whose limit is
    None is printed and not compared; a number the run did not read that
    has a limit makes the run not correct."""
    checks, ok = {}, True
    for name, limit in limits.items():
        got = nums.get(name)
        value = None if got is None else got["value"]
        checks[name] = {"value": value, "limit": limit}
        if limit is not None and (value is None or not value <= limit):
            ok = False
    return ok, checks
