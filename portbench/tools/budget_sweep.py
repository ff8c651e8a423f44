"""The one-off sweep that freezes a Chameleon cell's HBM budget.

    python3 -m portbench.tools.budget_sweep --workload <cell> [--seed N]

On the traffic's longest bucket: a trainer of the cell with Chameleon on
and no budget to meet runs two steps; its runtime's detailed profile of
the grad dispatch, priced at the second step's grad time as the runtime
prices it, gives the floor (every swap candidate absent for its whole
life) and the peak; the lowest budget a policy meets is bisected between
them (``generate_policy`` returns and its projected peak is at or under
the budget), and ``MARGIN`` is added.  Prints one JSON line: the floor,
the peak, the tightest budget, the budget with the margin, and every
budget tried.  The result is written into the traffic file by hand; no
run of the benchmark searches.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

MARGIN = 1.01
ROUNDS = 10


def timeline_floor(prof) -> int:
    """The profile's peak with every candidate absent for its whole life."""
    import numpy as np
    n = prof.n_ops
    delta = np.zeros(n + 2, np.int64)
    for t in prof.tensors:
        if t.site is None:
            b = min(max(t.birth, 0), n)
            delta[b] += t.nbytes
            delta[min(max(t.death, b), n + 1)] -= t.nbytes
    return int(np.cumsum(delta)[: n + 1].max(initial=0)) + prof.static_bytes


def plan(prof, budget: int):
    from repro_torch.common.config import ChameleonConfig
    from repro_torch.core.policy import ChameleonOOMError, generate_policy
    try:
        return generate_policy(prof, ChameleonConfig(), budget)
    except ChameleonOOMError:
        return None


def sweep(name: str, seed: int, device) -> dict:
    from repro_torch.core.memtrace import build_timeline
    from portbench import harness

    _, cfgj, traffic, _ = harness.cell_files(name)
    longest = max(traffic["buckets"])
    traffic = {**traffic, "buckets": [longest],
               "chameleon": {**traffic["chameleon"],
                             "hbm_budget_bytes": 1 << 62}}
    with tempfile.TemporaryDirectory(prefix="portbench_") as ckpt:
        run = harness.Run(cfgj, traffic, seed, device, ckpt)
        run.step()
        run.step()
        rt, rep = run.tr.rt, run.tr.report
        prof = rt._baseline_profile(rt._last_train_args, rep.grad_times[-1])
        tl = build_timeline(prof)
        floor, peak = timeline_floor(prof), int(tl.peak)
        lo, hi, tried = floor, peak, []
        for _ in range(ROUNDS):
            mid = (lo + hi) // 2
            pol = plan(prof, mid)
            ok = pol is not None and pol.projected_peak <= mid
            tried.append({"budget": mid, "met": ok,
                          "entries": len(pol.entries) if pol else None,
                          "projected_peak": (pol.projected_peak if pol
                                             else None)})
            lo, hi = (lo, mid) if ok else (mid, hi)
        harness.drop_trainer(run.tr)
    return {"workload": name, "seq": longest, "batch": traffic["batch"],
            "floor": floor, "peak": peak, "static_bytes": prof.static_bytes,
            "tightest": hi, "margin": MARGIN,
            "hbm_budget_bytes": int(hi * MARGIN), "tried": tried}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    t0 = time.perf_counter()
    out = sweep(args.workload, args.seed, torch.device(args.device))
    if args.device.startswith("cuda"):
        out["card"] = torch.cuda.get_device_name(0)
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
