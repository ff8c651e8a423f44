#!/usr/bin/env python3
"""Time each GenPolicy variant of the adaptation search (the planner's
host work that the async worker runs beside the training step):

    PYTHONPATH=src python3 tools/variant_times.py [--device cpu|cuda]
        [--layers 8] [--seq 128] [--turns 3]

Builds ``chip_smoke.py``'s Chameleon trainer on ``llama2-paper`` (the
reduced config on the CPU, full width on a card) at ``--layers`` layers,
profiles its grad dispatch as the runtime does, bisects the lowest budget
a policy meets (``chip_smoke.tightest_plan``) and takes the phases' margin
over it.  Then it runs ``AdaptationPipeline.variant`` for every knob of
``VARIANT_KNOBS`` ``--turns`` times and prints one JSON line per knob: the
fastest turn's ms, the entries of its policy (null for the conservative
fallback) and the profile's op count.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--turns", type=int, default=3)
    args = ap.parse_args(argv)
    import torch
    import chip_smoke as cs
    import repro_torch.configs as C
    from repro_torch.adapt.pipeline import VARIANT_KNOBS
    from repro_torch.common.config import ChameleonConfig
    from repro_torch.core.memtrace import build_timeline

    device = torch.device(args.device)
    if device.type == "cpu":
        torch.set_num_threads(1)
        cfg = C.get_reduced("llama2-paper")
    else:
        cfg = C.get_config("llama2-paper")
    cfg = cfg.replace(num_layers=args.layers, attn_impl="flash")
    tr = cs.exec_train(device, cfg, ChameleonConfig(
        enabled=True, hbm_budget_bytes=1 << 62), seq=args.seq)
    for _ in range(2):
        tr.train(1)
    prof = tr.rt._baseline_profile(tr.rt._last_train_args,
                                   tr.report.grad_times[-1])
    tl = build_timeline(prof)
    _, got, _ = cs.tightest_plan(prof, None, cs.timeline_floor(prof),
                                 tl.peak)
    budget = int(got["budget"] * cs.CHAM_EXEC_MARGIN)
    for knob in VARIANT_KNOBS:
        best, v = float("inf"), None
        for _ in range(args.turns):
            t0 = time.perf_counter()
            v = tr.rt.pipeline.variant(prof, knob, budget, tl=tl)
            best = min(best, time.perf_counter() - t0)
        print(json.dumps({"knob": knob, "ms": best * 1e3,
                          "entries": len(v.swap.entries) if v.swap else None,
                          "n_ops": prof.n_ops, "budget": budget,
                          "device": str(device)}), flush=True)
    cs.drop_trainer(tr)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
