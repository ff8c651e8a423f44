#!/usr/bin/env python3
"""Chameleon's projected stall against the measured copy stall (ROADMAP
P4) at two prices of the detailed profile, on one NVIDIA GPU:

    python3 tools/p4_prices.py [grad,dt] [exec] [async] [--out DIR]

Runs ``chip_smoke.py``'s ``chameleon_exec`` and ``chameleon_async`` phases
alone (both by default), once per price, in the order given:

* ``grad``: the profile priced at the grad dispatch's own time less its
  measured copy stall, as the trainer hands it to the runtime;
* ``dt``: the reference's price, the whole iteration's time
  (``ChameleonRuntime.end_iteration`` given no grad time, and the phase's
  budget bisected on the profile priced the same way).

Each phase's JSON lines go to ``DIR/p4_<price>_<phase>.jsonl`` (default
``build/p4``); the card's name and power limit, each phase's seconds and
problems, and its P4 readings (``chameleon_exec_p4``, the ``p4`` of each
placement and bucket) are printed.  A phase whose gate fails is reported,
not raised, so both prices always run.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRINTED = ("chameleon_exec_budget", "chameleon_async_budget",
           "chameleon_exec_p4")
SUMMARY = ("problems", "p4", "stable_ms", "off_stable_ms", "worst_ratio",
           "stable_p50_on", "stable_p50_off")


def main(argv) -> int:
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    import chip_smoke as cs
    from repro_torch.core.runtime import ChameleonRuntime
    from repro_torch.kernels import _build
    from repro_torch.runtime.trainer import Trainer

    out = os.path.join(ROOT, "build", "p4")
    if "--out" in argv:
        i = argv.index("--out")
        out = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    prices = (argv[0] if argv else "grad,dt").split(",")
    phases = argv[1:] or ["exec", "async"]
    if not torch.cuda.is_available():
        print("p4_prices: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi_line(), torch.__version__, flush=True)
    _build.build()
    torch.zeros(1, device=device)
    os.makedirs(out, exist_ok=True)
    end_iteration, one_step = ChameleonRuntime.end_iteration, \
        Trainer._one_step

    def end_at_dt(self, t_iter, t_grad=None):
        return end_iteration(self, t_iter)

    def step_at_dt(self, *a, **k):
        one_step(self, *a, **k)
        # the phases' budgets bisect on the profile at report.grad_times
        self.report.grad_times[-1] = self.report.times[-1]

    for price in prices:
        ChameleonRuntime.end_iteration, Trainer._one_step = (
            (end_at_dt, step_at_dt) if price == "dt"
            else (end_iteration, one_step))
        for ph in phases:
            buf = io.StringIO()
            t0 = time.time()
            try:
                with contextlib.redirect_stdout(buf):
                    (cs.phase_chameleon_exec if ph == "exec"
                     else cs.phase_chameleon_async)(device)
                res = "ok"
            except AssertionError as e:
                res = f"failed: {e}"
            with open(os.path.join(out, f"p4_{price}_{ph}.jsonl"), "w") as f:
                f.write(buf.getvalue())
            print(price, ph, round(time.time() - t0, 1), res, flush=True)
            for ln in buf.getvalue().splitlines():
                if not ln.startswith("{"):
                    continue
                d = json.loads(ln)
                if d["phase"] in PRINTED:
                    d.pop("tried", None)
                    print(json.dumps(d), flush=True)
                elif d["phase"] in ("chameleon_exec", "chameleon_async"):
                    print(json.dumps({k: d.get(k) for k in SUMMARY}),
                          flush=True)
    ChameleonRuntime.end_iteration, Trainer._one_step = end_iteration, \
        one_step
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
