"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It needs an NVIDIA card (``torch.cuda``):
without one, or with fewer cards than the cell asks for, it exits with 2
and prints no result.  The last line of standard output is the result
object; the numbers compared with the reference, each beside its limit,
are the last lines of standard error.  ``portbench.harness`` says what a
run does.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    from portbench import harness

    entry = harness.cell_files(args.workload)[0]
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: cell {args.workload} needs {entry['chips']} "
              f"CUDA card(s); torch.cuda sees {seen}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), device, T_START)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
