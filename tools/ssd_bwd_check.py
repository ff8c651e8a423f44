#!/usr/bin/env python3
"""K4's backward alone on one NVIDIA GPU: build report, check, timing.

    python3 tools/ssd_bwd_check.py [--rows-only]

Builds K4's forward and backward (``ssd_scan_fwd``, ``ssd_scan_bwd``),
prints the ptxas report of the backward's kernels (registers, shared
memory, spills), then holds the backward against ``ssd_scan_bwd_plain`` on
every case of ``chip_smoke.SSD_BWD_CASES`` (``chip_smoke.ssd_bwd_rows``:
each launched twice and bit-compared, and the forward that saved its
states against ``ssd_scan_plain``), printing one JSON line a case and
going on past a failure.  When every case passes and ``--rows-only`` is
not given, it times the train shapes as ``chip_smoke.py``'s phase
``ssd_bwd_kernel`` does (warm, cold, by pass, plain, bound).  Exits
non-zero if a case fails.  About a minute.
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke  # noqa: E402  (puts src/ on the path as well)


def main(argv=None) -> int:
    import torch
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("ssd_bwd_check: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    print(chip_smoke.nvidia_smi_line(), flush=True)
    paths = _build.build(["ssd_scan_fwd", "ssd_scan_bwd"])
    log = paths["ssd_scan_bwd"].with_suffix(".log").read_text().splitlines()
    chip_smoke.emit("ptxas", lines=[ln.strip() for ln in log if any(
        k in ln for k in ("entry function", "registers", "spill", "smem",
                          "warning", "C75"))])
    failed = []
    for row, fwd, _ in chip_smoke.ssd_bwd_rows(device, chip_smoke.SSD_BWD_CASES):
        chip_smoke.emit("ssd_bwd_row", **row)
        if not (row["ok"] and row["bit_equal"] and fwd["ok"]):
            failed.append([row["shape"], row["chunk"], row["dtype"]])
            chip_smoke.emit("ssd_bwd_fwd_row", **fwd)
    if failed:
        print(json.dumps({"failed": failed}), flush=True)
        return 1
    if "--rows-only" not in argv:
        timed = [c for c in chip_smoke.SSD_BWD_CASES if c[-1]]
        for row in chip_smoke.phase_ssd_bwd_kernel(device, timed):
            chip_smoke.emit("ssd_bwd_time", **{k: row[k] for k in (
                "arch", "shape", "ms", "cold_ms", "plain_ms", "bound_ms",
                "bound_by", "pass_ms", "dx_rel_fro", "dB_rel_fro",
                "dC_rel_fro")})
    return 0


if __name__ == "__main__":
    sys.exit(main())
