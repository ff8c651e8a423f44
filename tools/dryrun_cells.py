#!/usr/bin/env python3
"""The production dry-run cells on fake cuda tensors from one or more
source trees, and K1 at one rank's head runs, on one NVIDIA GPU:

    python3 tools/dryrun_cells.py [--k1-local] TREE [TREE ...]

Each TREE is the root of a checkout of this repository (for example the
parent commit unpacked with ``git archive`` beside this one).  For each
tree in the order given, a fresh process per cell imports that tree's
``repro_torch`` and runs ``launch.dryrun.run_cell`` on qwen2_7b,
mamba2_780m, whisper_large_v3 and zamba2_1_2b x train_4k x single (16 x
16, the default rules, ``device="cuda"``: a fake process group, nothing
allocated), printing one JSON line a cell with its wall time, memory
record, flops and bytes per chip, collective bytes and departures.  With
``--k1-local`` it first builds this checkout's kernels and runs
``chip_smoke.phase_kernel_local`` (K1 both ways at
``chip_smoke.local_head_cases``: two bit-equal launches a case against the
plain version, timed beside SDPA and the bound).  Prints the card's name
and power limit first.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("qwen2_7b", "mamba2_780m", "whisper_large_v3", "zamba2_1_2b")

_CELL = r'''
import json, sys, time
from repro_torch.launch import dryrun
arch = sys.argv[1]
t0 = time.perf_counter()
rec = dryrun.run_cell(arch, "train_4k", False, "none", None, verbose=False,
                      device="cuda", device_kind="h100_sxm")
r = rec["roofline"]
print("CELL " + json.dumps({
    "arch": arch, "wall_s": time.perf_counter() - t0,
    "device": rec["device"], **rec["memory"],
    "flops_per_chip": r["flops_per_chip"],
    "bytes_per_chip": r["bytes_per_chip"], "collectives": r["collectives"],
    "wire_bytes_per_chip": r.get("wire_bytes_per_chip"),
    "departures": rec["departures"]}), flush=True)
'''


def cells(tree: str) -> None:
    """Every cell of ARCHS from ``tree``, one process each."""
    tree = os.path.abspath(tree)
    for arch in ARCHS:
        env = dict(os.environ, PYTHONPATH=os.path.join(tree, "src"))
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-c", _CELL, arch], env=env,
                           cwd=tree, capture_output=True, text=True,
                           timeout=900)
        line = [ln for ln in p.stdout.splitlines() if ln.startswith("CELL ")]
        print(json.dumps({"tree": tree, "arch": arch, "rc": p.returncode,
                          "proc_s": time.perf_counter() - t0,
                          "rec": json.loads(line[0][5:]) if line else None,
                          "err": p.stderr[-1500:] if p.returncode else ""}),
              flush=True)


def k1_local() -> None:
    import torch
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import chip_smoke as c
    from repro_torch.kernels import _build
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    t0 = time.perf_counter()
    _build.build()
    print("build_s", time.perf_counter() - t0, flush=True)
    t0 = time.perf_counter()
    out = c.phase_kernel_local(dev)
    print("local_s", time.perf_counter() - t0, "launches", out["launches"],
          flush=True)


def main(argv) -> int:
    sys.path.insert(0, ROOT)
    from chip_smoke import nvidia_smi_line
    print(nvidia_smi_line(), flush=True)
    if argv[:1] == ["--k1-local"]:
        argv = argv[1:]
        k1_local()
    for tree in argv:
        cells(tree)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
