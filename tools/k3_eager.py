#!/usr/bin/env python3
"""K3's eager call time from two source trees, in turns, on one NVIDIA GPU:

    python3 tools/k3_eager.py TREE_A TREE_B

Each TREE is the root of a checkout of this repository (for example the
parent commit unpacked with ``git archive`` beside this one).  In turns
A, B, B, A, A, B, B, A, a fresh process per turn imports that tree's
``repro_torch``, builds its kernels and times ``ops.flash_decode`` called
from Python, back
to back (``chip_smoke.cuda_ms``'s method: CUDA events over ITERS calls,
after WARMUP), at llama2-paper's decode shape (q (4, 1, 32, 128), a (4,
1024, 32, 128) bf16 cache, lens 750 / 660 / 791 / 120), REPS times, and
prints one JSON line with every rep and their median.  So the host's cost
of a wrapper change shows beside the parent's on the same card.  Prints
the card's name and power limit first.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ITERS, WARMUP, REPS = 200, 20, 7

_CHILD = r'''
import json, statistics, sys
sys.path.insert(0, sys.argv[1] + "/src")
import torch
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops
_build.build()
dev = torch.device("cuda", 0)
g = torch.Generator(device=dev).manual_seed(0)
q = torch.randn(4, 1, 32, 128, generator=g, device=dev).to(torch.bfloat16)
k = torch.randn(4, 1024, 32, 128, generator=g, device=dev).to(torch.bfloat16)
v = torch.randn(4, 1024, 32, 128, generator=g, device=dev).to(torch.bfloat16)
lens = torch.tensor([750, 660, 791, 120], dtype=torch.int32, device=dev)
with torch.no_grad():
    reps = []
    for _ in range(int(sys.argv[4])):
        for _ in range(int(sys.argv[3])):
            ops.flash_decode(q, k, v, lens)
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        s.record()
        for _ in range(int(sys.argv[2])):
            ops.flash_decode(q, k, v, lens)
        e.record()
        e.synchronize()
        reps.append(s.elapsed_time(e) / int(sys.argv[2]))
print(json.dumps({"eager_ms": reps, "median_ms": statistics.median(reps)}))
'''


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    trees = [os.path.abspath(t) for t in argv]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    a, b = trees
    for turn, tree in enumerate((a, b, b, a) * 2):
        out = subprocess.run(
            [sys.executable, "-c", _CHILD, tree, str(ITERS), str(WARMUP),
             str(REPS)], capture_output=True, text=True, timeout=600)
        if out.returncode:
            print(out.stderr[-3000:], file=sys.stderr)
            return 1
        row = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"turn": turn, "tree": tree, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
