#!/usr/bin/env python3
"""Device time of each pass of the bf16 SSD scan (K4), on one NVIDIA GPU:

    python3 tools/ssd_passes.py

At mamba2-780m's widths (x (1, S, 48, 64), N 128, chunk 256, bf16; the
inputs of ``chip_smoke.ssd_inputs``) for each length of
``chip_smoke.SSD_LENS``, runs ``ssd_scan`` 20 times under torch.profiler
and prints, per length, one JSON line with the mean device time of each
kernel it launched (``ssd_scan_chunk``, ``ssd_scan_state``,
``ssd_scan_output``), their sum, and the card's name and power limit.
"""
from __future__ import annotations

import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke  # noqa: E402  (puts src/ on the path as well)

CALLS = 20


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("ssd_passes: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import repro_torch.configs as C
    from repro_torch.kernels.ssd_scan import ops as SSD

    device = torch.device("cuda", 0)
    smi = chip_smoke.nvidia_smi_line()
    cfg = C.get_config("mamba2-780m")
    gen = torch.Generator(device=device).manual_seed(0)
    for S in chip_smoke.SSD_LENS:
        ins = chip_smoke.ssd_inputs(gen, 1, S, cfg.ssm_heads, cfg.ssm_head_dim,
                                    cfg.ssm_state, torch.bfloat16, device)
        for _ in range(3):
            SSD.ssd_scan(*ins, chunk=cfg.ssm_chunk)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                SSD.ssd_scan(*ins, chunk=cfg.ssm_chunk)
            torch.cuda.synchronize()
        passes = {re.search(r"ssd_scan_\w+", e.key).group(0):
                  e.self_device_time_total / 1e3 / CALLS
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and "ssd_scan" in e.key}
        print(json.dumps({"shape": [1, S, cfg.ssm_heads, cfg.ssm_head_dim,
                                    cfg.ssm_state],
                          "chunk": cfg.ssm_chunk, "dtype": "bfloat16",
                          "pass_ms": passes, "sum_ms": sum(passes.values()),
                          "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
