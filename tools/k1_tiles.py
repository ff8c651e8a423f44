#!/usr/bin/env python3
"""Query rows per block of the bf16 flash-attention kernel (K1), measured on
one NVIDIA GPU:

    python3 tools/k1_tiles.py

At llama2-paper's causal bf16 prefill shapes (B 1, H = Kh = 32, D 128) for
each length of ``chip_smoke.TIMED_LENS``, launches the kernel with one
consumer warpgroup per block (64 query rows) and with two (128 rows), checks
each against the plain version with ``chip_smoke.py``'s limits, and times
both beside SDPA with CUDA graphs, in turns (1, 2, SDPA, SDPA, 2, 1), so a
drift of the card's clock falls on both.  Prints one JSON line per length
and the card's name and power limit; exits non-zero if a check fails.
"""
from __future__ import annotations

import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke  # noqa: E402  (puts src/ on the path as well)


def main() -> int:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("k1_tiles: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import repro_torch.configs as C
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ops

    device = torch.device("cuda", 0)
    print(chip_smoke.nvidia_smi_line(), flush=True)
    lib = _build.load("flash_attention_fwd")
    launch = K.bind(lib)          # flash_attention_fwd_wgs
    cfg = C.get_config("llama2-paper")
    H, Kh, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    gen = torch.Generator(device=device).manual_seed(0)
    ok = True
    for S in chip_smoke.TIMED_LENS:
        q, k, v = chip_smoke.k1_inputs(gen, 1, S, S, H, Kh, D, torch.bfloat16,
                                       device)
        ref = ops.flash_attention_plain(q, k, v, causal=True)
        sm = 1.0 / math.sqrt(D)

        def run(wgs):
            out = torch.empty_like(q)

            def fn():
                _build.check(lib, launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    None, None, 1, H, Kh, S, S, D, 1, sm, 1, wgs,
                    torch.cuda.current_stream(device).cuda_stream),
                    "flash_attention_fwd_wgs")
            return fn, out

        row = {"shape": [1, S, S, H, Kh, D], "dtype": "bfloat16"}
        fns = {}
        for wgs in (1, 2):
            fn, out = run(wgs)
            fn()
            torch.cuda.synchronize()
            chk = chip_smoke.k1_check(out, ref, "bfloat16")
            row[f"wgs{wgs}_ok"] = chk["ok"]
            row[f"wgs{wgs}_rel_fro"] = chk["rel_fro"]
            ok = ok and chk["ok"]
            fns[wgs] = fn
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        fns["sdpa"] = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=sm)
        times = {key: [] for key in fns}
        for key in (1, 2, "sdpa", "sdpa", 2, 1):
            times[key].append(chip_smoke.graph_ms(fns[key]))
        for key, ts in times.items():
            name = f"wgs{key}_ms" if key != "sdpa" else "sdpa_ms"
            row[name] = min(ts)
            row[name + "_all"] = ts
        print(json.dumps(row), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
