#!/usr/bin/env python3
"""Keys per split of the flash-decode kernel (K3), measured on one NVIDIA GPU:

    python3 tools/k3_splits.py

At llama2-paper's decode shape as the serve phase meets it (q (4, 1, 32,
128), a (4, 1024, 32, 128) bf16 cache, the lens of its first decode tick),
launches the kernel with 64, 128 and 256 keys per split, checks each
against the plain version with ``chip_smoke.py``'s limits, and times each
warm (``chip_smoke.graph_ms``: 20 launches over one layer's cache, whose
valid rows fit in L2) and cold (``chip_smoke.decode_cold_ms``: one launch
per layer of a 32-layer cache), in turns (64, 128, 256, 256, 128, 64) so a
drift of the card's clock falls on all, beside SDPA with a length mask.
The copy route is the one the source builds (``cp.async``; see its header
note for why TMA was not built).  Prints the card's name and power limit and
one JSON line per split; exits non-zero if a check fails.
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke  # noqa: E402  (puts src/ on the path as well)

SPLITS = (64, 128, 256)
ORDER = SPLITS + SPLITS[::-1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k3_splits: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import repro_torch.configs as C
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ops

    device = torch.device("cuda", 0)
    print(chip_smoke.nvidia_smi_line(), flush=True)
    cfg = C.get_config("llama2-paper")
    B, Sk, H, Kh, D, lens, _ = chip_smoke.decode_cases(cfg)[-1]
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v = chip_smoke.k1_inputs(gen, B, 1, Sk, H, Kh, D, torch.bfloat16,
                                   device)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=device)
    ref = ops.flash_decode_plain(q, k, v, lens_t)
    sm = D ** -0.5

    def launch(t):
        def fn(q, k, v, n):
            out = torch.empty_like(q)
            K.flash_decode_fwd(q, k, v, out, n, sm_scale=sm, split=t)
            return out
        return fn

    rows, ok = {}, True
    for t in SPLITS:
        out = launch(t)(q, k, v, lens_t)
        torch.cuda.synchronize()
        chk = chip_smoke.k1_check(out, ref, "bfloat16")
        rows[t] = {"split": t, "route": "cp.async", "ok": chk["ok"],
                   "rel_fro": chk["rel_fro"], "warm_ms_all": [],
                   "blocks": Kh * B * -(-Sk // t),
                   "working_blocks": Kh * sum(-(-n // t) for n in lens)}
        ok = ok and chk["ok"]
    for t in ORDER:
        fn = launch(t)
        rows[t]["warm_ms_all"].append(
            chip_smoke.graph_ms(lambda: fn(q, k, v, lens_t)))
    cold = chip_smoke.decode_cold_ms(
        q, lens_t, Sk, Kh, chip_smoke.DECODE_COLD_LAYERS,
        fns={f"{t}_{i}": launch(t) for i, t in enumerate(ORDER)})
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = (torch.arange(Sk, device=device)[None, :]
            < lens_t[:, None])[:, None, None, :]
    sdpa_ms = chip_smoke.graph_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask))
    bound, by = chip_smoke.attention_bound(B, 1, Sk, H, Kh, D, False, lens,
                                           torch.bfloat16)
    for t, row in rows.items():
        row["cold_ms_all"] = [cold[f"{t}_{i}"] for i, s in enumerate(ORDER)
                              if s == t]
        row["warm_ms"] = min(row["warm_ms_all"])
        row["cold_ms"] = min(row["cold_ms_all"])
        row.update({"default": K.split_keys(B, Kh, Sk) == t,
                    "sdpa_ms": sdpa_ms,
                    "sdpa_cold_ms": cold["library_cold_ms"],
                    "bound_ms": bound, "bound_by": by,
                    "shape": [B, Sk, H, Kh, D], "lens": list(lens)})
        print(json.dumps(row), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
