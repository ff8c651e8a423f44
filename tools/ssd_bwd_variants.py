#!/usr/bin/env python3
"""Ablations of K4 backward's bf16 passes, timed on one NVIDIA GPU:

    python3 tools/ssd_bwd_variants.py [--rounds=N] [name ...]

Builds each entry of ``VARIANTS`` (edits to a copy of
``csrc/ssd_scan_bwd.cu`` under ``build/ssd_bwd_variants/``, compiled with
the shared include path; ``a+b`` applies both) and the unchanged kernel,
then times them in turns (control first, the order reversed in every
second round) at mamba2-780m's and zamba2-1.2b's train shapes (the first
two cases of ``chip_smoke.SSD_BWD_CASES``): the whole backward in a CUDA
graph (``chip_smoke.graph_ms``) and each pass by torch.profiler.  Each
ablation removes a part of the work to show what it costs; its results
are wrong on purpose and are not checked.  Prints one JSON line per
(variant, shape, round).
"""
from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402

SOURCE = (ROOT / "src" / "repro_torch" / "kernels" / "ssd_scan" / "csrc"
          / "ssd_scan_bwd.cu")

VARIANTS = {
    # intra-chunk pass: dx += M^T dy (both halves of M), or its lo half
    "intra_no_dx": [(
        "#pragma unroll\n"
        "      for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64(dxa, mh[kk], mndesc<64, 64>(yt, kk));\n"
        "#pragma unroll\n"
        "      for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64(dxa, ml[kk], mndesc<64, 64>(yt, kk));\n",
        "")],
    "intra_no_dx_lo": [(
        "#pragma unroll\n"
        "      for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64(dxa, ml[kk], mndesc<64, 64>(yt, kk));\n",
        "")],
    # dM^T = x dy^T
    "intra_no_dm": [(
        "      for (int kk = 0; kk < 4; ++kk)\n"
        "        wgmma_ss_n64(dm, kdesc<64, 64>(sX, kk), kdesc<64, 64>(yt, kk), kk > 0);\n",
        "      for (int kk = 0; kk < 32; ++kk)\n        dm[kk] = 0.f;\n")],
    # the exps of L
    "intra_no_exp": [(
        "fast_exp2(keep ? (((e & 1) ? ci.y : ci.x) - csj[r]) * LOG2E : -INFINITY);",
        "(keep ? 1.f : 0.f);")],
    # dG's read-modify-write in shared memory
    "intra_no_dg": [(
        "          dgk[k * WG + tid] = fmaf(dm[k] * Lv, dtj[r], dgk[k * WG + tid]);\n",
        "")],
    # T's column sums, the barrier and the row sums' stores
    "intra_no_rows": [(
        "      consumer_sync();\n      if (tid < TT && i0 + tid < cl) {",
        "      if (false) {")],
    # the block's set-up: G^T's tiles from the saved CB
    "intra_no_g_load": [(
        "    sG[k * 4096 + r * 128 + t] = i < cl && j <= i ? cb[(int64_t)i * chunk + j] : 0.f;\n",
        "    sG[k * 4096 + r * 128 + t] = i < cl && j <= i ? 1.f : 0.f;\n")],
    # U = B_j D^T a head
    "intra_no_u": [(
        "#pragma unroll\n"
        "    for (int kk = 0; kk < NP / 16; ++kk)\n"
        "      wgmma_ss_n64(u, kdesc<NP, 64>(sB, kk), kdesc<NP, 64>(base + L.dh(), kk), kk > 0);\n"
        "#pragma unroll\n"
        "    for (int kk = 0; kk < NP / 16; ++kk)\n"
        "      wgmma_ss_n64(u, kdesc<NP, 64>(sB, kk), kdesc<NP, 64>(base + L.dl(), kk), 1);\n",
        "#pragma unroll\n    for (int k = 0; k < 32; ++k) u[k] = 0.f;\n")],
    # the producer's D split a head
    "intra_no_d_stage": [(
        "      dr.store(base + L.dh(), base + L.dl(), p);\n", "")],
    # dB / dC: the consumer's products, the B lo chain, two producers at N 128
    "dbc_no_mma": [(
        "#pragma unroll\n"
        "    for (int kk = 0; kk < 4; ++kk) wgmma_pv<NP>(acc, fh[kk], mndesc<NP, 64>(st, kk));\n"
        "#pragma unroll\n"
        "    for (int kk = 0; kk < 4; ++kk)\n"
        "      wgmma_pv<NP>(acc, fh[kk], mndesc<NP, 64>(st + L::B_BYTES, kk));\n"
        "#pragma unroll\n"
        "    for (int kk = 0; kk < 4; ++kk) wgmma_pv<NP>(acc, fl[kk], mndesc<NP, 64>(st, kk));\n",
        "")],
    "dbc_no_blo": [(
        "#pragma unroll\n"
        "    for (int kk = 0; kk < 4; ++kk)\n"
        "      wgmma_pv<NP>(acc, fh[kk], mndesc<NP, 64>(st + L::B_BYTES, kk));\n",
        "")],
    "dbc_two_producers": [(
        "{ return NP > 64 ? 1 : 2; }", "{ return 2; }")],
    # dB / dC: the producer's split stores of S_0 / D
    "dbc_no_b_stage": [("        br.store(bh, bl, p);\n", "")],
    # every f32 tile staged without its hi / lo split (the bits as they
    # are): what the split's arithmetic costs the passes that stage D or S_0
    "no_split_arith": [(
        "      split(a[u][0].x, a[u][0].y, h.x, l.x);\n"
        "      split(a[u][0].z, a[u][0].w, h.y, l.y);\n"
        "      split(a[u][1].x, a[u][1].y, h.z, l.z);\n"
        "      split(a[u][1].z, a[u][1].w, h.w, l.w);\n",
        "      h = make_uint4(__float_as_uint(a[u][0].x), __float_as_uint(a[u][0].y),\n"
        "                     __float_as_uint(a[u][0].z), __float_as_uint(a[u][0].w));\n"
        "      l = make_uint4(__float_as_uint(a[u][1].x), __float_as_uint(a[u][1].y),\n"
        "                     __float_as_uint(a[u][1].z), __float_as_uint(a[u][1].w));\n")],
    # dB / dC: the producer's weighted, split A rows of a head item
    "dbc_no_a_stage": [(
        "          *reinterpret_cast<uint4*>(ah + m * LDA + col + 8 * k) = hv;\n"
        "          *reinterpret_cast<uint4*>(al + m * LDA + col + 8 * k) = lv;\n",
        "")],
    # Q pass: V = C S_0^T
    "q_no_v": [(
        "#pragma unroll\n"
        "    for (int kk = 0; kk < NP / 16; ++kk)\n"
        "      wgmma_ss_n64(v, kdesc<NP, 64>(sC, kk), kdesc<NP, 64>(sS0h, kk), kk > 0);\n"
        "#pragma unroll\n"
        "    for (int kk = 0; kk < NP / 16; ++kk)\n"
        "      wgmma_ss_n64(v, kdesc<NP, 64>(sC, kk), kdesc<NP, 64>(sS0l, kk), 1);\n",
        "")],
}


def edits_of(name: str):
    return [e for part in name.split("+") for e in VARIANTS[part]]


def edited(edits) -> str:
    text = SOURCE.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{old[:60]!r} is not in {SOURCE.name} exactly once")
        text = text.replace(old, new)
    return text


def write_variants(out_dir: Path, names):
    """name -> (source, library) of each variant's copy."""
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        cu = out_dir / f"{name.replace('+', '__')}.cu"
        cu.write_text(edited(edits_of(name)))
        jobs[name] = (cu, cu.with_suffix(".so"))
    return jobs


def main(names, rounds: int = 2) -> int:
    import torch
    if not torch.cuda.is_available():
        print("ssd_bwd_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan import kernel as SK
    from repro_torch.kernels.ssd_scan import ops as SSD

    device = torch.device("cuda", 0)
    print(chip_smoke.nvidia_smi_line(), flush=True)
    control = _build.build(["ssd_scan_fwd", "ssd_scan_bwd"])["ssd_scan_bwd"]
    jobs = write_variants(_build.BUILD_DIR.parent / "ssd_bwd_variants", names)
    _build.compile_all(jobs)
    libs = {"control": control, **{n: lib for n, (_, lib) in jobs.items()}}

    def use(path):
        lib = ctypes.CDLL(str(path))
        SK._bwd_lib = lib
        SK._bwd_fn, SK._work_fn = SK.bind_bwd(lib)

    gen = torch.Generator(device=device).manual_seed(5)
    shapes = []
    for arch, B, S, H, P, N, chunk, dname, _ in chip_smoke.SSD_BWD_CASES[:2]:
        ins = chip_smoke.ssd_inputs(gen, B, S, H, P, N, torch.bfloat16, device)
        dy = torch.randn(B, S, H, P, generator=gen, device=device).bfloat16()
        dst = torch.randn(B, H, P, N, generator=gen, device=device)
        saved = SSD.ssd_scan_saved(*ins, chunk=chunk)[2]
        shapes.append((arch, ins, dy, dst, saved, chunk))
    order = list(libs)
    for rnd in range(rounds):
        for name in (order if rnd % 2 == 0 else order[::-1]):
            use(libs[name])
            for arch, ins, dy, dst, saved, chunk in shapes:
                def fn():
                    return SSD.ssd_scan_bwd(*ins, dy, dst, saved=saved, chunk=chunk)
                print(json.dumps({
                    "variant": name, "arch": arch, "round": rnd,
                    "ms": chip_smoke.graph_ms(fn, iters=5),
                    "pass_ms": chip_smoke.device_kernel_ms(fn, "ssd_bwd")}),
                    flush=True)
    SK._bwd_lib = SK._bwd_fn = SK._work_fn = None
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    rounds = next((int(a.split("=")[1]) for a in args
                   if a.startswith("--rounds=")), 2)
    names = [a for a in args if not a.startswith("--")] or list(VARIANTS)
    sys.exit(main(names, rounds))
