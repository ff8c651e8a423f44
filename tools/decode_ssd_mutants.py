#!/usr/bin/env python3
"""Mutation check of ``chip_smoke.py``'s flash-decode (K3), SSD-scan (K4),
K4-backward and int8 quantize (K2a) checks, on one NVIDIA GPU:

    python3 tools/decode_ssd_mutants.py

Plants each fault of ``MUTANTS`` in its own copy of the kernel's source
(``src/repro_torch/kernels/flash_attention/csrc/flash_decode_fwd.cu``,
``src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_fwd.cu``,
``src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_bwd.cu`` or
``src/repro_torch/kernels/quant_offload/csrc/quant_offload.cu``) under
``build/mutants/``, builds the copies (one ``nvcc`` each, all at once), and
runs every copy, and each unchanged kernel as a control, through
``chip_smoke.py``'s own check of that kernel: ``decode_rows`` over K3's
cases (peaked q and k, a random cache past lens, both dtypes, split
boundaries), ``ssd_rows`` over K4's mamba2-780m prefill lengths (both
dtypes), ``ssd_bwd_rows`` over K4 backward's cases (``SSD_BWD_CASES``: the
train shapes, ragged chunks, f32; within ``SSD_BWD_TOL`` and bit-equal over
two launches) and ``quant_rows`` over K2a/K2b's shapes and the KV spill's
slot row (bit for bit).  Every run starts from the unchanged libraries,
with only the one under test replaced.  A mutant is caught when at least
one case fails the check.  Prints one JSON line per kernel and exits
non-zero if a mutant is missed or a control fails.
"""
from __future__ import annotations

import ctypes
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke  # noqa: E402  (puts src/ on the path as well)

# name -> (library, text of the kernel, the text that replaces it)
MUTANTS = {
    # K3 reads one row past lens[b]
    "decode_reads_past_lens": (
        "flash_decode_fwd",
        "return min(max(lens[b], 0), Sk);",
        "return min(max(lens[b], 0) + 1, Sk);"),
    # K3 does not rescale l and acc when the running max rises
    "decode_no_alpha": (
        "flash_decode_fwd",
        "const float alpha = expf(m[g] - mx);",
        "const float alpha = 1.f;"),
    # K3's combine drops the last split that has keys (when there are two
    # or more)
    "decode_combine_drops_last_split": (
        "flash_decode_fwd",
        "const bool in = s0 + j < ns;",
        "const bool in = s0 + j < ns - (ns > 1);"),
    # K3's splits start one key late: key 0 is read by no split
    "decode_split_off_by_one": (
        "flash_decode_fwd",
        "const int k0 = split * Tk;",
        "const int k0 = split * Tk + 1;"),
    # K3's combine adds the splits without rescaling them to their max
    "decode_combine_no_rescale": (
        "flash_decode_fwd",
        "const float f = expf(mv[j] - mx);",
        "const float f = 1.f;"),
    # K2a's absmax skips the last shuffle step: lanes of a row disagree
    "quant_absmax_short_shuffle": (
        "quant_offload",
        "for (int off = lpr >> 1; off > 0; off >>= 1)",
        "for (int off = lpr >> 1; off > 1; off >>= 1)"),
    # K2a's vector path drops its tie check: x * rn(1 / scale) alone is an
    # ulp off the IEEE quotient in some elements, so a few near-ties round
    # the other way
    "quant_no_tie_check": (
        "quant_offload",
        "if (fabsf(fabsf(t - r) - 0.5f) <= 6.103515625e-5f) r = rintf(f[e] / scale);",
        ""),
    # K4 drops the carried state's contribution to y
    "ssd_no_inter_chunk": (
        "ssd_scan_fwd",
        "if (c > 0) {                            // the state carried into this chunk",
        "if (c < 0) {"),
    # K4 masks with i > j: the diagonal term is lost
    "ssd_strict_mask": (
        "ssd_scan_fwd",
        "const float arg = j <= i ? sCsI[r] - sCsJ[col + u] : -INFINITY;",
        "const float arg = j < i ? sCsI[r] - sCsJ[col + u] : -INFINITY;"),
    # K4 carries the state without the chunks' decay exp(cs_last)
    "ssd_no_state_decay": (
        "ssd_scan_fwd",
        "const float decay = expf(cs[bch * chunk + chunk - 1]);",
        "const float decay = 1.f;"),
    # K4's state recurrence skips the decay of one chunk (the second)
    "ssd_skip_one_decay": (
        "ssd_scan_fwd",
        "const float decay = expf(",
        "const float decay = c == 1 ? 1.f : expf("),
    # K4 drops the lo half of the split weighted-x operand of the state
    # update: one bf16 rounding, ~1.5e-3 relative (SSD_STATE_TOL is 1e-4)
    "ssd_state_lo_dropped": (
        "ssd_scan_fwd",
        "        mma_bf16(acc[nt], xw_lo, b0, b1);\n",
        ""),
    # K4 backward's dB / dC drop the last head group's dG partial
    "ssd_bwd_group_dropped": (
        "ssd_scan_bwd",
        "for (int gi = 0; gi < G; ++gi) {",
        "for (int gi = 0; gi < G - 1; ++gi) {"),
    # K4 backward's causal select loses the diagonal (j < i)
    "ssd_bwd_causal_off_by_one": (
        "ssd_scan_bwd",
        "const bool keep = i < cl && j <= i;",
        "const bool keep = i < cl && j < i;"),
    # K4 backward's dC leaves out the carried state's term
    "ssd_bwd_dc_no_s0": (
        "ssd_scan_bwd",
        "wt = expf(cst);",
        "wt = 0.f;"),
    # K4 backward loses the last token's extra dcs (exp(cs_last) <D, S_0>
    # and the key tile's sum of w_j x_j . U_j)
    "ssd_bwd_no_last_token_term": (
        "ssd_scan_bwd",
        "if (i0 + tid == cl - 1) v += ext;",
        "if (i0 + tid == cl) v += ext;"),
    # K4 backward drops a ragged chunk's partial row tile (the row tiles
    # rounded down): its rows get no intra-chunk terms
    "ssd_bwd_ragged_tile_dropped": (
        "ssd_scan_bwd",
        "const int nit = (cl + TT - 1) / TT, nt = nit - jt;",
        "const int nit = cl / TT, nt = nit - jt;"),
    # K4 backward's state cotangent skips the chunks' decay exp(cs_last)
    "ssd_bwd_no_state_decay": (
        "ssd_scan_bwd",
        "const float g = expf(lastv[k]);",
        "const float g = 1.f;"),
}


def build_mutants():
    from repro_torch.kernels import _build
    out_dir = _build.BUILD_DIR.parent / "mutants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, (lib, old, new) in MUTANTS.items():
        src = _build.SOURCES[lib]
        text = src.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"mutant {name}: {old!r} is not in {src} "
                               "exactly once")
        cu = out_dir / f"{name}.cu"
        cu.write_text(text.replace(old, new))
        jobs[name] = (cu, out_dir / f"{name}.so")
    _build.compile_all(jobs)
    return {name: (MUTANTS[name][0], lib) for name, (_, lib) in jobs.items()}


def install(lib_name: str, path) -> None:
    """Make the wrappers launch the library at ``path``."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.quant_offload import kernel as QK
    from repro_torch.kernels.ssd_scan import kernel as SK
    lib = ctypes.CDLL(str(path))
    if lib_name == "flash_decode_fwd":
        FK._decode_lib, FK._decode_fn = lib, FK.bind_decode(lib)
    elif lib_name == "quant_offload":
        QK._lib = lib
        QK._quant, QK._dequant = QK.bind(lib)
    elif lib_name == "ssd_scan_bwd":
        SK._bwd_lib = lib
        SK._bwd_fn, SK._work_fn = SK.bind_bwd(lib)
    else:
        SK._lib = lib
        SK._fn, SK._scratch_fn = SK.bind(lib)


def run_check(device, lib_name: str, dcfg, scfg) -> dict:
    if lib_name == "flash_decode_fwd":
        rows = [r for r, _ in chip_smoke.decode_rows(
            device, chip_smoke.decode_cases(dcfg))]
        failed = [[r["shape"][1], r["lens"], r["dtype"]] for r in rows
                  if not r["ok"]]
        worst = max(r["rel_fro"] for r in rows)
    elif lib_name == "quant_offload":
        rows, _ = chip_smoke.quant_rows(device, strict=False)
        failed = [[r["shape"], r["dtype"], r["strided"]] for r in rows
                  if not r["ok"]]
        return {"caught": bool(failed), "failed": failed,
                "cases": len(rows),
                "worst_q_diff": max(r["q_max_abs_diff"] for r in rows)}
    elif lib_name == "ssd_scan_bwd":
        rows = [r for r, _, _ in chip_smoke.ssd_bwd_rows(
            device, chip_smoke.SSD_BWD_CASES)]
        failed = [[r["shape"], r["chunk"], r["dtype"]] for r in rows
                  if not (r["ok"] and r["bit_equal"])]
        worst = max(r[f"{g}_rel_fro"] for r in rows
                    for g in ("dx", "ddt", "dA", "dB", "dC"))
    else:
        rows = [r for r, _ in chip_smoke.ssd_rows(
            device, scfg, chip_smoke.SSD_LENS, chip_smoke.BOTH)]
        failed = [[r["shape"][1], r["dtype"]] for r in rows if not r["ok"]]
        worst = max(max(r["y_rel_fro"], r["state_rel_fro"]) for r in rows)
    return {"caught": bool(failed), "failed": failed,
            "cases": len(rows), "worst_rel_fro": worst}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("decode_ssd_mutants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import repro_torch.configs as C
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.quant_offload import kernel as QK
    from repro_torch.kernels.ssd_scan import kernel as SK

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    print(chip_smoke.nvidia_smi_line(), flush=True)
    dcfg, scfg = C.get_config("llama2-paper"), C.get_config("mamba2-780m")
    controls = _build.build(["flash_decode_fwd", "ssd_scan_fwd",
                             "ssd_scan_bwd", "quant_offload"])
    libs = {f"control_{n}": (n, p) for n, p in controls.items()}
    libs.update(build_mutants())
    bad = []
    for name, (lib_name, path) in libs.items():
        for n, p in controls.items():      # K4 backward reads K4's saved states
            install(n, p)
        install(lib_name, path)
        row = run_check(device, lib_name, dcfg, scfg)
        print(json.dumps({"kernel": name, "library": lib_name, **row}),
              flush=True)
        if row["caught"] != (not name.startswith("control_")):
            bad.append(name)
    FK._decode_lib = FK._decode_fn = None
    SK._lib = SK._fn = SK._scratch_fn = None
    SK._bwd_lib = SK._bwd_fn = SK._work_fn = None
    QK._lib = QK._quant = QK._dequant = None
    if bad:
        print(f"the checks got these wrong: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
