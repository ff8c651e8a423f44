#!/usr/bin/env python3
"""Mutation check of ``chip_smoke.py``'s flash-decode (K3) and SSD-scan (K4)
checks, on one NVIDIA GPU:

    python3 tools/decode_ssd_mutants.py

Plants each fault of ``MUTANTS`` in its own copy of the kernel's source
(``src/repro_torch/kernels/flash_attention/csrc/flash_decode_fwd.cu`` or
``src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_fwd.cu``) under
``build/mutants/``, builds the copies (one ``nvcc`` each, all at once), and
runs every copy, and each unchanged kernel as a control, through
``chip_smoke.py``'s own check of that kernel: ``decode_rows`` over K3's
cases (peaked q and k, a random cache past lens, both dtypes) and
``ssd_rows`` over K4's mamba2-780m prefill lengths (both dtypes).  A mutant
is caught when at least one case fails the check.  Prints one JSON line per
kernel and exits non-zero if a mutant is missed or a control fails.
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
        "const int n = min(max(lens[b], 0), Sk);",
        "const int n = min(max(lens[b], 0) + 1, Sk);"),
    # K3 does not rescale l and acc when the running max rises
    "decode_no_alpha": (
        "flash_decode_fwd",
        "const float alpha = expf(m[g] - mx);",
        "const float alpha = 1.f;"),
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
    from repro_torch.kernels.ssd_scan import kernel as SK
    lib = ctypes.CDLL(str(path))
    if lib_name == "flash_decode_fwd":
        FK._decode_lib, FK._decode_fn = lib, FK.bind_decode(lib)
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
    from repro_torch.kernels.ssd_scan import kernel as SK

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    print(chip_smoke.nvidia_smi_line(), flush=True)
    dcfg, scfg = C.get_config("llama2-paper"), C.get_config("mamba2-780m")
    controls = _build.build(["flash_decode_fwd", "ssd_scan_fwd"])
    libs = {f"control_{n}": (n, p) for n, p in controls.items()}
    libs.update(build_mutants())
    bad = []
    for name, (lib_name, path) in libs.items():
        install(lib_name, path)
        row = run_check(device, lib_name, dcfg, scfg)
        print(json.dumps({"kernel": name, "library": lib_name, **row}),
              flush=True)
        if row["caught"] != (not name.startswith("control_")):
            bad.append(name)
    FK._decode_lib = FK._decode_fn = None
    SK._lib = SK._fn = SK._scratch_fn = None
    if bad:
        print(f"the checks got these wrong: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
