#!/usr/bin/env python3
"""Mutation check of ``chip_smoke.py``'s flash-attention (K1) check, on one
NVIDIA GPU:

    python3 tools/flash_attention_mutants.py

Plants each fault of ``MUTANTS`` in its own copy of
``src/repro_torch/kernels/flash_attention/csrc/flash_attention_fwd.cu``
under ``build/mutants/``, builds the copies (one ``nvcc`` each, all at
once), and runs every copy, and the unchanged kernel as a control, through
two checks in bf16 over ``chip_smoke.py``'s sweep (GQA, kv_lens, every head
dim) and llama2-paper's prefill shapes (the serve phase's prompt lengths
and the timed lengths of ``chip_smoke.py``):

  peaked   ``chip_smoke.py``'s own check: q and k at QK_SCALE x randn, v a
           unit normal, limits TOL, FRO_TOL and MAX_TOL;
  uniform  a weaker check for comparison: q, k and v at 0.3 x randn, so the
           softmax is near uniform, and the elementwise limit TOL only.

A mutant is caught by a check when at least one shape fails it.

The backward (``csrc/flash_attention_bwd.cu``) gets the same treatment with
``BWD_MUTANTS``: each copy, and the unchanged kernel, runs
``chip_smoke.py``'s ``kernel_bwd`` check (dq, dk and dv against the plain
backward, BWD_FRO_TOL and BWD_MAX_TOL) over its sweep, in bf16 and f32
(a mutant that changes only the bf16 kernels is caught on bf16 cases),
and each row names the limits that caught it.

Prints one JSON line per (kernel, check) and exits non-zero if the peaked
forward check or the backward check misses a mutant or fails a control.
"""
from __future__ import annotations

import ctypes
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke  # noqa: E402  (puts src/ on the path as well)

# name -> (text of the bf16 kernel, the text that replaces it)
MUTANTS = {
    # late rows only: a query tile that reads more than 6 KV tiles (causal
    # rows from 768 on) skips its last loop pass, so the diagonal tile's
    # scores never reach the softmax and its P V uses the tile before's P
    "skip_late_kv_tile": (
        "    for (int tile = 1; tile < n_tiles; ++tile) {",
        "    for (int tile = 1; tile < n_tiles - (n_tiles > 6); ++tile) {"),
    # the running sum and accumulator are not rescaled when the running max
    # rises (alpha = 1)
    "no_rescale": (
        "  a0 = fast_exp2(m0 - mn0);\n  a1 = fast_exp2(m1 - mn1);",
        "  a0 = 1.f;\n  a1 = 1.f;"),
    # each row also sees the key just after it
    "causal_one_late": (
        "const bool valid = key < kv_len && (!causal || key <= row);",
        "const bool valid = key < kv_len && (!causal || key <= row + 1);"),
    # heads are mapped to KV heads interleaved instead of grouped (GQA)
    "wrong_gqa_head": (
        "const int kh = h / (H / Kh);             // GQA: the KV head of head h",
        "const int kh = h % Kh;"),
    # the consumers compute S from the ring stage of the previous K tile,
    # one phase behind the barrier they waited on: a stale tile, or one the
    # producer is refilling (waiting on the wrong barrier phase instead would
    # release the stage before its copy lands and hang the producer)
    "stale_stage": (
        "      issue_qk<D, BQ16>(sacc, q_wg, sK + s * L::KV_BYTES);",
        "      issue_qk<D, BQ16>(sacc, q_wg, sK + ps * L::KV_BYTES);"),
}


# name -> (text of flash_attention_bwd.cu, the text that replaces it)
BWD_MUTANTS = {
    # the causal mask aligned bottom-right (attention_ref's) instead of the
    # forward's top-left: key <= qpos + Sk - Sq (kv_len is Sk without lens)
    "bwd_bottom_right_mask": (
        "return qpos < Sq && key < kv_len && (!causal || key <= qpos);",
        "return qpos < Sq && key < kv_len && (!causal || key <= qpos + kv_len - Sq);"),
    # the key at kv_lens[b] counted as valid
    "bwd_kv_len_off_by_one": (
        "return qpos < Sq && key < kv_len && (!causal || key <= qpos);",
        "return qpos < Sq && key <= kv_len && (!causal || key <= qpos);"),
    # delta = rowsum(dO * O) dropped: dS = P dP
    "bwd_no_delta": (
        "    delta[((int64_t)b * H + h) * Sq + i] = s;",
        "    delta[((int64_t)b * H + h) * Sq + i] = 0.f;"),
    # bf16 dK/dV from the group's first query head only (GQA not summed)
    "bwd_no_gqa_sum": (
        "  const int i_begin = causal ? j0 / IT * IT : 0;\n"
        "  for (int hh = 0; hh < G && j0 < kv_len; ++hh) {",
        "  const int i_begin = causal ? j0 / IT * IT : 0;\n"
        "  for (int hh = 0; hh < 1 && j0 < kv_len; ++hh) {"),
    # bf16 dK/dV skip the last query tile of every head
    "bwd_skip_query_tile": (
        "    for (int i0 = i_begin; i0 < Sq; i0 += IT) {",
        "    for (int i0 = i_begin; i0 < Sq - IT; i0 += IT) {"),
}


def build_mutants(lib_name="flash_attention_fwd", mutants=None):
    from repro_torch.kernels import _build
    src = _build.SOURCES[lib_name]
    text = src.read_text()
    out_dir = _build.BUILD_DIR.parent / "mutants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, (old, new) in (MUTANTS if mutants is None else mutants).items():
        if text.count(old) != 1:
            raise RuntimeError(f"mutant {name}: {old!r} is not in {src} "
                               "exactly once")
        cu = out_dir / f"{name}.cu"
        cu.write_text(text.replace(old, new))
        jobs[name] = (cu, out_dir / f"{name}.so")
    _build.compile_all(jobs)
    return {name: lib for name, (_, lib) in jobs.items()}


def run_check(device, cases, mode: str) -> dict:
    """Run one check over ``cases`` with whatever library ``kernel`` holds."""
    import torch
    from repro_torch.kernels.flash_attention import ops

    gen = torch.Generator(device=device).manual_seed(0)
    failed, worst_fro = [], 0.0
    for B, Sq, Sk, H, Kh, D, causal, kv_lens, _, _ in cases:
        if mode == "peaked":
            q, k, v = chip_smoke.k1_inputs(gen, B, Sq, Sk, H, Kh, D,
                                           torch.bfloat16, device)
        else:
            q, k, v = chip_smoke.k1_inputs(gen, B, Sq, Sk, H, Kh, D,
                                           torch.bfloat16, device,
                                           qk_scale=0.3, v_scale=0.3)
        lens = (None if kv_lens is None else
                torch.tensor(kv_lens, dtype=torch.int32, device=device))
        out = ops.flash_attention(q, k, v, causal=causal, kv_lens=lens)
        ref = ops.flash_attention_plain(q, k, v, causal=causal, kv_lens=lens)
        res = chip_smoke.k1_check(out, ref, "bfloat16")
        if mode == "uniform":
            diff = (out.float() - ref.float()).abs()
            tol = res["tol"]
            res["ok"] = bool((diff <= tol + tol * ref.float().abs()).all())
        worst_fro = max(worst_fro, res["rel_fro"])
        if not res["ok"]:
            failed.append([B, Sq, Sk, H, Kh, D])
    return {"caught": bool(failed), "failed_shapes": failed,
            "worst_rel_fro": worst_fro}


def run_bwd_check(device, cases) -> dict:
    """``chip_smoke.py``'s kernel_bwd check over ``cases`` with whatever
    backward library ``kernel`` holds: the shapes that fail and, for each,
    which limits (fro, max) of which gradient caught it."""
    import torch
    from repro_torch.kernels.flash_attention import ops

    gen = torch.Generator(device=device).manual_seed(3)
    failed, worst_fro = [], 0.0
    for B, Sq, Sk, H, Kh, D, causal, kv_lens, dtypes, _ in cases:
        for dname in dtypes:
            dtype = getattr(torch, dname)
            q, k, v = chip_smoke.k1_inputs(gen, B, Sq, Sk, H, Kh, D, dtype,
                                           device)
            do = torch.randn(B, Sq, H, D, generator=gen,
                             device=device).to(dtype)
            lens = (None if kv_lens is None else
                    torch.tensor(kv_lens, dtype=torch.int32, device=device))
            o, lse = ops._forward(q, k, v, causal=causal,
                                  sm_scale=1.0 / math.sqrt(D), kv_lens=lens,
                                  with_lse=True)
            got = ops.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                          kv_lens=lens)
            ref = ops.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                causal=causal, kv_lens=lens)
            limits = []
            for name, g, r in zip(("dq", "dk", "dv"), got, ref):
                c = chip_smoke.bwd_check(g, r, dname)
                worst_fro = max(worst_fro, c["rel_fro"])
                if c["rel_fro"] > chip_smoke.BWD_FRO_TOL[dname]:
                    limits.append(f"{name}:fro")
                if c["max_abs_err"] > (chip_smoke.BWD_MAX_TOL[dname]
                                       * c["max_abs_ref"]):
                    limits.append(f"{name}:max")
            if limits:
                failed.append({"shape": [B, Sq, Sk, H, Kh, D],
                               "causal": causal, "kv_lens": kv_lens,
                               "dtype": dname, "limits": limits})
    return {"caught": bool(failed), "failed": failed,
            "worst_rel_fro": worst_fro}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_attention_mutants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import repro_torch.configs as C
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as K

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    print(chip_smoke.nvidia_smi_line(), flush=True)
    cases = (chip_smoke.SWEEP_CASES
             + chip_smoke.llama2_cases(C.get_config("llama2-paper")))
    libs = {"control": _build.build(["flash_attention_fwd"])
            ["flash_attention_fwd"], **build_mutants()}
    bad = []
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        K._lib, K._fn = lib, K.bind(lib)
        for mode in ("peaked", "uniform"):
            row = run_check(device, cases, mode)
            print(json.dumps({"kernel": name, "check": mode, **row}),
                  flush=True)
            if mode == "peaked" and row["caught"] != (name != "control"):
                bad.append((name, mode))
    K._lib = K._fn = None
    bwd_libs = {"bwd_control": _build.build(["flash_attention_bwd"])
                ["flash_attention_bwd"],
                **build_mutants("flash_attention_bwd", BWD_MUTANTS)}
    for name, path in bwd_libs.items():
        lib = ctypes.CDLL(str(path))
        K._bwd_lib, K._bwd_fn = lib, K.bind_bwd(lib)
        row = run_bwd_check(device, chip_smoke.BWD_CASES)
        print(json.dumps({"kernel": name, "check": "kernel_bwd", **row}),
              flush=True)
        if row["caught"] != (name != "bwd_control"):
            bad.append((name, "kernel_bwd"))
    K._bwd_lib = K._bwd_fn = None
    if bad:
        print(f"the checks got these wrong: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
