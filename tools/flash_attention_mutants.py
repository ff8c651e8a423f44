#!/usr/bin/env python3
"""Mutation check of ``chip_smoke.py``'s flash-attention (K1) checks, on one
NVIDIA GPU:

    python3 tools/flash_attention_mutants.py

Plants each fault of ``MUTANTS`` (the forward) and ``BWD_MUTANTS`` (the
backward) in its own copy of the kernel's sources under
``build/mutants/<name>/``: the library's ``.cu`` and the shared header
``hopper_sm90.cuh`` beside it, one of them edited.  It builds every copy
and the unchanged libraries (one ``nvcc`` each, all at once), then runs each
library in a process of its own under a time limit (``RUN_TIMEOUT_S``),
because a mutant that breaks a ring's mbarrier protocol can hang the card's
kernel instead of failing a check.

Forward libraries go through two checks in bf16 over ``chip_smoke.py``'s
sweep (GQA, kv_lens, every head dim) and llama2-paper's prefill shapes (the
serve phase's prompt lengths and the timed lengths of ``chip_smoke.py``):

  peaked   ``chip_smoke.py``'s own check: q and k at QK_SCALE x randn, v a
           unit normal, limits TOL, FRO_TOL and MAX_TOL;
  uniform  a weaker check for comparison: q, k and v at 0.3 x randn, so the
           softmax is near uniform, and the elementwise limit TOL only.

Backward libraries go through ``chip_smoke.py``'s ``kernel_bwd`` check (dq,
dk and dv against the plain backward, BWD_FRO_TOL and BWD_MAX_TOL) over its
sweep in bf16 and f32 (a mutant of the bf16 kernels is caught on bf16
cases), and each row names the limits that caught it.

A mutant is caught by a check when at least one case fails it; one that
runs past its time limit is reported as ``hung`` (and counts as caught: the
smoke run would never end).  Prints one JSON line per (library, check) and
exits non-zero if the peaked forward check or the backward check misses a
mutant or a control fails or hangs.
"""
from __future__ import annotations

import ctypes
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "flash_attention" / "csrc"
HEADER = "hopper_sm90.cuh"
RUN_TIMEOUT_S = 180

# name -> (file in csrc/, [(text, the text that replaces it), ...]); the
# forward library is built with each
MUTANTS = {
    # late rows only: a query tile that reads more than 6 KV tiles (causal
    # rows from 768 on) skips its last loop pass, so the diagonal tile's
    # scores never reach the softmax and its P V uses the tile before's P
    "skip_late_kv_tile": ("flash_attention_fwd.cu", [(
        "    for (int tile = 1; tile < n_tiles; ++tile) {",
        "    for (int tile = 1; tile < n_tiles - (n_tiles > 6); ++tile) {")]),
    # the running sum and accumulator are not rescaled when the running max
    # rises (alpha = 1)
    "no_rescale": ("flash_attention_fwd.cu", [(
        "  a0 = fast_exp2(m0 - mn0);\n  a1 = fast_exp2(m1 - mn1);",
        "  a0 = 1.f;\n  a1 = 1.f;")]),
    # each row also sees the key just after it
    "causal_one_late": ("flash_attention_fwd.cu", [(
        "const bool valid = key < kv_len && (!causal || key <= row);",
        "const bool valid = key < kv_len && (!causal || key <= row + 1);")]),
    # heads are mapped to KV heads interleaved instead of grouped (GQA)
    "wrong_gqa_head": ("flash_attention_fwd.cu", [(
        "const int kh = h / (H / Kh);             // GQA: the KV head of head h",
        "const int kh = h % Kh;")]),
    # the consumers compute S from the ring stage of the previous K tile,
    # one phase behind the barrier they waited on: a stale tile, or one the
    # producer is refilling (waiting on the wrong barrier phase instead would
    # release the stage before its copy lands and hang the producer)
    "stale_stage": ("flash_attention_fwd.cu", [(
        "      issue_qk<D, BQ16>(sacc, q_wg, sK + s * L::KV_BYTES);",
        "      issue_qk<D, BQ16>(sacc, q_wg, sK + ps * L::KV_BYTES);")]),
    # the shared header: bf16 pairs packed high half first, so P's
    # fragments and every output pair have their two columns swapped
    "hdr_pack_swapped": (HEADER, [(
        "__nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);",
        "__nv_bfloat162 v = __floats2bfloat162_rn(hi, lo);")]),
    # the shared header: tensor maps fill rows past S with NaN instead of
    # zeros, so a V tile that runs past Sk puts NaN under P's zeros
    "hdr_oob_fill_nan": (HEADER, [(
        "CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);",
        "CU_TENSOR_MAP_FLOAT_OOB_FILL_NAN_REQUEST_ZERO_FMA);")]),
}

# the same for the backward library
BWD_MUTANTS = {
    # the causal mask aligned bottom-right (attention_ref's) instead of the
    # forward's top-left: key <= qpos + Sk - Sq (kv_len is Sk without lens)
    "bwd_bottom_right_mask": ("flash_attention_bwd.cu", [(
        "return qpos < Sq && key < kv_len && (!causal || key <= qpos);",
        "return qpos < Sq && key < kv_len && (!causal || key <= qpos + kv_len - Sq);")]),
    # the key at kv_lens[b] counted as valid
    "bwd_kv_len_off_by_one": ("flash_attention_bwd.cu", [(
        "return qpos < Sq && key < kv_len && (!causal || key <= qpos);",
        "return qpos < Sq && key <= kv_len && (!causal || key <= qpos);")]),
    # delta = rowsum(dO * O) dropped: dS = P dP
    "bwd_no_delta": ("flash_attention_bwd.cu", [(
        "    delta[((int64_t)b * H + h) * Sq + i] = s;",
        "    delta[((int64_t)b * H + h) * Sq + i] = 0.f;")]),
    # bf16 dK/dV from the group's first query head only (GQA not summed)
    "bwd_no_gqa_sum": ("flash_attention_bwd.cu", [(
        "  const int n_tiles = group * n_q;",
        "  const int n_tiles = n_q;")]),
    # bf16 dK/dV skip the last query tile of every head
    "bwd_skip_query_tile": ("flash_attention_bwd.cu", [(
        "(Sq - i_begin + BQ - 1) / BQ",
        "(Sq - i_begin - 1) / BQ")]),
    # the ring: bf16 dK/dV consumers release a Q/dO stage as soon as it has
    # landed, before their wgmma products read it, so the producer refills
    # it (the next tile but one, its lse and delta) under them.  The phases
    # stay consistent, so nothing hangs: the products read the wrong tile.
    "bwd_release_before_wgmma": ("flash_attention_bwd.cu", [
        ("      mbar_wait(full + s, (t / STAGES) & 1);\n"
         "      // skipped where every pair of this warpgroup's keys is masked\n",
         "      mbar_wait(full + s, (t / STAGES) & 1);\n"
         "      warp_release(empty + s);\n"
         "      // skipped where every pair of this warpgroup's keys is masked\n"),
        ("      warp_release(empty + s);                      // Q, dO, lse and delta read\n",
         "")]),
}

LIBS = {"fwd": ("flash_attention_fwd", MUTANTS),
        "bwd": ("flash_attention_bwd", BWD_MUTANTS)}


def mutated(file: str, edits) -> str:
    """The text of csrc/``file`` with ``edits`` applied; each edited text
    must occur exactly once."""
    text = (CSRC / file).read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{old!r} is not in {CSRC / file} exactly once")
        text = text.replace(old, new)
    return text


def write_mutants(out_dir: Path):
    """Write every mutant's copy of its library's sources under
    ``out_dir/<name>/``; return name -> (kind, source, library)."""
    jobs = {}
    for kind, (lib, table) in LIBS.items():
        src = CSRC / f"{lib}.cu"
        for name, (file, edits) in table.items():
            d = out_dir / name
            shutil.rmtree(d, ignore_errors=True)
            d.mkdir(parents=True)
            for f in (src, *sorted(CSRC.glob("*.cuh"))):
                (d / f.name).write_text(mutated(file, edits) if f.name == file
                                        else f.read_text())
            jobs[name] = (kind, d / src.name, d / f"{name}.so")
    return jobs


def run_check(device, cases, mode: str) -> dict:
    """Run one forward check over ``cases`` with whatever library
    ``kernel`` holds."""
    import torch
    import chip_smoke
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
    import chip_smoke
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


def run_one(kind: str, name: str, path: str) -> int:
    """In a process of its own: load the library at ``path`` into the
    wrapper and print one JSON line per check."""
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import chip_smoke
    import repro_torch.configs as C
    from repro_torch.kernels.flash_attention import kernel as K

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    lib = ctypes.CDLL(path)
    if kind == "fwd":
        K._lib, K._fn = lib, K.bind(lib)
        cases = (chip_smoke.SWEEP_CASES
                 + chip_smoke.llama2_cases(C.get_config("llama2-paper")))
        for mode in ("peaked", "uniform"):
            print(json.dumps({"kernel": name, "check": mode,
                              **run_check(device, cases, mode)}), flush=True)
    else:
        K._bwd_lib, K._bwd_fn = lib, K.bind_bwd(lib)
        print(json.dumps({"kernel": name, "check": "kernel_bwd",
                          **run_bwd_check(device, chip_smoke.BWD_CASES)}),
              flush=True)
    return 0


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("flash_attention_mutants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import _build

    print(chip_smoke.nvidia_smi_line(), flush=True)
    jobs = write_mutants(_build.BUILD_DIR.parent / "mutants")
    controls = {"control": "flash_attention_fwd",
                "bwd_control": "flash_attention_bwd"}
    todo = {n: (src, lib) for n, (_, src, lib) in jobs.items()}
    for name, lib in controls.items():
        path = _build.library_path(lib)
        if not path.exists():
            todo[name] = (_build.SOURCES[lib], path)
    _build.compile_all(todo)
    runs = {name: ("fwd" if lib == "flash_attention_fwd" else "bwd",
                   _build.library_path(lib)) for name, lib in controls.items()}
    runs.update({n: (kind, lib) for n, (kind, _, lib) in jobs.items()})
    bad = []
    for name, (kind, path) in runs.items():
        control = name in controls
        check = "peaked" if kind == "fwd" else "kernel_bwd"
        try:
            proc = subprocess.run(
                [sys.executable, __file__, "--one", kind, name, str(path)],
                capture_output=True, text=True, timeout=RUN_TIMEOUT_S)
            rows = [json.loads(ln) for ln in proc.stdout.splitlines()
                    if ln.startswith("{")]
            if not any(r["check"] == check for r in rows):
                # a launch or device fault ended the process: not a pass
                rows.append({"kernel": name, "check": check, "caught": True,
                             "crashed": proc.stderr[-2000:]})
        except subprocess.TimeoutExpired:
            rows = [{"kernel": name, "check": check, "caught": True,
                     "hung": RUN_TIMEOUT_S}]
        for row in rows:
            print(json.dumps(row), flush=True)
            if row["check"] == check and row["caught"] == control:
                bad.append((name, check))
    if bad:
        print(f"the checks got these wrong: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        sys.exit(run_one(*sys.argv[2:5]))
    sys.exit(main())
