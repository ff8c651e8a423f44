#!/usr/bin/env python3
"""Variants and ablations of K1's backward kernels, timed on one NVIDIA GPU:

    python3 tools/k1_bwd_variants.py [--rounds=N] [name ...]

Builds each entry of ``VARIANTS`` (edits to a copy of
``csrc/flash_attention_bwd.cu``, with the shared header beside it, under
``build/k1_bwd_variants/<name>/``; ``a+b`` applies both) and the unchanged
kernel, then times them in turns (control first, the order reversed in
every second round) at
the training shape (B 2, S 2048, 32 heads of 128, causal, bf16): the whole
backward in a CUDA graph (``chip_smoke.graph_ms``) and each of its kernels
by torch.profiler.

  design    another design choice for the same function; its gradients
            must be bit-equal to the control's at the training shape and
            pass ``chip_smoke.py``'s kernel_bwd limits on its bf16 cases.
  ablation  a part of the work removed to see what it costs; the results
            are wrong on purpose and are not checked.

Prints one JSON line per (variant, round) and per correctness check, and
exits non-zero if a design variant disagrees with the control.
"""
from __future__ import annotations

import ctypes
import json
import math
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "flash_attention" / "csrc"
SOURCE = "flash_attention_bwd.cu"


def _span(start: str, end: str) -> str:
    """The source's text from ``start`` through the end of ``end``."""
    text = (CSRC / SOURCE).read_text()
    i = text.index(start)
    return text[i:text.index(end, i) + len(end)]


TURNS = '''// Ping-pong between the two consumer warpgroups, as the forward has.
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\\n" :: "r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) { named_arrive(2 - wg); }

'''
IDLE_TURNS = ("      } else {\n        turn_wait(wg);\n        turn_pass(wg);\n"
              "        turn_wait(wg);\n        turn_pass(wg);\n      }\n")


def _pingpong(dkdv: bool, dq: bool):
    """Each tile takes two turns (S and dP, then the register products),
    in the dK/dV pass, the dQ pass or both."""
    helpers = [("// A consumer warp is done with a ring stage",
                TURNS + "// A consumer warp is done with a ring stage")]
    kv = [
        ("    for (int t = 0; t < n_tiles; ++t) {\n      const int s = t % STAGES;\n",
         "    if (wg == 1) named_arrive(1);\n"
         "    for (int t = 0; t < n_tiles; ++t) {\n      const int s = t % STAGES;\n"),
        ("        issue_ss<D, BKV, BQ, BQ>(st, k_wg, q_s);\n"
         "        issue_ss<D, BKV, BQ, BQ>(dpt, v_wg, o_s);\n",
         "        turn_wait(wg);\n        issue_ss<D, BKV, BQ, BQ>(st, k_wg, q_s);\n"
         "        issue_ss<D, BKV, BQ, BQ>(dpt, v_wg, o_s);\n        turn_pass(wg);\n"),
        ("        wg_fence();\n        issue_rs<D, BQ>(dvacc, pa, o_s);",
         "        turn_wait(wg);\n        wg_fence();\n        issue_rs<D, BQ>(dvacc, pa, o_s);"),
        ("        issue_rs<D, BQ>(dkacc, da, q_s);            // dK += dS^T Q\n"
         "        wg_commit();\n",
         "        issue_rs<D, BQ>(dkacc, da, q_s);            // dK += dS^T Q\n"
         "        wg_commit();\n        turn_pass(wg);\n"),
        ("        fence_frags(da);\n      }\n      warp_release(empty + s);"
         "                      // Q, dO",
         "        fence_frags(da);\n" + IDLE_TURNS +
         "      warp_release(empty + s);                      // Q, dO"),
    ]
    q = [
        ("    for (int t = 0; t < n_tiles; ++t) {\n      const int s = t % STAGES, k0",
         "    if (wg == 1) named_arrive(1);\n"
         "    for (int t = 0; t < n_tiles; ++t) {\n      const int s = t % STAGES, k0"),
        ("        issue_ss<D, BQD, BKD, BKD>(sa, q_wg, k_s);\n"
         "        issue_ss<D, BQD, BKD, BKD>(dpa, o_wg, v_s);\n",
         "        turn_wait(wg);\n        issue_ss<D, BQD, BKD, BKD>(sa, q_wg, k_s);\n"
         "        issue_ss<D, BQD, BKD, BKD>(dpa, o_wg, v_s);\n        turn_pass(wg);\n"),
        ("        wg_fence();\n        issue_rs<D, BKD>(dqacc, da, k_s);           // dQ += dS K\n"
         "        wg_commit();\n",
         "        turn_wait(wg);\n        wg_fence();\n"
         "        issue_rs<D, BKD>(dqacc, da, k_s);           // dQ += dS K\n"
         "        wg_commit();\n        turn_pass(wg);\n"),
        ("        fence_frags(da);\n      }\n      warp_release(empty + s);"
         "                      // K and V",
         "        fence_frags(da);\n" + IDLE_TURNS +
         "      warp_release(empty + s);                      // K and V"),
    ]
    return helpers + (kv if dkdv else []) + (q if dq else [])


def _variants():
    rs_dv = "        issue_rs<D, BQ>(dvacc, pa, o_s);            // dV += P^T dO\n"
    rs_dk = "        issue_rs<D, BQ>(dkacc, da, q_s);            // dK += dS^T Q\n"
    rs_dq = "        issue_rs<D, BKD>(dqacc, da, k_s);           // dQ += dS K\n"
    keep_dv = ("        dvacc[0] += __uint_as_float(pa[0][0] ^ pa[1][1] ^ pa[2][2]"
               " ^ pa[3][3]);\n")
    keep_dk = ("        dkacc[0] += __uint_as_float(da[0][0] ^ da[1][1] ^ da[2][2]"
               " ^ da[3][3]);\n")
    keep_dq = ("        dqacc[0] += __uint_as_float(da[0][0] ^ da[1][1] ^ da[2][2]"
               " ^ da[3][3]);\n")
    return {
        # design choices, each against the kernel as built
        "kv_stages2": ("design", [(
            "constexpr int KV_STAGES = 3;", "constexpr int KV_STAGES = 2;")]),
        # dQ back to 64-key tiles: three stages of 128-key K and V tiles
        # and the resident Q and dO are 256 KB, past the 227 KB of shared
        # memory a block may have
        "q_stages3_keys64": ("design", [
            ("constexpr int Q_STAGES = 2;", "constexpr int Q_STAGES = 3;"),
            ("constexpr int BKD = 128;", "constexpr int BKD = 64; ")]),
        "dq_keys64": ("design", [(
            "constexpr int BKD = 128;", "constexpr int BKD = 64; ")]),
        "thread_release": ("design", [
            ("      mbar_init(empty + s, 4 * NWG);      // every consumer warp",
             "      mbar_init(empty + s, 128 * NWG);    // every consumer warp"),
            ("      mbar_init(empty + s, 4 * NWG);\n",
             "      mbar_init(empty + s, 128 * NWG);\n"),
            ("  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);",
             "  mbar_arrive(bar);")]),
        "dv_before_dp_wait": ("design", [(
            _span("        wg_wait<0>();                               // dP^T is done",
                  rs_dk),
            _span("        wg_wait<0>();                               // dP^T is done",
                  rs_dk)
            .replace("        wg_wait<0>();                               // dP^T is done\n",
                     "        uint32_t pa[BQ / 16][4], da[BQ / 16][4];\n"
                     "        acc_frags<BQ>(st, pa);\n        wg_fence();\n" + rs_dv +
                     "        wg_commit();\n        wg_wait<1>();\n", 1)
            .replace("        uint32_t pa[BQ / 16][4], da[BQ / 16][4];\n"
                     "        acc_frags<BQ>(st, pa);\n        acc_frags<BQ>(dpt, da);\n",
                     "        acc_frags<BQ>(dpt, da);\n", 1)
            .replace("        wg_fence();\n" + rs_dv + rs_dk,
                     "        wg_fence();\n" + rs_dk, 1))]),
        "pingpong": ("design", _pingpong(True, True)),
        "pingpong_dkdv": ("design", _pingpong(True, False)),
        "pingpong_dq": ("design", _pingpong(False, True)),
        # ablations: the results are wrong on purpose
        "dkdv_no_elementwise": ("ablation", [(
            _span("        const bool edge = wkey + 64 > kv_len",
                  "        uint32_t pa[BQ / 16][4], da[BQ / 16][4];\n"),
            "        wg_wait<0>();\n        fence_regs(dpt);\n"
            "        uint32_t pa[BQ / 16][4], da[BQ / 16][4];\n")]),
        "dkdv_no_smem_products": ("ablation", [(
            "        issue_ss<D, BKV, BQ, BQ>(st, k_wg, q_s);\n"
            "        issue_ss<D, BKV, BQ, BQ>(dpt, v_wg, o_s);\n",
            "        for (int i = 0; i < BQ / 2; ++i) { st[i] = ls[i & 7]; dpt[i] = ds[i & 7]; }\n"
            "        wg_commit();\n        wg_commit();\n")]),
        "dkdv_no_register_products": ("ablation", [(rs_dv + rs_dk,
                                                    keep_dv + keep_dk)]),
        "dq_no_elementwise": ("ablation", [(
            _span("        const bool edge = k0 + BKD > kv_len",
                  "        uint32_t da[BKD / 16][4];\n"),
            "        wg_wait<0>();\n        fence_regs(dpa);\n"
            "        uint32_t da[BKD / 16][4];\n")]),
        "dq_no_register_product": ("ablation", [(rs_dq, keep_dq)]),
    }


VARIANTS = _variants()


def edits_of(name: str):
    """The edits of a variant; ``a+b`` applies a's and then b's."""
    parts = [VARIANTS[n] for n in name.split("+")]
    kinds = {kind for kind, _ in parts}
    return ("ablation" if "ablation" in kinds else "design",
            [e for _, edits in parts for e in edits])


def edited(edits) -> str:
    text = (CSRC / SOURCE).read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{old[:60]!r} is not in {SOURCE} exactly once")
        text = text.replace(old, new)
    return text


def write_variants(out_dir: Path, names):
    """Each variant's sources under ``out_dir/<name>/``; name -> (source,
    library)."""
    jobs = {}
    for name in names:
        d = out_dir / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        (d / SOURCE).write_text(edited(edits_of(name)[1]))
        for hdr in CSRC.glob("*.cuh"):
            shutil.copy(hdr, d / hdr.name)
        jobs[name] = (d / SOURCE, d / f"{name}.so")
    return jobs


def kernel_ms(fn, calls: int = 10) -> dict:
    """Device ms per call of each kernel ``fn`` launches (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("<")[0].split("::")[-1]:
            e.self_device_time_total / e.count / 1e3
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def main(names, rounds: int = 2) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("k1_bwd_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as c
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ops

    print(c.nvidia_smi_line(), flush=True)
    names = names or list(VARIANTS)
    jobs = write_variants(_build.BUILD_DIR.parent / "k1_bwd_variants", names)
    control = _build.build(["flash_attention_bwd"])["flash_attention_bwd"]
    _build.compile_all(jobs)
    libs = {"control": control, **{n: lib for n, (_, lib) in jobs.items()}}
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    B, S, H, D = c.TRAIN_BATCH, c.TRAIN_SEQ, 32, 128
    q, k, v = c.k1_inputs(gen, B, S, S, H, H, D, torch.bfloat16, dev)
    do = torch.randn(B, S, H, D, generator=gen, device=dev).to(torch.bfloat16)
    o, lse = ops._forward(q, k, v, causal=True, sm_scale=1 / math.sqrt(D),
                          kv_lens=None, with_lse=True)

    def use(path):
        lib = ctypes.CDLL(str(path))
        K._bwd_lib, K._bwd_fn = lib, K.bind_bwd(lib)

    def run():
        return ops.flash_attention_bwd(q, k, v, o, lse, do, causal=True)

    bad = []
    use(control)
    ref = run()
    kinds = {n: edits_of(n)[0] for n in names}
    for rnd in range(rounds):
        for name in (list(libs) if rnd % 2 == 0 else list(libs)[::-1]):
            use(libs[name])
            row = {"variant": name, "round": rnd,
                   "kind": kinds.get(name, "control")}
            try:
                row.update(ms=c.graph_ms(run, iters=5),
                           kernels_ms=kernel_ms(run))
            except RuntimeError as e:      # a launch the card refuses
                print(json.dumps({**row, "error": str(e)}), flush=True)
                bad.append((name, "launch"))
                continue
            if row["kind"] != "ablation":
                row["bit_equal_control"] = all(
                    torch.equal(a, b) for a, b in zip(run(), ref))
                if not row["bit_equal_control"]:
                    bad.append((name, "bits"))
            print(json.dumps(row), flush=True)
    cgen = torch.Generator(device=dev).manual_seed(3)
    for name, path in libs.items():
        if kinds.get(name) == "ablation" or (name, "launch") in bad:
            continue
        use(path)
        failed = []
        for Bq, Sq, Sk, Hq, Kh, Dd, causal, kv_lens, _, _ in c.BWD_CASES:
            qq, kk, vv = c.k1_inputs(cgen, Bq, Sq, Sk, Hq, Kh, Dd,
                                     torch.bfloat16, dev)
            dd = torch.randn(Bq, Sq, Hq, Dd, generator=cgen,
                             device=dev).to(torch.bfloat16)
            lens = (None if kv_lens is None else
                    torch.tensor(kv_lens, dtype=torch.int32, device=dev))
            oo, ll = ops._forward(qq, kk, vv, causal=causal,
                                  sm_scale=1 / math.sqrt(Dd), kv_lens=lens,
                                  with_lse=True)
            got = ops.flash_attention_bwd(qq, kk, vv, oo, ll, dd,
                                          causal=causal, kv_lens=lens)
            want = ops.flash_attention_bwd_plain(qq, kk, vv, oo, ll, dd,
                                                 causal=causal, kv_lens=lens)
            if not all(c.bwd_check(a, b, "bfloat16")["ok"]
                       for a, b in zip(got, want)):
                failed.append([Bq, Sq, Sk, Hq, Kh, Dd, causal, kv_lens])
        print(json.dumps({"variant": name, "check": "kernel_bwd bf16",
                          "failed": failed}), flush=True)
        if failed:
            bad.append((name, "kernel_bwd"))
    K._bwd_lib = K._bwd_fn = None
    if bad:
        print(f"variants that disagree with the control: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    rounds = [a for a in args if a.startswith("--rounds=")]
    sys.exit(main([a for a in args if a not in rounds],
                  int(rounds[-1].split("=")[1]) if rounds else 2))
