"""Serving entry point: batched decode over the slot server.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-paper \\
        --attn-impl flash --requests 8 --max-batch 4 --max-len 1024 \\
        --min-prompt-len 65 --max-prompt-len 900 --new-tokens 32

``--arch mamba2-780m`` serves the Mamba-2 (ssm) family: every prefill's
SSD scan runs on the hand-written SSD-scan kernel, decode is the one-token
recurrence; ``--attn-impl`` does not apply to it.  ``--arch
granite-moe-1b-a400m`` and ``--arch qwen3-moe-30b-a3b`` serve the moe
family, whose blocks route each token to its top-k experts.  With ``--attn-impl
flash`` a dense model's prefills run on the flash-attention kernel and its
decode attention on the flash-decode kernel.

Over-subscription: ``--max-active`` beyond ``--max-batch`` admits more
concurrent requests than device-resident slots by spilling preempted
decode state into the pinned host pool (``repro_torch.hostmem``), raw or,
with ``--spill-compression int8``, row-quantized by the int8 kernels;
``--spill-compression auto`` prices raw against int8 per row.
``--autotune`` tunes the int8 kernels against the roofline at startup
(``repro_torch.kernels.autotune``), feeding the ``auto`` advisor;
``--autotune-cache-dir D`` keeps the tuned entries in ``D``, so a restart
on it measures nothing.

``--policy-store-dir D`` attaches the shared adaptation cache read-only
and prints its stats; with ``--adapt-mode async|speculative`` the server
re-scans ``D`` in the background every 256 ticks, so a co-located
trainer's new records become visible without a tick waiting on the disk.

Port of ``repro/launch/serve.py``.  Weights are random, drawn on the device from seed 0; prompts are drawn
from ``RandomState(0)`` as the reference draws them.  Runs on ``cuda``
unless ``--device cpu``.  ``main(argv)`` returns the run's stats dict.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4,
                    help="device-resident decode slots")
    ap.add_argument("--max-active", type=int, default=0,
                    help="admitted concurrency (> max-batch spills KV state "
                         "to the host pool; 0 = max-batch)")
    ap.add_argument("--spill-compression", choices=["none", "int8", "auto"],
                    default="none",
                    help="int8: KV spill crosses the link row-quantized by "
                         "the int8 kernels (about 1.9x fewer bytes for bf16, "
                         "at most half a quantization step per element); "
                         "auto: raw-vs-int8 priced per row from the tuned "
                         "kernel rates + measured link curve")
    ap.add_argument("--autotune", action="store_true",
                    help="tune the int8 kernels against the roofline at "
                         "startup (repro_torch.kernels.autotune); feeds the "
                         "auto spill-compression advisor")
    ap.add_argument("--autotune-cache-dir", default="",
                    help="persist/reuse tuned configs here (warm cache = "
                         "zero re-measurement)")
    ap.add_argument("--calibrate-link", action="store_true",
                    help="measure the host link before serving")
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--min-prompt-len", type=int, default=4)
    ap.add_argument("--max-prompt-len", type=int, default=15,
                    help="prompt lengths are drawn uniformly from "
                         "[min, max], both included")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked for")
    ap.add_argument("--attn-impl", choices=["dense", "chunked", "flash"],
                    default=None,
                    help="attention implementation (default: the config's); "
                         "flash sends every prefill attention and every "
                         "decode attention to the CUDA kernels")
    ap.add_argument("--policy-store-dir", default="",
                    help="attach the shared adaptation cache (read-only "
                         "visibility: cache warmth is reported in stats)")
    ap.add_argument("--adapt-mode",
                    choices=["inline", "async", "speculative"],
                    default="inline",
                    help="adaptation placement: async / speculative enable "
                         "the background policy-store refresher so a "
                         "co-located trainer's new policies become visible "
                         "without a tick-loop stall")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome trace-event JSON here on exit "
                         "(open in Perfetto / chrome://tracing)")
    ap.add_argument("--metrics-out", default="",
                    help="write one metrics-registry snapshot (JSONL) here "
                         "on exit")
    return ap


def main(argv: Optional[List[str]] = None) -> dict:
    args = _parser().parse_args(argv)

    import numpy as np
    import torch

    import repro_torch.configs as C
    from repro_torch import obs
    from repro_torch.common.config import HostMemConfig, PolicyStoreConfig
    from repro_torch.common.device import resolve_device
    from repro_torch.hostmem import HostMemTier
    from repro_torch.models.registry import get_api
    from repro_torch.runtime.server import Server

    device = resolve_device(args.device)
    cfg = C.get_reduced(args.arch) if args.reduced else C.get_config(args.arch)
    if args.attn_impl:
        cfg = cfg.replace(attn_impl=args.attn_impl)
    api = get_api(cfg)
    model = api.init(cfg, seed=0, device=device)
    max_active = args.max_active or args.max_batch
    hostmem = None
    if (max_active > args.max_batch or args.calibrate_link
            or args.spill_compression != "none" or args.autotune):
        hostmem = HostMemTier(HostMemConfig(
            spill_compression=args.spill_compression), device=device)
        if args.calibrate_link:
            hostmem.calibrate()        # engine-path sweep
        if args.autotune:
            from repro_torch.common.config import AutotuneConfig
            hostmem.autotune(AutotuneConfig(
                enabled=True, cache_dir=args.autotune_cache_dir))
    policystore = None
    if args.policy_store_dir:
        from repro_torch.policystore import PolicyStore
        # readonly: a shared training store must not lose records to this
        # reader's load-time eviction
        policystore = PolicyStore(PolicyStoreConfig(dir=args.policy_store_dir),
                                  readonly=True)
    srv = Server(cfg, model, max_batch=args.max_batch, max_len=args.max_len,
                 max_active=max_active, hostmem=hostmem,
                 policystore=policystore, adapt_mode=args.adapt_mode)
    rng = np.random.RandomState(0)
    prompt_lens = []
    t0 = time.perf_counter()      # submit() already prefills the first slots
    for _ in range(args.requests):
        n = rng.randint(args.min_prompt_len, args.max_prompt_len + 1)
        prompt_lens.append(int(n))
        srv.submit(rng.randint(0, cfg.vocab_size, size=n),
                   max_new_tokens=args.new_tokens)
    results = srv.run_until_done(max_ticks=10_000)
    dt = time.perf_counter() - t0
    toks = sum(len(v) for v in results.values())
    srv.close()                   # a running store re-scan finishes
    lat = srv.latency_stats()
    srv_stats = srv.stats()
    print(f"{len(results)} requests, {toks} tokens, {dt:.2f}s, "
          f"{toks / dt:.1f} tok/s, {srv.ticks} ticks, "
          f"{srv.n_preemptions} preemptions, on {device}")
    print(f"tick p50 {lat['tick_ms']['p50']:.1f} ms / "
          f"p95 {lat['tick_ms']['p95']:.1f} ms, "
          f"occupancy {lat['slot_occupancy']:.1%}, "
          f"queue-wait p95 {lat['queue_wait_ticks']['p95']:.0f} ticks")
    if hostmem is not None:
        print(hostmem.summary())          # includes per-traffic-class lines
        ks = hostmem.kvspill.stats()
        if ks["compression"] != "none" and ks["n_spills"]:
            print(f"spill compression ({ks['compression']}): "
                  f"{ks['bytes_raw'] / 2**20:.1f} MiB raw -> "
                  f"{ks['bytes_spilled'] / 2**20:.1f} MiB staged "
                  f"({ks['compression_ratio']:.2f}x)")
        if ks["advisor"] is not None:
            print(f"spill advisor: {ks['advisor']['n_int8']} rows int8, "
                  f"{ks['advisor']['n_raw']} raw")
        if hostmem.autotuner is not None:
            print(f"autotune: {hostmem.autotuner.stats()}")
    if policystore is not None:
        print(f"policystore: {srv_stats['policystore']}")
        ad = srv_stats["adapt"]
        if ad["mode"] != "inline":
            print(f"adapt[{ad['mode']}]: "
                  f"store_refreshes={ad['store_refreshes']} "
                  f"records_refreshed={ad['store_records_refreshed']}")
    if args.metrics_out:
        obs.metrics().write_jsonl(args.metrics_out)
    obs.metrics().unregister_provider("server")    # drop the model with srv
    if args.trace_out:
        obs.export_chrome_trace(args.trace_out, obs.tracer(),
                                counters=obs.ledger().counter_tracks(),
                                meta={"arch": args.arch,
                                      "requests": args.requests})
        print(f"trace: {args.trace_out} "
              f"({obs.tracer().stats()['retained']} events)")
    return {
        "arch": cfg.name,
        "device": str(device),
        "attn_impl": cfg.attn_impl,
        "requests": args.requests,
        "prompt_lens": prompt_lens,
        "results": {int(r): list(map(int, v)) for r, v in results.items()},
        "completed": len(results),
        "tokens": toks,
        "wall_s": dt,
        "tokens_per_s": toks / dt if dt > 0 else 0.0,
        "ticks": srv.ticks,
        "latency": lat,
        "max_active": max_active,
        "preemptions": srv.n_preemptions,
        "kv_spill_class": srv_stats["kv_spill_class"],
        "hostmem": srv_stats["hostmem"],
        "kvspill": srv_stats["hostmem"]["kvspill"] if hostmem else None,
        "autotune": (hostmem.autotuner.stats()
                     if hostmem is not None and hostmem.autotuner else None),
        "policystore": srv_stats["policystore"],
        "adapt": srv_stats["adapt"],
        "link_curve": ({int(k): list(v) for k, v in hostmem.link_curve.items()}
                       if hostmem else None),
        "max_memory_allocated": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else None),
    }


if __name__ == "__main__":
    main()
