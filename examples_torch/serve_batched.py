"""Batched serving with continuous batching over the decode step.

Port of ``examples/serve_batched.py``.

    PYTHONPATH=src python examples_torch/serve_batched.py [--device cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402

import torch  # noqa: E402

import repro_torch.configs as C  # noqa: E402
from repro_torch.models.registry import get_api  # noqa: E402
from repro_torch.runtime.server import Server  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = C.get_reduced("llama3_2_1b")
    if torch.device(args.device).type == "cuda":   # the card's kernels
        cfg = cfg.replace(attn_impl="flash")
    api = get_api(cfg)
    params = api.init(cfg, seed=0, device=args.device)
    srv = Server(cfg, params, max_batch=4, max_len=64)

    rng = np.random.RandomState(0)
    rids = []
    for i in range(10):  # more requests than slots: queue + backfill
        prompt = rng.randint(0, cfg.vocab_size, size=rng.randint(4, 12))
        rids.append(srv.submit(prompt, max_new_tokens=8))
    t0 = time.time()
    results = srv.run_until_done()
    dt = time.time() - t0
    total_tokens = sum(len(v) for v in results.values())
    print(f"served {len(results)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s over {srv.ticks} decode ticks "
          f"({total_tokens / dt:.1f} tok/s)")
    for rid in rids[:3]:
        print(f"  req {rid}: {results[rid]}")
    assert set(results) == set(rids)
    print("OK")
    return {"results": results, "ticks": srv.ticks, "seconds": dt}


if __name__ == "__main__":
    main()
