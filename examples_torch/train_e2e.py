"""End-to-end training run: ~100M-parameter llama-family model for a few
hundred steps with Chameleon, checkpointing, eval, and loss-scale dynamics.

Port of ``examples/train_e2e.py``.

    PYTHONPATH=src python examples_torch/train_e2e.py --steps 300 [--device cpu]

``--preset small`` (default) trains a ~20M model with the identical
pipeline, ``--preset tiny`` a ~5M one; ``--preset 100m`` selects the full
deliverable configuration.
"""
import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch.common.config import ChameleonConfig, ModelConfig, TrainConfig  # noqa: E402
from repro_torch.data.synthetic import SyntheticTokens  # noqa: E402
from repro_torch.runtime.trainer import Trainer  # noqa: E402

PRESETS = {
    "tiny": ModelConfig(name="tiny-llama", family="dense", num_layers=4,
                        d_model=256, num_heads=8, num_kv_heads=4,
                        d_ff=688, vocab_size=4096, dtype="float32",
                        param_dtype="float32"),
    "small": ModelConfig(name="llama-20m", family="dense", num_layers=8,
                         d_model=384, num_heads=8, num_kv_heads=4,
                         d_ff=1024, vocab_size=8192, dtype="float32",
                         param_dtype="float32"),
    "100m": ModelConfig(name="llama-100m", family="dense", num_layers=12,
                        d_model=768, num_heads=12, num_kv_heads=4,
                        d_ff=2048, vocab_size=32000, dtype="float32",
                        param_dtype="float32"),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--preset", choices=PRESETS, default="small")
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--eval-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--budget-gib", type=float, default=16.0,
                    help="HBM budget; small values force swap policies "
                         "(and thus policy_swap-lane trace traffic)")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome trace-event JSON on exit")
    ap.add_argument("--metrics-out", default="",
                    help="append repro_torch.obs metrics snapshots (JSONL)")
    ap.add_argument("--with-serve", action="store_true",
                    help="after training, run a short over-subscribed "
                         "serving burst in-process so the trace also "
                         "carries kv_spill-lane spans")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = PRESETS[args.preset]
    if torch.device(args.device).type == "cuda":   # the card's kernels
        cfg = cfg.replace(attn_impl="flash")
    print(f"model {cfg.name}: {cfg.param_count():,} params")
    tcfg = TrainConfig(steps=args.steps,
                       checkpoint_every=args.checkpoint_every,
                       checkpoint_dir=os.path.join(
                           tempfile.gettempdir(), f"train_e2e_{args.preset}"),
                       eval_every=args.eval_every, warmup_steps=20,
                       learning_rate=3e-4)
    cham = ChameleonConfig(enabled=True,
                           hbm_budget_bytes=int(args.budget_gib * 2 ** 30))
    data = SyntheticTokens(cfg.vocab_size, args.seq, args.batch).start()
    tr = None
    out = {}
    try:
        tr = Trainer(cfg, tcfg, cham, data=data,
                     metrics_out=args.metrics_out or None,
                     metrics_every=max(args.steps // 4, 1),
                     device=args.device)
        if args.resume and tr.resume():
            print(f"resumed at step {tr.step}")
        out["start_step"] = tr.step
        t0 = time.time()
        rep = tr.train(args.steps)
        dt = time.time() - t0
        tok_s = args.steps * args.batch * args.seq / dt
        print(f"\n{args.steps} steps in {dt:.0f}s  ({tok_s:,.0f} tok/s)")
        print(f"loss: {rep.losses[0]:.3f} -> {rep.losses[-1]:.3f}")
        print(f"evals: {rep.eval_losses}")
        print(f"straggler events: {len(tr.straggler.events)}")
        print(f"chameleon: {tr.rt.stats()}")
        out.update(losses=rep.losses, evals=rep.eval_losses,
                   checkpoints=rep.checkpoints, step=tr.step)
        if args.with_serve:
            out["serve"] = serve_burst(cfg, tr)
    finally:
        data.stop()
        if tr is not None:
            export_obs(args, tr.rt)
    return out


def serve_burst(cfg, tr):
    """Over-subscribed serving burst on the freshly trained weights: more
    admitted requests than HBM-resident slots, so preempted decode state
    spills through the host pool and the trace picks up kv_spill-lane
    spans in the same file as the training lanes."""
    import numpy as np  # noqa: E402

    from repro_torch.runtime.server import Server  # noqa: E402

    srv = Server(cfg, tr.model, max_batch=2, max_len=64, max_active=4)
    rng = np.random.RandomState(0)
    for _ in range(4):
        srv.submit(rng.randint(0, cfg.vocab_size, size=8), max_new_tokens=6)
    results = srv.run_until_done(max_ticks=200)
    print(f"serve burst: {len(results)} requests, "
          f"{srv.n_preemptions} preemptions, "
          f"{srv.hostmem.kvspill.n_spills} spills")
    return {"requests": len(results), "preemptions": srv.n_preemptions,
            "spills": srv.hostmem.kvspill.n_spills}


def export_obs(args, rt):
    from repro_torch import obs  # noqa: E402

    if args.metrics_out:
        obs.metrics().write_jsonl(args.metrics_out)
        print(f"metrics: {args.metrics_out}")
    if args.trace_out:
        counters = {"overlap_efficiency": [
            (h["t"], h["efficiency"]) for h in rt.overlap_history
            if h["efficiency"] is not None]}
        counters.update(obs.ledger().counter_tracks())
        obs.export_chrome_trace(args.trace_out, obs.tracer(),
                                counters=counters,
                                meta={"preset": args.preset,
                                      "steps": args.steps})
        print(f"trace: {args.trace_out} "
              f"({obs.tracer().stats()['retained']} events)")


if __name__ == "__main__":
    main()
