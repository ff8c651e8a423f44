"""Quickstart: train a small llama-family model with Chameleon enabled.

Port of ``examples/quickstart.py``.

    PYTHONPATH=src python examples_torch/quickstart.py [--steps 50] [--device cpu]

Watch the stage machine move WarmUp -> GenPolicy -> Stable while the loss
decreases; ``--budget-mib`` tightens the emulated HBM budget so swap
policies actually generate.
"""
import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

import repro_torch.configs as C  # noqa: E402
from repro_torch.common.config import ChameleonConfig, TrainConfig  # noqa: E402
from repro_torch.data.synthetic import SyntheticTokens  # noqa: E402
from repro_torch.runtime.trainer import Trainer  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--budget-mib", type=int, default=30)
    ap.add_argument("--arch", default="llama2-paper")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = C.get_reduced(args.arch)
    if torch.device(args.device).type == "cuda":   # the card's kernels
        cfg = cfg.replace(attn_impl="flash")
    ckpt = os.path.join(tempfile.gettempdir(), "quickstart_ckpt")
    tcfg = TrainConfig(steps=args.steps, checkpoint_every=25,
                       checkpoint_dir=ckpt, warmup_steps=5,
                       learning_rate=1e-3)
    cham = ChameleonConfig(enabled=True,
                           hbm_budget_bytes=args.budget_mib << 20)
    data = SyntheticTokens(cfg.vocab_size, seq_len=128, global_batch=8)
    try:
        tr = Trainer(cfg, tcfg, cham, data=data, device=args.device)
        rep = tr.train(args.steps)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)

    print(f"\narch={cfg.name} params={cfg.param_count():,}")
    print(f"loss: {rep.losses[0]:.3f} -> {rep.losses[-1]:.3f}")
    print(f"stages: {rep.stages}")
    print(f"stage transitions: {tr.rt.machine.transitions}")
    print(f"applied policy: {tr.rt.applied.fingerprint[:80]}")
    print(f"skipped (loss-scale) steps: {rep.skipped_steps}")
    print(f"checkpoints: {rep.checkpoints}")
    assert rep.losses[-1] < rep.losses[0]
    first = [rep.stages.index(s) for s in ("WarmUp", "GenPolicy", "Stable")]
    assert first == sorted(first), rep.stages
    print("OK")
    return {"losses": rep.losses, "stages": rep.stages,
            "transitions": tr.rt.machine.transitions}


if __name__ == "__main__":
    main()
