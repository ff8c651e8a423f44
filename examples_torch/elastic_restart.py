"""Fault tolerance / elastic restart demo.

Port of ``examples/elastic_restart.py``.  Train, kill mid-run (simulated
node failure -> emergency checkpoint), then resume from the latest
checkpoint and verify the loss trajectory continues exactly where it left
off.

    PYTHONPATH=src python examples_torch/elastic_restart.py [--device cpu]
"""
import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch.configs as C  # noqa: E402
from repro_torch.common.config import ChameleonConfig, TrainConfig  # noqa: E402
from repro_torch.data.synthetic import SyntheticTokens  # noqa: E402
from repro_torch.runtime.trainer import Trainer  # noqa: E402


def make_trainer(ckpt, device):
    cfg = C.get_reduced("llama2_paper")
    if torch.device(device).type == "cuda":   # the card's kernels
        cfg = cfg.replace(attn_impl="flash")
    tcfg = TrainConfig(steps=40, checkpoint_every=10, checkpoint_dir=ckpt,
                       warmup_steps=2, learning_rate=1e-3)
    data = SyntheticTokens(cfg.vocab_size, 64, 4, seed=3)
    return Trainer(cfg, tcfg, ChameleonConfig(enabled=False), data=data,
                   device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ckpt = os.path.join(tempfile.gettempdir(), "elastic_demo")
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        # ---- reference: uninterrupted run
        ref = make_trainer(ckpt, args.device)
        ref_losses = ref.train(30).losses
        shutil.rmtree(ckpt, ignore_errors=True)

        # ---- run 1: dies at step 17
        tr = make_trainer(ckpt, args.device)

        def bomb(step):
            if step == 17:
                raise RuntimeError("simulated node failure")

        try:
            tr.train(30, fault_hook=bomb)
        except RuntimeError as e:
            print(f"crashed as injected: {e}")
        print(f"emergency checkpoint at step {tr.ckpt.latest_step()}")

        # ---- run 2: a fresh trainer resumes and finishes
        tr2 = make_trainer(ckpt, args.device)
        assert tr2.resume(), "must find the emergency checkpoint"
        print(f"resumed at step {tr2.step}")
        resumed_at = tr2.step
        rep2 = tr2.train(30 - tr2.step)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)

    want = np.asarray(ref_losses[-len(rep2.losses):])
    np.testing.assert_allclose(want, rep2.losses, rtol=1e-5)
    print(f"post-resume losses match uninterrupted run "
          f"(max diff {np.max(np.abs(want - np.asarray(rep2.losses))):.2e})")
    print("OK")
    return {"reference": ref_losses, "resumed": rep2.losses,
            "resumed_at": resumed_at}


if __name__ == "__main__":
    main()
