"""Chameleon adaptivity demo — the paper's core scenario, end to end.

Port of ``examples/adaptive_swap_demo.py``.  Under a tight emulated HBM
budget we train with (1) dynamic loss scaling and (2) on-the-fly
validation.  Both change the per-iteration operator sequence; the
lightweight profiler detects it (Algo 1), the policy regenerates, and
training never crashes — this is the Fig-7 experiment where Capuchin dies
at the first validation.

    PYTHONPATH=src python examples_torch/adaptive_swap_demo.py [--device cpu]
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
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = C.get_reduced("llama2_paper")
    if torch.device(args.device).type == "cuda":   # the card's kernels
        cfg = cfg.replace(attn_impl="flash")
    steps = 45
    ckpt = tempfile.mkdtemp(prefix="adaptive_demo")
    tcfg = TrainConfig(steps=steps, checkpoint_every=0, checkpoint_dir=ckpt,
                       eval_every=15, warmup_steps=2, learning_rate=1e-3)
    data = SyntheticTokens(cfg.vocab_size, 64, 4, seed=1)
    try:
        tr = Trainer(cfg, tcfg,
                     ChameleonConfig(enabled=True, hbm_budget_bytes=30 << 20),
                     data=data, device=args.device)
        rep = tr.train(steps)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)

    print("step | stage     | policy")
    last = None
    for h in tr.rt.history:
        key = (h["stage"], h["policy"][:40])
        if key != last:
            print(f"{h['step']:4d} | {h['stage']:9s} | {h['policy'][:60]}")
            last = key
    print("\nstage transitions:", tr.rt.machine.transitions)
    print("eval (sequence-change) steps:", sorted(rep.eval_losses))
    print(f"policies generated: {len(tr.rt.variants)}, "
          f"best grouping knob: {tr.rt.best.knob if tr.rt.best else None}")
    print(f"failures: {rep.failures} (Capuchin-style systems crash here)")
    assert not rep.failures
    assert any(w == "seq-change" for _, w, _ in tr.rt.machine.transitions)
    print("OK — survived operator-sequence changes")
    return {"losses": rep.losses, "failures": rep.failures,
            "transitions": tr.rt.machine.transitions,
            "evals": sorted(rep.eval_losses)}


if __name__ == "__main__":
    main()
