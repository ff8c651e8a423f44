"""The comparison that decides ``correct`` catches what it is there for.

A run at the small sizes with the timed path broken underneath (the
harness's look for a card skipped) comes out not correct, once for each
fault a training cell can have: a step that leaves its state unchanged,
half of the batch left out (the mean over the rest), and a gradient leaf
altered where the grad step produces it.  The control, the reference in
fp8 put in the program's place, fails a number too.  A sound run passes.
"""
from __future__ import annotations

import pytest

from portbench import compare, harness
from portbench.tests import tiny_cells

CELLS = ["qwen2-7b.noswap_drift", "qwen3-moe-30b-a3b.train"]
ALL = CELLS + ["qwen2-7b.swap_drift"]


def limits(cell):
    return harness.cell_files(cell)[3]["limits"]


@pytest.mark.parametrize("cell", ALL)
def test_sound_run_is_correct(cell):
    out = tiny_cells.run(cell)
    assert out["correct"], out["checks"]
    if "drift" in cell:        # the late step ran the longer bucket
        late = out["detail"]["late_step"]
        assert late["seq"] == max(tiny_cells.TRAFFIC["buckets"])
        assert set(out["checks"]) >= {"late_grad", "late_change"}
    if cell == "qwen2-7b.swap_drift":         # and swapped
        assert out["detail"]["late_step"]["staged_bytes"] > 0


def _state_unchanged(monkeypatch):
    from repro_torch.distributed import steps as S
    monkeypatch.setattr(S, "adamw_update",
                        lambda params, grads, state, cfg, lr: state)


def _half_batch(monkeypatch):
    from repro_torch.models import transformer
    real = transformer.loss_fn

    def half(cfg, model, batch):
        rows = batch["tokens"].shape[0] // 2
        return real(cfg, model, {k: v[:rows] for k, v in batch.items()})
    monkeypatch.setattr(transformer, "loss_fn", half)


def _leaf_doubled(monkeypatch):
    from repro_torch.distributed import steps as S
    real = S.check_finite

    def doubled(grads):
        grads["blocks.0.attn.wq"].mul_(2)
        return real(grads)
    monkeypatch.setattr(S, "check_finite", doubled)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _leaf_doubled],
                         ids=["state_unchanged", "half_batch", "leaf_doubled"])
@pytest.mark.parametrize("cell", ALL)
def test_broken_step_is_not_correct(cell, fault, monkeypatch):
    """Not correct, or no result at all: with half of the batch the swap
    cell's longer bucket fits its budget and no step swaps, which the
    harness refuses."""
    fault(monkeypatch)
    try:
        out = tiny_cells.run(cell)
    except RuntimeError as e:
        assert "no Stable step with swaps" in str(e)
        return
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_number(cell):
    import torch
    ov = tiny_cells.overrides(cell)
    _, cfgj, traffic, _ = harness.cell_files(cell)
    cfgj = {**cfgj, **ov["config_overrides"]}
    traffic = {**traffic, **ov["traffic_overrides"]}
    # the drift cell's late step: the second step of the longer bucket
    late = traffic["period"] + 1 if len(traffic["buckets"]) > 1 else None
    args = (cfgj, traffic, 5, torch.device("cpu"), [0, 1, 2], late)
    ref = harness.reference(*args)
    ctl = harness.reference(*args, precision="fp8")
    correct, checks = compare.judge(compare.numbers(ctl, ref), limits(cell))
    assert not correct, checks
    assert any(c["value"] is not None and c["value"] > c["limit"]
               for c in checks.values()), checks
