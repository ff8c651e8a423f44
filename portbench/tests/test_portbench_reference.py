"""The plain reference against the program's CPU path: the same seeded
weights and batch, the program's grad step (plain autograd) on the
reduced sizes in float32, where both compute the same equations."""
from __future__ import annotations

import pytest
import torch

from portbench import compare, feed, harness, weights
from portbench.reference import train as ref_train
from portbench.tests import tiny_cells

CELLS = ["qwen2-7b.noswap_drift", "qwen3-moe-30b-a3b.train"]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_matches_the_program_in_f32(cell):
    from repro_torch.common.config import TrainConfig
    from repro_torch.distributed import steps as S
    from repro_torch.optim.adamw import clip_by_global_norm
    ov = tiny_cells.overrides(cell)
    _, cfgj, traffic, _ = harness.cell_files(cell)
    cfgj = {**cfgj, **ov["config_overrides"]}
    traffic = {**traffic, **ov["traffic_overrides"]}
    port = harness.port_config(cfgj, {**ov["port_overrides"],
                                      "dtype": "float32",
                                      "param_dtype": "float32"})
    torch.manual_seed(0)
    from repro_torch.models.registry import get_api
    model = get_api(port).init(port, seed=0, device="cpu")
    weights.load_into(model, None, cfgj, seed=11)
    sched = feed.Schedule(traffic)
    tokens, labels = feed.batch(sched, cfgj["vocab_size"], 11, 0)
    batch = {"tokens": torch.from_numpy(tokens).long(),
             "labels": torch.from_numpy(labels).long()}
    tcfg = TrainConfig(checkpoint_every=0)
    loss, grads, finite = S.make_grad_step(port, tcfg)(model, batch, 1.0)
    assert bool(finite)
    grads, _ = clip_by_global_norm(grads, tcfg.grad_clip)
    p = {s.name: v.float() for s, v in weights.values(cfgj, 11, "cpu")}
    want = ref_train.run(cfgj, p, [(torch.from_numpy(tokens),
                                    torch.from_numpy(labels))],
                         harness.train_settings(traffic))
    want_loss = want["losses"][0]
    assert abs(float(loss) - want_loss) <= 1e-5 * want_loss
    gap, leaf = compare.worst_leaf(ref_train.norms(grads), want["grads"][0])
    assert gap < 1e-4, leaf
