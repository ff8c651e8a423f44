"""Chameleon in the port's trainer (``repro_torch.core.runtime``): ports of
the Chameleon tests of ``tests/test_trainer_integration.py`` and of
``examples/quickstart.py``'s behaviour.

The long-term-stability scenario (40 steps, an eval every 13, a 20 MiB
budget) runs once through each package's ``Trainer``: the port's stage
list and transition reasons must be the reference's, and its losses
bit-equal to its own Chameleon-off run (the reference asks 2e-4; the
executor's swaps are byte copies).  On the CPU the port's profile counts
the dispatch's inputs as its static bytes, as the reference's traced
program does (``ChameleonRuntime._static_bytes``).
"""
import shutil
import tempfile

import numpy as np
import pytest
import torch

import repro.configs as RC
import repro_torch.configs as PC
from repro.common.config import ChameleonConfig as RChameleonConfig
from repro.common.config import TrainConfig as RTrainConfig
from repro.data.synthetic import SyntheticTokens as RTokens
from repro.runtime.trainer import Trainer as RTrainer
from repro_torch.common.config import ChameleonConfig, TrainConfig
from repro_torch import obs
from repro_torch.core.runtime import ChameleonRuntime
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.runtime.trainer import Trainer

torch.set_num_threads(1)      # tier-1 runs several xdist workers


def _kw(d, steps, eval_every, **kw):
    return dict(steps=steps, checkpoint_every=10, checkpoint_dir=d,
                eval_every=eval_every, warmup_steps=2, learning_rate=1e-3,
                **kw)


def _port(d, *, cham, eval_every=0, steps=30, budget=1 << 60, seq=64,
          batch=4):
    cfg = PC.get_reduced("llama2_paper")
    return Trainer(cfg, TrainConfig(**_kw(d, steps, eval_every)),
                   ChameleonConfig(enabled=cham, hbm_budget_bytes=budget),
                   data=SyntheticTokens(cfg.vocab_size, seq, batch, seed=0),
                   device="cpu")


@pytest.fixture(scope="module")
def forty():
    """The Fig-7 scenario through both packages (reference once, port with
    Chameleon on and off)."""
    dirs = [tempfile.mkdtemp() for _ in range(3)]
    try:
        rcfg = RC.get_reduced("llama2_paper")
        rtr = RTrainer(rcfg, RTrainConfig(**_kw(dirs[0], 40, 13)),
                       RChameleonConfig(enabled=True,
                                        hbm_budget_bytes=20 << 20),
                       data=RTokens(rcfg.vocab_size, 64, 4, seed=0))
        ref = rtr.train(40)
        # the memory ledger is process-wide: count this run's iterations
        # only, whatever ran before in this process
        obs.ledger().clear()
        on = _port(dirs[1], cham=True, eval_every=13, steps=40,
                   budget=20 << 20)
        rep_on = on.train(40)
        off = _port(dirs[2], cham=False, eval_every=13, steps=40)
        rep_off = off.train(40)
        yield dict(ref=ref, ref_transitions=list(rtr.rt.machine.transitions),
                   on=on, rep_on=rep_on, rep_off=rep_off)
    finally:
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)


def test_long_term_stability_with_sequence_changes(forty):
    """Paper Fig 7: on-the-fly validation changes the operator sequence;
    Chameleon adapts.  The port's losses equal Chameleon-off's bit for
    bit, and its stages and transitions are the reference's."""
    rep, tr = forty["rep_on"], forty["on"]
    assert not rep.failures
    stages = set(rep.stages)
    assert "GenPolicy" in stages and "Stable" in stages
    assert any(why == "seq-change" for _, why, _s in tr.rt.machine.transitions)
    assert rep.losses == forty["rep_off"].losses
    assert rep.stages == forty["ref"].stages
    assert ([tuple(t) for t in tr.rt.machine.transitions]
            == [tuple(t) for t in forty["ref_transitions"]])
    # the store's tiers and the adaptation records follow the reference's
    assert rep.policystore["tiers"] == forty["ref"].policystore["tiers"]
    assert ([(a["tier"], a["trigger_step"], a["end_step"])
             for a in rep.policystore["adaptations"]]
            == [(a["tier"], a["trigger_step"], a["end_step"])
                for a in forty["ref"].policystore["adaptations"]])
    assert rep.adapt == forty["ref"].adapt


def test_runtime_stats_surface(forty):
    tr = forty["on"]
    st = tr.rt.stats()
    for key in ("stage", "transitions", "n_variants", "best_knob", "applied",
                "release_plan", "contention_s", "profiling_overhead_s",
                "adaptation_overhead_s", "ladder", "signature", "hostmem",
                "policystore", "adapt", "obs"):
        assert key in st, key
    assert st["obs"]["memory"]["iterations"] == 40
    assert len(tr.rt.history) == 40
    assert tr.rt.obs_stats()["overlap"]["iterations"] == 40
    assert tr.rt.adaptation_overhead_s > 0 and tr.rt.profiling_overhead_s > 0


def test_loss_parts_reported_with_chameleon_on(forty):
    """The report's xent and aux fill through Chameleon's dispatch as
    through the plain one: one of each a step, summing to the loss."""
    for rep in (forty["rep_on"], forty["rep_off"]):
        assert len(rep.xent) == len(rep.aux) == len(rep.losses) == 40
        np.testing.assert_allclose(np.add(rep.xent, rep.aux), rep.losses,
                                   rtol=1e-6)


def test_profiling_overhead_small():
    """Lightweight-mode bookkeeping must stay a small fraction of step time
    (paper Table 1: 0.9%); CPU steps are ms-scale, so the reference's bar
    is half the steps' time."""
    d = tempfile.mkdtemp()
    try:
        tr = _port(d, cham=True, steps=20)
        rep = tr.train(20)
        total = sum(rep.times[5:])
        assert 0 < tr.rt.profiling_overhead_s < 0.5 * total
    finally:
        shutil.rmtree(d, ignore_errors=True)


@pytest.fixture(scope="module")
def quickstart():
    """``examples/quickstart.py`` at its defaults (reduced llama2-paper,
    128 tokens x 8, a 30 MiB budget, warmup 5, lr 1e-3), cut to 18 steps."""
    d = tempfile.mkdtemp()
    try:
        cfg = PC.get_reduced("llama2-paper")
        tcfg = TrainConfig(steps=18, checkpoint_every=25, checkpoint_dir=d,
                           warmup_steps=5, learning_rate=1e-3)
        tr = Trainer(cfg, tcfg, ChameleonConfig(enabled=True,
                                                hbm_budget_bytes=30 << 20),
                     data=SyntheticTokens(cfg.vocab_size, seq_len=128,
                                          global_batch=8), device="cpu")
        yield tr, tr.train(18)
    finally:
        shutil.rmtree(d, ignore_errors=True)


def test_quickstart_behaviour(quickstart):
    tr, rep = quickstart
    first = {s: rep.stages.index(s) for s in ("WarmUp", "GenPolicy",
                                              "Stable")}
    assert first["WarmUp"] < first["GenPolicy"] < first["Stable"]
    assert rep.losses[-1] < rep.losses[0]
    assert tr.rt.applied.fingerprint != tr.rt.executor.baseline().fingerprint
    # the applied policy moved real bytes through the engine, both ways
    c = tr.rt.hostmem.engine.by_class["policy_swap"]
    assert c.bytes_out == c.bytes_in > 0
    assert tr.rt.hostmem.pool.bytes_in_use == 0


def test_variant_selection_picks_the_best_measured_time(quickstart):
    tr, rep = quickstart
    rt = tr.rt
    assert len(rt.variants) == rep.genpolicy_steps
    assert all(v.measured_t is not None for v in rt.variants)
    assert rt.best.measured_t == min(v.measured_t for v in rt.variants)
    assert rt.applied is rt.best.applied
    # each variant's time is the iteration that ran it
    gen = [i for i, s in enumerate(rep.stages) if s == "GenPolicy"]
    assert [v.measured_t for v in rt.variants] == [rep.times[i + 1]
                                                   for i in gen]


def test_select_best_takes_the_minimum():
    """``_select_best`` on hand-made variants: the fastest wins and the
    adaptation closes as a regen."""
    from repro_torch.adapt import PolicyVariant
    rt = ChameleonRuntime(ChameleonConfig(), lambda p: None, device="cpu")
    rt.service.begin(0)                  # the window prepare() opens
    base = rt.executor.baseline()
    cons = rt.executor.conservative(None)
    rt.variants = [PolicyVariant(base, None, 1.0, 0.30),
                   PolicyVariant(cons, None, 2.0, 0.10),
                   PolicyVariant(base, None, 0.5, 0.20)]
    rt._select_best()
    assert rt.best.knob == 2.0 and rt.applied is cons
    assert rt.adaptations[-1]["tier"] == "regen"


def test_record_dispatch_needs_a_recorded_function():
    rt = ChameleonRuntime(ChameleonConfig(), lambda p: None, device="cpu")
    with pytest.raises(ValueError, match="recorder"):
        rt.record_dispatch("train", lambda: None, ())
    fn = rt.recorded(lambda x: x * 2)
    fn(torch.ones(3))
    rt.record_dispatch("eval", fn, (torch.ones(3),))
    assert len(rt._iter_streams) == 1 and len(rt._iter_streams[0]) == 1
