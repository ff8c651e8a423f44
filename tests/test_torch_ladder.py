"""The degradation ladder (``repro_torch.faults.ladder``, a copy of the
reference's) and the runtime's memory-ledger feedback with real swaps.

Ports of the four ladder tests of ``tests/test_faults.py`` and of the
runtime case of ``tests/test_memledger.py``.  The reference's
``test_runtime_mirrored_iterations_score_zero_error`` mirrors the policy's
schedule through the engine; the port's runtime runs the policy's swaps
for real (``core.executor``), so here the grad dispatch itself moves the
entries and the ledger scores the iteration: when every copy lands on
plan, the realized peak equals the policy's projected peak exactly.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro_torch.configs as PC
from repro_torch import faults, obs
from repro_torch.common.config import ChameleonConfig, TrainConfig
from repro_torch.core import memtrace as pmem
from repro_torch.core import policy as ppol
from repro_torch.core.runtime import ChameleonRuntime
from repro_torch.distributed import steps as S
from repro_torch.faults.health import FAILED, DEGRADED, HEALTHY
from repro_torch.faults.ladder import (RUNG_CONSERVATIVE, RUNG_FULL,
                                       RUNG_NO_SWAP, RUNG_TRIMMED,
                                       DegradationLadder, trim_swap)
from repro_torch.models import transformer as T
from repro_torch.obs.memledger import LEDGER_TRACKS, MemoryLedger

torch.set_num_threads(1)      # tier-1 runs several xdist workers


# ------------------------------------------------------- the ladder alone
def test_ladder_descends_with_hold_and_recovers():
    lad = DegradationLadder(hold_iterations=2)
    assert lad.decide(FAILED, 10) == RUNG_TRIMMED
    assert lad.decide(FAILED, 11) is None        # hold window
    assert lad.decide(FAILED, 12) == RUNG_CONSERVATIVE
    assert lad.decide(FAILED, 14) == RUNG_NO_SWAP
    assert lad.decide(FAILED, 20) is None        # bottom rung holds
    assert lad.decide(HEALTHY, 22) == RUNG_CONSERVATIVE
    assert lad.decide(HEALTHY, 24) == RUNG_TRIMMED
    assert lad.decide(HEALTHY, 26) == RUNG_FULL
    assert lad.decide(HEALTHY, 30) is None       # already at full
    assert lad.n_descents == 3 and lad.n_ascents == 3


def test_ladder_degraded_goes_to_trimmed_only():
    lad = DegradationLadder(hold_iterations=0)
    assert lad.decide(DEGRADED, 1) == RUNG_TRIMMED
    assert lad.decide(DEGRADED, 5) is None       # never deeper on degraded


def test_ladder_reset_and_probe_throttle():
    lad = DegradationLadder(hold_iterations=0, probe_interval=4)
    assert not lad.should_probe(0)               # full rung: no probes
    lad.decide(FAILED, 1)
    assert lad.should_probe(2)
    assert not lad.should_probe(3)               # throttled
    assert lad.should_probe(6)
    lad.reset(7)
    assert lad.rung == RUNG_FULL
    assert any(t["why"] == "new-policy" for t in lad.transitions)


def test_trim_swap_drops_lowest_scores_within_budget(monkeypatch):
    entries = [SimpleNamespace(uid=i, score=float(i), nbytes=10)
               for i in range(10)]
    swap = SimpleNamespace(entries=entries)
    # dropping an entry raises the peak by its footprint: monotone in the
    # number dropped, exactly what the binary search assumes
    monkeypatch.setattr(
        ppol, "projected_peak",
        lambda prof, kept: 100 + (len(entries) - len(kept)) * 10)
    kept = trim_swap(None, swap, budget=130, max_drop_fraction=0.5)
    assert len(kept) == 7                        # 3 dropped: peak 130
    assert [e.uid for e in kept] == [3, 4, 5, 6, 7, 8, 9]  # lowest cut
    # budget below any drop: nothing to trim
    assert trim_swap(None, swap, budget=100, max_drop_fraction=0.5) is None
    # cap respected even with infinite headroom
    kept = trim_swap(None, swap, budget=10 ** 9, max_drop_fraction=0.3)
    assert len(kept) == 7


# ------------------------------------------------- through the runtime
@pytest.fixture
def fresh_ledger():
    old = obs.set_ledger(MemoryLedger())
    yield obs.ledger()
    obs.set_ledger(old)


def _runtime(frac=0.9):
    """A runtime over the reduced llama2-paper's grad dispatch with a
    lowered policy installed (its entries bound to the engine)."""
    cfg = PC.get_reduced("llama2_paper")
    model = T.init_model(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(0)
    tok = torch.as_tensor(rng.randint(0, cfg.vocab_size, (4, 64)))
    args = (model, {"tokens": tok, "labels": torch.roll(tok, -1, 1)}, 1.0)
    rt = ChameleonRuntime(
        ChameleonConfig(), lambda pol: S.make_grad_step(cfg, TrainConfig(),
                                                        pol), device="cpu")
    prof = rt._baseline_profile(args, 0.01)
    tl = pmem.build_timeline(prof)
    pol = ppol.generate_policy(
        prof, ChameleonConfig(groups_per_phase=cfg.num_layers),
        int(prof.static_bytes + frac * (tl.peak - prof.static_bytes)),
        timeline=tl)
    rt.profile = prof
    rt.applied = rt.executor.lower(pol, prof, remat_fallback=False)
    rt.executor.bind_release_points(rt.applied, rt.hostmem.engine)
    return rt, args, pol


def _iterate(rt, args):
    fn = rt.step_fn()
    fn(*args)
    rt.record_dispatch("train", fn, args)
    return rt.end_iteration(0.01)


def test_runtime_real_swaps_score_zero_error(fresh_ledger):
    """The grad dispatch's real policy_swap copies feed the ledger, and a
    clean iteration (every D2H retired at its promised release op)
    scores realized == ``SwapPolicy.projected_peak`` — error exactly 0."""
    rt, args, pol = _runtime()
    assert pol.entries
    for _ in range(3):
        _iterate(rt, args)
    led = obs.ledger()
    assert led.n_iterations == 3
    last = led.last()
    assert last["realized_peak"] == pol.projected_peak
    assert last["peak_error"] == 0.0
    assert last["n_failed"] == 0
    assert last["n_observed"] == len(pol.entries)   # every entry really moved
    assert last["conservation"]["ok"]               # slabs all recycled
    sb = led.scoreboard()
    assert sb["n"] == 3 and sb["max_abs_error"] == 0.0
    assert rt.stats()["obs"]["memory"]["iterations"] == 3
    tracks = led.counter_tracks()
    assert all(tracks[name] for name in LEDGER_TRACKS)
    eng = rt.hostmem.engine.by_class["policy_swap"]
    assert eng.bytes_out == eng.bytes_in == 3 * sum(
        e.nbytes for e in pol.entries)
    assert eng.released_at_op == 3 * len(pol.entries)


def _exact_step(rt, args, want):
    """One grad dispatch through the runtime, bit-equal to the plain grad
    step's ``want``, then the iteration's bookkeeping (the ladder's move);
    returns the rung it ends on."""
    fn = rt.step_fn()
    loss, grads, _ = fn(*args)
    assert torch.equal(loss, want[0])
    assert all(torch.equal(grads[k], want[1][k]) for k in grads)
    rt.record_dispatch("train", fn, args)
    rt.end_iteration(0.01)
    return rt.ladder.rung


def _failed_link_descent(rt, args, want):
    """Six iterations with every copy failing for good; the rungs."""
    rt._full_applied = rt.applied
    rt.machine.force_stable(0, "test")       # the ladder skips GenPolicy
    plan = faults.FaultPlan([faults.FaultSpec("engine.transfer_error",
                                              prob=1.0)])
    with faults.injected(plan):
        return [_exact_step(rt, args, want) for _ in range(6)]


def _want(args):
    grad = S.make_grad_step(PC.get_reduced("llama2_paper"), TrainConfig())
    return grad(*args)


def test_runtime_ladder_descends_on_a_failed_link(fresh_ledger):
    """Every copy of the executed policy fails for good (an armed fault
    plan): the engine keeps each source on the device, so the step stays
    bit-exact, link health reads FAILED, and the ladder walks the applied
    policy down its rungs — trimmed, the Algo-3 fit, the baseline — each
    rebinding the engine's release points."""
    rt, args, pol = _runtime()
    rungs = _failed_link_descent(rt, args, _want(args))
    assert rt.hostmem.engine.n_failed_out > 0
    assert rungs[-1] == RUNG_NO_SWAP
    assert [t["to"] for t in rt.ladder.transitions] == [
        "trimmed", "conservative", "no_swap"]
    assert rt.applied.fingerprint == rt.executor.baseline().fingerprint
    assert rt.hostmem.engine.planned_releases() == {}


def test_runtime_ladder_probes_walk_back_to_full(fresh_ledger):
    """The descent above, then the link heals (the plan disarmed): at the
    baseline rung the policy moves nothing, so only the probe bursts, one
    every ``probe_interval`` iterations, feed the health machine's recovery
    streak; once healthy the ladder climbs one rung per hold window, back
    to the full policy, and the step stays bit-exact at every rung."""
    rt, args, pol = _runtime()
    want = _want(args)
    assert _failed_link_descent(rt, args, want)[-1] == RUNG_NO_SWAP
    eng, lad = rt.hostmem.engine, rt.ladder
    log = obs.set_audit(obs.AuditLog())
    try:
        rungs = []
        for _ in range(4 * lad.probe_interval):
            rungs.append(_exact_step(rt, args, want))
            if rungs[-1] == RUNG_FULL:
                break
        probes = [e["step"] for e in obs.audit().tail(100, "ladder.probe")]
    finally:
        obs.set_audit(log)
    assert rungs[-1] == RUNG_FULL, lad.transitions
    assert eng.health.worst() == HEALTHY
    up = lad.transitions[3:]
    assert [t["to"] for t in up] == ["conservative", "trimmed", "full"]
    assert all(t["why"] == "recovery-probe" for t in up)
    assert lad.n_descents == lad.n_ascents == 3
    assert probes and all(b - a >= lad.probe_interval
                          for a, b in zip(probes, probes[1:]))
    assert rt.applied is rt._full_applied
    assert eng.planned_releases()              # the full policy's, rebound
