"""What Chameleon's detailed profile is priced at (``core.runtime``'s
module doc), and the copy stall the executor measures (``core.executor``).

The reference prices the grad step's profile at the whole iteration's
time (its trainer times the grad step, the optimizer step and the eval
together).  The port's trainer hands the runtime the grad dispatch's own
time, less that dispatch's measured copy stall, and the runtime prices the
GenPolicy step's profile and the async snapshot's at it; the variants'
measured time stays the iteration's.  A caller that gives no grad time
prices exactly as the reference does.

No card is here, so the copy stall runs with fake CUDA events in the
pattern of ``tests/test_torch_contention.py``: the engine's ``fence``
hands the executor a (need, done) pair whose ``need.elapsed_time(done)``
the test chooses, a late copy (positive) or one done first (negative).
The trainer's clock is replaced where a test needs a slow optimizer step
or an exact grad time.
"""
import dataclasses
import shutil
import tempfile

import numpy as np
import pytest
import torch

from repro.core.policy import generate_policy as rgenerate_policy
from repro.core.runtime import ChameleonRuntime as RRuntime
import repro_torch.configs as PC
from repro_torch.common.config import (ChameleonConfig, PolicyStoreConfig,
                                       TrainConfig)
from repro_torch.core.policy import generate_policy
from repro_torch.core.runtime import ChameleonRuntime
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.distributed import steps as S
from repro_torch.models import transformer as T
from repro_torch.policystore import PolicyStore
from repro_torch.runtime import trainer as trainer_mod
from repro_torch.runtime.trainer import Trainer
from tests.test_torch_adapt_placements import _ref_cfg, _to_ref
from tests.test_torch_planning import _entry

torch.set_num_threads(1)      # tier-1 runs several xdist workers

# the reduced llama2-paper's grad dispatch at 4 x 64 tokens peaks near
# 17.7 MB on the CPU: at 16 MiB its policies swap
BUDGET = 16 << 20
SLOW_APPLY_S = 5.0            # what the slowed optimizer step adds to dt


class _Clock:
    """The trainer module's ``time``: the host clock plus ``offset``."""

    def __init__(self, real):
        self.real, self.offset, self.frozen = real, 0.0, None

    def perf_counter(self):
        if self.frozen is not None:
            return self.frozen + self.offset
        return self.real.perf_counter() + self.offset


@pytest.fixture
def clock(monkeypatch):
    c = _Clock(trainer_mod.time)
    monkeypatch.setattr(trainer_mod, "time", c)
    return c


def _trainer(d, *, steps, budget=BUDGET, mode=None, store_dir=None):
    cfg = PC.get_reduced("llama2_paper")
    cham = ChameleonConfig(
        enabled=True, hbm_budget_bytes=budget,
        policystore=PolicyStoreConfig(enabled=store_dir is not None,
                                      dir=store_dir or ""))
    tcfg = TrainConfig(steps=steps, checkpoint_every=0, checkpoint_dir=d,
                       eval_every=0, warmup_steps=2, learning_rate=1e-3)
    return Trainer(cfg, tcfg, cham,
                   data=SyntheticTokens(cfg.vocab_size, 64, 4, seed=0),
                   adapt_mode=mode, device="cpu")


def _slow_apply(tr, clock):
    """The optimizer step takes SLOW_APPLY_S more on the trainer's clock."""
    inner = tr._apply.fn

    def slow(*a, **k):
        out = inner(*a, **k)
        clock.offset += SLOW_APPLY_S
        return out
    tr._apply.fn = slow


def _priced(rt):
    """Record every ``_baseline_profile`` call: (iteration, price)."""
    calls, inner = [], rt._baseline_profile

    def rec(args, t):
        calls.append((rt.step_idx - 1, t))
        return inner(args, t)
    rt._baseline_profile = rec
    return calls


@pytest.fixture
def tmpdir_():
    d = tempfile.mkdtemp()
    yield d
    shutil.rmtree(d, ignore_errors=True)


# ------------------------------------------------ the trainer's pricing
@pytest.mark.parametrize("mode", ["inline", "async"])
def test_slow_apply_step_does_not_price_the_profile(mode, clock, tmpdir_):
    """With the optimizer step slowed by SLOW_APPLY_S, every step's ``dt``
    carries it and its grad time does not; the GenPolicy step (inline) and
    the async snapshot price the replayed profile at the step's grad time,
    and inline variants keep the iteration's ``dt`` as their measured
    time."""
    tr = _trainer(tmpdir_, steps=14, mode=mode)
    _slow_apply(tr, clock)
    rt = tr.rt
    calls = _priced(rt)
    snaps, inner_snap = [], rt._snapshot
    rt._snapshot = lambda args, t, p: snaps.append(
        inner_snap(args, t, p)) or snaps[-1]
    try:
        rep = tr.train(14)
        rt.service.drain()
    finally:
        rt.close()
    assert all(dt > SLOW_APPLY_S for dt in rep.times)
    assert all(0.0 < g < 1.0 for g in rep.grad_times)
    assert [h["t_grad"] for h in rt.history] == rep.grad_times
    adapt_calls = [(i, t) for i, t in calls if i >= 0 and t != 1.0]
    assert adapt_calls                       # the adaptation priced one
    for i, t in adapt_calls:
        assert t == rep.grad_times[i], (i, t)
    if mode == "inline":
        assert "GenPolicy" in rep.stages
        assert rt.variants and all(v.measured_t > SLOW_APPLY_S
                                   for v in rt.variants)
        assert rt.profile.t_iter < 1.0
    else:
        # the profile is priced at the step's grad time, and the snapshot
        # carries the step's own time, which paces the worker (P11)
        assert snaps
        for s in snaps:
            assert s.profile.t_iter == rep.grad_times[s.step - 1]
            assert s.t_iter == rep.times[s.step - 1]


# a step's time on the card (llama2-paper, 8 layers, 2 x 3072 tokens):
# the slowed optimizer step puts dt above the worker's pace_s and under
# its cap, so the pace reads the step's time
CARD_STEP_S = 0.3


def test_worker_paces_by_the_iteration_time(clock, tmpdir_):
    """P11: the async worker sleeps ``min(max(pace_s, snapshot.t_iter),
    pace_cap_s)`` between variants, the reference's formula, and the
    snapshot's ``t_iter`` is the iteration's time as in the reference,
    while its profile stays priced at the grad time.  The reference's
    service, given a snapshot of the same ``t_iter`` and the same knobs,
    paces the same.  The trainer's clock is slowed, not the host: the
    pipeline runs unpaced (its sleeps are not what is held here)."""
    from repro.adapt import AdaptSnapshot as RSnapshot
    from repro.adapt import AdaptationService as RService

    tr = _trainer(tmpdir_, steps=14, mode="async")
    inner = tr._apply.fn

    def slow(*a, **k):
        out = inner(*a, **k)
        clock.offset += CARD_STEP_S
        return out
    tr._apply.fn = slow
    rt = tr.rt
    paced, run = [], rt.service.pipeline.run

    def record(snap, *, pace_s=0.0):
        paced.append((snap, pace_s))
        return run(snap, pace_s=0.0)
    rt.service.pipeline.run = record
    try:
        rep = tr.train(14)
        assert rt.service.drain()
    finally:
        rt.close()
    cfg = tr.cham.adapt
    assert paced and cfg.pace_s < CARD_STEP_S < cfg.pace_cap_s
    for snap, pace in paced:
        assert snap.t_iter == rep.times[snap.step - 1]
        assert snap.profile.t_iter == rep.grad_times[snap.step - 1]
        assert snap.profile.t_iter < CARD_STEP_S < snap.t_iter
        assert pace == min(max(cfg.pace_s, snap.t_iter), cfg.pace_cap_s)

    class _Echo:                       # the reference's pipeline stand-in
        def __init__(self):
            self.paces = []

        def run(self, snap, *, pace_s=0.0):
            self.paces.append(pace_s)
            raise RuntimeError("paced")   # published as a fallback

    echo = _Echo()
    ref = RService(echo, "async", pace_s=cfg.pace_s,
                   pace_cap_s=cfg.pace_cap_s)
    try:
        for snap, _ in paced:
            ref.submit(RSnapshot(t_iter=snap.t_iter, budget=BUDGET,
                                 iter_exact=snap.iter_exact,
                                 step=snap.step))
            assert ref.drain()
    finally:
        ref.close()
    assert echo.paces == [p for _, p in paced]


def test_store_record_round_trips_its_price(clock, tmpdir_):
    """The async worker's store record carries the price of the snapshot
    it was adapted from (the grad time, not ``dt``), and a store reopened
    from its directory rebuilds the policy at that price.  (The worker
    ranks variants by predicted time, so its winner is a swap policy
    wherever one fits; an inline winner is whichever variant's iteration
    ran fastest.)"""
    store = tempfile.mkdtemp(dir=tmpdir_)
    tr = _trainer(tmpdir_, steps=14, mode="async", store_dir=store)
    _slow_apply(tr, clock)
    rt = tr.rt
    snaps, inner_snap = [], rt._snapshot
    rt._snapshot = lambda args, t, p: snaps.append(
        inner_snap(args, t, p)) or snaps[-1]
    try:
        rep = tr.train(14)
        rt.service.drain()
    finally:
        rt.close()
    prices = {s.profile.t_iter for s in snaps}
    assert prices and all(p < 1.0 and p in rep.grad_times for p in prices)
    swapped = [r for r in rt.store.records() if r.policy_kind == "swap"]
    assert swapped, [r.policy_kind for r in rt.store.records()]
    for r in swapped:
        assert r.policy_meta["t_iter"] in prices
    again = PolicyStore(PolicyStoreConfig(enabled=True, dir=store))
    back = {r.key: r for r in again.records()}
    for r in swapped:
        assert back[r.key].swap_policy().t_iter == r.policy_meta["t_iter"]
        assert back[r.key].measured_t == r.measured_t


# ------------------------------------- without a grad time: the reference
def _grad_runtime(budget):
    cfg = PC.get_reduced("llama2_paper")
    model = T.init_model(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(0)
    tok = torch.as_tensor(rng.randint(0, cfg.vocab_size, (4, 64)))
    args = (model, {"tokens": tok, "labels": torch.roll(tok, -1, 1)}, 1.0)
    cham = ChameleonConfig(hbm_budget_bytes=budget,
                           policystore=PolicyStoreConfig(enabled=False))
    rt = ChameleonRuntime(
        cham, lambda pol: S.make_grad_step(cfg, TrainConfig(), pol),
        device="cpu")
    return rt, args


def _drive(rt, args, dts, grads=None):
    rt.prepare(args)
    for i, dt in enumerate(dts):
        fn = rt.step_fn()
        fn(*args)
        rt.record_dispatch("train", fn, args)
        if grads is None:
            rt.end_iteration(dt)
        else:
            rt.end_iteration(dt, grads[i])


def test_no_grad_time_prices_as_the_reference():
    """``end_iteration(dt)`` alone, as the reference-parity tests drive
    the runtime: each GenPolicy step prices the replayed profile at its
    iteration's ``dt``, as the reference's ``_genpolicy_step_body`` does,
    and Algo 2 on that priced profile gives the reference's policy entry
    for entry; given a grad time, the same profile is priced at it
    instead, and the variants' measured times stay the ``dt``s."""
    dts = [0.01 * (i + 1) for i in range(10)]
    rt, args = _grad_runtime(BUDGET)
    calls = _priced(rt)
    _drive(rt, args, dts)
    gen = [(i, t) for i, t in calls if i >= 0]
    assert gen and all(t == dts[i] for i, t in gen)
    assert len(rt.variants) == len(gen)
    base = rt._baseprof_cache[next(iter(rt._baseprof_cache))]
    for (i, t), var in zip(gen, rt.variants):
        assert var.measured_t == dts[i + 1]     # the next iteration ran it
        if var.swap is not None:
            assert var.swap.t_iter == t
        groups = max(1, int((base.scan_layers or 32) * var.knob))
        cfg_v = dataclasses.replace(rt.cfg, groups_per_phase=groups)
        prof = dataclasses.replace(base, t_iter=t)
        got, want = _policy_or_oom(generate_policy, prof, cfg_v), \
            _policy_or_oom(rgenerate_policy, _to_ref(prof), _ref_cfg(cfg_v))
        assert got == want
    # the reference's runtime takes no grad time at all
    assert "t_grad" not in RRuntime.end_iteration.__code__.co_varnames
    grads = [dt / 4 for dt in dts]
    rt2, args2 = _grad_runtime(BUDGET)
    calls2 = _priced(rt2)
    _drive(rt2, args2, dts, grads)
    gen2 = [(i, t) for i, t in calls2 if i >= 0]
    assert gen2 and all(t == grads[i] for i, t in gen2)
    assert [v.measured_t for v in rt2.variants] == [
        v.measured_t for v in rt.variants]


def _policy_or_oom(gen, prof, cfg):
    """Algo 2's policy as comparable values, or the error's class name."""
    try:
        pol = gen(prof, cfg, BUDGET)
    except Exception as e:  # noqa: BLE001 — each package's OOM error
        return type(e).__name__
    return (pol.t_iter, pol.stall_time, pol.projected_peak,
            [_entry(e) for e in pol.entries])


# ------------------------------------------- the measured copy stall
class _FakeEvent:
    def __init__(self, ms=0.0):
        self.ms = ms
        self.synced = False

    def synchronize(self):
        self.synced = True

    def elapsed_time(self, other):
        return other.ms


def _fake_fence(eng, ms, clock=None, wall_s=0.0):
    """The engine's fence on a card: a (need, done) pair per wait whose
    elapsed time is ``ms``; each advances the trainer's clock by
    ``wall_s`` (the host time the step spends)."""
    pairs = []

    def fence(ev, timed=False):
        if clock is not None:
            clock.offset += wall_s
        pair = (_FakeEvent(), _FakeEvent(ms))
        pairs.append(pair)
        return pair
    eng.fence = fence
    return pairs


@pytest.mark.parametrize("ms", [7.0, -3.0])
def test_fake_events_give_the_copy_stall_per_entry(ms, clock, tmpdir_):
    """A late done event (``ms`` > 0) is ``ms`` of copy stall for its
    entry, summed into ``copy_stall_s`` and taken off the step's grad
    time; one done first is 0.  The trainer's clock stands still but for
    2 * ``|ms|`` a fence, so the grad time is exact."""
    tr = _trainer(tmpdir_, steps=3)
    wall = 2 * abs(ms) / 1e3
    pairs = _fake_fence(tr.rt.hostmem.engine, ms, clock, wall)
    clock.frozen = 100.0
    try:
        tr.train(3)
    finally:
        tr.rt.close()
    ex = tr.rt._last_dispatch.execution
    assert ex is not None                  # the warm-up fit offloads
    last = ex.last
    n = len(last["stall_entries"])
    assert n > 0 and n == last["restored"]
    stall = max(ms, 0.0)
    assert all(e[2] == stall and e[1] > 0 for e in last["stall_entries"])
    assert last["fence_stall_s"] == pytest.approx(n * stall / 1e3)
    assert last["copy_stall_s"] == pytest.approx(n * stall / 1e3)
    assert all(need.synced and done.synced for need, done in pairs)
    # the last step's grad time: its fences' wall less their stall
    want = n * wall - n * stall / 1e3
    assert tr.report.grad_times[-1] == pytest.approx(want, abs=1e-12)
    assert tr.report.grad_times[-1] >= 0.0


def test_cpu_copies_measure_no_stall(tmpdir_):
    """On the CPU every copy is synchronous: no fence waits, no stall,
    and the grad time is the dispatch's wall; recompute and hook time are
    reported beside it."""
    tr = _trainer(tmpdir_, steps=3)
    try:
        tr.train(3)
    finally:
        tr.rt.close()
    last = tr.rt._last_dispatch.execution.last
    assert last["staged"] > 0
    assert last["stall_entries"] == [] and last["copy_stall_s"] == 0.0
    assert last["on_demand_s"] == last["forced_wait_s"] == 0.0
    assert last["hook_s"] > 0.0
    assert all(0.0 < g <= dt for g, dt in zip(tr.report.grad_times,
                                              tr.report.times))
