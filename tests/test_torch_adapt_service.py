"""The port's adaptation service (``repro_torch.adapt.service``): every case
of ``tests/test_adapt_service.py`` and the three adaptation-worker cases of
``tests/test_faults.py``, plus what the port adds.

* **swap-in protocol stress** — hundreds of iteration boundaries racing
  enqueue / publish / discard on the worker against the install poll:
  no torn install, a monotone generation counter, a balanced job ledger;
* **the worker's result against the reference pipeline's** —
  ``AdaptationPipeline.run`` is numpy in both packages, so the port's
  worker publishes exactly what the reference pipeline computes for the
  same profile and budget: knob, kind, predicted time and every entry;
* **crash hygiene and the watchdog** — a raising pipeline publishes the
  conservative fallback and the worker lives on; ``submit`` re-arms a dead
  thread; the fault sites ``adapt.worker`` and ``adapt.hang``;
* **speculative pre-generation** — a recurring A/B cycle parks the
  successor's policy, and every later switch is a hit;
* **the worker never touches the card** — ``submit`` refuses a callable
  profile, and ``ChameleonRuntime._baseline_profile`` (a replay of the
  grad dispatch) raises off the thread that built the runtime;
* the satellites of the reference file: MRL slice-window parity and the
  vectorized ``nearest`` miss path, held against the reference too.
"""
import threading
import time

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.adapt import AdaptSnapshot as RSnapshot
from repro.adapt import AdaptationPipeline as RPipeline
from repro.core.executor import Executor as RExecutor
from repro.core.mrl import MRL as RMRL
from repro_torch import faults, obs
from repro_torch.adapt import (VARIANT_KNOBS, AdaptResult, AdaptSnapshot,
                               AdaptationPipeline, AdaptationService)
from repro_torch.common.config import ChameleonConfig, PolicyStoreConfig
from repro_torch.core.executor import AppliedPolicy, Executor
from repro_torch.core.mrl import MRL
from repro_torch.core.runtime import ChameleonRuntime
from repro_torch.faults import FaultPlan, FaultSpec
from repro_torch.policystore import PolicyRecord, PolicyStore, fingerprint_tokens
from tests.test_torch_planning import _entry, cfgs, synth_profile, to_port


# ------------------------------------------------------------------ helpers
class _EchoPipeline:
    """Pipeline stand-in: returns a result that names the snapshot it was
    computed from (so a torn or mixed install is detectable), after an
    optional delay to widen the race window."""

    def __init__(self, delay=0.0, jitter=0.0, seed=0):
        self.executor = Executor(ChameleonConfig())
        self.delay, self.jitter = delay, jitter
        self._rng = np.random.RandomState(seed)   # worker thread only
        self.fail = False
        self.n_runs = 0

    def run(self, snap: AdaptSnapshot, *, pace_s: float = 0.0
            ) -> AdaptResult:
        self.n_runs += 1
        if self.delay or self.jitter:
            time.sleep(self.delay + self.jitter * float(self._rng.rand()))
        if self.fail:
            raise RuntimeError("injected pipeline crash")
        applied = AppliedPolicy(None, set(), set(), set(),
                                f"policy-for-{snap.iter_exact}")
        return AdaptResult(applied=applied, swap=None, knob=1.0,
                           kind="echo", tier="regen",
                           predicted_t=snap.t_iter, profile=None,
                           iter_exact=snap.iter_exact, step=snap.step)


def _snap(fp: str, step: int = 0) -> AdaptSnapshot:
    return AdaptSnapshot(t_iter=0.01, budget=1 << 30, iter_exact=fp,
                         step=step, profile=None)


# ------------------------------------------------- swap-in protocol stress
def test_stress_no_torn_install_monotone_epochs():
    """300 boundaries of drift / submit / poll racing the worker: every
    polled result is current and self-consistent, epochs never move
    backwards, and the job ledger balances."""
    svc = AdaptationService(_EchoPipeline(delay=0.0005, jitter=0.002),
                            "async")
    rng = np.random.RandomState(1234)
    live = None
    installs = 0
    last_epoch = svc.epoch
    try:
        for i in range(300):
            assert svc.epoch >= last_epoch          # monotone generations
            last_epoch = svc.epoch
            r = rng.rand()
            if live is None or r < 0.30:
                live = f"fp-{i}"                    # drift: supersede
                svc.invalidate("injected-drift")
                svc.submit(_snap(live, step=i))
            elif r < 0.45:
                # a re-submit without an epoch bump: older same-epoch
                # results must fail the fingerprint check
                live = f"fp-{i}"
                svc.submit(_snap(live, step=i))
            time.sleep(float(rng.rand()) * 0.001)
            res = svc.poll()                        # iteration boundary
            if res is not None:
                installs += 1
                assert res.epoch == svc.epoch       # never a stale epoch
                assert res.iter_exact == live       # never a stale stream
                assert res.applied.fingerprint == f"policy-for-{live}"
        assert svc.drain(timeout=30.0)
        if svc.poll() is not None:                  # flush the mailbox
            installs += 1
        svc.invalidate("final-flush")
        assert installs == svc.n_installed > 0
        assert svc.n_discarded > 0                  # drift really superseded
        assert svc.n_jobs == svc.n_installed + svc.n_discarded
    finally:
        svc.close()


def test_poll_rejects_stale_epoch_and_foreign_fingerprint():
    svc = AdaptationService(_EchoPipeline(), "async")
    try:
        svc.submit(_snap("A", step=1))
        assert svc.drain()
        svc.invalidate("drift")                     # supersedes A's result
        assert svc.poll() is None
        assert svc.n_discarded == 1

        svc.submit(_snap("B", step=2))
        assert svc.drain()
        svc.submit(_snap("C", step=3))              # same epoch, new stream
        deadline = time.monotonic() + 5.0
        while svc.poll() is None:                   # B is discarded, C
            assert time.monotonic() < deadline      # installs
            time.sleep(0.001)
        assert svc.n_installed == 1
        assert svc.n_discarded >= 2                 # A (epoch) + B (stream)
    finally:
        svc.close()


# ----------------------------- the worker's result = the reference pipeline's
def _planning_case(res_bytes=1 << 20, budget=3 << 20):
    """A reference profile, its port copy, and each package's pipeline run
    synchronously on it (the store off)."""
    ref = synth_profile(n_layers=8, ops_per_layer=10, res_bytes=res_bytes)
    rcfg, pcfg = cfgs(enabled=True)      # one link rate for both packages
    rres = RPipeline(rcfg, RExecutor(rcfg)).run(RSnapshot(
        profile=ref, t_iter=1.0, budget=budget, iter_exact="stream",
        step=7))
    pipe = AdaptationPipeline(pcfg, Executor(pcfg))
    snap = lambda: AdaptSnapshot(profile=to_port(ref), t_iter=1.0,
                                 budget=budget, iter_exact="stream", step=7)
    return rres, pipe, snap


def _same_result(got, want):
    assert got.kind == want.kind and got.tier == want.tier
    assert got.knob == want.knob
    assert got.predicted_t == want.predicted_t
    assert got.n_variants == want.n_variants
    assert got.applied.fingerprint == want.applied.fingerprint
    assert got.applied.offload == want.applied.offload
    if want.swap is None:
        assert got.swap is None
    else:
        assert ([_entry(e) for e in got.swap.entries]
                == [_entry(e) for e in want.swap.entries])
        assert got.swap.projected_peak == want.swap.projected_peak


@pytest.mark.parametrize("budget_mib", [3, 6])
def test_worker_result_equals_the_reference_pipeline(budget_mib):
    """The worker publishes exactly what a synchronous run of the same
    snapshot computes in the port and in the reference: the equivalence
    that makes an async install safe, exact because planning is numpy."""
    rres, pipe, snap = _planning_case(budget=budget_mib << 20)
    inline = pipe.run(snap())
    assert inline.kind == "genpolicy" and inline.swap is not None
    assert inline.n_variants == len(VARIANT_KNOBS)
    _same_result(inline, rres)
    svc = AdaptationService(pipe, "async")
    try:
        svc.submit(snap())
        assert svc.drain()
        res = svc.poll()
    finally:
        svc.close()
    assert res is not None and res.epoch == svc.epoch
    _same_result(res, rres)


def test_worker_result_with_a_store_equals_the_references():
    """With a policy store the worker classifies, generates and writes
    back; a second snapshot of the same program is a reuse hit — as in the
    reference."""
    rres, _, snap = _planning_case()
    from repro.policystore import DriftClassifier as RDrift
    from repro.policystore import PolicyStore as RStore
    from repro_torch.policystore import DriftClassifier
    rcfg, pcfg = cfgs(enabled=True)
    rpipe = RPipeline(rcfg, RExecutor(rcfg), store=RStore(rcfg.policystore),
                      drift=RDrift(rcfg.policystore))
    pipe = AdaptationPipeline(pcfg, Executor(pcfg),
                              store=PolicyStore(pcfg.policystore),
                              drift=DriftClassifier(pcfg.policystore))
    svc = AdaptationService(pipe, "async")
    try:
        got = []
        for _ in range(2):
            svc.submit(snap())
            assert svc.drain()
            got.append(svc.poll())
    finally:
        svc.close()
    ref = synth_profile(n_layers=8, ops_per_layer=10, res_bytes=1 << 20)
    want = [rpipe.run(RSnapshot(profile=ref, t_iter=1.0, budget=3 << 20,
                                iter_exact="stream", step=7))
            for _ in range(2)]
    assert [(r.kind, r.tier, r.knob) for r in got] == [
        (r.kind, r.tier, r.knob) for r in want]
    assert got[1].kind == "reuse"
    _same_result(got[0], want[0])


# --------------------------------------------------------- crash hygiene
def test_worker_crash_publishes_conservative_and_stays_alive():
    pipe = _EchoPipeline()
    pipe.fail = True
    svc = AdaptationService(pipe, "async")
    try:
        svc.submit(_snap("A", step=1))
        assert svc.drain()
        assert svc.n_failed == 1
        assert svc.stats()["worker_alive"]          # the loop survived
        res = svc.poll()
        assert res is not None
        assert res.kind == "conservative-fallback" and res.tier == "failed"
        assert res.applied.offload                  # offload-all fallback
        assert obs.audit().tail(5, kind="adaptation.failed")

        pipe.fail = False                           # the next job publishes
        svc.invalidate("retry")
        svc.submit(_snap("B", step=2))
        assert svc.drain()
        res = svc.poll()
        assert res is not None and res.kind == "echo"
        assert res.iter_exact == "B"
    finally:
        svc.close()


def test_submit_rearms_dead_worker():
    svc = AdaptationService(_EchoPipeline(), "async")
    svc.submit(_snap("A", step=1))
    assert svc.drain()
    svc.close()                                     # worker thread exits
    assert not svc.stats()["worker_alive"]
    svc.invalidate("restart")
    svc.submit(_snap("B", step=2))                  # re-arms the thread
    try:
        assert svc.stats()["worker_alive"]
        assert svc.drain()
        res = svc.poll()
        assert res is not None and res.iter_exact == "B"
    finally:
        svc.close()


# ------------------------------------------------ adaptation-worker faults
def test_adapt_worker_crash_publishes_conservative_fallback():
    svc = AdaptationService(_EchoPipeline(), "async")
    plan = FaultPlan([FaultSpec("adapt.worker", prob=1.0, max_fires=1)])
    with faults.injected(plan):
        svc.submit(_snap("fp-a", step=1))
        assert svc.drain(timeout=10.0)
    res = svc.poll()
    assert res is not None and res.kind == "conservative-fallback"
    assert svc.n_failed == 1
    svc.close()


def test_adapt_hang_trips_watchdog_once():
    svc = AdaptationService(_EchoPipeline(), "async")
    plan = FaultPlan([FaultSpec("adapt.hang", prob=1.0, seconds=1.0,
                                max_fires=1)])
    with faults.injected(plan):
        svc.submit(_snap("fp-b", step=2))
        time.sleep(0.1)
        assert svc.watchdog(0.05) is True
        assert svc.watchdog(0.05) is False       # fires at most once a job
    assert svc.n_watchdog == 1
    assert svc.stats()["watchdog_fired"] == 1
    svc.invalidate("worker-timeout")             # what the runtime does
    svc.drain(timeout=10.0)
    assert svc.poll() is None                    # the late result is dropped
    svc.close()


def test_watchdog_disabled_and_clean_poll_clears_timer():
    svc = AdaptationService(_EchoPipeline(), "async")
    svc.submit(_snap("fp-c", step=3))
    assert svc.watchdog(0.0) is False            # 0 disables
    svc.drain(timeout=10.0)
    assert svc.poll() is not None
    assert svc.watchdog(1e-9) is False           # the poll cleared the timer
    svc.close()


# --------------------------------------------------- speculative chaining
def test_speculative_recurring_cycle_parks_and_chains():
    """A/B/A/B...: after A -> B -> A is observed, the successor's policy
    is parked before its phase arrives, and every later switch is a hit
    with no new non-speculative job."""
    svc = AdaptationService(_EchoPipeline(), "speculative")

    def boundary(fp, step):
        """What the runtime does when a settled phase enters ADAPTING."""
        svc.invalidate("phase-switch")
        hit = svc.take_speculative(fp)
        if hit is not None:
            svc.note_adapted(fp)
            assert svc.drain()                      # let chained spec land
            return hit, True
        svc.submit(_snap(fp, step=step))
        assert svc.drain()
        return svc.poll(), False

    try:
        seq = ["A", "B", "A", "B", "A", "B"]
        hits = []
        for step, fp in enumerate(seq):
            res, was_spec = boundary(fp, step)
            assert res is not None
            assert res.iter_exact == fp
            assert res.applied.fingerprint == f"policy-for-{fp}"
            hits.append(was_spec)
        assert hits[:3] == [False, False, False]
        assert all(hits[3:])
        assert svc.n_spec_hits == len(seq) - 3
        assert svc.n_jobs - svc.n_spec_jobs == 3    # nothing inline after
    finally:
        svc.close()


def test_speculative_lru_bounds():
    svc = AdaptationService(_EchoPipeline(), "speculative", max_parked=2,
                            max_snapshots=3)
    try:
        for i in range(6):
            svc.submit(_snap(f"fp-{i}", step=i))
        assert svc.drain()
        st_ = svc.stats()
        assert st_["snapshots"] <= 3
        assert st_["parked"] <= 2
    finally:
        svc.close()


# ------------------------------------------ the worker never touches the card
def test_submit_refuses_a_callable_profile():
    """A callable profile would be a replay of the grad dispatch on the
    worker, beside the training step: refused before anything runs."""
    pipe = _EchoPipeline()
    svc = AdaptationService(pipe, "async")
    try:
        with pytest.raises(TypeError, match="callable"):
            svc.submit(AdaptSnapshot(profile=lambda: None, iter_exact="A"))
        assert svc.n_jobs == 0 and pipe.n_runs == 0
        assert not svc.stats()["worker_alive"]      # nothing was started
    finally:
        svc.close()


def test_baseline_profile_raises_off_the_runtimes_thread():
    """The replay runs only on the thread that built the runtime; a memo
    hit is only a dict read, so another thread may take that."""
    calls = []

    def step_builder(policy):
        def step(*args):
            calls.append(policy)
        return step

    rt = ChameleonRuntime(ChameleonConfig(enabled=False), step_builder,
                          device="cpu")
    import torch
    args = (torch.ones(3),)
    out = {}

    def worker():
        try:
            rt._baseline_profile(args, 1.0)
        except RuntimeError as e:
            out["err"] = str(e)

    th = threading.Thread(target=worker)
    th.start()
    th.join()
    assert "thread" in out["err"] and rt.replays == 0 and not calls
    prof = rt._baseline_profile(args, 0.5)         # the owner replays
    assert rt.replays == 1 and prof.t_iter == 0.5

    def memo():
        out["memo"] = rt._baseline_profile(args, 2.0)

    th = threading.Thread(target=memo)
    th.start()
    th.join()
    assert out["memo"].t_iter == 2.0 and rt.replays == 1


def test_service_modes_and_inline_bookkeeping():
    """An unknown placement raises; inline starts no worker."""
    with pytest.raises(ValueError, match="mode"):
        AdaptationService(_EchoPipeline(), "eager")
    svc = AdaptationService(_EchoPipeline(), "inline")
    assert svc.stats()["worker_alive"] is False
    svc.close()


# ----------------------------------------------------- satellite: MRL parity
@settings(max_examples=60, deadline=None)
@given(st.integers(0, 2 ** 31 - 1))
def test_mrl_window_parity_vs_masked_reference(seed):
    """covered_count / covered_counts / decrement through the sorted-ops
    window match the O(n) boolean-mask version and the reference's MRL on
    arbitrary [birth, death) queries, empty, inverted and out-of-range
    windows included."""
    r = np.random.RandomState(seed)
    ops = np.unique(r.randint(0, 200, size=r.randint(1, 64)))
    req = r.randint(-5, 1 << 20, size=ops.size).astype(np.int64)
    mrl, rmrl = MRL(ops.copy(), req.copy()), RMRL(ops.copy(), req.copy())
    ref = req.copy()
    for _ in range(12):
        birth = int(r.randint(-10, 220))
        death = int(r.randint(-10, 220))
        mask = (ops >= birth) & (ops < death)
        n = mrl.covered_count(birth, death)
        assert n == int(np.count_nonzero(ref[mask] > 0))
        assert n == rmrl.covered_count(birth, death)
        births = r.randint(-10, 220, size=5)
        deaths = r.randint(-10, 220, size=5)
        assert mrl.covered_counts(births, deaths).tolist() == [
            mrl.covered_count(int(b), int(d)) for b, d in zip(births, deaths)]
        nbytes = int(r.randint(0, 1 << 16))
        mrl.decrement(birth, death, nbytes)
        rmrl.decrement(birth, death, nbytes)
        ref[mask] -= nbytes
        np.testing.assert_array_equal(mrl.required, ref)
        np.testing.assert_array_equal(mrl.required, rmrl.required)
    assert mrl.is_empty() == bool(np.all(ref <= 0)) == rmrl.is_empty()
    assert mrl.max_required() == int(ref.max(initial=0))


# ------------------------------------- satellite: nearest() miss-path prune
def _record(fp):
    return PolicyRecord.from_policy(
        fingerprint=fp, prepare_fingerprint=fp, swap=None, candidates=[],
        n_ops=max(fp.length, 1), knob=1.0, measured_t=0.1, budget=1 << 30,
        policy_kind="conservative")


def test_nearest_true_miss_prunes_and_matches_exhaustive():
    """A query far from every record returns the exhaustive scan's answer
    after a handful of similarity evaluations, as the reference's does."""
    from repro import policystore as rps
    from repro.common.config import PolicyStoreConfig as RPSCfg
    rng = np.random.RandomState(3)
    store = PolicyStore(PolicyStoreConfig(max_records=512))
    rstore = rps.PolicyStore(RPSCfg(max_records=512))
    for i in range(200):
        t = rng.randint(1, 40, size=250 + i % 9).astype(np.int32)
        store.put(_record(fingerprint_tokens(t, cache=False)))
        rstore.put(rps.PolicyRecord.from_policy(
            fingerprint=rps.fingerprint_tokens(t, cache=False),
            prepare_fingerprint=rps.fingerprint_tokens(t, cache=False),
            swap=None, candidates=[], n_ops=t.size, knob=1.0,
            measured_t=0.1, budget=1 << 30, policy_kind="conservative"))
    q = np.arange(500, dtype=np.int32) % 11 + 300
    before, rbefore = store.n_sim_evals, rstore.n_sim_evals
    rec, sim = store.nearest(fingerprint_tokens(q, cache=False))
    evals = store.n_sim_evals - before
    rsim = rstore.nearest(rps.fingerprint_tokens(q, cache=False))[1]
    ex_rec, ex_sim = store.nearest_exhaustive(fingerprint_tokens(
        q, cache=False))
    assert sim == pytest.approx(ex_sim, abs=1e-9) and sim == rsim
    assert sim < store.cfg.warm_threshold           # really a miss
    assert evals <= 40 and evals == rstore.n_sim_evals - rbefore


def test_nearest_prune_never_changes_the_answer():
    """Pruned ``nearest`` equals the exhaustive scan across the hit / miss
    spectrum."""
    rng = np.random.RandomState(11)
    store = PolicyStore(PolicyStoreConfig(max_records=512))
    streams = []
    for i in range(80):
        t = rng.randint(1, 30, size=200 + (i % 5) * 17).astype(np.int32)
        streams.append(t)
        store.put(_record(fingerprint_tokens(t, cache=False)))
    for i in range(24):
        if i % 3 == 0:                              # near-recurrence
            base = streams[rng.randint(len(streams))]
            t = np.concatenate([base, base[: rng.randint(0, 9)]])
        elif i % 3 == 1:                            # mid-distance
            t = rng.randint(1, 60, size=rng.randint(150, 400))
        else:                                       # far miss
            t = rng.randint(100 + i, 140 + i, size=rng.randint(50, 600))
        q = fingerprint_tokens(t.astype(np.int32), cache=False)
        rec, sim = store.nearest(q)
        ex_rec, ex_sim = store.nearest_exhaustive(q)
        assert sim == pytest.approx(ex_sim, abs=1e-9)
