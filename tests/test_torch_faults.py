"""The robustness drill (``repro_torch.faults`` through the policy store,
the checkpoint manager, the trainer and the train CLI) against the
reference, on the CPU.

Ports of the tests of ``tests/test_faults.py`` that the plan, engine,
health, ladder and adapt files do not already hold: the arm / disarm audit
trail, the four policy-store crash and corruption cases, the four
checkpoint cases, and the trainer's straggler event run once on each
package from the same inputs (numpy, seeded), and must end in the same
record sets and counters, restore equal arrays and emit the same audit
kinds.  Then what only the port has to show:

  * P8, a torn checkpoint: a tensor updated in place after ``save()``
    must not leak into the checkpoint, whether its staging failed for good
    or no engine stages it (the reference's leaves are immutable);
  * the chaos trainer of ``test_chaos_trainer_descends_and_recovers``
    (marked slow there) at the reference's reduced llama2-paper and 12 MiB
    budget, shortened through its own ``ResilienceConfig``, with its fault
    window placed after the fault-free twin's first Stable step; and the
    reference chaos bench's ``drop_and_stall`` scenario, which reaches the
    engine's synchronous swap-in fallback through the executor (P9);
  * ``python -m repro_torch.launch.train --fault-plan``.
"""
import contextlib
import gc
import glob
import json
import os
import shutil
import tempfile
import threading
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.checkpointing.manager as RCkpt
import repro.hostmem as RH
from repro import faults as RF
from repro import obs as RO
from repro import policystore as RPS
from repro.common.config import PolicyStoreConfig as RPolicyStoreConfig
from repro.common.config import ResilienceConfig as RResilienceConfig
from repro.runtime.straggler import StragglerDetector as RStraggler
from repro.runtime.trainer import Trainer as RTrainer

import repro_torch.checkpointing.manager as PCkpt
import repro_torch.configs as PC
import repro_torch.hostmem as PH
import repro_torch.policystore as PPS
from repro_torch import faults as PF
from repro_torch import obs as PO
from repro_torch.common.config import (ChameleonConfig, PolicyStoreConfig,
                                       ResilienceConfig, TrainConfig)
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.faults import HEALTHY
from repro_torch.hostmem.engine import SWAP_IN, SWAP_OUT, TransferEvent
from repro_torch.launch import train as train_cli
from repro_torch.runtime.straggler import StragglerDetector
from repro_torch.runtime.trainer import Trainer

torch.set_num_threads(1)      # tier-1 runs several xdist workers

REF = SimpleNamespace(
    name="ref", faults=RF, obs=RO, ps=RPS, PSC=RPolicyStoreConfig,
    ckpt=RCkpt.CheckpointManager, arr=lambda a: a,
    engine=lambda rs: RH.TransferEngine(RH.PinnedSlabPool(), resilience=rs),
    RC=RResilienceConfig)
PORT = SimpleNamespace(
    name="port", faults=PF, obs=PO, ps=PPS, PSC=PolicyStoreConfig,
    ckpt=PCkpt.CheckpointManager, arr=lambda a: torch.from_numpy(a.copy()),
    engine=lambda rs: PH.TransferEngine(PH.PinnedSlabPool(), resilience=rs,
                                        device="cpu"),
    RC=ResilienceConfig)
SIDES = (REF, PORT)


@pytest.fixture(autouse=True)
def _always_disarmed():
    """No test leaks an armed fault plan, on either package."""
    RF.disarm()
    PF.disarm()
    yield
    RF.disarm()
    PF.disarm()


@contextlib.contextmanager
def _fresh_audit(side):
    """A side's audit log replaced by an empty one for the block."""
    old = side.obs.set_audit(side.obs.AuditLog())
    try:
        yield side.obs.audit()
    finally:
        side.obs.set_audit(old)


def _kinds(log):
    return [e["kind"] for e in log.tail(10_000)]


def _both(fn):
    """``fn(side, tmpdir)`` on each package, each in its own directory."""
    out = []
    for side in SIDES:
        d = tempfile.mkdtemp()
        try:
            with _fresh_audit(side) as log:
                res = fn(side, d)
                out.append((res, _kinds(log)))
        finally:
            shutil.rmtree(d, ignore_errors=True)
    return out


# ------------------------------------------------------------- the audit
def test_arm_disarm_and_audit_trail():
    def run(side, _d):
        plan = side.faults.FaultPlan(
            [side.faults.FaultSpec("store.load", prob=1.0)], seed=3)
        with side.faults.injected(plan):
            assert side.faults.active() is plan
            hit = side.faults.inject("store.load", key="rec")
        assert side.faults.active() is None
        return hit is not None, plan.total_fired()

    (ref, ref_kinds), (port, port_kinds) = _both(run)
    assert ref == port == (True, 1)
    assert port_kinds == ref_kinds == ["fault.armed", "fault.injected",
                                       "fault.disarmed"]


def test_straggler_callback_emits_audit_event():
    """The trainer's ``straggler.flagged`` event carries the reference's
    fields and values for the same wall times."""
    def run(side, _d):
        det_cls, tr_cls = ((RStraggler, RTrainer) if side is REF
                           else (StragglerDetector, Trainer))
        det = det_cls(threshold_sigma=3.0, warmup=2,
                      on_straggler=lambda ev: tr_cls._on_straggler(None, ev))
        for s in range(8):
            det.observe(s, 0.01 + 0.0001 * (s % 2))
        assert det.observe(8, 10.0) is True
        ev = side.obs.audit().tail(5, kind="straggler.flagged")[-1]
        return {k: v for k, v in ev.items() if k not in ("t", "seq")}

    (ref, ref_kinds), (port, port_kinds) = _both(run)
    assert port == ref
    assert port["step"] == 8 and port["wall"] == 10.0
    assert port_kinds == ref_kinds and set(port_kinds) == {
        "straggler.flagged"}


# ------------------------------------------------------ the policy store
def _mini_store(side, d, n=3):
    store = side.ps.PolicyStore(side.PSC(dir=d))
    for i in range(n):
        fp = side.ps.fingerprint_tokens(np.arange(100) % (i + 5) + 1)
        store.put(side.ps.PolicyRecord.from_policy(
            fingerprint=fp, prepare_fingerprint=fp, swap=None,
            candidates=[], n_ops=100, knob=1.0, measured_t=0.1,
            budget=1 << 20, policy_kind="conservative"))
    return store


def _store_state(store):
    keys = sorted(r.key for r in store.records())
    assert store.index.keys() == set(keys)   # the index matches the records
    return {"keys": keys, "n_corrupt": store.n_corrupt,
            "n_io_errors": store.n_io_errors,
            "n_index_rebuilds": store.n_index_rebuilds}


def test_store_injected_corrupt_record_skipped_on_load():
    def run(side, d):
        _mini_store(side, d, n=3)
        plan = side.faults.FaultPlan(
            [side.faults.FaultSpec("store.load", prob=1.0, max_fires=1)])
        with side.faults.injected(plan):
            store = side.ps.PolicyStore(side.PSC(dir=d))
        assert len(store) == 2 and store.n_corrupt == 1
        return _store_state(store)

    (ref, ref_kinds), (port, port_kinds) = _both(run)
    assert port == ref
    assert port_kinds == ref_kinds


def test_store_mid_put_crash_is_atomic():
    """A writer dying mid-persist leaves a ``*.tmp``; the record file and
    the next attach are unaffected, and ``put()`` never raises."""
    def run(side, d):
        store = _mini_store(side, d, n=1)
        rec = store.records()[0]
        path = os.path.join(d, rec.key + ".json")
        with open(path) as f:
            before = f.read()
        rec.knob = 9.0
        plan = side.faults.FaultPlan(
            [side.faults.FaultSpec("store.put", prob=1.0, max_fires=1)])
        with side.faults.injected(plan):
            store.put(rec)                       # must not raise
        assert store.n_io_errors == 1
        with open(path) as f:
            assert f.read() == before
        tmp = [os.path.basename(p) for p in
               glob.glob(os.path.join(d, "*.json.tmp"))]
        assert tmp
        fresh = side.ps.PolicyStore(side.PSC(dir=d))
        assert len(fresh) == 1 and fresh.n_corrupt == 0
        return {"tmp": tmp, "writer": _store_state(store),
                "fresh": _store_state(fresh)}

    (ref, ref_kinds), (port, port_kinds) = _both(run)
    assert port == ref
    assert "store.io_error" in port_kinds and port_kinds == ref_kinds


def test_store_truncated_index_rebuilds_silently():
    def run(side, d):
        store = _mini_store(side, d, n=3)
        idx_path = os.path.join(d, "lsh.index")
        with open(idx_path) as f:
            payload = f.read()
        with open(idx_path, "w") as f:
            f.write(payload[: len(payload) // 3])    # truncated mid-write
        fresh = side.ps.PolicyStore(side.PSC(dir=d))
        assert len(fresh) == 3 and fresh.n_index_rebuilds == 1
        with open(idx_path) as f:
            json.load(f)                  # re-persisted in valid form
        assert fresh.index.keys() == {r.key for r in store.records()}
        return _store_state(fresh)

    (ref, ref_kinds), (port, port_kinds) = _both(run)
    assert port == ref
    assert port_kinds == ref_kinds


def test_store_crash_between_record_write_and_index_update():
    """The record file lands, the index flush does not: the next attach
    sees the key-set mismatch and rebuilds instead of serving a partial
    index."""
    def run(side, d):
        _mini_store(side, d, n=2)
        fp = side.ps.fingerprint_tokens(np.arange(100) % 13 + 1)
        rec = side.ps.PolicyRecord.from_policy(
            fingerprint=fp, prepare_fingerprint=fp, swap=None, candidates=[],
            n_ops=100, knob=1.0, measured_t=0.1, budget=1 << 20,
            policy_kind="conservative")
        with open(os.path.join(d, rec.key + ".json"), "w") as f:
            json.dump(rec.to_json(), f)
        fresh = side.ps.PolicyStore(side.PSC(dir=d))
        assert len(fresh) == 3 and fresh.n_index_rebuilds == 1
        return _store_state(fresh)

    (ref, ref_kinds), (port, port_kinds) = _both(run)
    assert port == ref
    assert port_kinds == ref_kinds


# ------------------------------------------------------- the checkpoints
def _ckpt_trees(side, v):
    return {"arrays": {"w": side.arr(np.full((4, 4), v, np.float32)),
                       "b": side.arr(np.arange(6, dtype=np.float32) + v)}}


def _restored(side, mgr, step, **kw):
    out, extra = mgr.restore(step, _ckpt_trees(side, 0.0), **kw)
    return ({k: np.asarray(v) for k, v in out["arrays"].items()},
            extra["step"])


def test_ckpt_restore_falls_back_on_bit_flip():
    def run(side, d):
        mgr = side.ckpt(d, process_index=0)
        mgr.save(1, _ckpt_trees(side, 1.0), extra={"step": 1}, block=True)
        mgr.save(2, _ckpt_trees(side, 2.0), extra={"step": 2}, block=True)
        shard = os.path.join(d, "step_00000002", "arrays.p0.npz")
        with open(shard, "rb") as f:
            raw = bytearray(f.read())
        raw[len(raw) // 2] ^= 0xFF                   # bit-flip mid-file
        with open(shard, "wb") as f:
            f.write(raw)
        with pytest.raises(IOError, match=r"arrays\.p0\.npz"):
            mgr.restore(2, _ckpt_trees(side, 0.0), fallback=False)
        arrays, step = _restored(side, mgr, 2)
        assert step == 1 and mgr.n_restore_fallbacks == 1
        return arrays, step

    (ref, ref_kinds), (port, port_kinds) = _both(run)
    assert port[1] == ref[1]
    for k in ref[0]:
        np.testing.assert_array_equal(port[0][k], ref[0][k])
    np.testing.assert_array_equal(port[0]["w"], np.full((4, 4), 1.0))
    assert {"ckpt.restore_failed", "ckpt.restore_fallback"} <= set(port_kinds)
    assert port_kinds == ref_kinds


def test_ckpt_write_fault_retries_then_succeeds():
    def run(side, d):
        mgr = side.ckpt(d, process_index=0)
        plan = side.faults.FaultPlan(
            [side.faults.FaultSpec("ckpt.write", prob=1.0, max_fires=1)])
        with side.faults.injected(plan):
            mgr.save(5, _ckpt_trees(side, 5.0), extra={"step": 5},
                     block=True)
        return _restored(side, mgr, 5)

    (ref, ref_kinds), (port, port_kinds) = _both(run)
    assert port[1] == ref[1] == 5
    for k in ref[0]:
        np.testing.assert_array_equal(port[0][k], ref[0][k])
    assert "ckpt.write_retry" in port_kinds and port_kinds == ref_kinds


def test_ckpt_degrade_mode_survives_write_failure():
    """``on_error="degrade"`` survives a write failure that beats the
    retries; ``raise`` mode still fails the ``wait()``."""
    def run(side, d):
        mgr = side.ckpt(d, process_index=0, on_error="degrade")
        always = [side.faults.FaultSpec("ckpt.write", prob=1.0)]
        with side.faults.injected(side.faults.FaultPlan(always)):
            mgr.save(3, _ckpt_trees(side, 3.0), extra={"step": 3})
            mgr.wait()
        assert mgr.n_write_failures == 1 and mgr.all_steps() == []
        strict = side.ckpt(d, process_index=0)
        with side.faults.injected(side.faults.FaultPlan(always)):
            strict.save(4, _ckpt_trees(side, 4.0), extra={"step": 4})
            with pytest.raises(RuntimeError,
                               match="checkpoint write failed"):
                strict.wait()
        return strict.all_steps(), strict.n_write_failures

    (ref, ref_kinds), (port, port_kinds) = _both(run)
    assert port == ref == ([], 1)
    assert "ckpt.write_failed" in port_kinds and port_kinds == ref_kinds


def test_ckpt_collect_snapshots_failed_staging_from_hbm():
    """With the engine's checkpoint-class staging failing for good, the
    writer takes the retained arrays instead of crashing, and every slab
    is released once."""
    def run(side, d):
        eng = side.engine(side.RC(retry_backoff_s=0.0, max_retries=0))
        mgr = side.ckpt(d, process_index=0, engine=eng)
        plan = side.faults.FaultPlan(
            [side.faults.FaultSpec("engine.transfer_error", prob=1.0)])
        with side.faults.injected(plan):
            mgr.save(9, _ckpt_trees(side, 9.0), extra={"step": 9},
                     block=True)
        out = _restored(side, mgr, 9)
        assert eng.pool.live_blocks == 0
        eng.pool.check()
        return out, eng.n_failed_out

    (ref, ref_kinds), (port, port_kinds) = _both(run)
    assert port[1] == ref[1] == 2
    for k in ref[0][0]:
        np.testing.assert_array_equal(port[0][0][k], ref[0][0][k])
    np.testing.assert_array_equal(port[0][0]["w"], np.full((4, 4), 9.0))
    # the same events; the port issues each copy (and fires its fault) at
    # submission, the reference when the copy retires, so they interleave
    # differently
    assert "engine.swap_out_failed" in port_kinds
    assert Counter(port_kinds) == Counter(ref_kinds)


@pytest.mark.parametrize("staging", ["failed", "none"])
def test_ckpt_restores_the_values_of_save_after_an_inplace_update(
        staging, monkeypatch, tmp_path):
    """P8: an async ``save(9)`` of tensors, then an in-place update (the
    next optimizer step) before the writer thread reads them; ``restore(9)``
    must give the values of ``save()``, as the reference's does.  The
    writer is held until the update is done.  ``failed``: the engine's
    checkpoint staging fails for good at issue, so the engine holds the
    live tensor; ``none``: no engine, the CPU tensor's numpy view."""
    gate = threading.Event()
    body = PCkpt.CheckpointManager._write_body

    def held(self, *a):
        assert gate.wait(30.0)
        return body(self, *a)

    monkeypatch.setattr(PCkpt.CheckpointManager, "_write_body", held)
    eng = (PORT.engine(ResilienceConfig(retry_backoff_s=0.0, max_retries=0))
           if staging == "failed" else None)
    mgr = PCkpt.CheckpointManager(str(tmp_path), process_index=0, engine=eng)
    trees = _ckpt_trees(PORT, 9.0)
    plan = PF.FaultPlan([PF.FaultSpec("engine.transfer_error", prob=1.0)])
    with PF.injected(plan):
        mgr.save(9, trees, extra={"step": 9})
        for t in trees["arrays"].values():
            t.add_(1.0)
        gate.set()
        mgr.wait()
    assert plan.total_fired() == (2 if eng is not None else 0)
    arrays, step = _restored(PORT, mgr, 9)
    want = _ckpt_trees(REF, 9.0)["arrays"]
    assert step == 9
    for k in want:
        np.testing.assert_array_equal(arrays[k], want[k])
    if eng is not None:
        assert eng.n_failed_out == 2 and eng.pool.live_blocks == 0
        eng.pool.check()


# ------------------------------------------------------ the chaos trainer
CHAOS_BUDGET = 12 << 20      # the reference test's budget
CHAOS_STEPS = 36
# probes every 4 steps and a one-step hold (the defaults are 8 and 2):
# no_swap -> full in ~15 steps after the window instead of ~30
CHAOS_RESILIENCE = dict(probe_interval=4, ladder_hold_iterations=1)


def _chaos_trainer(d):
    cfg = PC.get_reduced("llama2_paper")
    tcfg = TrainConfig(steps=CHAOS_STEPS, checkpoint_every=0,
                       checkpoint_dir=d, eval_every=0, warmup_steps=2,
                       learning_rate=1e-3)
    cham = ChameleonConfig(enabled=True, hbm_budget_bytes=CHAOS_BUDGET,
                           resilience=ResilienceConfig(**CHAOS_RESILIENCE))
    return Trainer(cfg, tcfg, cham,
                   data=SyntheticTokens(cfg.vocab_size, 64, 4, seed=0),
                   device="cpu")


@pytest.fixture(scope="module")
def twin():
    """The fault-free run both chaos runs are held to, and their fault
    window: ten steps from two after its first Stable step (the first
    install of a selected policy, which swaps at this budget)."""
    d = tempfile.mkdtemp()
    try:
        tr = _chaos_trainer(d)
        rep = tr.train(CHAOS_STEPS)
        eng = tr.rt.hostmem.engine
        assert not rep.failures and not tr.rt.ladder.transitions
        assert eng.health.worst() == HEALTHY
        first = rep.stages.index("Stable")
        assert eng.by_class["policy_swap"].bytes_out > 0
        yield SimpleNamespace(losses=list(rep.losses),
                              window=dict(start=first + 2, stop=first + 12))
        tr.rt.close()
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _chaos(twin, specs):
    """One chaos run under ``specs``; every check common to the reference
    bench's scenarios (no crash, fired, bit-equal losses, no live slab),
    and no failed copy outliving its step (P10: its traceback kept the
    step's activations alive)."""
    d = tempfile.mkdtemp()
    try:
        with _fresh_audit(PORT) as log:
            tr = _chaos_trainer(d)
            plan = PF.FaultPlan(specs, seed=1)
            with PF.injected(plan):
                rep = tr.train(CHAOS_STEPS)
            kinds = set(_kinds(log))
        tr.rt.close()
        eng = tr.rt.hostmem.engine
        assert not rep.failures
        assert plan.total_fired() > 0
        assert rep.losses == twin.losses          # bit-equal, every step
        assert eng.pool.live_blocks == 0
        eng.pool.check()
        gc.collect()
        assert not [o for o in gc.get_objects()
                    if type(o) is TransferEvent and o.failed]
        return tr, eng, kinds
    finally:
        shutil.rmtree(d, ignore_errors=True)


def test_chaos_trainer_descends_and_recovers(twin):
    """The reference's integration bar: an engine-fault window never
    crashes the run, walks the ladder down while the link is bad, and the
    probes walk it back up after; the audit log shows the chain."""
    tr, eng, kinds = _chaos(twin, [PF.FaultSpec(
        "engine.transfer_error", prob=1.0, **twin.window)])
    lad = tr.rt.ladder
    assert eng.n_retries > 0 and eng.n_failed_out > 0
    assert lad.n_descents >= 1, lad.transitions
    assert lad.n_ascents >= 1, lad.transitions     # probe-driven recovery
    assert eng.health.worst() == HEALTHY
    assert {"fault.injected", "engine.retry", "ladder.transition",
            "ladder.probe"} <= kinds


def test_chaos_trainer_drop_and_stall_is_bit_exact(twin):
    """The reference bench's ``drop_and_stall``: dropped and stalled copies
    are retried, retained on the device or, for a swap-in, fetched by the
    synchronous fallback, which the executor reaches through ``fence``
    (P9: the executor read a swap-in's result before it existed)."""
    _, eng, kinds = _chaos(twin, [
        PF.FaultSpec("engine.transfer_drop", prob=0.3, **twin.window),
        PF.FaultSpec("engine.transfer_stall", prob=0.2, seconds=0.002,
                     **twin.window)])
    assert eng.n_retries > 0
    assert eng.n_sync_fallback_in > 0 and eng.n_hbm_fallback_in > 0
    assert {"engine.sync_fallback_in", "engine.hbm_fallback_in"} <= kinds


# ---------------------------------------------------------------- the CLI
def test_train_cli_fault_plan(tmp_path, capsys):
    """``--fault-plan`` arms the plan before the trainer is built and
    disarms it on exit; both summary lines print, ``main`` returns the
    count and the ladder's moves, and ``--audit-out`` holds the faults."""
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps(PF.FaultPlan([PF.FaultSpec(
        "engine.transfer_error", prob=1.0, start=2, stop=6)], seed=1
    ).to_json()))
    audit = tmp_path / "audit.jsonl"
    out = train_cli.main([
        "--arch", "llama2-paper", "--reduced", "--device", "cpu",
        "--steps", "8", "--seq", "64", "--global-batch", "4",
        "--budget-gib", str(CHAOS_BUDGET / 2 ** 30),
        "--ckpt-dir", str(tmp_path / "ckpt"), "--fault-plan", str(plan),
        "--audit-out", str(audit)])
    assert not PF.armed()
    text = capsys.readouterr().out
    assert f"fault plan: fired={out['fault_fired']}" in text
    assert out["fault_fired"] > 0
    lad = out["ladder"]
    assert lad and lad[0]["why"] == "health-failed"
    descents = sum(t["why"] == "health-failed" for t in lad)
    assert f"descents={descents} " in text and "ladder: rung=" in text
    kinds = [json.loads(ln)["kind"] for ln in audit.read_text().splitlines()]
    assert kinds[0] == "fault.armed" and "fault.injected" in kinds
    assert "fault.disarmed" in kinds


# ------------------------------- 12d: a terminal swap-in failure, timeouts
TERMINAL_STEPS = 24           # the terminal step, then the ladder's answer
STALL_S = 0.1                 # twice ResilienceConfig.timeout_floor_s
HEALTH_WHY = ("health-failed", "health-degraded", "recovery-probe")


class _Clock:
    """A module's ``time``: ``perf_counter`` advances ``tick`` a call and
    ``sleep`` advances it instead of sleeping.  In an engine module a
    copy's measured time is then its injected stall (and its backoffs);
    in a trainer module an iteration's time, which prices the detailed
    profile and ranks the inline variants, is the same in every run: the
    policies do not depend on the host's load."""

    def __init__(self, tick=1e-6):
        self.t, self.tick = 0.0, tick

    def perf_counter(self):
        self.t += self.tick
        return self.t

    def sleep(self, s):
        self.t += max(float(s), 0.0)


def _terminal_swap_ins(side, eng, method, in_step):
    """Every swap-in of the step ``in_step()`` says is the terminal one
    fails for good after its swap-out staged: the engine's ``method`` (the
    port issues a copy at ``submit_swap_in``, the reference at
    ``_execute``) runs with a drop-everything plan armed for that call
    alone (the plan has no direction filter, in either package).  Returns
    the count of such swap-ins."""
    inner, plan, n = getattr(eng, method), side.faults.FaultPlan(
        [side.faults.FaultSpec("engine.transfer_drop", prob=1.0)],
        seed=1), [0]

    def call(ev_or_src, *a, **k):
        if not in_step() or (method == "_execute"
                             and ev_or_src.kind != SWAP_IN):
            return inner(ev_or_src, *a, **k)
        n[0] += 1
        side.faults.arm(plan)
        try:
            return inner(ev_or_src, *a, **k)
        finally:
            side.faults.disarm()
    setattr(eng, method, call)
    return n


def _scenario(name, window):
    """(steps, ResilienceConfig fields, fault specs, terminal step)."""
    if name == "swap_in_terminal":
        return TERMINAL_STEPS, {"max_retries": 1}, None, window["start"]
    return CHAOS_STEPS, {}, [dict(site="engine.transfer_stall", prob=0.3,
                                  seconds=STALL_S, **window)], None


def _counters(eng):
    return (eng.n_sync_fallback_in, eng.n_hbm_fallback_in, eng.n_timeouts,
            eng.n_retries, eng.n_failed_out, eng.n_failed_in)


def _port_scenario(name, window, rtr, monkeypatch):
    """The port's chaos trainer under the scenario, from the reference
    trainer's initial state, its engine and trainer modules on ``_Clock``.
    Returns (report, the stream of what fed its engine's health and
    ladder, per-step counters, ladder transitions, terminal swap-ins)."""
    from repro_torch.hostmem import engine as PE
    from repro_torch.runtime import trainer as PT
    from tests.test_torch_training import _start_from_reference
    steps, res, specs, term = _scenario(name, window)
    monkeypatch.setattr(PE, "time", _Clock())
    monkeypatch.setattr(PT, "time", _Clock(1e-3))
    d = tempfile.mkdtemp()
    try:
        cfg = PC.get_reduced("llama2_paper")
        tr = Trainer(cfg, TrainConfig(
            steps=steps, checkpoint_every=0, checkpoint_dir=d,
            eval_every=0, warmup_steps=2, learning_rate=1e-3),
            ChameleonConfig(enabled=True, hbm_budget_bytes=CHAOS_BUDGET,
                            resilience=ResilienceConfig(
                                **CHAOS_RESILIENCE, **res)),
            data=SyntheticTokens(cfg.vocab_size, 64, 4, seed=0),
            device="cpu")
        _start_from_reference(tr, rtr)
        rt, eng = tr.rt, tr.rt.hostmem.engine
        lad, stream, ids = rt.ladder, [], {}
        # what the engine's copies did, in the order they retired: each
        # attempt's stall and failure, and the copy itself
        attempts = {}
        copy_once, execute = eng._copy_once, eng._execute

        def rec_copy_once(ev):
            ev._stall_s = 0.0
            try:
                copy_once(ev)
            except Exception:
                attempts.setdefault(ev.eid, []).append((ev._stall_s, True))
                raise
            attempts.setdefault(ev.eid, []).append((ev._stall_s, False))

        def rec_execute(ev):
            execute(ev)
            stream.append(("copy", ev.eid, ev.kind, ev.nbytes, ev.tag,
                           ev.cls, ids.get(ev.eid),
                           getattr(ev, "_free_block", True),
                           attempts.pop(ev.eid, [])))
        submit_in = eng.submit_swap_in

        def rec_submit_in(src, tag="", free_block=True, cls=None):
            ev = submit_in(src, tag, free_block, cls)
            ids[ev.eid] = getattr(src, "eid", None)
            if ev.done and ev.result is not None and getattr(
                    src, "failed", False):            # a retained source
                stream.append(("hbm_fallback", ev.eid, src.eid, tag))
            return ev
        eng._copy_once, eng._execute = rec_copy_once, rec_execute
        eng.submit_swap_in = rec_submit_in
        n_term = (_terminal_swap_ins(PORT, eng, "submit_swap_in",
                                     lambda: tr.step == term)
                  if term is not None else None)
        should_probe, decide = lad.should_probe, lad.decide

        def rec_probe(step):
            p = should_probe(step)
            stream.append(("probe?", step, p))
            return p

        def rec_decide(worst, step):
            stream.append(("decide", step, worst))
            return decide(worst, step)
        lad.should_probe, lad.decide = rec_probe, rec_decide
        note_pressure = eng.health.note_pressure

        def rec_pressure(cls, severe=False):
            stream.append(("pressure", cls, severe))
            return note_pressure(cls, severe)
        eng.health.note_pressure = rec_pressure
        per_step = []

        def hook(step):
            per_step.append((_counters(eng), eng.health.worst()))
            stream.append(("end", step))
        plan = (PF.FaultPlan([PF.FaultSpec(**s) for s in specs], seed=1)
                if specs else None)
        with contextlib.ExitStack() as stack:
            if plan is not None:
                stack.enter_context(PF.injected(plan))
            rep = tr.train(steps, fault_hook=hook)
        tr.rt.close()
        assert eng.pool.live_blocks == 0
        eng.pool.check()
        return SimpleNamespace(
            rep=rep, stream=stream, per_step=per_step,
            transitions=[(t["step"], t["to"], t["why"])
                         for t in lad.transitions],
            terminal=n_term[0] if n_term else None, term=term,
            fired=plan.stats()["fired"] if plan else {}, cham=tr.cham)
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _replay_on_reference(port, monkeypatch):
    """The port run's copies, in the order they retired and with each
    attempt's stall and failure, through the reference's engine (from the
    reference's tier for the same ChameleonConfig) on ``_Clock``;
    its health fed the same memory-pressure notes, and the reference's
    ladder asked at the same points.  Returns per-step (counters, worst
    health), the ladder's transitions and its probe answers."""
    from repro.faults.ladder import DegradationLadder as RLadder
    from repro.hostmem import engine as RE
    from tests.test_torch_adapt_placements import _ref_cfg
    clock = _Clock()
    monkeypatch.setattr(RE, "time", clock)
    rcfg = _ref_cfg(port.cham)
    eng = RH.HostMemTier.from_chameleon(rcfg).engine
    lad = RLadder(hold_iterations=rcfg.resilience.ladder_hold_iterations,
                  probe_interval=rcfg.resilience.probe_interval)
    script = []
    copy_once = eng._copy_once

    def scripted(ev):
        stall, fails = script.pop(0)
        clock.sleep(stall)
        if fails:
            raise RE.TransferError(f"replayed failure ({ev.tag!r})")
        copy_once(ev)
    eng._copy_once = scripted
    events, per_step, probes = {}, [], []
    for item in port.stream:
        kind = item[0]
        if kind == "copy":
            _, eid, direction, nbytes, tag, cls, src, free, tries = item
            script[:] = list(tries)
            if direction == SWAP_OUT:
                ev = eng.submit_swap_out(np.zeros(nbytes, np.uint8), tag, cls)
            else:
                ev = eng.submit_swap_in(events[src], tag, free, cls)
            eng.wait(ev)
            assert not script, (item, script)
            events[eid] = ev
        elif kind == "hbm_fallback":
            _, eid, src, tag = item
            ev = eng.submit_swap_in(events[src], tag)
            assert ev.done and eng.n_hbm_fallback_in
            events[eid] = ev
        elif kind == "probe?":
            probes.append((item[1], lad.should_probe(item[1])))
        elif kind == "decide":
            lad.decide(eng.health.worst(), item[1])
        elif kind == "pressure":
            eng.health.note_pressure(item[1], item[2])
        else:
            per_step.append((_counters(eng), eng.health.worst()))
    return SimpleNamespace(per_step=per_step, probes=probes,
                           transitions=[(t["step"], t["to"], t["why"])
                                        for t in lad.transitions])


def _ref_scenario(name, window, monkeypatch):
    """The reference's own trainer under the scenario (the reference
    test's chaos trainer, shortened as ``_chaos_trainer``), its engine and
    trainer modules on ``_Clock``: the trainer the port starts from, and
    its run."""
    import repro.configs as RC
    from repro.common.config import ChameleonConfig as RCham
    from repro.common.config import TrainConfig as RTrainConfig
    from repro.data.synthetic import SyntheticTokens as RTokens
    from repro.hostmem import engine as RE
    from repro.runtime import trainer as RTm
    steps, res, specs, term = _scenario(name, window)
    monkeypatch.setattr(RE, "time", _Clock())
    monkeypatch.setattr(RTm, "time", _Clock(1e-3))
    d = tempfile.mkdtemp()
    try:
        cfg = RC.get_reduced("llama2_paper")
        tr = RTrainer(cfg, RTrainConfig(
            steps=steps, checkpoint_every=0, checkpoint_dir=d,
            eval_every=0, warmup_steps=2, learning_rate=1e-3),
            RCham(enabled=True, hbm_budget_bytes=CHAOS_BUDGET,
                  resilience=RResilienceConfig(**CHAOS_RESILIENCE, **res)),
            data=RTokens(cfg.vocab_size, 64, 4, seed=0))
        start = SimpleNamespace(params=tr.params, opt_state=tr.opt_state)
        eng = tr.rt.hostmem.engine
        n_term = (_terminal_swap_ins(REF, eng, "_execute",
                                     lambda: tr.step == term)
                  if term is not None else None)
        per_step = []
        plan = (RF.FaultPlan([RF.FaultSpec(**s) for s in specs], seed=1)
                if specs else None)
        with contextlib.ExitStack() as stack:
            if plan is not None:
                stack.enter_context(RF.injected(plan))
            rep = tr.train(steps, fault_hook=lambda s: per_step.append(
                _counters(eng)))
        return start, SimpleNamespace(
            rep=rep, per_step=per_step, terminal=n_term[0] if n_term else
            None, fired=plan.stats()["fired"] if plan else {})
    finally:
        shutil.rmtree(d, ignore_errors=True)


@pytest.mark.parametrize("name", ["swap_in_terminal", "copy_timeout"])
def test_engine_faults_in_a_step_match_the_reference(twin, name,
                                                     monkeypatch):
    """ROADMAP 12d's drill scenarios on the reduced llama2-paper, run the
    same way through both packages' trainers from the reference's initial
    state: ``swap_in_terminal`` (every swap-in of the window's first step
    fails for good after its swap-out staged, max_retries 1) and
    ``copy_timeout`` (copies stalled 0.1 s, twice the timeout floor, at
    0.3 over the window).  Neither crashes; the losses agree within the
    trainer bar (``tests/test_torch_training.py``); in each, every
    terminal swap-in is served by the synchronous fallback and every
    timeout is a stalled copy.  The policies differ (the port profiles
    storages), so the counters are held where the inputs are the same:
    the port's copies, each with its stalls and failures, replayed in the
    order they retired through the reference's engine and ladder give
    the same fallback, timeout, retry and failure counts and the same
    worst health after every step, and the same ladder moves at the same
    steps (P9, and the health layer under faults)."""
    from tests.test_torch_training import LOSS_TOL
    start, ref = _ref_scenario(name, twin.window, monkeypatch)
    port = _port_scenario(name, twin.window, start, monkeypatch)
    rep = port.rep
    assert not rep.failures and not ref.rep.failures
    np.testing.assert_allclose(rep.losses, ref.rep.losses, **LOSS_TOL)
    for side in (port, ref):
        counts = [c if side is ref else c[0] for c in side.per_step]
        if name == "swap_in_terminal":
            k = side.term if side is port else twin.window["start"]
            fallbacks = counts[k][0] - counts[k - 1][0]
            assert side.terminal >= 1 and fallbacks == side.terminal, (
                side.terminal, fallbacks)
            assert counts[k][1] == counts[k - 1][1]     # no retained source
        else:
            stalls = side.fired.get("engine.transfer_stall", 0)
            assert 0 < counts[-1][2] <= stalls, (counts[-1][2], stalls)
    replay = _replay_on_reference(port, monkeypatch)
    assert replay.per_step == port.per_step
    assert replay.transitions == port.transitions
    assert all(why in HEALTH_WHY for _, _, why in port.transitions)
    assert replay.probes == [(s, p) for kind, s, p in
                             (i for i in port.stream if i[0] == "probe?")]
    if name == "swap_in_terminal":
        assert port.transitions and port.transitions[0][:2] == (
            port.term + 1, "trimmed")


# ------------------------------------ checkpoints under the CLI's plan
# chip_smoke.py's CHAOS_CLI_PLAN (store and checkpoint faults), its
# checkpoint-write fault made certain: a write runs on the writer thread,
# so the iteration a fault draw is keyed on is the host's timing; at 1.0
# the first two shard writes fail and the third attempt lands
CLI_PLAN = [dict(site="store.put", prob=0.5),
            dict(site="store.load", prob=0.5),
            dict(site="ckpt.write", prob=1.0, max_fires=2)]


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_chaos_checkpoint_restores_in_the_other_package(writer, tmp_path):
    """A reduced llama2-paper run under Chameleon with a policy store,
    checkpointing every 3 of 6 steps under CLI_PLAN (store and
    checkpoint-write faults, ``on_error="degrade"``: two shard writes
    retried), in one package; the other package's trainer resumes from
    its newest checkpoint: the step, the loss scale and every parameter
    equal the writer's at its end."""
    import jax
    import repro.configs as RC
    from repro.common.config import ChameleonConfig as RCham
    from repro.common.config import TrainConfig as RTrainConfig
    from repro.data.synthetic import SyntheticTokens as RTokens
    from repro_torch.models import convert
    ckpt, store = str(tmp_path / "ckpt"), str(tmp_path / "store")
    kw = dict(steps=6, checkpoint_every=3, checkpoint_dir=ckpt,
              eval_every=0, warmup_steps=2, learning_rate=1e-3)

    def port_trainer():
        cfg = PC.get_reduced("llama2_paper")
        return Trainer(cfg, TrainConfig(**kw), ChameleonConfig(
            enabled=True, hbm_budget_bytes=CHAOS_BUDGET,
            policystore=PolicyStoreConfig(enabled=True, dir=store)),
            data=SyntheticTokens(cfg.vocab_size, 64, 4, seed=0),
            device="cpu")

    def ref_trainer():
        cfg = RC.get_reduced("llama2_paper")
        return RTrainer(cfg, RTrainConfig(**kw), RCham(
            enabled=True, hbm_budget_bytes=CHAOS_BUDGET,
            policystore=RPolicyStoreConfig(enabled=True, dir=store)),
            data=RTokens(cfg.vocab_size, 64, 4, seed=0))

    side = PORT if writer == "port" else REF
    plan = side.faults.FaultPlan(
        [side.faults.FaultSpec(**s) for s in CLI_PLAN], seed=0)
    with side.faults.injected(plan):
        w = port_trainer() if writer == "port" else ref_trainer()
        rep = w.train(6)
    w.rt.close()
    assert not rep.failures and plan.stats()["fired"]["ckpt.write"] == 2
    assert w.ckpt.latest_step() == 6 and w.ckpt.n_write_failures == 0
    if writer == "port":
        want = convert.params_to_reference(w.model)
        r = ref_trainer()
        assert r.resume() and r.step == 6
        got = jax.tree.map(np.asarray, r.params)
        assert float(r.loss_scale.scale) == float(w.loss_scale.scale)
        r.rt.close()
    else:
        want = jax.tree.map(np.asarray, w.params)
        p = port_trainer()
        assert p.resume() and p.step == 6
        got = convert.params_to_reference(p.model)
        assert float(p.loss_scale.scale) == float(w.loss_scale.scale)
        p.rt.close()
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert flat
    for path, leaf in flat:
        node = got
        for q in path:
            node = node[q.key]
        np.testing.assert_array_equal(np.asarray(node), leaf)
