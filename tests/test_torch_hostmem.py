"""The port's host-memory tier (pinned slab pool, per-class transfer
engine, bandwidth model, fault hooks and link health) against the
reference, on the CPU.

The scenarios of ``tests/test_hostmem.py``, ``tests/test_engine_streams.py``
and ``tests/test_faults.py`` that touch the ported modules run once on each
tier, from the same submissions: the observations (which events are done
when, what comes back) and every counter of ``stats()`` that does not
depend on the host clock must be equal.  On the CPU the port's copies are
synchronous; its scheduler, windows and accounting are the reference's.
"""
import collections
import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.hostmem as RH
import repro_torch.hostmem as PH
from repro import faults as RF
from repro import obs as RO
from repro.common.config import HostMemConfig as RHostMemConfig
from repro.common.config import ResilienceConfig as RResilienceConfig
from repro_torch import faults as PF
from repro_torch import obs as PO
from repro_torch.common.config import HostMemConfig, ResilienceConfig
from repro_torch.faults import (DEGRADED, FAILED, HEALTHY, FaultPlan,
                                FaultSpec, HealthMonitor)
from repro_torch.hostmem import (BandwidthModel, HostMemError, HostMemTier,
                                 PinnedSlabPool, TransferEngine)
from repro_torch.hostmem.engine import PRIORITY
from repro_torch.hostmem.pool import size_class

torch.set_num_threads(1)      # tier-1 runs several xdist workers

TC_POLICY_SWAP, TC_KV_SPILL, TC_CHECKPOINT = (PH.TC_POLICY_SWAP,
                                              PH.TC_KV_SPILL,
                                              PH.TC_CHECKPOINT)
CLASSES = (TC_POLICY_SWAP, TC_KV_SPILL, TC_CHECKPOINT)


@pytest.fixture(autouse=True)
def _always_disarmed():
    """No test leaks an armed fault plan, on either tier."""
    RF.disarm()
    PF.disarm()
    yield
    RF.disarm()
    PF.disarm()


# ------------------------------------------------------ the two tiers
def _port_state(L, B, D, rng):
    State = collections.namedtuple("State", ["pos", "attn_k", "attn_v"])
    return State(pos=torch.arange(B, dtype=torch.int64) + 5,
                 attn_k=torch.from_numpy(rng.randn(L, B, D).astype(
                     np.float32)),
                 attn_v=torch.from_numpy(rng.randn(L, B, D).astype(
                     np.float32)))


def _ref_state(L, B, D, rng):
    import jax.numpy as jnp
    State = collections.namedtuple("State", ["pos", "attn_k", "attn_v"])
    return State(pos=jnp.asarray(np.arange(B, dtype=np.int32) + 5),
                 attn_k=jnp.asarray(rng.randn(L, B, D).astype(np.float32)),
                 attn_v=jnp.asarray(rng.randn(L, B, D).astype(np.float32)))


REF = SimpleNamespace(
    name="ref", faults=RF, HMC=RHostMemConfig, RC=RResilienceConfig,
    arr=lambda a: a,
    tier=lambda cfg=None: RH.HostMemTier(cfg),
    engine=lambda rs: RH.TransferEngine(RH.PinnedSlabPool(), resilience=rs),
    state=_ref_state)
PORT = SimpleNamespace(
    name="port", faults=PF, HMC=HostMemConfig, RC=ResilienceConfig,
    arr=lambda a: torch.from_numpy(np.array(a)),
    tier=lambda cfg=None: HostMemTier(cfg, device="cpu"),
    engine=lambda rs: TransferEngine(PinnedSlabPool(), resilience=rs,
                                     device="cpu"),
    state=_port_state)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _zeros(side, n, dtype=np.uint8):
    return side.arr(np.zeros(n, dtype))


def _tier(side, **class_depths):
    return side.tier(side.HMC(class_depths=tuple(class_depths.items())))


def _flat(d, pre=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}."))
        else:
            out[f"{pre}{k}"] = v
    return out


# Keys left out of the comparison.  The first group comes from the host
# clock (copy seconds, rates, the bandwidth curve and the health residuals
# priced from it).  The second is the pool's occupancy over time: the port
# issues a copy when it is submitted, so a queued transfer already holds its
# slab, where the reference takes the slab when the transfer retires.  Peaks,
# reserved bytes and slab reuse then differ; every byte and block count
# conserved over a scenario (taken after the engine has drained) matches.
_CLOCK = ("time", "gbps", "_bps", "stall_s", "bwmodel.", "score", "n_slow",
          "clean_streak", ".state", "n_transitions", "timeouts")
_OCCUPANCY = ("peak", "bytes_reserved", "bytes_free", "slab_allocs",
              "reuse_hits", "hit_rate", "fragmentation")


def _counters(stats: dict) -> dict:
    return {k: v for k, v in _flat(stats).items()
            if not any(c in k for c in _CLOCK + _OCCUPANCY)}


def _engine_stats(eng):
    return {"engine": eng.stats(), "pool": eng.pool.stats()}


# ---------------------------------------------------------- scenarios
# Each takes a side and returns (observations, stats dict).  Ported from
# the reference tests named in their docstrings.
def sc_fifo_double_buffer(side):
    """test_engine_fifo_completion_and_double_buffer"""
    tier = side.tier(side.HMC(engine_depth=2))
    eng = tier.engine
    arrs = [np.full(256, i, np.float32) for i in range(5)]
    evs = [eng.submit_swap_out(side.arr(a), f"t{i}")
           for i, a in enumerate(arrs)]
    seen = {"after_submit": [e.done for e in evs],
            "forced": eng.forced_retires}
    eng.wait(evs[3])
    seen["after_wait3"] = [e.done for e in evs]
    eng.synchronize()
    back = [eng.wait(eng.submit_swap_in(e)) for e in evs]
    seen["roundtrip"] = all(np.array_equal(_np(ev.result), a)
                            for a, ev in zip(arrs, back))
    return seen, tier.stats()


def sc_callbacks_order(side):
    """test_engine_completion_callbacks_order"""
    tier = side.tier(side.HMC(engine_depth=1))
    order = []
    for i in range(4):
        ev = tier.engine.submit_swap_out(_zeros(side, 128), f"t{i}")
        ev.on_done(lambda e: order.append(e.tag))
    tier.engine.synchronize()
    return {"order": order}, tier.stats()


def sc_planned_release_tag(side):
    """test_engine_planned_release_tags"""
    tier = side.tier()
    tier.engine.plan_release("ffn_pre:3:17", 412)
    ev = tier.engine.submit_swap_out(_zeros(side, 64), "ffn_pre:3:17")
    tier.engine.synchronize()
    return {"release_op": ev.release_op}, tier.stats()


def sc_bwmodel_fed_by_copies(side):
    """test_engine_observations_feed_bwmodel"""
    tier = side.tier()
    seen = {"before": tier.bwmodel.is_calibrated}
    for sz in (1 << 16, 1 << 20, 1 << 22):
        tier.engine.wait(tier.engine.submit_swap_out(_zeros(side, sz)))
    seen["after"] = tier.bwmodel.is_calibrated
    seen["points"] = tier.stats()["bwmodel"]["points"]
    return seen, tier.stats()


def sc_autochain(side):
    """test_swap_in_autochains_queued_swap_out (the port issues the copy,
    and so allocates its slab, at submit: ``block`` is not compared)"""
    tier = _tier(side, policy_swap=8)
    eng = tier.engine
    arr = np.arange(64, dtype=np.float32)
    ev_out = eng.submit_swap_out(side.arr(arr), "t")
    seen = {"queued": not ev_out.done}
    ev_in = eng.wait(eng.submit_swap_in(ev_out, "t"))
    seen["chained"] = ev_out.done
    seen["equal"] = bool(np.array_equal(_np(ev_in.result), arr))
    return seen, tier.stats()


def sc_strict_priority(side):
    """test_strict_priority_policy_swap_preempts_checkpoint_drain"""
    tier = _tier(side, checkpoint=16)
    eng = tier.engine
    ck = [eng.submit_swap_out(_zeros(side, 1 << 16), f"ck{i}",
                              cls=TC_CHECKPOINT) for i in range(6)]
    pol = eng.submit_swap_out(_zeros(side, 1 << 12), "pol",
                              cls=TC_POLICY_SWAP)
    eng.wait(ck[0])
    st_ck = eng.by_class[TC_CHECKPOINT]
    seen = {"pol_done": pol.done, "stall_s_positive": st_ck.stall_s > 0.0}
    eng.synchronize()
    seen["all_done"] = all(e.done for e in ck)
    return seen, tier.stats()


def sc_per_class_windows(side):
    """test_per_class_windows_are_independent"""
    tier = _tier(side, policy_swap=1, checkpoint=4)
    eng = tier.engine
    ck = [eng.submit_swap_out(_zeros(side, 1 << 12), f"ck{i}",
                              cls=TC_CHECKPOINT) for i in range(4)]
    seen = {"ck_held": [e.done for e in ck]}
    p0 = eng.submit_swap_out(_zeros(side, 1 << 12), "p0")
    p1 = eng.submit_swap_out(_zeros(side, 1 << 12), "p1")
    seen.update(p0=p0.done, p1=p1.done, ck=[e.done for e in ck],
                forced=eng.by_class[TC_POLICY_SWAP].forced_retires)
    eng.synchronize()
    return seen, tier.stats()


def sc_kv_jumps_checkpoint(side):
    """test_wait_on_kv_spill_jumps_checkpoint_not_policy"""
    tier = _tier(side, policy_swap=8, kv_spill=8, checkpoint=8)
    eng = tier.engine
    ck = eng.submit_swap_out(_zeros(side, 1 << 12), "ck", cls=TC_CHECKPOINT)
    kv = eng.submit_swap_out(_zeros(side, 1 << 12), "kv", cls=TC_KV_SPILL)
    pol = eng.submit_swap_out(_zeros(side, 1 << 12), "pol",
                              cls=TC_POLICY_SWAP)
    eng.wait(kv)
    seen = {"pol": pol.done, "ck": ck.done}
    eng.synchronize()
    return seen, tier.stats()


def sc_advance_op_release(side):
    """test_advance_op_releases_at_promised_op"""
    tier = _tier(side, policy_swap=8)
    eng = tier.engine
    eng.plan_release("resid:0:1", 5)
    ev = eng.submit_swap_out(side.arr(np.ones(256, np.float32)), "resid:0:1")
    seen = {"release_op": ev.release_op, "done0": ev.done,
            "adv4": eng.advance_op(4), "held": ev._source is not None,
            "adv5": eng.advance_op(5), "done": ev.done,
            "released": ev._source is None}
    eng.begin_iteration()
    seen["cursor"] = eng.current_op
    return seen, tier.stats()


def sc_advance_op_fifo_head(side):
    """test_advance_op_keeps_fifo_unplanned_head_blocks"""
    tier = _tier(side, policy_swap=8)
    eng = tier.engine
    first = eng.submit_swap_out(_zeros(side, 64), "unplanned")
    eng.plan_release("planned", 3)
    second = eng.submit_swap_out(_zeros(side, 64), "planned")
    seen = {"adv": eng.advance_op(10), "first": first.done,
            "second": second.done}
    eng.synchronize()
    return seen, tier.stats()


def sc_set_class_depth(side):
    """test_set_class_depth_widens_and_never_shrinks"""
    tier = side.tier()
    eng = tier.engine
    eng.set_class_depth(TC_CHECKPOINT, 8)
    evs = [eng.submit_swap_out(_zeros(side, 64), f"c{i}", cls=TC_CHECKPOINT)
           for i in range(8)]
    seen = {"queued": [e.done for e in evs]}
    eng.set_class_depth(TC_CHECKPOINT, 2)
    eng.submit_swap_out(_zeros(side, 64), "c8", cls=TC_CHECKPOINT)
    seen["after"] = [e.done for e in evs]
    eng.synchronize()
    return seen, tier.stats()


def _subs(seed, n, max_size):
    rng = np.random.RandomState(seed)
    return [(CLASSES[rng.randint(3)], int(rng.randint(1, max_size)),
             int(rng.randint(6))) for _ in range(n)]


def sc_priority_drain(side):
    """test_strict_priority_drain_order, one fixed draw"""
    tier = _tier(side, policy_swap=64, kv_spill=64, checkpoint=64)
    done = []
    for cls, size, _ in _subs(5, 24, 1 << 14):
        ev = tier.engine.submit_swap_out(_zeros(side, size), cls=cls)
        ev.on_done(lambda e: done.append(e.eid))
    tier.engine.synchronize()
    return {"done": done}, tier.stats()


def sc_multiclass_churn(side):
    """test_pool_invariants_under_multiclass_churn, one fixed draw"""
    tier = side.tier(side.HMC(engine_depth=2))
    eng = tier.engine
    outstanding, done = [], []
    for i, (cls, size, action) in enumerate(_subs(7, 40, 1 << 16)):
        ev = eng.submit_swap_out(_zeros(side, size), f"op{i}", cls=cls)
        ev.on_done(lambda e: done.append(e.eid))
        outstanding.append(ev)
        if action == 1:
            eng.wait(eng.submit_swap_in(outstanding.pop(0)))
        elif action == 2:
            eng.advance_op(i)
        elif action == 3:
            eng.wait(outstanding[-1])
        tier.pool.check()
    eng.synchronize()
    for ev in outstanding:
        eng.wait(eng.submit_swap_in(ev))
    tier.pool.check()
    return {"done": done}, tier.stats()


def sc_kv_spill_concurrent(side):
    """test_kv_spill_roundtrip_under_concurrent_classes"""
    tier = _tier(side, checkpoint=32)
    state = side.state(3, 4, 8, np.random.RandomState(0))
    k0, v0 = _np(state.attn_k).copy(), _np(state.attn_v).copy()
    sp = tier.kvspill.spill(state, 2, tag="req")
    for i in range(6):
        tier.engine.submit_swap_out(_zeros(side, 1 << 18), f"ck{i}",
                                    cls=TC_CHECKPOINT)
    state2 = tier.kvspill.restore(state, sp, 2)
    seen = {"k": bool(np.array_equal(_np(state2.attn_k), k0)),
            "v": bool(np.array_equal(_np(state2.attn_v), v0)),
            "nbytes": sp.nbytes}
    tier.engine.synchronize()
    tier.pool.check()
    return seen, tier.stats()


def sc_spill_one_slab(side):
    """test_spill_is_one_packed_slab_per_slot"""
    tier = side.tier()
    sp = tier.kvspill.spill(side.state(2, 3, 4, np.random.RandomState(0)),
                            0, tag="req0")
    tier.engine.synchronize()
    seen = {"n_out": tier.engine.n_out, "live": tier.pool.live_blocks,
            "layout": [(fs.name, fs.offset, fs.nbytes, tuple(fs.shape),
                        fs.kind) for fs in sp.layout],
            "nbytes": sp.nbytes}
    tier.kvspill.discard(sp)
    return seen, tier.stats()


def sc_restore_then_discard(side):
    """test_restore_then_discard_is_not_double_free"""
    tier = side.tier()
    state = side.state(2, 3, 4, np.random.RandomState(0))
    k0 = _np(state.attn_k).copy()
    sp = tier.kvspill.spill(state, 1, tag="req1")
    state2 = tier.kvspill.restore(state, sp, 1)
    tier.kvspill.discard(sp)
    tier.kvspill.discard(sp)
    tier.pool.check()
    return {"equal": bool(np.array_equal(_np(state2.attn_k), k0))}, \
        tier.stats()


def sc_discard_then_restore(side):
    """test_discard_frees_once_and_restore_of_discarded_raises"""
    tier = side.tier()
    state = side.state(2, 3, 4, np.random.RandomState(0))
    sp = tier.kvspill.spill(state, 0, tag="req0")
    tier.kvspill.discard(sp)
    tier.kvspill.discard(sp)
    try:
        tier.kvspill.restore(state, sp, 0)
        raised = None
    except Exception as err:          # noqa: BLE001 — compared by name
        raised = type(err).__name__
    tier.pool.check()
    return {"raised": raised}, tier.stats()


def _fault_engine(side, **rs_kw):
    return side.engine(side.RC(retry_backoff_s=0.0, **rs_kw))


def _roundtrip(eng, arr, tag="t"):
    ev = eng.wait(eng.submit_swap_out(arr, tag))
    return eng.wait(eng.submit_swap_in(ev, tag))


def sc_fault_retry_transient(side):
    """test_retry_recovers_transient_fault_bit_exactly"""
    eng = _fault_engine(side)
    arr = np.random.RandomState(0).randn(257).astype(np.float32)
    plan = side.faults.FaultPlan([side.faults.FaultSpec(
        "engine.transfer_error", prob=1.0, max_fires=2)])
    with side.faults.injected(plan):
        ev2 = _roundtrip(eng, side.arr(arr))
    eng.pool.check()
    return {"equal": bool(np.array_equal(_np(ev2.result), arr)),
            "failed": ev2.failed}, _engine_stats(eng)


def sc_fault_terminal_swap_out(side):
    """test_terminal_swap_out_retains_in_hbm_and_short_circuits"""
    eng = _fault_engine(side, max_retries=1)
    arr = np.random.RandomState(1).randn(100).astype(np.float32)
    src = side.arr(arr)
    plan = side.faults.FaultPlan([side.faults.FaultSpec(
        "engine.transfer_error", prob=1.0)])
    with side.faults.injected(plan):
        ev = eng.wait(eng.submit_swap_out(src, "t"))
        seen = {"failed": ev.failed, "block": ev.block,
                "retained": ev.result is src}
        ev2 = eng.wait(eng.submit_swap_in(ev, "t"))
    seen.update(done=ev2.done, failed2=ev2.failed,
                equal=bool(np.array_equal(_np(ev2.result), arr)),
                health=eng.health.state(TC_POLICY_SWAP),
                score_ge_1=eng.health.links[TC_POLICY_SWAP].score >= 1.0)
    eng.pool.check()
    return seen, _engine_stats(eng)


def sc_fault_terminal_swap_in(side):
    """test_terminal_swap_in_falls_back_to_sync_copy"""
    eng = _fault_engine(side, max_retries=1)
    arr = np.random.RandomState(2).randn(64).astype(np.float32)
    ev = eng.wait(eng.submit_swap_out(side.arr(arr), "t"))
    plan = side.faults.FaultPlan([side.faults.FaultSpec(
        "engine.transfer_drop", prob=1.0)])
    with side.faults.injected(plan):
        ev2 = eng.wait(eng.submit_swap_in(ev, "t"))
    eng.pool.check()
    return {"equal": bool(np.array_equal(_np(ev2.result), arr))}, \
        _engine_stats(eng)


def sc_fault_dropped_dma(side):
    """test_dropped_dma_never_loses_data"""
    eng = _fault_engine(side)
    arr = np.random.RandomState(3).randn(333).astype(np.float32)
    plan = side.faults.FaultPlan([side.faults.FaultSpec(
        "engine.transfer_drop", prob=1.0, max_fires=1)])
    with side.faults.injected(plan):
        ev2 = _roundtrip(eng, side.arr(arr))
    return {"equal": bool(np.array_equal(_np(ev2.result), arr))}, \
        _engine_stats(eng)


def sc_fault_pool_alloc(side):
    """test_pool_faults_are_absorbed_by_engine_retry"""
    eng = _fault_engine(side)
    arr = np.random.RandomState(4).randn(50).astype(np.float32)
    plan = side.faults.FaultPlan([side.faults.FaultSpec(
        "pool.alloc", prob=1.0, max_fires=1)])
    with side.faults.injected(plan):
        ev2 = _roundtrip(eng, side.arr(arr))
    return {"equal": bool(np.array_equal(_np(ev2.result), arr))}, \
        _engine_stats(eng)


def sc_fault_stall(side):
    """test_stall_fault_delays_but_completes"""
    eng = _fault_engine(side)
    plan = side.faults.FaultPlan([side.faults.FaultSpec(
        "engine.transfer_stall", prob=1.0, seconds=0.05, max_fires=1)])
    with side.faults.injected(plan):
        t0 = time.perf_counter()
        ev2 = _roundtrip(eng, _zeros(side, 64, np.float32))
        dt = time.perf_counter() - t0
    return {"slow": dt >= 0.05, "failed": ev2.failed}, _engine_stats(eng)


SCENARIOS = {name[3:]: fn for name, fn in dict(globals()).items()
             if name.startswith("sc_")}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_same_observations_and_counters_on_both_tiers(name):
    seen_ref, stats_ref = SCENARIOS[name](REF)
    seen, stats = SCENARIOS[name](PORT)
    assert seen == seen_ref
    assert _counters(stats) == _counters(stats_ref)


def test_stats_schema_matches_reference():
    """Every key of the reference tier's stats, clock-derived ones too."""
    assert set(_flat(PORT.tier().stats())) == set(_flat(REF.tier().stats()))


# ------------------------------------------------------------------- pool
def test_pool_alloc_free_reuse():
    p = PinnedSlabPool()
    a = p.alloc(1000)
    assert a.class_bytes == size_class(1000) and a.nbytes == 1000
    p.free(a)
    b = p.alloc(700)                     # same 4 KiB class -> recycled slab
    assert b.class_bytes == a.class_bytes
    assert p.reuse_hits == 1 and p.slab_allocs == 1
    assert p.bytes_reserved == a.class_bytes
    assert a.data.dtype == torch.uint8 and not a.data.is_pinned()
    p.check()


def test_pool_double_free_rejected():
    p = PinnedSlabPool()
    blk = p.alloc(64)
    p.free(blk)
    with pytest.raises(HostMemError):
        p.free(blk)


def test_pool_capacity_cap():
    p = PinnedSlabPool(capacity_bytes=1 << 14)
    p.alloc(1 << 13)
    with pytest.raises(HostMemError):
        p.alloc(1 << 14)
    p.alloc(1 << 12)


def test_pool_steady_state_zero_fresh_allocation():
    p = PinnedSlabPool()
    sizes = [3 << 10, 70 << 10, 1 << 20, 5 << 20]
    for step in range(20):
        blocks = [p.alloc(s) for s in sizes]
        for b in blocks:
            p.free(b)
        if step == 0:
            fresh_after_warmup = p.slab_allocs
    assert p.slab_allocs == fresh_after_warmup
    assert p.hit_rate > 0.9
    p.check()


def test_block_roundtrip_preserves_bits_and_chunks():
    p = PinnedSlabPool()
    arr = torch.from_numpy(np.random.RandomState(0).randn(33, 7).astype(
        np.float32))
    blk = p.alloc(arr.numel() * 4).write(arr)
    out = blk.read()
    assert out.dtype == arr.dtype and out.shape == arr.shape
    assert torch.equal(out, arr)
    # a sequence of tensors is staged back to back as one byte payload
    a, b = torch.arange(5, dtype=torch.int16), torch.ones(3, dtype=torch.int8)
    blk2 = p.alloc(13).write([a, b])
    got = blk2.read()
    assert got.dtype == torch.uint8 and got.shape == (13,)
    assert torch.equal(got[:10].view(torch.int16), a)
    assert torch.equal(got[10:].view(torch.int8), b)
    with pytest.raises(HostMemError, match="payload has"):
        p.alloc(20).write([a])


def test_read_before_write_raises_descriptive_error():
    p = PinnedSlabPool()
    blk = p.alloc(256, tag="staging")
    with pytest.raises(HostMemError, match="read before write"):
        blk.read()
    blk.write(torch.arange(64, dtype=torch.int32))
    assert torch.equal(blk.read(), torch.arange(64, dtype=torch.int32))


@given(st.lists(st.integers(1, 1 << 20), min_size=1, max_size=60),
       st.lists(st.integers(0, 1 << 30), min_size=0, max_size=60))
@settings(max_examples=30, deadline=None)
def test_pool_never_double_books(sizes, free_picks):
    p = PinnedSlabPool()
    live = []
    picks = iter(free_picks)
    for s in sizes:
        live.append(p.alloc(s))
        k = next(picks, None)
        if k is not None and live and k % 3 == 0:
            p.free(live.pop(k % len(live)))
    addrs = [b.data.data_ptr() for b in live]
    assert len(addrs) == len(set(addrs)), "two live blocks share a slab"
    assert p.bytes_in_use == sum(b.nbytes for b in live)
    p.check()
    n_free_before = sum(len(v) for v in p._free.values())
    for b in list(live):
        p.free(b)
    assert p.bytes_in_use == 0 and p.live_blocks == 0
    assert sum(len(v) for v in p._free.values()) == n_free_before + len(live)
    p.check()


def test_pool_pressure_spares_recycled_slabs():
    pool = PinnedSlabPool()
    blk = pool.alloc(1000, "warm")
    pool.free(blk)
    plan = FaultPlan([FaultSpec("pool.pressure", prob=1.0)])
    with PF.injected(plan):
        ok = pool.alloc(900, "recycled")
        with pytest.raises(HostMemError, match="pressure"):
            pool.alloc(1 << 20, "fresh")
    pool.free(ok)
    pool.check()


# ---------------------------------------------------------------- bwmodel
@pytest.mark.parametrize("points,probe", [
    ((), (1 << 30,)),
    (((1 << 16, 1e-4), (1 << 26, 4e-3)),
     tuple(1 << p for p in range(8, 29))),
    (((1 << 16, 2e-4), (1 << 20, 5e-4)), (1 << 18, 1 << 22)),
])
def test_bwmodel_curve_equals_reference(points, probe):
    """test_bwmodel_*: the same observations give the same curve, and it
    survives a to_dict/from_dict round trip."""
    m, r = BandwidthModel(32.0), RH.BandwidthModel(32.0)
    for n, t in points:
        m.observe(n, t)
        r.observe(n, t)
    assert m.is_calibrated == r.is_calibrated == bool(points)
    m2 = BandwidthModel.from_dict(json.loads(json.dumps(m.to_dict())))
    for n in probe:
        assert m.transfer_time(n) == pytest.approx(r.transfer_time(n),
                                                   rel=1e-12)
        assert m2.transfer_time(n) == pytest.approx(m.transfer_time(n),
                                                    rel=1e-12)
    if points == ((1 << 16, 1e-4), (1 << 26, 4e-3)):
        assert m.transfer_time(1 << 10) == pytest.approx(1e-4)
        assert m.transfer_time(1 << 27) == pytest.approx(8e-3)


def test_bwmodel_calibrate_probe():
    """The probe (a host -> device -> host round trip, here on the CPU),
    and an injected round-trip clock whose per-direction median is what
    the reference observes per size."""
    m = BandwidthModel(32.0).calibrate(sizes=(1 << 12, 1 << 16), iters=1,
                                       device="cpu")
    assert m.is_calibrated and m.transfer_time(1 << 14) > 0

    def clock(size):
        return 2 * (2e-5 + size / 20e9)
    m = BandwidthModel(32.0).calibrate(sizes=(1 << 16, 1 << 24), iters=3,
                                       roundtrip=clock)
    r = RH.BandwidthModel(32.0)
    for n in (1 << 16, 1 << 24):
        r.observe(n, clock(n) / 2)
    for n in (1 << 10, 1 << 20, 1 << 26):
        assert m.transfer_time(n) == pytest.approx(r.transfer_time(n),
                                                   rel=1e-12)


# ----------------------------------------------------------------- engine
def test_engine_release_point_drops_device_ref():
    eng = HostMemTier(device="cpu").engine
    a = torch.ones(1024)
    ev = eng.submit_swap_out(a, "resid")
    assert ev._source is a               # held until the copy retires
    eng.wait(ev)
    assert ev._source is None            # recordStream analogue: released
    eng.fence(ev)                        # a no-op once retired / on the CPU


def test_swap_in_of_consumed_block_still_rejected():
    eng = HostMemTier(device="cpu").engine
    ev = eng.wait(eng.submit_swap_out(torch.zeros(64, dtype=torch.uint8), "t"))
    eng.wait(eng.submit_swap_in(ev))
    ev.block = None
    with pytest.raises(ValueError):
        eng.submit_swap_in(ev)


def test_unknown_traffic_class_rejected():
    with pytest.raises(ValueError, match="unknown traffic class"):
        HostMemTier(device="cpu").engine.submit_swap_out(
            torch.zeros(16, dtype=torch.uint8), cls="gradients")


def test_swap_out_of_chunks_is_one_transfer():
    """A sequence of tensors (the KV spill's layer rows) is one copy into
    one slab, its bytes back to back."""
    tier = HostMemTier(device="cpu")
    rows = torch.arange(24, dtype=torch.float32).reshape(3, 8)
    ev = tier.engine.wait(tier.engine.submit_swap_out(list(rows.unbind(0)),
                                                      "rows"))
    assert tier.engine.n_out == 1 and ev.nbytes == 96
    back = tier.engine.wait(tier.engine.submit_swap_in(ev)).result
    assert torch.equal(back.view(torch.float32).view(3, 8), rows)
    assert tier.pool.bytes_in_use == 0


@given(st.lists(st.tuples(st.sampled_from(CLASSES), st.integers(1, 1 << 16)),
                min_size=1, max_size=40))
@settings(max_examples=25, deadline=None)
def test_per_class_fifo_under_interleaved_traffic(subs):
    tier = HostMemTier(HostMemConfig(engine_depth=2), device="cpu")
    eng = tier.engine
    done, evs = [], []
    for cls, size in subs:
        ev = eng.submit_swap_out(torch.zeros(size, dtype=torch.uint8),
                                 cls=cls)
        ev.on_done(lambda e: done.append((e.cls, e.eid)))
        evs.append(ev)
    eng.synchronize()
    per_class = {}
    for cls, eid in done:
        per_class.setdefault(cls, []).append(eid)
    for cls, eids in per_class.items():
        assert eids == sorted(eids), f"{cls} completed out of FIFO order"
    assert len(done) == len(subs)
    for ev in evs:
        tier.pool.free(ev.block)
    tier.pool.check()


@given(st.lists(st.tuples(st.sampled_from(CLASSES), st.integers(1, 1 << 14)),
                min_size=2, max_size=24))
@settings(max_examples=25, deadline=None)
def test_strict_priority_drain_order(subs):
    tier = HostMemTier(HostMemConfig(class_depths=(
        ("policy_swap", 64), ("kv_spill", 64), ("checkpoint", 64))),
        device="cpu")
    done = []
    for cls, size in subs:
        ev = tier.engine.submit_swap_out(torch.zeros(size, dtype=torch.uint8),
                                         cls=cls)
        ev.on_done(lambda e: done.append((PRIORITY[e.cls], e.eid)))
    tier.engine.synchronize()
    assert done == sorted(done), "drain violated strict priority order"
    assert tier.engine.stats()["forced_retires"] == 0
    tier.pool.check()


# ----------------------------------------------------------------- faults
def test_plan_fires_like_the_reference():
    """test_plan_is_deterministic_in_seed: the same seed fires at the same
    calls on both tiers, and another seed differs."""
    def fires(fmod, seed):
        plan = fmod.FaultPlan([fmod.FaultSpec("engine.transfer_error",
                                              prob=0.3)], seed=seed)
        out = []
        for it in range(20):
            plan.set_iteration(it)
            out.append([plan.fire("engine.transfer_error", key="k")
                        is not None for _ in range(5)])
        return out

    assert fires(PF, 7) == fires(RF, 7) == fires(PF, 7)
    assert fires(PF, 7) != fires(PF, 8)


def test_plan_window_and_max_fires():
    plan = FaultPlan([FaultSpec("pool.alloc", prob=1.0, start=3, stop=6,
                                max_fires=2)])
    hits = []
    for it in range(10):
        plan.set_iteration(it)
        if plan.fire("pool.alloc") is not None:
            hits.append(it)
    assert hits == [3, 4]


def test_plan_sites_and_json_match_reference():
    assert PF.SITES == RF.SITES
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultSpec("engine.nonexistent")
    plan = FaultPlan.everywhere(seed=42, prob=0.1, seconds=0.5, stop=100)
    ref = RF.FaultPlan.everywhere(seed=42, prob=0.1, seconds=0.5, stop=100)
    assert plan.to_json() == ref.to_json()
    clone = FaultPlan.from_json(json.loads(json.dumps(plan.to_json())))
    assert clone.seed == plan.seed
    assert [s.to_json() for s in clone.specs] == \
           [s.to_json() for s in plan.specs]


def test_disarmed_inject_is_noop_and_audit_trail():
    assert not PF.armed()
    assert PF.inject("engine.transfer_error", key="x") is None
    PF.tick(5)
    plan = FaultPlan([FaultSpec("store.load", prob=1.0)], seed=3)
    with PF.injected(plan):
        assert PF.active() is plan
        assert PF.inject("store.load", key="rec") is not None
    assert PF.active() is None
    kinds = [e["kind"] for e in PO.audit().tail(50)]
    assert "fault.armed" in kinds and "fault.injected" in kinds \
        and "fault.disarmed" in kinds


def test_engine_retry_is_audited():
    log = PO.set_audit(PO.AuditLog())
    try:
        eng = _fault_engine(PORT)
        with PF.injected(FaultPlan([FaultSpec("engine.transfer_error",
                                              prob=1.0, max_fires=1)])):
            _roundtrip(eng, torch.ones(8))
        assert PO.audit().counts().get("engine.retry") == 1
    finally:
        PO.set_audit(log)


def test_resilience_disabled_preserves_legacy_raise():
    eng = TransferEngine(PinnedSlabPool(), device="cpu",
                         resilience=ResilienceConfig(enabled=False))
    plan = FaultPlan([FaultSpec("engine.transfer_error", prob=1.0)])
    with PF.injected(plan):
        with pytest.raises(Exception):
            eng.wait(eng.submit_swap_out(torch.zeros(8), "t"))


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2 ** 32 - 1), st.floats(0.0, 0.6))
def test_per_class_fifo_order_survives_faults(seed, prob):
    PF.disarm()
    eng = _fault_engine(PORT)
    done = {c: [] for c in CLASSES}
    plan = FaultPlan([FaultSpec("engine.transfer_error", prob=prob),
                      FaultSpec("engine.transfer_drop", prob=prob / 2)],
                     seed=seed)
    rng = np.random.RandomState(seed % (2 ** 31))
    with PF.injected(plan):
        evs = []
        for i in range(18):
            cls = CLASSES[int(rng.randint(3))]
            ev = eng.submit_swap_out(torch.full((8 + i,), float(i)),
                                     f"s{i}", cls=cls)
            ev.on_done(lambda e, c=cls: done[c].append(e.eid))
            evs.append(ev)
        eng.synchronize()
    for c, order in done.items():
        assert order == sorted(order), (c, order)
    for i, ev in enumerate(evs):
        got = ev.result if ev.failed else ev.block.read()
        assert torch.equal(got, torch.full((8 + i,), float(i)))


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2 ** 32 - 1))
def test_no_double_release_under_chaos(seed):
    PF.disarm()
    eng = _fault_engine(PORT, max_retries=1)
    plan = FaultPlan.everywhere(seed=seed, prob=0.25)
    with PF.injected(plan):
        outs = [eng.submit_swap_out(torch.full((16,), float(i)), f"o{i}")
                for i in range(12)]
        for ev in outs:
            eng.wait(ev)
            eng.wait(eng.submit_swap_in(ev, ev.tag))
    assert eng.pool.live_blocks == 0
    eng.pool.check()


@pytest.mark.parametrize("script,kw", [
    ("EE|EE", dict(degrade_score=2.0, fail_score=4.0, recover_successes=3,
                   decay=0.5)),
    ("RRRR", dict(degrade_score=2.0)),
    ("EESRSSSS", dict(degrade_score=2.0, recover_successes=4, decay=0.1)),
    ("EEEES" + "S" * 9, dict(degrade_score=2.0, fail_score=4.0,
                             recover_successes=3, decay=0.5)),
    ("PPp" + "S" * 8, dict(degrade_score=2.0)),
])
def test_health_machine_matches_reference(script, kw):
    """test_health_*: the same notes walk both monitors through the same
    states and scores.  E error, R retry, T timeout, S success,
    P pressure, p severe pressure, | a checkpoint of the state."""
    from repro.faults import HealthMonitor as RefHealth
    mons = [HealthMonitor(["link"], **kw), RefHealth(["link"], **kw)]
    trail = [[], []]
    for ch in script + "|":
        for m, t in zip(mons, trail):
            if ch == "E":
                m.note_error("link")
            elif ch == "R":
                m.note_retry("link")
            elif ch == "T":
                m.note_timeout("link")
            elif ch == "S":
                m.note_success("link")
            elif ch in "Pp":
                m.note_pressure("link", severe=ch == "p")
            t.append((m.state("link"), round(m.links["link"].score, 12)))
    assert trail[0] == trail[1]
    assert mons[0].stats() == mons[1].stats()
    assert {s for s, _ in trail[0]} <= {HEALTHY, DEGRADED, FAILED}


def test_health_slow_residual_weighs_a_quarter():
    h = HealthMonitor(["l2"], degrade_score=2.0, residual_limit=8.0)
    for _ in range(7):
        h.note_success("l2", residual=50.0)   # 7 * 0.25 = 1.75
    assert h.state("l2") == HEALTHY
    h.note_success("l2", residual=50.0)
    assert h.state("l2") == DEGRADED


# ------------------------------------------------------------ ledger, tier
def test_memledger_sees_the_same_transfers():
    """The engine notes every retired copy and kvspill.discard notes the
    release: both ledgers end with the same staged bytes per class."""
    def run(side, ledger_mod):
        led = ledger_mod.set_ledger(ledger_mod.MemoryLedger())
        try:
            tier = side.tier()
            state = side.state(2, 3, 16, np.random.RandomState(0))
            sp = tier.kvspill.spill(state, 0, tag="a")
            sp2 = tier.kvspill.spill(state, 1, tag="b")
            tier.kvspill.discard(sp)
            tier.kvspill.restore(state, sp2, 1)
            tier.engine.wait(tier.engine.submit_swap_out(
                _zeros(side, 1 << 12), "w"))
            return ledger_mod.ledger().staged_bytes()
        finally:
            ledger_mod.set_ledger(led)

    assert run(PORT, PO) == run(REF, RO)


def test_tier_calibrate_on_cpu_and_later_slices_raise():
    tier = HostMemTier(device="cpu")
    bw = tier.calibrate(sizes=(1 << 12, 1 << 16), iters=2)
    assert bw is tier.bwmodel and bw.is_calibrated
    assert sorted(tier.link_curve) == [1 << 12, 1 << 16]
    assert all(d > 0 and h > 0 for d, h in tier.link_curve.values())
    assert tier.pool.bytes_in_use == 0
    # the autotuner (slice 10) once raised here: it now tunes on the CPU,
    # and the calibrated link sets the model's efficiency
    from repro_torch.kernels.autotune import table
    try:
        tuner = tier.autotune()
    finally:
        table.clear()                # the wrappers' process-wide table
    assert tuner.spec.kind == "cpu" and tuner.n_measured == 2
    assert tier.autotuner is tuner
    assert tier.bwmodel.link_efficiency == tuner.link_efficiency(tier.bwmodel)
    auto = HostMemTier(HostMemConfig(spill_compression="auto"), device="cpu")
    assert auto.kvspill.advisor is not None
    assert "pool:" in tier.summary()


def test_tier_runs_on_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HostMemTier()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransferEngine(PinnedSlabPool())
