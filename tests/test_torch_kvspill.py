"""The port's KV spill (raw and int8) and over-subscribed serving against
the reference, on the CPU.

Reduced ``llama2-paper`` in f32: the reference draws the weights and the
port receives them through numpy (``params_from_reference``); decode
states cross the same way (``decode_state_from_reference``), so both tiers
spill the same bytes.  The five cases each of ``tests/test_kvspill.py`` and
``tests/test_spill_compression.py`` run on the port, the packed image is
compared with the reference's field by field, and an over-subscribed
server must emit the reference's tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro_torch.configs as PC
from repro.common.config import HostMemConfig as RHostMemConfig
from repro.hostmem import HostMemTier as RHostMemTier
from repro.models.registry import get_api as ref_get_api
from repro.runtime.server import Server as RefServer
from repro_torch.common.config import HostMemConfig
from repro_torch.hostmem import HostMemTier
from repro_torch.hostmem.kvspill import STATE_FIELDS, KVSpillManager
from repro_torch.kernels.quant_offload import ops as Q
from repro_torch.models.convert import (decode_state_from_reference,
                                        params_from_reference)
from repro_torch.runtime.server import Server

torch.set_num_threads(1)      # tier-1 runs several xdist workers


@pytest.fixture(scope="module")
def pair():
    """(reference cfg, reference params, port cfg, port model)."""
    rcfg = RC.get_reduced("llama2_paper")
    rparams, _ = ref_get_api(rcfg).init(rcfg, jax.random.PRNGKey(0))
    pcfg = PC.get_reduced("llama2_paper")
    model = params_from_reference(pcfg, jax.tree.map(np.asarray, rparams),
                                  device="cpu")
    return rcfg, rparams, pcfg, model


def _tier(compression="none", min_bytes=1 << 12):
    return HostMemTier(HostMemConfig(spill_compression=compression,
                                     spill_compress_min_bytes=min_bytes),
                       device="cpu")


def _int8_tier():
    return _tier("int8", 1)


def _prompts(vocab, n, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=rng.randint(4, 10)) for _ in range(n)]


def _two_slot_server(model, cfg):
    srv = Server(cfg, model, max_batch=2, max_len=32)
    srv.submit(np.arange(5, dtype=np.int32), max_new_tokens=30)
    srv.submit(np.arange(7, dtype=np.int32), max_new_tokens=30)
    srv.tick()
    return srv


# ------------------------------------------- tests/test_kvspill.py cases
def test_spill_restore_roundtrip_is_exact(pair):
    """Spill a slot, let the other decode, overwrite the row as a new
    tenant would, restore: the rows and pos come back bit for bit."""
    _, _, cfg, model = pair
    srv = _two_slot_server(model, cfg)
    tier = _tier()
    before_k = srv.state.attn_k[:, 0].clone()
    before_v = srv.state.attn_v[:, 0].clone()
    before_pos = int(srv.state.pos[0])
    sp = tier.kvspill.spill(srv.state, 0, tag="req-a")
    assert sp.nbytes > 0
    srv.tick()                       # slot 1 keeps decoding meanwhile
    srv.state.attn_k[:, 0] = 0
    srv.state.pos[0] = 0
    srv.state = tier.kvspill.restore(srv.state, sp, 0)
    assert torch.equal(srv.state.attn_k[:, 0], before_k)
    assert torch.equal(srv.state.attn_v[:, 0], before_v)
    assert int(srv.state.pos[0]) == before_pos
    assert tier.kvspill.n_spills == 1 and tier.kvspill.n_restores == 1
    assert tier.pool.bytes_in_use == 0
    assert sp.consumed


def test_oversubscribed_server_matches_resident_and_reference(pair):
    """2 slots, 5 concurrent requests: the same tokens as a port server
    with 5 resident slots and as the reference's over-subscribed server."""
    rcfg, rparams, cfg, model = pair
    prompts = _prompts(cfg.vocab_size, 5)

    ref = Server(cfg, model, max_batch=5, max_len=48)
    ref_ids = [ref.submit(p, max_new_tokens=6) for p in prompts]
    resident = ref.run_until_done()

    tier = _tier()
    srv = Server(cfg, model, max_batch=2, max_len=48, max_active=5,
                 hostmem=tier)
    ids = [srv.submit(p, max_new_tokens=6) for p in prompts]
    out = srv.run_until_done(max_ticks=500)

    rsrv = RefServer(rcfg, rparams, max_batch=2, max_len=48, max_active=5,
                     hostmem=RHostMemTier())
    rids = [rsrv.submit(p, max_new_tokens=6) for p in prompts]
    rout = rsrv.run_until_done(max_ticks=500)

    assert srv.n_active == 0 and len(out) == 5
    assert srv.n_preemptions > 0, "over-subscription must actually spill"
    assert srv.n_preemptions == rsrv.n_preemptions
    assert srv.ticks == rsrv.ticks
    for a, b, c in zip(ref_ids, ids, rids):
        assert out[b] == resident[a], f"spilled request {b} diverged"
        assert out[b] == rout[c]
    ks = srv.stats()["hostmem"]["kvspill"]
    assert ks["n_spills"] == ks["n_restores"] == srv.n_preemptions
    assert ks == rsrv.stats()["hostmem"]["kvspill"]
    assert tier.pool.bytes_in_use == 0


def test_oversubscription_requires_hostmem_builds_default(pair):
    _, _, cfg, model = pair
    srv = Server(cfg, model, max_batch=1, max_len=32, max_active=2)
    assert srv.hostmem is not None
    assert srv.hostmem.device == model.device
    a, b = _prompts(cfg.vocab_size, 2, seed=3)
    ra = srv.submit(a, max_new_tokens=4)
    rb = srv.submit(b, max_new_tokens=4)
    out = srv.run_until_done(max_ticks=200)
    assert len(out[ra]) == 4 and len(out[rb]) == 4


def test_resident_only_server_never_spills(pair):
    _, _, cfg, model = pair
    tier = HostMemTier(HostMemConfig(engine_depth=2), device="cpu")
    srv = Server(cfg, model, max_batch=3, max_len=48, hostmem=tier)
    for p in _prompts(cfg.vocab_size, 6, seed=1):
        srv.submit(p, max_new_tokens=4)
    srv.run_until_done(max_ticks=200)
    assert srv.n_preemptions == 0
    assert tier.engine.n_out == 0 and tier.pool.alloc_count == 0


def test_pool_reuse_across_spill_churn(pair):
    """Steady-state spill traffic recycles slabs: hit rate >= 90%."""
    _, _, cfg, model = pair
    tier = _tier()
    srv = Server(cfg, model, max_batch=2, max_len=48, max_active=4,
                 hostmem=tier)
    for p in _prompts(cfg.vocab_size, 16, seed=2):
        srv.submit(p, max_new_tokens=5)
    srv.run_until_done(max_ticks=800)
    assert srv.n_preemptions >= 16
    assert tier.pool.hit_rate >= 0.9, tier.pool.stats()
    tier.pool.check()


# ------------------------------------ tests/test_spill_compression.py cases
def test_unknown_compression_rejected():
    tier = _tier()
    with pytest.raises(ValueError, match="spill compression"):
        KVSpillManager(tier.pool, tier.engine, compression="zstd")
    auto = KVSpillManager(tier.pool, tier.engine, compression="auto")
    assert auto.compression == "auto" and auto.advisor is None


def test_int8_roundtrip_within_tolerance(pair):
    _, _, cfg, model = pair
    srv = _two_slot_server(model, cfg)
    tier = _int8_tier()
    before_k = srv.state.attn_k[:, 0].clone()
    before_pos = int(srv.state.pos[0])
    launches = (Q.quantize.launches, Q.dequantize.launches)
    sp = tier.kvspill.spill(srv.state, 0, tag="req-a")
    ks = tier.kvspill.stats()
    assert ks["compression"] == "int8"
    assert ks["bytes_spilled"] < ks["bytes_raw"]
    assert ks["compression_ratio"] > 1.5
    assert [fs.kind for fs in sp.layout] == ["int8", "int8"]
    srv.state.attn_k[:, 0] = 0
    srv.state.pos[0] = 0
    srv.state = tier.kvspill.restore(srv.state, sp, 0)
    after_k = srv.state.attn_k[:, 0]
    # row-wise symmetric int8: at most half a step, absmax/254, per row
    step = before_k.abs().amax(-1, keepdim=True) / 254
    assert bool(((after_k - before_k).abs() <= step * (1 + 1e-6)).all())
    assert int(srv.state.pos[0]) == before_pos
    assert tier.pool.bytes_in_use == 0
    # the CPU runs the plain versions: no kernel was launched
    assert (Q.quantize.launches, Q.dequantize.launches) == launches


def test_int8_discard_is_idempotent(pair):
    _, _, cfg, model = pair
    srv = Server(cfg, model, max_batch=1, max_len=32)
    tier = _int8_tier()
    srv.submit(np.arange(6, dtype=np.int32), max_new_tokens=10)
    srv.tick()
    sp = tier.kvspill.spill(srv.state, 0, tag="cancelled")
    tier.kvspill.discard(sp)
    tier.kvspill.discard(sp)
    assert tier.kvspill.n_discards == 1
    assert tier.pool.bytes_in_use == 0


def test_small_fields_stay_raw(pair):
    _, _, cfg, model = pair
    srv = Server(cfg, model, max_batch=1, max_len=32)
    tier = _tier("int8", 1 << 30)
    srv.submit(np.arange(6, dtype=np.int32), max_new_tokens=10)
    srv.tick()
    before_k = srv.state.attn_k[:, 0].clone()
    sp = tier.kvspill.spill(srv.state, 0, tag="raw")
    assert all(fs.kind == "raw" for fs in sp.layout)
    srv.state = tier.kvspill.restore(srv.state, sp, 0)
    assert torch.equal(srv.state.attn_k[:, 0], before_k)


def test_oversubscribed_int8_server_completes(pair):
    _, _, cfg, model = pair
    tier = _int8_tier()
    srv = Server(cfg, model, max_batch=2, max_len=48, max_active=4,
                 hostmem=tier)
    rng = np.random.RandomState(0)
    rids = [srv.submit(rng.randint(0, cfg.vocab_size, size=6),
                       max_new_tokens=5) for _ in range(4)]
    out = srv.run_until_done(max_ticks=400)
    assert sorted(out) == sorted(rids)
    assert all(len(v) == 5 for v in out.values())
    assert srv.n_preemptions > 0
    assert tier.kvspill.stats()["compression_ratio"] > 1.5
    assert tier.pool.bytes_in_use == 0


# ------------------------------------------------- against the reference
def _ref_state(rcfg, rparams, prompts_lens=(5, 9, 3), max_len=24,
               dtype=jnp.float32):
    """A reference decode state of three slots, prefilled to different
    lengths (rows past pos are zeros)."""
    from repro.models.registry import get_api
    state = get_api(rcfg).init_decode_state(rcfg, len(prompts_lens), max_len,
                                            params=rparams)
    rng = np.random.RandomState(0)
    k = np.array(state.attn_k, np.float32)
    v = np.array(state.attn_v, np.float32)
    for b, n in enumerate(prompts_lens):
        k[:, b, :n] = rng.randn(*k[:, b, :n].shape)
        v[:, b, :n] = rng.randn(*v[:, b, :n].shape)
    return state._replace(attn_k=jnp.asarray(k, dtype),
                          attn_v=jnp.asarray(v, dtype),
                          pos=jnp.asarray(prompts_lens, jnp.int32))


def _np_state(state):
    return jax.tree.map(lambda a: None if a is None else np.asarray(a),
                        state)


def _staged(ev):
    return ev.block.view().numpy() if isinstance(ev.block.view(),
                                                 torch.Tensor) \
        else np.asarray(ev.block.view())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("compression", ["none", "int8"])
def test_packed_image_matches_reference(pair, compression, dtype):
    """The same decode state spilled by both tiers: the layout is the
    reference's field by field, and the staged bytes are equal (raw) or
    equal up to one-quantum rounding flips in < 1% of the payload (int8;
    scales to rtol 1e-6)."""
    rcfg, rparams, _, _ = pair
    rstate = _ref_state(rcfg, rparams, dtype=getattr(jnp, dtype))
    pstate = decode_state_from_reference(_np_state(rstate), device="cpu")
    assert pstate.attn_k.dtype == getattr(torch, dtype)
    assert pstate.pos.dtype == torch.int64
    rtier = RHostMemTier(RHostMemConfig(spill_compression=compression,
                                        spill_compress_min_bytes=1))
    ptier = _tier(compression, 1)
    rsp = rtier.kvspill.spill(rstate, 1, tag="s")
    psp = ptier.kvspill.spill(pstate, 1, tag="s")
    assert (psp.pos, psp.nbytes, psp.tag) == (rsp.pos, rsp.nbytes, rsp.tag)
    assert len(psp.layout) == len(rsp.layout) == 2
    for p, r in zip(psp.layout, rsp.layout):
        assert (p.name, p.offset, p.nbytes, tuple(p.shape), p.kind,
                p.scale_offset, p.scale_nbytes) == \
               (r.name, r.offset, r.nbytes, tuple(r.shape), r.kind,
                r.scale_offset, r.scale_nbytes)
        assert str(p.dtype).split(".")[-1] == np.dtype(r.dtype).name
    rtier.engine.synchronize()
    ptier.engine.synchronize()
    pb, rb = _staged(psp.event), _staged(rsp.event)
    assert pb.shape == rb.shape == (psp.nbytes,)
    if compression == "none":
        np.testing.assert_array_equal(pb, rb)
    else:
        for fs in psp.layout:
            q = pb[fs.offset:fs.offset + fs.nbytes].view(np.int8)
            qr = rb[fs.offset:fs.offset + fs.nbytes].view(np.int8)
            diff = np.abs(q.astype(np.int32) - qr.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 0.01
            sl = slice(fs.scale_offset, fs.scale_offset + fs.scale_nbytes)
            np.testing.assert_allclose(pb[sl].view(np.float32),
                                       rb[sl].view(np.float32), rtol=1e-6)
    # both restore into another slot with the same result
    rout = rtier.kvspill.restore(rstate, rsp, 2)
    pout = ptier.kvspill.restore(pstate, psp, 2)
    tol = 0 if compression == "none" else \
        float(np.abs(np.asarray(rstate.attn_k, np.float32)).max()) / 127
    for name in ("attn_k", "attn_v"):
        np.testing.assert_allclose(
            getattr(pout, name)[:, 2].float().numpy(),
            np.asarray(getattr(rout, name)[:, 2], np.float32),
            rtol=0, atol=tol)
    assert int(pout.pos[2]) == int(rout.pos[2]) == 9
    assert rtier.pool.bytes_in_use == ptier.pool.bytes_in_use == 0


def test_spill_stats_match_reference(pair):
    """Spill / restore / discard counters and byte totals, both tiers."""
    rcfg, rparams, _, _ = pair
    for compression in ("none", "int8"):
        rstate = _ref_state(rcfg, rparams)
        pstate = decode_state_from_reference(_np_state(rstate), device="cpu")
        rtier = RHostMemTier(RHostMemConfig(spill_compression=compression))
        ptier = _tier(compression)
        for tier, state in ((rtier, rstate), (ptier, pstate)):
            a = tier.kvspill.spill(state, 0, tag="a")
            b = tier.kvspill.spill(state, 1, tag="b")
            tier.kvspill.discard(a)
            state = tier.kvspill.restore(state, b, 0)
            tier.kvspill.discard(b)
        assert ptier.kvspill.stats() == rtier.kvspill.stats()
        assert (ptier.stats()["engine"]["classes"]["kv_spill"]["n_out"]
                == rtier.stats()["engine"]["classes"]["kv_spill"]["n_out"]
                == 2)


def test_decode_state_from_reference_keeps_every_field(pair):
    rcfg, rparams, _, _ = pair
    rstate = _ref_state(rcfg, rparams, dtype=jnp.bfloat16)
    pstate = decode_state_from_reference(_np_state(rstate), device="cpu")
    for name in pstate._fields:
        r, p = getattr(rstate, name), getattr(pstate, name)
        assert (r is None) == (p is None), name
        if r is not None:
            np.testing.assert_array_equal(
                p.float().numpy(), np.asarray(r, np.float32))
    assert set(STATE_FIELDS) <= set(pstate._fields)


def test_server_stats_schema_matches_reference(pair):
    rcfg, rparams, cfg, model = pair
    srv = Server(cfg, model, max_batch=1, max_len=32, max_active=2)
    rsrv = RefServer(rcfg, rparams, max_batch=1, max_len=32, max_active=2)
    for s in (srv, rsrv):
        for p in _prompts(cfg.vocab_size, 2, seed=4):
            s.submit(p, max_new_tokens=3)
        s.run_until_done(max_ticks=100)
    ps, rs = srv.stats(), rsrv.stats()
    assert set(ps) == set(rs)
    assert set(ps["kv_spill_class"]) == set(rs["kv_spill_class"])
    for k in ("ticks", "active", "spilled", "queued", "completed",
              "preemptions"):
        assert ps[k] == rs[k], k


def test_serve_cli_spills_on_cpu():
    from repro_torch.launch import serve
    base = ["--arch", "llama2-paper", "--reduced", "--device", "cpu",
            "--attn-impl", "flash", "--requests", "4", "--max-batch", "2",
            "--max-active", "4", "--new-tokens", "4", "--max-len", "32",
            "--max-prompt-len", "8"]
    raw = serve.main(base)
    assert raw["preemptions"] > 0 and raw["max_active"] == 4
    assert raw["kvspill"]["n_spills"] == raw["kvspill"]["n_restores"]
    assert raw["hostmem"]["pool"]["bytes_in_use"] == 0
    assert raw["kv_spill_class"]["n_out"] == raw["kvspill"]["n_spills"]
    assert raw["link_curve"] == {}
    q = serve.main(base + ["--spill-compression", "int8", "--calibrate-link"])
    assert q["kvspill"]["compression"] == "int8"
    assert q["kvspill"]["compression_ratio"] > 1.5
    assert q["link_curve"] and q["completed"] == 4
    assert all(len(v) == 4 for v in q["results"].values())


@pytest.mark.parametrize("then", ["restore", "discard"])
def test_failed_spill_is_retained_then_restored_or_discarded(pair, then):
    """A spill whose D2H fails for good keeps its bytes on the device (a
    copy: the slot row is overwritten at once).  Restoring it is bit-exact;
    discarding it frees nothing twice.  (The reference's discard of such an
    image raises AttributeError: ``pool.free(None)``, ROADMAP.md fault F3.)"""
    from repro_torch import faults
    from repro_torch.common.config import ResilienceConfig
    _, _, cfg, model = pair
    srv = _two_slot_server(model, cfg)
    tier = HostMemTier(device="cpu", resilience=ResilienceConfig(
        retry_backoff_s=0.0, max_retries=1))
    before_k = srv.state.attn_k[:, 0].clone()
    plan = faults.FaultPlan([faults.FaultSpec("engine.transfer_error",
                                              prob=1.0, max_fires=2)])
    with faults.injected(plan):
        sp = tier.kvspill.spill(srv.state, 0, tag="doomed")
    srv.state.attn_k[:, 0] = 0                 # the next tenant's prefill
    assert tier.engine.wait(sp.event).failed and sp.event.block is None
    if then == "restore":
        srv.state = tier.kvspill.restore(srv.state, sp, 1)
        assert torch.equal(srv.state.attn_k[:, 1], before_k)
        assert tier.engine.n_hbm_fallback_in == 1
    else:
        tier.kvspill.discard(sp)
        tier.kvspill.discard(sp)
        assert tier.kvspill.n_discards == 1
    assert tier.pool.bytes_in_use == 0 and tier.pool.live_blocks == 0
    tier.pool.check()
