"""The port's training substrate against the reference, on the CPU.

Ports of every ``tests/test_substrate.py`` bar (AdamW, weight decay, the
bf16 master copy, clipping, loss-scale dynamics, ``check_finite``, the
warmup-cosine schedule, synthetic data, checkpoints), each also held
against the reference function on the same numpy inputs.
"""
import os
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpointing.manager import CheckpointManager as RefManager
from repro.common.config import TrainConfig as RefTrainConfig
from repro.data.synthetic import SyntheticTokens as RefTokens
from repro.optim import adamw as RA
from repro.optim import loss_scale as RL
from repro.optim.schedules import warmup_cosine as ref_warmup_cosine
from repro_torch.checkpointing.manager import CheckpointManager
from repro_torch.common.config import TrainConfig
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.optim.adamw import (adamw_init, adamw_update,
                                     clip_by_global_norm, global_norm)
from repro_torch.optim.loss_scale import (check_finite, init_loss_scale,
                                          update_loss_scale)
from repro_torch.optim.schedules import warmup_cosine

torch.set_num_threads(1)      # tier-1 runs several xdist workers


@pytest.fixture
def tmpdir():
    d = tempfile.mkdtemp()
    yield d
    shutil.rmtree(d, ignore_errors=True)


def _tree(seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(8, 5).astype(dtype),
            "b": rng.randn(5).astype(dtype),
            "blocks.0.x": rng.randn(3, 4).astype(dtype)}


# ------------------------------------------------------------------ adamw
def test_adamw_matches_manual():
    tcfg = TrainConfig(learning_rate=0.1, weight_decay=0.0)
    p = {"w": torch.tensor([1.0, 2.0])}
    g = {"w": torch.tensor([0.5, -0.5])}
    st = adamw_init(p)
    st2 = adamw_update(p, g, st, tcfg, torch.tensor(0.1))
    # manual first-step adam: mhat = g, vhat = g^2 -> update ~ -lr*sign(g)
    exp = np.asarray([1.0, 2.0]) - 0.1 * np.sign([0.5, -0.5])
    np.testing.assert_allclose(p["w"].numpy(), exp, rtol=1e-4)
    assert st2.step == 1


@pytest.mark.parametrize("master", [False, True])
def test_adamw_matches_reference(master):
    """Three AdamW steps from the same numpy params and grads: params, m, v
    and the master copy at 1e-6 relative (the reference's formula op for
    op; only the libraries' pow and rounding of constants can differ)."""
    wd, lrs = 0.1, (1e-3, 3e-4, 5e-4)
    rp = {k: jnp.asarray(v) for k, v in _tree(0).items()}
    if master:
        rp = {k: v.astype(jnp.bfloat16) for k, v in rp.items()}
    pp = {k: torch.tensor(np.asarray(v, np.float32)).to(
        torch.bfloat16 if master else torch.float32) for k, v in rp.items()}
    rst, pst = RA.adamw_init(rp), adamw_init(pp)
    assert (rst.master is None) == (pst.master is None) == (not master)
    for i, lr in enumerate(lrs):
        g = _tree(10 + i)
        rp, rst = RA.adamw_update(rp, {k: jnp.asarray(v) for k, v in g.items()},
                                  rst, RefTrainConfig(weight_decay=wd),
                                  jnp.float32(lr))
        pst = adamw_update(pp, {k: torch.tensor(v) for k, v in g.items()},
                           pst, TrainConfig(weight_decay=wd), torch.tensor(lr))
    assert pst.step == int(rst.step) == 3
    for k in rp:
        for ours, theirs in ((pst.m[k], rst.m[k]), (pst.v[k], rst.v[k])):
            np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                       rtol=1e-6, atol=1e-12)
        if master:
            np.testing.assert_allclose(pst.master[k].numpy(),
                                       np.asarray(rst.master[k]), rtol=1e-6)
            # the bf16 parameter is the master rounded: equal but where the
            # masters straddle a rounding boundary (one bf16 ulp)
            np.testing.assert_allclose(pp[k].float().numpy(),
                                       np.asarray(rp[k], np.float32),
                                       rtol=2.0 ** -7)
        else:
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(rp[k]),
                                       rtol=1e-6)


def test_adamw_weight_decay():
    tcfg = TrainConfig(learning_rate=0.1, weight_decay=0.5)
    p = {"w": torch.tensor([10.0])}
    g = {"w": torch.tensor([0.0])}
    st = adamw_init(p)
    adamw_update(p, g, st, tcfg, torch.tensor(0.1))
    assert float(p["w"][0]) < 10.0  # decay shrinks


def test_adamw_master_for_bf16():
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    st = adamw_init(p)
    assert st.master is not None
    assert st.master["w"].dtype == torch.float32


def test_clip_by_global_norm():
    g = {"a": torch.ones(100) * 10.0}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    assert float(norm) == pytest.approx(100.0, rel=1e-5)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_matches_reference(max_norm):
    g = _tree(3)
    rc, rn = RA.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()},
                                    max_norm)
    pc, pn = clip_by_global_norm({k: torch.tensor(v) for k, v in g.items()},
                                 max_norm)
    np.testing.assert_allclose(float(pn), float(rn), rtol=1e-6)
    for k in g:
        np.testing.assert_allclose(pc[k].numpy(), np.asarray(rc[k]),
                                   rtol=1e-6)


# -------------------------------------------------------------- loss scale
def test_loss_scale_dynamics():
    st = init_loss_scale(1024.0)
    st = update_loss_scale(st, finite=False)
    assert float(st.scale) == 512.0
    for _ in range(200):
        st = update_loss_scale(st, finite=True, growth_interval=200)
    assert float(st.scale) == 1024.0


def test_loss_scale_matches_reference():
    rng = np.random.RandomState(0)
    rs, ps = RL.init_loss_scale(2.0 ** 15), init_loss_scale(2.0 ** 15)
    for finite in rng.rand(300) > 0.05:
        rs = RL.update_loss_scale(rs, bool(finite), growth_interval=20)
        ps = update_loss_scale(ps, bool(finite), growth_interval=20)
        assert ps.scale == float(rs.scale)
        assert ps.growth_count == int(rs.growth_count)


def test_check_finite():
    assert bool(check_finite({"a": torch.ones(3)}))
    assert not bool(check_finite({"a": torch.tensor([1.0, np.inf])}))
    assert not bool(check_finite({"a": torch.ones(2),
                                  "b": torch.tensor([np.nan])}))


def test_warmup_cosine_shape():
    lrs = [float(warmup_cosine(s, 1.0, 10, 100)) for s in range(100)]
    assert lrs[0] == 0.0
    assert max(lrs) == pytest.approx(1.0, rel=1e-3)
    assert lrs[5] < lrs[9]           # warming up
    assert lrs[50] > lrs[99]         # decaying
    assert lrs[99] >= 0.1 * 0.99     # final_frac floor


@pytest.mark.parametrize("base,warm,total", [(1.0, 10, 100), (3e-4, 2, 30),
                                             (1e-3, 0, 7)])
def test_warmup_cosine_matches_reference(base, warm, total):
    """The same f32 arithmetic; the two libraries' f32 cos differ in the
    last bit for ~5% of arguments, and ``1 + cos`` magnifies that near the
    end of the decay (cos near -1) to a few ulps, so the decay is held to
    5e-7 relative and the warmup (no cos) to equality."""
    steps = range(total + 3)
    ours = np.asarray([warmup_cosine(s, base, warm, total).numpy()
                       for s in steps], np.float32)
    ref = np.asarray([np.float32(ref_warmup_cosine(s, base, warm, total))
                      for s in steps], np.float32)
    np.testing.assert_array_equal(ours[:warm], ref[:warm])
    np.testing.assert_allclose(ours, ref, rtol=5e-7, atol=0)


# -------------------------------------------------------------------- data
def test_data_deterministic():
    a = SyntheticTokens(1000, 32, 8, seed=3)
    b = SyntheticTokens(1000, 32, 8, seed=3)
    for _ in range(3):
        ba, bb = a.next_batch(), b.next_batch()
        np.testing.assert_array_equal(ba["tokens"], bb["tokens"])
    assert np.all(a.next_batch()["tokens"] < 1000)


@pytest.mark.parametrize("seed,hosts", [(0, 1), (7, 2), (123, 4)])
def test_data_bit_identical_to_reference(seed, hosts):
    for h in range(hosts):
        ours = SyntheticTokens(32000, 33, 8, seed=seed, host_index=h,
                               host_count=hosts)
        ref = RefTokens(32000, 33, 8, seed=seed, host_index=h,
                        host_count=hosts)
        for _ in range(3):
            a, b = ours.next_batch(), ref.next_batch()
            for k in ("tokens", "labels"):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
        assert ours.state() == ref.state()


def test_data_labels_shifted():
    d = SyntheticTokens(1000, 32, 4, seed=0)
    b = d.next_batch()
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_data_host_shards_disjoint():
    full = SyntheticTokens(1000, 16, 8, seed=1, host_index=0, host_count=1)
    h0 = SyntheticTokens(1000, 16, 8, seed=1, host_index=0, host_count=2)
    h1 = SyntheticTokens(1000, 16, 8, seed=1, host_index=1, host_count=2)
    f, a, b = full.next_batch(), h0.next_batch(), h1.next_batch()
    np.testing.assert_array_equal(np.concatenate([a["tokens"], b["tokens"]]),
                                  f["tokens"])


def test_data_resume_exact():
    d = SyntheticTokens(1000, 16, 4, seed=2)
    d.next_batch()
    st = d.state()
    want = d.next_batch()
    d2 = SyntheticTokens(1000, 16, 4, seed=0)
    d2.restore(st)
    got = d2.next_batch()
    np.testing.assert_array_equal(want["tokens"], got["tokens"])


def test_data_prefetch_thread():
    d = SyntheticTokens(1000, 16, 4, seed=5).start()
    ref = RefTokens(1000, 16, 4, seed=5)
    try:
        b1 = d.get()
        b2 = d.get()
        assert not np.array_equal(b1["tokens"], b2["tokens"])
        np.testing.assert_array_equal(b1["tokens"], ref.next_batch()["tokens"])
        np.testing.assert_array_equal(b2["tokens"], ref.next_batch()["tokens"])
        assert d.cursor == 2
    finally:
        d.stop()
    assert d._thread is None


# ------------------------------------------------------------- checkpoints
def _ckpt_tree():
    return {"a": torch.arange(10, dtype=torch.float32),
            "nested": {"b": torch.ones((3, 3), dtype=torch.bfloat16) * 1.5,
                       "c": np.arange(4, dtype=np.int32)}}


def test_checkpoint_roundtrip(tmpdir):
    mgr = CheckpointManager(tmpdir, keep=2)
    tree = _ckpt_tree()
    mgr.save(5, {"params": tree}, extra={"step": 5}, block=True)
    restored, extra = mgr.restore(5, {"params": tree})
    assert extra["step"] == 5
    got = restored["params"]
    assert torch.equal(got["a"], tree["a"])
    assert got["nested"]["b"].dtype == torch.bfloat16
    assert torch.equal(got["nested"]["b"], tree["nested"]["b"])
    np.testing.assert_array_equal(got["nested"]["c"], tree["nested"]["c"])


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_format_matches_reference(tmpdir, writer):
    """One package's checkpoint restores in the other: same files, keys,
    manifest and checksums."""
    rng = np.random.RandomState(0)
    arrs = {"w": rng.randn(4, 3).astype(np.float32),
            "m": {"x": rng.randn(2).astype(np.float32)}}
    jtree = jax.tree.map(jnp.asarray, arrs)
    ttree = {"w": torch.tensor(arrs["w"]), "m": {"x": torch.tensor(arrs["m"]["x"])}}
    if writer == "port":
        CheckpointManager(tmpdir).save(3, {"params": ttree}, extra={"s": 1},
                                       block=True)
        got, extra = RefManager(tmpdir, process_index=0).restore(
            3, {"params": jtree})
        leaves = {"w": got["params"]["w"], "x": got["params"]["m"]["x"]}
    else:
        RefManager(tmpdir, process_index=0).save(3, {"params": jtree},
                                                 extra={"s": 1}, block=True)
        got, extra = CheckpointManager(tmpdir).restore(3, {"params": ttree})
        leaves = {"w": got["params"]["w"], "x": got["params"]["m"]["x"]}
    assert extra == {"s": 1}
    np.testing.assert_array_equal(np.asarray(leaves["w"]), arrs["w"])
    np.testing.assert_array_equal(np.asarray(leaves["x"]), arrs["m"]["x"])
    assert sorted(os.listdir(os.path.join(tmpdir, "step_00000003"))) == [
        "manifest.p0.json", "params.p0.npz"]


def test_checkpoint_gc_keeps_n(tmpdir):
    mgr = CheckpointManager(tmpdir, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"params": {"a": torch.ones(2)}}, block=True)
    assert mgr.all_steps() == [3, 4]


def test_checkpoint_corruption_detected(tmpdir):
    mgr = CheckpointManager(tmpdir, keep=2)
    path = mgr.save(7, {"params": {"a": torch.ones(64)}}, block=True)
    npz = [f for f in os.listdir(path) if f.endswith(".npz")][0]
    fp = os.path.join(path, npz)
    with open(fp, "r+b") as f:
        f.seek(100)
        f.write(b"\xff\xff\xff")
    with pytest.raises(IOError):
        mgr.restore(7, {"params": {"a": torch.ones(64)}})


def test_checkpoint_async(tmpdir):
    mgr = CheckpointManager(tmpdir, keep=3)
    mgr.save(1, {"params": {"a": torch.ones(1000)}})  # async
    mgr.wait()
    assert mgr.latest_step() == 1


def test_checkpoint_stages_through_engine(tmpdir):
    """With a host-tier engine attached, every array is staged on the
    checkpoint traffic class and its slab recycled after the write."""
    from repro_torch.hostmem import HostMemTier
    from repro_torch.hostmem.engine import TC_CHECKPOINT
    tier = HostMemTier(device="cpu")
    mgr = CheckpointManager(tmpdir, engine=tier.engine)
    tree = _ckpt_tree()
    mgr.save(2, {"params": tree}, extra={"step": 2})
    mgr.wait()
    restored, _ = mgr.restore(2, {"params": tree})
    assert torch.equal(restored["params"]["nested"]["b"], tree["nested"]["b"])
    st = tier.engine.stats()
    assert st["classes"][TC_CHECKPOINT]["n_out"] == 3
    assert tier.pool.stats()["bytes_in_use"] == 0
