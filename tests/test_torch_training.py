"""The port's training slice against the reference, on the CPU.

Reduced ``llama2-paper`` (f32, 4 layers, d 128) and reduced
``mamba2-780m``.  Both packages start from the reference's initial
parameters and optimizer state (through ``models.convert``) and draw the
same ``SyntheticTokens`` batches; the reference's ``pallas`` attention runs
its kernel in interpret mode, the port's ``flash`` its plain versions (the
CPU has no card).  Bars: one grad step's gradients per leaf at 1e-5
relative Frobenius; 10 ``Trainer`` steps' losses within the reference's own
bar for two runs that should agree (``rtol=2e-4, atol=2e-4``,
``tests/test_trainer_integration.py``).  Then the non-Chameleon tests of
``tests/test_trainer_integration.py`` ported, a reference checkpoint
resumed by the port, ``tests/test_models_smoke.py``'s bars, and the CLI.
"""
import os
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro_torch.configs as PC
from repro.common.config import ChameleonConfig as RChameleonConfig
from repro.common.config import TrainConfig as RTrainConfig
from repro.data.synthetic import SyntheticTokens as RTokens
from repro.distributed import steps as RS
from repro.models.registry import get_api as ref_get_api
from repro.runtime.trainer import Trainer as RTrainer
from repro_torch import obs
from repro_torch.common.config import ChameleonConfig, TrainConfig
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.distributed import steps as S
from repro_torch.models import convert
from repro_torch.models.registry import get_api
from repro_torch.runtime.straggler import StragglerDetector
from repro_torch.runtime.trainer import Trainer

torch.set_num_threads(1)      # tier-1 runs several xdist workers

GRAD_REL = 1e-5
LOSS_TOL = dict(rtol=2e-4, atol=2e-4)
REF_IMPL = {"chunked": "chunked", "dense": "dense", "flash": "pallas"}


@pytest.fixture
def tmpdir():
    d = tempfile.mkdtemp()
    yield d
    shutil.rmtree(d, ignore_errors=True)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _tcfg(cls, d, **kw):
    base = dict(steps=30, checkpoint_every=0, checkpoint_dir=d,
                warmup_steps=2, learning_rate=1e-3)
    return cls(**{**base, **kw})


def _port_trainer(d, impl="chunked", *, seed=0, seq=32, batch=4,
                  arch="llama2_paper", **kw):
    cfg = PC.get_reduced(arch).replace(attn_impl=impl)
    return Trainer(cfg, _tcfg(TrainConfig, d, **kw),
                   ChameleonConfig(enabled=False),
                   data=SyntheticTokens(cfg.vocab_size, seq, batch, seed=seed),
                   device="cpu")


def _ref_trainer(d, impl="chunked", *, seed=0, seq=32, batch=4,
                 arch="llama2_paper", **kw):
    cfg = RC.get_reduced(arch).replace(attn_impl=REF_IMPL[impl])
    return RTrainer(cfg, _tcfg(RTrainConfig, d, **kw),
                    RChameleonConfig(enabled=False),
                    data=RTokens(cfg.vocab_size, seq, batch, seed=seed))


def _start_from_reference(pt, rt):
    """The port trainer takes the reference trainer's initial parameters
    and optimizer state."""
    convert.load_params_from_reference(pt.model, _np(rt.params))
    pt.opt_state = convert.opt_state_from_reference(pt.model,
                                                    _np(rt.opt_state))


def _batch(cfg, seed=3, seq=32, batch=4):
    """Synthetic tokens for each package; for vlm and encdec also
    ``memory``, ones of (batch, image_tokens | encoder_seq, d) in f32."""
    b = SyntheticTokens(cfg.vocab_size, seq, batch, seed=seed).next_batch()
    rb = {k: jnp.asarray(v) for k, v in b.items()}
    pb = {k: torch.as_tensor(v, dtype=torch.int64) for k, v in b.items()}
    T = {"vlm": cfg.image_tokens, "encdec": cfg.encoder_seq}.get(cfg.family)
    if T is not None:
        rb["memory"] = jnp.ones((batch, T, cfg.d_model), jnp.float32)
        pb["memory"] = torch.ones((batch, T, cfg.d_model))
    return rb, pb


def _check_grads(cfg_name, impl, batch_kw=None):
    rcfg = RC.get_reduced(cfg_name)
    pcfg = PC.get_reduced(cfg_name)
    if impl is not None:
        rcfg, pcfg = (rcfg.replace(attn_impl=REF_IMPL[impl]),
                      pcfg.replace(attn_impl=impl))
    rparams, _ = ref_get_api(rcfg).init(rcfg, jax.random.PRNGKey(0))
    model = convert.params_from_reference(pcfg, _np(rparams), device="cpu")
    rb, pb = _batch(rcfg, **(batch_kw or {}))
    scale = 2.0 ** 15
    rloss, rgrads, rfinite = jax.jit(RS.make_grad_step(rcfg, RTrainConfig()))(
        rparams, rb, jnp.float32(scale))
    ploss, pgrads, pfinite = S.make_grad_step(pcfg, TrainConfig())(
        model, pb, scale)
    assert bool(rfinite) and bool(pfinite)
    np.testing.assert_allclose(float(ploss), float(rloss), rtol=1e-5)
    ours = convert.to_reference_tree({n: g.numpy() for n, g in pgrads.items()})
    flat_r = jax.tree_util.tree_flatten_with_path(_np(rgrads))[0]
    assert len(flat_r) == len(jax.tree_util.tree_leaves(ours))
    for path, leaf in flat_r:
        node = ours
        for p in path:
            node = node[p.key]
        assert node.dtype == np.float32
        if rcfg.family == "encdec" and path[-1].key == "bk":
            # softmax ignores a shift shared by every key, so whisper's
            # key-bias gradients are 0 up to rounding in both packages
            assert max(np.abs(node).max(), np.abs(leaf).max()) <= 1e-6, path
            continue
        assert _rel(node, leaf) <= GRAD_REL, (path, _rel(node, leaf))


# ----------------------------------------------------------- grad parity
@pytest.mark.parametrize("impl", ["chunked", "dense", "flash"])
def test_grad_step_matches_reference(impl):
    _check_grads("llama2_paper", impl)


@pytest.mark.parametrize("impl", ["chunked", "dense", "flash"])
def test_trainer_losses_match_reference(tmpdir, impl):
    rt = _ref_trainer(os.path.join(tmpdir, "ref"), impl)
    pt = _port_trainer(os.path.join(tmpdir, "port"), impl)
    _start_from_reference(pt, rt)
    rrep, prep = rt.train(10), pt.train(10)
    assert not prep.failures and not prep.skipped_steps
    np.testing.assert_allclose(prep.losses, rrep.losses, **LOSS_TOL)
    assert prep.stages == [] and prep.policystore is None


@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m", "zamba2_1_2b"])
def test_trainer_losses_match_reference_families(tmpdir, arch):
    """The trainer bar above for the moe and hybrid families: 10 steps from
    the reference's initial state give its losses (2e-4), and the port
    reports the loss's parts (xent + aux = loss; aux > 0 only for moe).
    zamba2 trains at 4 tokens: the reference's gradients through its SSD
    scan turn NaN (F5) once dt |A| summed over a chunk's upper triangle
    passes ~88, which its own updates reach within 10 steps at 8 tokens
    (steps 2, 3, 8 and 9 skipped), so its trainer takes other steps than
    the port's, whose gradients stay finite."""
    seq = 4 if arch == "zamba2_1_2b" else 32
    rt = _ref_trainer(os.path.join(tmpdir, "ref"), arch=arch, seq=seq)
    pt = _port_trainer(os.path.join(tmpdir, "port"), arch=arch, seq=seq)
    _start_from_reference(pt, rt)
    rrep, prep = rt.train(10), pt.train(10)
    assert not rrep.skipped_steps
    assert not prep.failures and not prep.skipped_steps
    np.testing.assert_allclose(prep.losses, rrep.losses, **LOSS_TOL)
    np.testing.assert_allclose(np.add(prep.xent, prep.aux), prep.losses,
                               rtol=1e-6)
    assert all(a > 0 for a in prep.aux) == (arch != "zamba2_1_2b")


def test_reference_checkpoint_resumes_in_port(tmpdir):
    """The reference trainer checkpoints at step 10; the port resumes from
    that directory (params, AdamW m/v, step, loss scale, data cursor) and
    its next 5 losses track the reference's own continuation."""
    rt = _ref_trainer(tmpdir, seed=7)
    rt.train(10)
    rt._checkpoint(block=True)
    cont = rt.train(5).losses[10:]
    pt = _port_trainer(tmpdir, seed=0)
    assert pt.resume() and pt.step == 10
    assert pt.data.state() == {"cursor": 11, "seed": 7}
    np.testing.assert_allclose(pt.loss_scale.scale, float(rt.loss_scale.scale))
    prep = pt.train(5)
    np.testing.assert_allclose(prep.losses, cont, **LOSS_TOL)


def test_port_checkpoint_restores_in_reference(tmpdir):
    pt = _port_trainer(tmpdir, seed=5)
    pt.train(3)
    pt._checkpoint(block=True)
    rt = _ref_trainer(tmpdir)
    assert rt.resume() and rt.step == 3
    ours = convert.params_to_reference(pt.model)
    for path, leaf in jax.tree_util.tree_flatten_with_path(_np(rt.params))[0]:
        node = ours
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf)
    assert int(rt.opt_state.step) == pt.opt_state.step == 3


# ------------------------------- tests/test_trainer_integration.py ported
def test_loss_decreases(tmpdir):
    tr = _port_trainer(tmpdir, seq=64, steps=25)
    rep = tr.train(25)
    first = np.mean(rep.losses[:5])
    last = np.mean(rep.losses[-5:])
    assert last < first, (first, last)


def test_resume_bitexact(tmpdir):
    tr = _port_trainer(tmpdir, seed=7, steps=20)
    tr.train(10)
    tr._checkpoint(block=True)     # single checkpoint at step 10
    cont = tr.train(10)
    ref_losses = cont.losses[:]

    tr2 = _port_trainer(tmpdir, seed=7, steps=20)
    assert tr2.resume()
    assert tr2.step == 10
    rep2 = tr2.train(10)
    np.testing.assert_allclose(ref_losses[10:], rep2.losses, rtol=1e-6)


def test_emergency_checkpoint_on_failure(tmpdir):
    tr = _port_trainer(tmpdir, steps=50, checkpoint_every=10)

    def bomb(step):
        if step == 7:
            raise RuntimeError("injected node failure")

    with pytest.raises(RuntimeError, match="injected"):
        tr.train(50, fault_hook=bomb)
    assert tr.report.failures
    # the emergency checkpoint carries post-step-7 state as step 8, so
    # resume does NOT replay the already-applied update
    assert tr.ckpt.latest_step() == 8

    tr2 = _port_trainer(tmpdir, steps=50)
    assert tr2.resume() and tr2.step == 8
    for (n, a), b in zip(tr.model.named_parameters(), tr2.model.parameters()):
        assert torch.equal(a, b), n


def test_loss_scale_skip_changes_sequence(tmpdir):
    """Force a gradient overflow: the optimizer dispatch is skipped and the
    iteration's op sequence shortens (§2.3's primary cause)."""
    old = obs.set_tracer(obs.SpanTracer())
    try:
        tr = _port_trainer(tmpdir, steps=6)
        tr.loss_scale = tr.loss_scale._replace(scale=1e38)
        before = [p.detach().clone() for p in tr.model.parameters()]
        rep = tr.train(4)
        spans = [r["name"] for r in obs.tracer().records()
                 if r["kind"] == "span"]
    finally:
        obs.set_tracer(old)
    assert rep.skipped_steps, "overflow must skip an optimizer step"
    assert float(tr.loss_scale.scale) < 1e38
    assert spans.count("train_step") == 4
    assert spans.count("apply_step") == 4 - len(rep.skipped_steps)
    assert tr.opt_state.step == 4 - len(rep.skipped_steps)
    unchanged = all(torch.equal(a, b) for a, b in
                    zip(before, tr.model.parameters()))
    assert unchanged == (len(rep.skipped_steps) == 4)


def test_straggler_detection():
    det = StragglerDetector(threshold_sigma=4.0, warmup=3)
    rng = np.random.RandomState(0)
    for s in range(30):
        det.observe(s, 0.10 + abs(rng.randn()) * 0.004)
    assert not det.events
    det.observe(30, 0.50)   # 5x outlier
    assert len(det.events) == 1 and det.events[0].step == 30
    w = det.skew_map({0: 0.1, 1: 0.2})
    assert w[0] > w[1]
    assert abs(sum(w.values()) - 1.0) < 1e-9


def test_straggler_matches_reference():
    from repro.runtime.straggler import StragglerDetector as RDet
    rng = np.random.RandomState(1)
    times = 0.1 + np.abs(rng.randn(60)) * 0.01
    times[[20, 41]] = 0.6
    a, b = StragglerDetector(warmup=4), RDet(warmup=4)
    flags = [(a.observe(i, t), b.observe(i, t)) for i, t in enumerate(times)]
    assert all(x == y for x, y in flags)
    assert [e.step for e in a.events] == [e.step for e in b.events] == [20, 41]


# ------------------------------------ tests/test_models_smoke.py's bars
DECODER_ARCHS = RC.ARCH_IDS + ["llama2_paper"]


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_forward_and_train_step(arch):
    """Every config (dense, moe, ssm, hybrid, vlm, encdec; vlm and encdec
    with ``memory`` of ones in the batch, as tests/test_models_smoke.py's
    ``_batch`` makes it): forward shape and no NaN; one fused train step
    gives a finite loss, advances the optimizer and moves the parameters;
    and the grad step's gradients match the reference's (through the plain
    SSD scan for the ssm-bearing families, the port of the reference's
    differentiable ``ssd_chunked``).  Their gradients are compared at 8
    tokens: at 16 the reference's are not finite (F5,
    ``test_reference_ssm_gradients_overflow``)."""
    rcfg, pcfg = RC.get_reduced(arch), PC.get_reduced(arch)
    rparams, _ = ref_get_api(rcfg).init(rcfg, jax.random.PRNGKey(0))
    model = convert.params_from_reference(pcfg, _np(rparams), device="cpu")
    B, S_ = 2, 16
    _, pb = _batch(pcfg, seed=1, seq=S_, batch=B)
    with torch.no_grad():
        logits, _ = get_api(pcfg).forward(pcfg, model, pb["tokens"],
                                          memory=pb.get("memory"))
    assert logits.shape == (B, S_, pcfg.vocab_size)
    assert not torch.isnan(logits).any()

    from repro_torch.optim.adamw import adamw_init
    before = [p.detach().clone() for p in model.parameters()]
    opt = adamw_init(model)
    step = S.make_train_step(pcfg, TrainConfig(steps=10, warmup_steps=0))
    model, opt, metrics = step(model, opt, pb, 1.0)
    assert np.isfinite(float(metrics["loss"]))
    assert opt.step == 1
    assert any(not torch.allclose(a, b) for a, b in
               zip(before, model.parameters()))
    assert all(torch.isfinite(p).all() for p in model.parameters())
    _check_grads(arch, None, dict(
        seed=1, batch=B,
        seq=8 if pcfg.family in ("ssm", "hybrid") else S_))


def test_reference_ssm_gradients_overflow():
    """F5 (reference side): the reference's ``ssd_chunked`` takes
    ``where(mask, exp(seg), 0)``, and above the diagonal seg is a positive
    sum of dt |A| that overflows exp, so the masked branch's gradient is
    0 * inf = NaN.  At the smoke shape (16 tokens) every gradient that
    passes through the scan is NaN in the reference (its smoke test only
    checks the loss and that parameters moved); the port masks before the
    exp and its gradients are finite."""
    rcfg, pcfg = RC.get_reduced("mamba2_780m"), PC.get_reduced("mamba2_780m")
    rparams, _ = ref_get_api(rcfg).init(rcfg, jax.random.PRNGKey(0))
    model = convert.params_from_reference(pcfg, _np(rparams), device="cpu")
    rb, pb = _batch(rcfg, seed=1, seq=16, batch=2)
    _, rgrads, rfinite = jax.jit(RS.make_grad_step(rcfg, RTrainConfig()))(
        rparams, rb, jnp.float32(1.0))
    loss, pgrads, pfinite = S.make_grad_step(pcfg, TrainConfig())(
        model, pb, 1.0)
    assert not bool(rfinite)
    assert not np.isfinite(np.asarray(rgrads["blocks"]["ssm"]["A_log"])).all()
    assert bool(pfinite) and np.isfinite(float(loss))


# ------------------------------------------------------------------- CLI
@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_train_cli_on_cpu(tmpdir, impl):
    from repro_torch.launch import train
    stats = train.main(["--reduced", "--device", "cpu", "--no-chameleon",
                        "--steps", "3", "--seq", "32", "--global-batch", "2",
                        "--attn-impl", impl, "--ckpt-dir", tmpdir])
    assert stats["steps"] == 3 and stats["attn_impl"] == impl
    assert len(stats["losses"]) == 3 and np.isfinite(stats["losses"]).all()
    assert len(stats["checkpoints"]) == 3


def test_chameleon_and_later_slices_raise(tmpdir):
    """Chameleon runs in the trainer and in the CLI (``--budget-gib``,
    ``--stats-json``, the policy store's flags, ``--adapt-mode``);
    ``--mesh single`` raises without the mesh's 256 ranks; the vlm and
    encdec families train a step through the CLI."""
    import json
    from repro_torch.launch import train
    cfg = PC.get_reduced("llama2_paper")
    tr = Trainer(cfg, _tcfg(TrainConfig, tmpdir),
                 ChameleonConfig(enabled=True),
                 data=SyntheticTokens(cfg.vocab_size, 32, 2, seed=0),
                 device="cpu")
    rep = tr.train(3)
    assert len(rep.losses) == 3 and np.isfinite(rep.losses).all()
    assert rep.stages == ["WarmUp"] * 3 and rep.policystore is not None
    path = os.path.join(tmpdir, "stats.json")
    stats = train.main(["--reduced", "--device", "cpu", "--steps", "3",
                        "--seq", "32", "--global-batch", "2",
                        "--budget-gib", "0.004", "--stats-json", path,
                        "--ckpt-dir", tmpdir])
    assert stats["steps"] == 3 and len(stats["stages"]) == 3
    assert stats["applied"] != "baseline-save-sites"    # 4 MiB needs swaps
    with open(path) as f:
        snap = json.load(f)
    assert snap["runtime"]["stage"] == "WarmUp"
    assert snap["runtime"]["hostmem"]["engine"]["bytes_out"] > 0
    # the production mesh needs its 256 ranks (one process here)
    with pytest.raises(RuntimeError, match="256"):
        train.main(["--reduced", "--device", "cpu", "--no-chameleon",
                    "--mesh", "single"])
    # the policy store's flags and the background placements (once
    # refused) run: the store persists the worker's record in the dir
    store = os.path.join(tmpdir, "store")
    stats = train.main(["--reduced", "--device", "cpu", "--no-chameleon",
                        "--steps", "1", "--seq", "32", "--global-batch",
                        "2", "--policy-store-dir", store, "--ckpt-dir",
                        tmpdir])
    assert stats["steps"] == 1 and "adapt" not in stats
    stats = train.main(["--reduced", "--device", "cpu", "--adapt-mode",
                        "async", "--steps", "12", "--seq", "32",
                        "--global-batch", "2", "--policy-store-dir", store,
                        "--ckpt-dir", tmpdir])
    assert stats["adapt"]["mode"] == "async" and stats["adapt"]["jobs"] >= 1
    assert "GenPolicy" not in stats["stages"]
    assert stats["policystore"]["store"]["dir"] == store
    assert os.listdir(store)
    stats = train.main(["--reduced", "--device", "cpu", "--no-policy-store",
                        "--adapt-mode", "speculative", "--steps", "3",
                        "--seq", "32", "--global-batch", "2", "--ckpt-dir",
                        tmpdir])
    assert stats["policystore"] is None
    assert stats["adapt"]["mode"] == "speculative"
    for arch in ("llama-3.2-vision-90b", "whisper-large-v3"):
        stats = train.main(["--arch", arch, "--reduced", "--device", "cpu",
                            "--no-chameleon", "--steps", "1", "--seq", "16",
                            "--global-batch", "2", "--ckpt-dir", tmpdir])
        assert stats["steps"] == 1 and np.isfinite(stats["losses"]).all()


def test_entry_points_refuse_cpu_fallback(tmpdir, monkeypatch):
    """With no card and no ``device='cpu'`` the trainer and the CLI raise."""
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PC.get_reduced("llama2_paper")
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(cfg, _tcfg(TrainConfig, tmpdir))
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--reduced", "--no-chameleon", "--steps", "1",
                    "--ckpt-dir", tmpdir])
