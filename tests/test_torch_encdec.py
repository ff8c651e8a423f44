"""The encdec family (whisper-large-v3, reduced) against the reference, on
the CPU.

Reduced whisper: 2 encoder and 2 decoder layers, d 64, 4 heads of 16, 32
frames of memory, f32, LayerNorm with bias, QKV bias, a GELU MLP without a
gate, learned positions.  The reference draws the weights; every test
first sets each cross block's ``xgate`` and every bias and norm scale to
nonzero values (``perturbed``): at ``xgate = 0``, the init of both
packages, ``tanh(0)`` multiplies the cross-attention away and with it
every gradient into the cross K/V and the whole encoder.  The port takes
the weights through ``convert.params_from_reference``; inputs are drawn
from a seed with numpy.  ``flash`` runs the port's plain versions of the
kernels (the CPU has no card) against the reference's ``pallas`` in
interpret mode; ``chunked`` runs both packages' chunked attention.

Bars: activations, logits and caches at ``TOL`` (rtol = atol = 2e-3, the
serving slice's bar: f32 in both, summation order only); gradients per
leaf at ``GRAD_REL`` relative Frobenius (``bk``'s, 0 in exact arithmetic,
at 1e-6 absolute); trainer losses at ``LOSS_TOL``
(the reference's bar for two runs that should agree).
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
from repro.core.profiler import profile_jaxpr
from repro.data.synthetic import SyntheticTokens as RTokens
from repro.distributed import steps as RS
from repro.models import whisper as RW
from repro.models.registry import get_api as ref_get_api
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro.runtime.trainer import Trainer as RTrainer
from repro_torch.common.config import ChameleonConfig, TrainConfig
from repro_torch.core.profiler import profile_step
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.distributed import steps as S
from repro_torch.models import convert
from repro_torch.models import whisper as PW
from repro_torch.models.registry import get_api
from repro_torch.runtime.trainer import Trainer

torch.set_num_threads(1)      # tier-1 runs several xdist workers

ARCH = "whisper_large_v3"
TOL = dict(rtol=2e-3, atol=2e-3)
GRAD_REL = 1e-5
LOSS_TOL = dict(rtol=2e-4, atol=2e-4)
REF_IMPL = {"chunked": "chunked", "flash": "pallas"}


@pytest.fixture
def tmpdir():
    d = tempfile.mkdtemp()
    yield d
    shutil.rmtree(d, ignore_errors=True)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def perturbed(params, seed=0):
    """The reference's parameter tree with every ``xgate`` in +-[0.3, 0.9]
    and every bias (``bq``, ``bk``, ``bv``, a norm's ``bias``) and norm
    ``scale`` moved off its init, as jnp arrays."""
    rng = np.random.RandomState(seed)

    def move(path, leaf):
        a = np.asarray(leaf)
        name = path[-1].key
        if name == "xgate":
            return (rng.uniform(0.3, 0.9, a.shape)
                    * rng.choice([-1.0, 1.0], a.shape)).astype(a.dtype)
        if name in ("bq", "bk", "bv", "bias"):
            return (0.1 * rng.randn(*a.shape)).astype(a.dtype)
        if name == "scale":
            return (1.0 + 0.1 * rng.randn(*a.shape)).astype(a.dtype)
        return a
    return jax.tree.map(jnp.asarray,
                        jax.tree_util.tree_map_with_path(move, params))


def pair(arch, impl="chunked", seed=0, **over):
    """(reference cfg, reference params (perturbed), port cfg, port model)
    of the reduced ``arch`` with ``over`` applied to both configs."""
    rcfg = RC.get_reduced(arch).replace(attn_impl=REF_IMPL[impl], **over)
    pcfg = PC.get_reduced(arch).replace(attn_impl=impl, **over)
    rparams, _ = ref_get_api(rcfg).init(rcfg, jax.random.PRNGKey(seed))
    rparams = perturbed(rparams, seed)
    model = convert.params_from_reference(pcfg, np_tree(rparams),
                                          device="cpu")
    return rcfg, rparams, pcfg, model


def memory_of(cfg, B, seed=1):
    T = cfg.encoder_seq if cfg.family == "encdec" else cfg.image_tokens
    return np.random.RandomState(seed).randn(B, T, cfg.d_model).astype(
        np.float32)


def tokens_of(cfg, B, S, seed=2):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.int64)


def batches(cfg, B, S, seed=3):
    """One batch of tokens, labels and random memory for each package."""
    toks = tokens_of(cfg, B, S + 1, seed)
    mem = memory_of(cfg, B, seed)
    rb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:]), "memory": jnp.asarray(mem)}
    pb = {"tokens": t64(toks[:, :-1]), "labels": t64(toks[:, 1:]),
          "memory": torch.tensor(mem)}
    return rb, pb


def check_grads(rcfg, rparams, pcfg, model, rb, pb):
    """One grad step of each package: losses at 1e-5, every gradient leaf
    within GRAD_REL relative Frobenius; returns the port's gradients."""
    scale = 2.0 ** 15
    rloss, rgrads, rfinite = jax.jit(RS.make_grad_step(rcfg, RTrainConfig()))(
        rparams, rb, jnp.float32(scale))
    ploss, pgrads, pfinite = S.make_grad_step(pcfg, TrainConfig())(
        model, pb, scale)
    assert bool(rfinite) and bool(pfinite)
    np.testing.assert_allclose(float(ploss), float(rloss), rtol=1e-5)
    ours = convert.to_reference_tree({n: g.numpy() for n, g in pgrads.items()})
    flat = jax.tree_util.tree_flatten_with_path(np_tree(rgrads))[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(ours))
    for path, leaf in flat:
        node = ours
        for p in path:
            node = node[p.key]
        assert node.shape == leaf.shape, path
        if path[-1].key == "bk":
            # softmax ignores a shift shared by every key: q.(k + bk) adds
            # q.bk to a whole row, so this gradient is 0 up to rounding
            assert max(np.abs(node).max(), np.abs(leaf).max()) <= 1e-6, path
            continue
        assert rel(node, leaf) <= GRAD_REL, (path, rel(node, leaf))
    return pgrads


# --------------------------------------------------------- forward / loss
@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_encode_forward_and_loss_match_reference(impl):
    rcfg, rparams, pcfg, model = pair(ARCH, impl)
    B, S_ = 2, 9
    mem, toks = memory_of(rcfg, B), tokens_of(rcfg, B, S_)
    renc = RW.encode(rcfg, rparams, jnp.asarray(mem))
    rlog, _ = RW.forward(rcfg, rparams, jnp.asarray(toks),
                         memory=jnp.asarray(mem))
    with torch.no_grad():
        penc = PW.encode(pcfg, model, torch.tensor(mem))
        plog, aux = PW.forward(pcfg, model, t64(toks),
                               memory=torch.tensor(mem))
    assert penc.shape == (B, rcfg.encoder_seq, rcfg.d_model)
    np.testing.assert_allclose(penc.numpy(), np.asarray(renc), **TOL)
    assert plog.shape == (B, S_, rcfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(plog.numpy(), np.asarray(rlog), **TOL)
    rb, pb = batches(rcfg, B, S_)
    rl, rm = RW.loss_fn(rcfg, rparams, rb)
    with torch.no_grad():
        pl, pm = PW.loss_fn(pcfg, model, pb)
    np.testing.assert_allclose(float(pl), float(rl), rtol=1e-5)
    np.testing.assert_allclose(float(pm["xent"]), float(rm["xent"]),
                               rtol=1e-5)


def test_logits_softcap_matches_reference():
    """No config sets ``logits_softcap``; with it set on reduced whisper
    and reduced vlm the port's logits are the reference's, inside +-cap."""
    for arch in (ARCH, "llama3_2_vision_90b"):
        rcfg, rparams, pcfg, model = pair(arch, logits_softcap=3.0)
        mem, toks = memory_of(rcfg, 2), tokens_of(rcfg, 2, 7)
        api = get_api(pcfg)
        rlog, _ = ref_get_api(rcfg).forward(rcfg, rparams, jnp.asarray(toks),
                                            memory=jnp.asarray(mem))
        with torch.no_grad():
            plog, _ = api.forward(pcfg, model, t64(toks),
                                  memory=torch.tensor(mem))
        np.testing.assert_allclose(plog.numpy(), np.asarray(rlog), **TOL)
        assert float(plog.abs().max()) < 3.0
        with torch.no_grad():
            raw, _ = api.forward(pcfg.replace(logits_softcap=0.0), model,
                                 t64(toks), memory=torch.tensor(mem))
        assert float(raw.abs().max()) > 3.0     # the cap is what bounds it


# ----------------------------------------------------------------- decode
@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_decode_matches_reference(impl):
    """init_decode_state(memory=, params=) projects the same cross K/V,
    then 5 ticks of decode_step give the reference's logits and caches."""
    rcfg, rparams, pcfg, model = pair(ARCH, impl)
    B = 2
    mem, toks = memory_of(rcfg, B), tokens_of(rcfg, B, 5)
    rstate = RW.init_decode_state(rcfg, B, 16, memory=jnp.asarray(mem),
                                  params=rparams)
    with torch.no_grad():
        pstate = PW.init_decode_state(pcfg, B, 16, params=model,
                                      memory=torch.tensor(mem))
    assert isinstance(pstate, PW.EncDecState)
    for name in ("cross_k", "cross_v"):
        np.testing.assert_allclose(getattr(pstate, name).numpy(),
                                   np.asarray(getattr(rstate, name)), **TOL)
    for t in range(toks.shape[1]):
        rlog, rstate = RW.decode_step(rcfg, rparams,
                                      jnp.asarray(toks[:, t:t + 1]), rstate)
        with torch.no_grad():
            plog, pstate = PW.decode_step(pcfg, model, t64(toks[:, t:t + 1]),
                                          pstate)
        np.testing.assert_allclose(plog.numpy(), np.asarray(rlog), **TOL)
        np.testing.assert_allclose(pstate.attn_k.numpy(),
                                   np.asarray(rstate.attn_k), **TOL)
        np.testing.assert_array_equal(pstate.pos.numpy(),
                                      np.asarray(rstate.pos))


def test_prefill_is_decode_step_token_by_token():
    """The port's encdec prefill feeds the prompt through decode_step (the
    reference has none): its logits are the forward's, and the state it
    leaves decodes the next token as the reference's token-by-token
    state does; the state converts from the reference's exactly."""
    rcfg, rparams, pcfg, model = pair(ARCH, "flash")
    B, S_ = 2, 6
    mem, toks = memory_of(rcfg, B), tokens_of(rcfg, B, S_ + 1)
    api = get_api(pcfg)
    with torch.no_grad():
        plog, pstate = api.prefill(pcfg, model, t64(toks[:, :S_]), 16,
                                   memory=torch.tensor(mem))
        flog, _ = api.forward(pcfg, model, t64(toks[:, :S_]),
                              memory=torch.tensor(mem))
    np.testing.assert_allclose(plog.numpy(), flog.numpy(), **TOL)
    rstate = RW.init_decode_state(rcfg, B, 16, memory=jnp.asarray(mem),
                                  params=rparams)
    for t in range(S_):
        _, rstate = RW.decode_step(rcfg, rparams,
                                   jnp.asarray(toks[:, t:t + 1]), rstate)
    conv = convert.decode_state_from_reference(np_tree(rstate), device="cpu")
    assert isinstance(conv, PW.EncDecState)
    np.testing.assert_array_equal(conv.pos.numpy(), pstate.pos.numpy())
    np.testing.assert_allclose(pstate.attn_k.numpy(), conv.attn_k.numpy(),
                               **TOL)
    rlog, _ = RW.decode_step(rcfg, rparams, jnp.asarray(toks[:, S_:]),
                             rstate)
    with torch.no_grad():
        nlog, _ = api.decode_step(pcfg, model, t64(toks[:, S_:]), pstate)
    np.testing.assert_allclose(nlog.numpy(), np.asarray(rlog), **TOL)


# --------------------------------------------------------------- training
@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_grad_step_matches_reference(impl):
    """Every gradient, the encoder's and the cross K/V's among them
    (nonzero with xgate nonzero), within GRAD_REL of the reference's."""
    rcfg, rparams, pcfg, model = pair(ARCH, impl)
    rb, pb = batches(rcfg, 2, 8)
    grads = check_grads(rcfg, rparams, pcfg, model, rb, pb)
    for name in ("enc_blocks.0.attn.wq", "dec_blocks.1.xattn.wk",
                 "dec_blocks.0.xgate", "enc_pos"):
        assert float(grads[name].norm()) > 0, name


def trainer_vs_train_step(arch, tmpdir, steps=3, seq=16, batch=2):
    """``steps`` steps of the port's Trainer (Chameleon off) from the
    perturbed reference weights and the reference's AdamW state, against
    the reference's ``make_train_step`` on the same batches and zero
    memory (what both trainers feed): losses at LOSS_TOL."""
    rcfg, rparams, pcfg, model = pair(arch)
    tk = dict(steps=10, checkpoint_every=0, checkpoint_dir=tmpdir,
              warmup_steps=2, learning_rate=1e-3)
    tr = Trainer(pcfg, TrainConfig(**tk), ChameleonConfig(enabled=False),
                 data=SyntheticTokens(pcfg.vocab_size, seq, batch, seed=0),
                 device="cpu")
    convert.load_params_from_reference(tr.model, np_tree(rparams))
    ropt = ref_adamw_init(rparams)
    tr.opt_state = convert.opt_state_from_reference(tr.model, np_tree(ropt))
    rep = tr.train(steps)
    step = jax.jit(RS.make_train_step(rcfg, RTrainConfig(**tk)))
    data = RTokens(rcfg.vocab_size, seq, batch, seed=0)
    T = rcfg.encoder_seq if rcfg.family == "encdec" else rcfg.image_tokens
    losses = []
    for i in range(steps):
        b = {k: jnp.asarray(v) for k, v in data.batch_at(i).items()}
        b["memory"] = jnp.zeros((batch, T, rcfg.d_model), jnp.float32)
        rparams, ropt, m = step(rparams, ropt, b, jnp.float32(2.0 ** 15))
        losses.append(float(m["loss"]))
    assert not rep.failures and not rep.skipped_steps
    np.testing.assert_allclose(rep.losses, losses, **LOSS_TOL)
    return tr


def test_trainer_matches_reference_train_step(tmpdir):
    tr = trainer_vs_train_step(ARCH, tmpdir)
    assert tr.step == 3


def checkpoints_cross(arch, tmpdir, **over):
    """A port checkpoint restores in the reference's Trainer (every leaf,
    ``xgate`` included, bit-equal, and AdamW's step and master copy) and a
    reference checkpoint in the port's; ``over`` applies to both
    configs."""
    pcfg = PC.get_reduced(arch).replace(**over)
    rcfg = RC.get_reduced(arch).replace(**over)
    tk = dict(steps=10, checkpoint_every=0, warmup_steps=2,
              learning_rate=1e-3)
    port_dir, ref_dir = (os.path.join(tmpdir, d) for d in ("port", "ref"))
    pt = Trainer(pcfg, TrainConfig(checkpoint_dir=port_dir, **tk),
                 ChameleonConfig(enabled=False),
                 data=SyntheticTokens(pcfg.vocab_size, 8, 2, seed=5),
                 device="cpu")
    pt.train(2)
    pt._checkpoint(block=True)
    rt = RTrainer(rcfg, RTrainConfig(checkpoint_dir=port_dir, **tk),
                  RChameleonConfig(enabled=False),
                  data=RTokens(rcfg.vocab_size, 8, 2, seed=0))
    assert rt.resume() and rt.step == 2
    ours = convert.params_to_reference(pt.model)
    for path, leaf in jax.tree_util.tree_flatten_with_path(np_tree(rt.params))[0]:
        node = ours
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf)
    assert int(rt.opt_state.step) == pt.opt_state.step == 2
    master = convert.opt_state_to_reference(pt.opt_state)["master"]
    assert (master is None) == (rt.opt_state.master is None)
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            np_tree(rt.opt_state.master))[0]:
        node = master
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf)
    rt2 = RTrainer(rcfg, RTrainConfig(checkpoint_dir=ref_dir, **tk),
                   RChameleonConfig(enabled=False),
                   data=RTokens(rcfg.vocab_size, 8, 2, seed=7))
    rt2.train(2)
    rt2._checkpoint(block=True)
    pt2 = Trainer(pcfg, TrainConfig(checkpoint_dir=ref_dir, **tk),
                  ChameleonConfig(enabled=False),
                  data=SyntheticTokens(pcfg.vocab_size, 8, 2, seed=0),
                  device="cpu")
    assert pt2.resume() and pt2.step == 2
    ours = convert.params_to_reference(pt2.model)
    for path, leaf in jax.tree_util.tree_flatten_with_path(np_tree(rt2.params))[0]:
        node = ours
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf)


def test_checkpoints_cross_packages(tmpdir):
    checkpoints_cross(ARCH, tmpdir)


# --------------------------------------------------------------- chameleon
def test_chameleon_stages_match_reference(tmpdir):
    """Reduced whisper with Chameleon on under a 2 MiB budget, 14 steps
    through each package's Trainer: WarmUp, GenPolicy, then Stable, with
    the reference's stage list and transitions."""
    tk = dict(steps=14, checkpoint_every=0, eval_every=0, warmup_steps=2,
              learning_rate=1e-3)
    rcfg, pcfg = RC.get_reduced(ARCH), PC.get_reduced(ARCH)
    rt = RTrainer(rcfg, RTrainConfig(checkpoint_dir=tmpdir, **tk),
                  RChameleonConfig(enabled=True, hbm_budget_bytes=2 << 20),
                  data=RTokens(rcfg.vocab_size, 32, 4, seed=0))
    ref = rt.train(14)
    pt = Trainer(pcfg, TrainConfig(checkpoint_dir=tmpdir, **tk),
                 ChameleonConfig(enabled=True, hbm_budget_bytes=2 << 20),
                 data=SyntheticTokens(pcfg.vocab_size, 32, 4, seed=0),
                 device="cpu")
    rep = pt.train(14)
    pt.rt.close()
    assert not rep.failures
    assert rep.stages == ref.stages
    assert rep.stages[0] == "WarmUp" and rep.stages[-1] == "Stable"
    assert "GenPolicy" in rep.stages
    assert ([tuple(t) for t in pt.rt.machine.transitions]
            == [tuple(t) for t in rt.rt.machine.transitions])


def test_detailed_profile_has_the_reference_candidates():
    """The behaviour parity of the profiler (tests/test_torch_profiler.py)
    on one whisper train step: the same (site, layer) candidates with the
    same bytes, ``cross_kv`` among them, encoder and decoder layers both
    numbered from 0 as the reference's two scans slice them.  Apart from
    the representation differences that file asserts for the decoder:
    the reference's ``ln_in`` (the port's buffer is the previous layer's
    ``resid_post``) and the port's contexts, ``attn_ctx`` and
    ``cross_ctx``, whose reshaped copies the reference's aval matcher
    does not tie to the named (B, S, H, D) variable."""
    rcfg, rparams, pcfg, model = pair(ARCH)
    B, S_ = 4, 64
    api = ref_get_api(rcfg)
    rb = {"tokens": jnp.ones((B, S_), jnp.int32),
          "labels": jnp.ones((B, S_), jnp.int32),
          "memory": jnp.zeros((B, rcfg.encoder_seq, rcfg.d_model))}

    def ref_step(params, batch):
        loss, g = jax.value_and_grad(
            lambda p: api.loss_fn(rcfg, p, batch)[0])(params)
        return loss, jax.tree.map(lambda p, gg: p - 1e-3 * gg, params, g)

    ref = profile_jaxpr(jax.make_jaxpr(ref_step)(rparams, rb), t_iter=1.0)
    pb = {"tokens": torch.ones((B, S_), dtype=torch.int64),
          "labels": torch.ones((B, S_), dtype=torch.int64),
          "memory": torch.zeros((B, pcfg.encoder_seq, pcfg.d_model))}

    def port_step():
        loss, _ = PW.loss_fn(pcfg, model, pb)
        loss.backward()
        with torch.no_grad():
            for p in model.parameters():
                p.sub_(1e-3 * p.grad)
                p.grad = None

    port = profile_step(port_step, device="cpu")

    def by_pair(prof):
        out = {}
        for t in prof.candidates:
            out.setdefault((t.site, t.layer), []).append(t.nbytes)
        return {k: sorted(v) for k, v in out.items()}

    r, p = by_pair(ref), by_pair(port)
    layers = range(rcfg.encoder_layers)
    ref_only = {("ln_in", i) for i in layers}
    port_only = {(s, i) for s in ("attn_ctx", "cross_ctx") for i in layers}
    assert set(r) - set(p) == ref_only
    assert set(p) - set(r) == port_only
    for key in set(r) & set(p):
        assert p[key] == r[key], key
    assert {("cross_kv", i) for i in layers} <= set(p)
    # cross_kv: a K and a V of (B, S_enc, Kh, D) f32 per decoder layer
    assert p[("cross_kv", 0)] == [B * rcfg.encoder_seq * rcfg.kv_dim * 4] * 2
