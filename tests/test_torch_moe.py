"""The moe family (``repro_torch.models.moe``) against the reference, on
the CPU.

``apply_moe``'s output and load-balance loss against
``repro/models/moe.py::apply_moe`` on the reference's own weights (1e-5),
with the default capacity and with a capacity factor that drops tokens
(the same tokens: the outputs agree, and drops happened); its gradients
against ``jax.grad`` of the same loss after the weights cross through
``models.convert``; the whole reduced model's logits (1e-4); and greedy
``Server`` tokens for reduced ``granite-moe-1b-a400m`` and
``qwen3-moe-30b-a3b`` against the reference's server.  Inputs are made
with numpy from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro_torch.configs as PC
from repro.models import moe as RM
from repro.models import transformer as RT
from repro.models.registry import get_api as ref_get_api
from repro.runtime.server import Server as RefServer
from repro_torch.models import convert
from repro_torch.models import moe as PM
from repro_torch.models import transformer as PT
from repro_torch.runtime.server import Server

torch.set_num_threads(1)      # tier-1 runs several xdist workers

TOL = 1e-5                    # of the largest magnitude
GRAD_REL = 1e-5               # relative Frobenius
ARCHS = ["granite_moe_1b_a400m", "qwen3_moe_30b_a3b"]


def _moe_pair(arch, **kw):
    rcfg = RC.get_reduced(arch).replace(**kw)
    pcfg = PC.get_reduced(arch).replace(**kw)
    rp, _ = RM.init_moe(jax.random.PRNGKey(3), rcfg)
    moe = PM.Moe(pcfg, generator=None, device=torch.device("cpu"))
    with torch.no_grad():
        for k, v in rp.items():
            getattr(moe, k).copy_(torch.from_numpy(np.array(v)))
    return rcfg, rp, pcfg, moe


def _x(seed, B, S, d):
    return np.random.RandomState(seed).randn(B, S, d).astype(np.float32)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


def _dropped(rcfg, rp, x):
    """(token, k) assignments past their expert's capacity in the
    reference's routing of x."""
    T = x.shape[0] * x.shape[1]
    logits = x.reshape(T, -1) @ np.asarray(rp["router"])
    top = np.argsort(-logits, axis=-1, kind="stable")[:, :rcfg.experts_per_token]
    counts = np.bincount(top.reshape(-1), minlength=rcfg.num_experts)
    C = RM.capacity(rcfg, T)
    return int(np.clip(counts - C, 0, None).sum())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_apply_moe_matches_reference(arch, cf):
    """cf 1.25 is the configs' capacity factor; at 0.25 every expert's
    capacity is its floor of 8 slots for 64 tokens x top-2 over 8 experts,
    so tokens are dropped, and the outputs agree only if the same ones
    are."""
    rcfg, rp, pcfg, moe = _moe_pair(arch, moe_capacity_factor=cf)
    x = _x(0, 2, 32, rcfg.d_model)
    rout, raux = RM.apply_moe(rcfg, rp, jnp.asarray(x))
    with torch.no_grad():
        pout, paux = PM.apply_moe(pcfg, moe, torch.from_numpy(x))
    assert pout.shape == x.shape and paux.dtype == torch.float32
    _close(pout.numpy(), np.asarray(rout))
    _close(float(paux), float(raux))
    assert (_dropped(rcfg, rp, x) > 0) == (cf < 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_gradients_match_reference(arch):
    """d/d(x, router, wi_gate, wi_up, wo) of sum(out * g) + aux, the
    capacity factor dropping tokens, against jax.grad."""
    rcfg, rp, pcfg, moe = _moe_pair(arch, moe_capacity_factor=0.5)
    x = _x(1, 2, 32, rcfg.d_model)
    g = _x(2, 2, 32, rcfg.d_model)

    def rloss(params, x_):
        out, aux = RM.apply_moe(rcfg, params, x_)
        return jnp.sum(out * g) + aux

    rgp, rgx = jax.grad(rloss, argnums=(0, 1))(rp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = PM.apply_moe(pcfg, moe, xt)
    ((out * torch.from_numpy(g)).sum() + aux).backward()
    grads = {"x": (xt.grad, rgx)}
    grads.update({k: (getattr(moe, k).grad, rgp[k]) for k in rp})
    for name, (got, want) in grads.items():
        got, want = got.numpy().astype(np.float64), np.asarray(want, np.float64)
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= GRAD_REL, (name, rel)


def test_capacity_matches_reference():
    for arch in ARCHS:
        for n in (1, 7, 64, 4096):
            assert PM.capacity(PC.get_reduced(arch), n) == \
                RM.capacity(RC.get_reduced(arch), n)


@pytest.fixture(scope="module", params=ARCHS)
def model_pair(request):
    rcfg = RC.get_reduced(request.param)
    rparams, _ = ref_get_api(rcfg).init(rcfg, jax.random.PRNGKey(0))
    pcfg = PC.get_reduced(request.param)
    model = convert.params_from_reference(
        pcfg, jax.tree.map(np.asarray, rparams), device="cpu")
    return rcfg, rparams, pcfg, model


def test_forward_logits_match_reference(model_pair):
    """The whole reduced model: logits within 1e-4 of the largest, and the
    summed load-balance loss within 1e-5."""
    rcfg, rparams, pcfg, model = model_pair
    toks = np.random.RandomState(5).randint(0, rcfg.vocab_size, size=(2, 24))
    ref, raux = RT.forward(rcfg, rparams, jnp.asarray(toks))
    with torch.no_grad():
        out, aux = PT.forward(pcfg, model, torch.as_tensor(toks))
    _close(out.numpy(), np.asarray(ref), 1e-4)
    _close(float(aux), float(raux))


def test_weights_cross_both_ways(model_pair):
    """``params_to_reference`` gives back the reference's moe leaves:
    router (L, d, E), wi_gate / wi_up (L, E, d, f), wo (L, E, f, d)."""
    rcfg, rparams, _, model = model_pair
    back = convert.params_to_reference(model)
    flat_r = jax.tree_util.tree_flatten_with_path(rparams)[0]
    assert len(flat_r) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat_r:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    assert back["blocks"]["moe"]["wi_gate"].shape == (
        rcfg.num_layers, rcfg.num_experts, rcfg.d_model, rcfg.moe_d_ff)


def test_server_greedy_tokens_match_reference(model_pair):
    """3 requests over 2 slots, greedy: the same tokens as the reference's
    server (prefill through the moe blocks, then batched decode, whose
    expert capacity is the batch's)."""
    rcfg, rparams, pcfg, model = model_pair
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, rcfg.vocab_size, size=n) for n in (5, 9, 7)]

    def serve(cls, cfg, params):
        srv = cls(cfg, params, max_batch=2, max_len=32)
        rids = [srv.submit(p, max_new_tokens=4) for p in prompts]
        out = srv.run_until_done()
        return [out[r] for r in rids]

    got = serve(Server, pcfg, model)
    assert got == serve(RefServer, rcfg, rparams)
    assert [len(t) for t in got] == [4, 4, 4]
