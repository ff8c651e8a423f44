"""The hybrid family (zamba2: Mamba-2 layers and one shared attention
block) against the reference, on the CPU.

Reduced ``zamba2-1.2b`` (5 Mamba-2 layers, the shared GELU-GLU block
after every 2, f32) on the reference's weights through ``models.convert``:
forward logits (1e-4 of the largest), one grad step's gradients per leaf
(1e-5 relative Frobenius) at 8 tokens (at 16 the reference's are NaN, F5),
token-by-token ``decode_step`` against the full forward and against the
reference's ``decode_step`` (its caches too), and the weights back to the
reference's pytree.  Tokens are made with numpy from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro_torch.configs as PC
from repro.common.config import TrainConfig as RTrainConfig
from repro.distributed import steps as RS
from repro.models import transformer as RT
from repro.models.registry import get_api as ref_get_api
from repro_torch.common.config import TrainConfig
from repro_torch.distributed import steps as S
from repro_torch.models import convert
from repro_torch.models import transformer as PT

torch.set_num_threads(1)      # tier-1 runs several xdist workers

ARCH = "zamba2_1_2b"
LOGIT_TOL = 1e-4              # of the largest |logit|
GRAD_REL = 1e-5


@pytest.fixture(scope="module")
def pair():
    rcfg = RC.get_reduced(ARCH)
    rparams, _ = ref_get_api(rcfg).init(rcfg, jax.random.PRNGKey(0))
    pcfg = PC.get_reduced(ARCH)
    model = convert.params_from_reference(
        pcfg, jax.tree.map(np.asarray, rparams), device="cpu")
    return rcfg, rparams, pcfg, model


def _tokens(seed, B, S_, vocab):
    return np.random.RandomState(seed).randint(0, vocab, size=(B, S_))


def _close(got, want, tol=LOGIT_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_config_shape(pair):
    """Reduced zamba2: 5 Mamba-2 layers, the shared block after layers 2 and
    4 (two KV caches), one Mamba-2 layer after the last."""
    _, _, pcfg, model = pair
    assert pcfg.family == "hybrid" and pcfg.act == "gelu" and pcfg.glu
    assert len(model.blocks) == 5 and hasattr(model, "shared_attn")
    st = PT.init_decode_state(pcfg, 2, 16, params=model)
    assert st.attn_k.shape[0] == 2 and st.ssm_ssd.shape[0] == 5


def test_forward_logits_match_reference(pair):
    rcfg, rparams, pcfg, model = pair
    toks = _tokens(0, 2, 24, rcfg.vocab_size)
    ref, raux = RT.forward(rcfg, rparams, jnp.asarray(toks))
    with torch.no_grad():
        out, aux = PT.forward(pcfg, model, torch.as_tensor(toks))
    assert float(aux) == float(raux) == 0.0
    _close(out.numpy(), np.asarray(ref))


def test_grad_step_matches_reference(pair):
    rcfg, rparams, pcfg, model = pair
    toks = _tokens(1, 2, 9, rcfg.vocab_size)
    rb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    pb = {k: torch.as_tensor(np.array(v), dtype=torch.int64)
          for k, v in rb.items()}
    rloss, rgrads, rfinite = jax.jit(RS.make_grad_step(rcfg, RTrainConfig()))(
        rparams, rb, jnp.float32(1.0))
    ploss, pgrads, pfinite = S.make_grad_step(pcfg, TrainConfig())(
        model, pb, 1.0)
    assert bool(rfinite) and bool(pfinite)
    np.testing.assert_allclose(float(ploss), float(rloss), rtol=1e-5)
    ours = convert.to_reference_tree({n: g.numpy() for n, g in pgrads.items()})
    flat = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray,
                                                             rgrads))[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(ours))
    assert "shared_attn" in ours
    for path, leaf in flat:
        node = ours
        for p in path:
            node = node[p.key]
        rel = (np.linalg.norm(node.astype(np.float64) - leaf)
               / max(np.linalg.norm(leaf), 1e-30))
        assert rel <= GRAD_REL, (path, rel)


def test_decode_matches_forward_and_reference(pair):
    """Token-by-token decode from an empty state: the port's logits equal
    its full forward's at every position, and the reference decode's, with
    the same caches (both shared-block applications' K/V, every Mamba-2
    layer's conv window and SSD state)."""
    rcfg, rparams, pcfg, model = pair
    toks = _tokens(2, 2, 12, rcfg.vocab_size)
    with torch.no_grad():
        full, _ = PT.forward(pcfg, model, torch.as_tensor(toks))
    pstate = PT.init_decode_state(pcfg, 2, 16, params=model)
    rstate = RT.init_decode_state(rcfg, 2, 16)
    for t in range(toks.shape[1]):
        step = toks[:, t:t + 1]
        with torch.no_grad():
            plog, pstate = PT.decode_step(pcfg, model, torch.as_tensor(step),
                                          pstate)
        rlog, rstate = RT.decode_step(rcfg, rparams, jnp.asarray(step),
                                      rstate)
        _close(plog[:, 0].numpy(), full[:, t].numpy())
        _close(plog.numpy(), np.asarray(rlog))
    for name in ("attn_k", "attn_v", "ssm_conv", "ssm_ssd"):
        _close(getattr(pstate, name).numpy(), np.asarray(getattr(rstate, name)))
    np.testing.assert_array_equal(pstate.pos.numpy(), np.asarray(rstate.pos))


def test_weights_cross_both_ways(pair):
    """``params_to_reference`` gives back the reference's pytree, with the
    shared block unstacked beside the stacked Mamba-2 blocks, and the
    reference loads it again."""
    rcfg, rparams, pcfg, model = pair
    back = convert.params_to_reference(model)
    flat = jax.tree_util.tree_flatten_with_path(rparams)[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    toks = jnp.asarray(_tokens(3, 1, 8, rcfg.vocab_size))
    a, _ = RT.forward(rcfg, rparams, toks)
    b, _ = RT.forward(rcfg, jax.tree.map(jnp.asarray, back), toks)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_prefill_raises(pair):
    """The reference serves the hybrid family by decode_step alone (its
    prefill collects no hybrid state), so the port has no prefill for it."""
    _, _, pcfg, model = pair
    with pytest.raises(NotImplementedError, match="decode_step"):
        PT.prefill(pcfg, model, torch.zeros(1, 4, dtype=torch.int64), 8)
