"""K1's backward on the CPU: ``flash_attention_bwd_plain`` and the autograd
function ``_FlashAttentionFn`` against autograd through the plain forward,
against ``jax.vjp`` of the reference model's ``dense_attention`` (the
top-left causal mask the forward uses), and against the reference's own
flash-attention backward (its ``_flash_bwd`` rule, the Pallas forward in
interpret mode) where that rule agrees with its forward (Sq = Sk).

Inputs from numpy seeds, f32; q and k at 2 x randn so each softmax row is
peaked (a wrong mask or a dropped term moves the gradients by O(1)).
Gradients are compared by relative Frobenius error per tensor at 1e-5
(both sides f32, summed in another order).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.kernels.flash_attention import ops as ref_fa
from repro.models import attention as RAttn
from repro_torch.kernels.flash_attention import ops

torch.set_num_threads(1)      # tier-1 runs several xdist workers

REL = 1e-5
# (B, Sq, Sk, H, Kh, D, causal, kv_lens)
CASES = [
    (2, 24, 24, 4, 2, 16, True, None),           # GQA, causal
    (1, 20, 36, 2, 2, 32, False, None),          # Sq != Sk, not causal
    (2, 17, 30, 4, 1, 16, True, None),           # Sq < Sk, causal (top-left)
    (1, 30, 12, 2, 1, 16, True, None),           # Sq > Sk, causal
    (2, 16, 16, 4, 4, 16, True, (16, 5)),        # kv_lens
    (2, 12, 20, 6, 3, 16, False, (0, 11)),       # a batch row with no valid key
]
IDS = ["gqa", "sq_lt_sk", "causal_sq_lt_sk", "causal_sq_gt_sk", "kv_lens",
       "empty_rows"]


def _inputs(seed, B, Sq, Sk, H, Kh, D):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, Sq, H, D).astype(np.float32) * 2.0
    k = rng.randn(B, Sk, Kh, D).astype(np.float32) * 2.0
    v = rng.randn(B, Sk, Kh, D).astype(np.float32)
    do = rng.randn(B, Sq, H, D).astype(np.float32)
    return q, k, v, do


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _t(a, grad=False):
    return torch.tensor(a, requires_grad=grad)


def _lens(kv_lens):
    return None if kv_lens is None else torch.tensor(kv_lens)


def _autograd_plain(q, k, v, do, causal, kv_lens):
    qt, kt, vt = _t(q, True), _t(k, True), _t(v, True)
    out = ops.flash_attention_plain(qt, kt, vt, causal=causal,
                                    kv_lens=_lens(kv_lens))
    return [g.numpy() for g in torch.autograd.grad(out, (qt, kt, vt), _t(do))]


def _plain_bwd(q, k, v, do, causal, kv_lens):
    qt, kt, vt = _t(q), _t(k), _t(v)
    out, lse = ops.flash_attention_plain(qt, kt, vt, causal=causal,
                                         kv_lens=_lens(kv_lens),
                                         return_lse=True)
    return [g.numpy() for g in ops.flash_attention_bwd_plain(
        qt, kt, vt, out, lse, _t(do), causal=causal, kv_lens=_lens(kv_lens))]


def _ref_dense_vjp(q, k, v, do, causal, kv_lens):
    cfg = RC.get_reduced("llama2_paper")
    lens = None if kv_lens is None else jnp.asarray(kv_lens, jnp.int32)
    _, vjp = jax.vjp(lambda a, b, c: RAttn.dense_attention(
        cfg, a, b, c, causal=causal, kv_len=lens), jnp.asarray(q),
        jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_autograd(case):
    B, Sq, Sk, H, Kh, D, causal, kv_lens = case
    q, k, v, do = _inputs(0, B, Sq, Sk, H, Kh, D)
    want = _autograd_plain(q, k, v, do, causal, kv_lens)
    got = _plain_bwd(q, k, v, do, causal, kv_lens)
    for name, g, w in zip("qkv", got, want):
        assert np.isfinite(g).all()
        assert _rel(g, w) <= REL, (name, _rel(g, w))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_reference_dense_attention(case):
    """The reference model's attention with the top-left mask (F1's oracle):
    rows with no valid key have zero gradient in the port, so they are left
    out of the reference side, whose uniform softmax over masked keys gives
    them a (meaningless) gradient."""
    B, Sq, Sk, H, Kh, D, causal, kv_lens = case
    q, k, v, do = _inputs(1, B, Sq, Sk, H, Kh, D)
    if kv_lens is not None:
        for b, n in enumerate(kv_lens):
            if n == 0:
                do[b] = 0.0           # the row's output is constant there
    want = _ref_dense_vjp(q, k, v, do, causal, kv_lens)
    got = _plain_bwd(q, k, v, do, causal, kv_lens)
    for name, g, w in zip("qkv", got, want):
        assert _rel(g, w) <= REL, (name, _rel(g, w))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_autograd_function_gives_those_gradients(case):
    """``ops.flash_attention`` with inputs that require grad goes through
    ``_FlashAttentionFn``: its forward saves the lse, its backward is the
    backward wrapper (the plain version on the CPU), counted apart from the
    forward's launches (neither launches a kernel here)."""
    B, Sq, Sk, H, Kh, D, causal, kv_lens = case
    q, k, v, do = _inputs(2, B, Sq, Sk, H, Kh, D)
    qt, kt, vt = _t(q, True), _t(k, True), _t(v, True)
    before = (ops.flash_attention.launches, ops.flash_attention_bwd.launches)
    out = ops.flash_attention(qt, kt, vt, causal=causal,
                              kv_lens=_lens(kv_lens))
    assert type(out.grad_fn).__name__ == "_FlashAttentionFnBackward"
    got = [g.numpy() for g in torch.autograd.grad(out, (qt, kt, vt), _t(do))]
    assert (ops.flash_attention.launches,
            ops.flash_attention_bwd.launches) == before
    want = _autograd_plain(q, k, v, do, causal, kv_lens)
    for name, g, w in zip("qkv", got, want):
        assert _rel(g, w) <= REL, (name, _rel(g, w))
    with torch.no_grad():
        ref = ops.flash_attention_plain(qt, kt, vt, causal=causal,
                                        kv_lens=_lens(kv_lens))
    np.testing.assert_allclose(out.detach().numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_lse_is_the_rows_log_sum_exp():
    B, Sq, Sk, H, Kh, D = 2, 10, 14, 4, 2, 16
    q, k, v, _ = _inputs(3, B, Sq, Sk, H, Kh, D)
    lens = torch.tensor([14, 0])
    _, lse = ops.flash_attention_plain(_t(q), _t(k), _t(v), causal=True,
                                       kv_lens=lens, return_lse=True)
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    assert torch.isneginf(lse[1]).all()           # no valid key: -inf
    G = H // Kh
    s = np.einsum("qhd,khd->hqk", q[0], np.repeat(k[0], G, axis=1)) / math.sqrt(D)
    s = np.where(np.tril(np.ones((Sq, Sk), bool))[None], s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    np.testing.assert_allclose(lse[0].numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("B,S,H,Kh,D", [(2, 32, 4, 2, 16), (1, 48, 2, 1, 32)])
def test_matches_reference_flash_backward_at_equal_lengths(B, S, H, Kh, D):
    """At Sq = Sk the reference's ``_flash_bwd`` (a vjp of ``attention_ref``,
    bottom-right mask) agrees with its forward's top-left mask, so its
    gradients of the Pallas path (interpret mode) are the port's."""
    q, k, v, do = _inputs(4, B, S, S, H, Kh, D)
    _, vjp = jax.vjp(lambda a, b, c: ref_fa.flash_attention(a, b, c,
                                                             causal=True),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    got = _plain_bwd(q, k, v, do, True, None)
    for name, g, w in zip("qkv", got, want):
        assert _rel(g, w) <= REL, (name, _rel(g, w))


def test_reference_flash_backward_differs_at_unequal_lengths():
    """F1: the reference pads q and k/v to their own block sizes, and where
    the padded lengths differ (here S 40, block_q 32, block_k 8: 64 query
    rows against 40 keys) its ``_flash_bwd`` masks bottom-right while its
    forward masks top-left, so its gradients are not its forward's.  The
    port follows the forward: it matches ``dense_attention``'s vjp and not
    the reference's flash backward."""
    B, S, H, Kh, D = 1, 40, 2, 2, 16
    q, k, v, do = _inputs(5, B, S, S, H, Kh, D)
    _, vjp = jax.vjp(lambda a, b, c: ref_fa.flash_attention(
        a, b, c, causal=True, block_q=32, block_k=8),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref_flash = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    dense = _ref_dense_vjp(q, k, v, do, True, None)
    got = _plain_bwd(q, k, v, do, True, None)
    assert all(_rel(g, w) <= REL for g, w in zip(got, dense))
    assert max(_rel(g, w) for g, w in zip(got, ref_flash)) > 1e-2
