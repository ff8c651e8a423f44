"""The port's flash-attention wrapper and plain version against the
reference (the Pallas kernel in interpret mode and the model's attention).

Inputs come from numpy seeds and go to both packages.  On the CPU the
port's wrapper runs its plain version; the CUDA kernel itself is checked
against that plain version by ``tests/test_torch_cuda_kernels.py`` (marked
``cuda``, skipped without a card) and by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import ModelConfig as RefModelConfig
from repro.kernels.flash_attention import kernel as ref_kernel
from repro.kernels.flash_attention.ops import flash_attention as ref_flash
from repro.models.attention import dense_attention as ref_dense_attention
from repro_torch.kernels.flash_attention import ops

torch.set_num_threads(1)      # tier-1 runs several xdist workers

SWEEP = [                      # tests/test_kernels.py::test_flash_attention_sweep
    (2, 256, 256, 4, 2, 64, True),
    (1, 128, 384, 4, 4, 32, False),
    (2, 100, 100, 2, 1, 64, True),      # non-multiple of block
    (1, 512, 512, 8, 1, 128, True),     # MQA, head dim 128
    (1, 64, 192, 6, 3, 16, False),
]


def _tol(dtype):
    return (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
            else dict(rtol=2e-3, atol=2e-3))


def _inputs(seed, B, Sq, Sk, H, Kh, D):
    """q and k at 2 x randn (scores with a std of 4, a peaked softmax, so a
    wrong mask or rescale moves outputs by about |v|), v at randn."""
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Sq, H, D).astype(np.float32) * 2.0,
            rng.randn(B, Sk, Kh, D).astype(np.float32) * 2.0,
            rng.randn(B, Sk, Kh, D).astype(np.float32))


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _jax(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("B,Sq,Sk,H,Kh,D,causal", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_kernel(B, Sq, Sk, H, Kh, D, causal, dtype):
    q, k, v = _inputs(0, B, Sq, Sk, H, Kh, D)
    ref = ref_flash(_jax(q, dtype), _jax(k, dtype), _jax(v, dtype),
                    causal=causal)
    tq, tk, tv = (_torch(a, dtype) for a in (q, k, v))
    plain = ops.flash_attention_plain(tq, tk, tv, causal=causal)
    wrapped = ops.flash_attention(tq, tk, tv, causal=causal)
    assert plain.dtype == tq.dtype and plain.shape == tq.shape
    np.testing.assert_allclose(_f32(plain), _f32(ref), **_tol(dtype))
    np.testing.assert_array_equal(_f32(wrapped), _f32(plain))


@pytest.mark.parametrize("Sq,Sk", [(100, 300), (300, 100)])
def test_plain_causal_is_top_left_like_the_model(Sq, Sk):
    """Sq != Sk: the kernel's causal mask is the model's top-left
    ``qpos >= kpos``, not ``attention_ref``'s bottom-right one."""
    q, k, v = _inputs(1, 2, Sq, Sk, 4, 2, 32)
    cfg = RefModelConfig(name="t", family="dense", num_layers=1, d_model=128,
                         num_heads=4, d_ff=8, vocab_size=8, num_kv_heads=2)
    ref = ref_dense_attention(cfg, jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=True)
    out = ops.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                    causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_kv_lens_matches_reference_kernel(causal):
    """Per-batch kv_lens against the Pallas kernel's own ``kv_lens`` mask
    (called directly, (B,H,S,D) layout, block multiples)."""
    B, S, H, Kh, D = 2, 256, 4, 2, 32
    q, k, v = _inputs(2, B, S, S, H, Kh, D)
    lens = np.array([256, 77], np.int32)
    ref = ref_kernel.flash_attention_fwd(
        *(jnp.swapaxes(jnp.asarray(a), 1, 2) for a in (q, k, v)),
        causal=causal, sm_scale=1 / np.sqrt(D), kv_lens=jnp.asarray(lens),
        interpret=True)
    out = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal, kv_lens=torch.from_numpy(lens))
    np.testing.assert_allclose(out.numpy(), np.swapaxes(np.asarray(ref), 1, 2),
                               rtol=2e-3, atol=2e-3)


def test_cuda_path_raises_instead_of_falling_back(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel path, which
    raises here (no card) and never calls the plain version."""
    def fail(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")
    monkeypatch.setattr(ops, "flash_attention_plain", fail)
    q = torch.empty(1, 8, 2, 32, device="meta")
    before = ops.flash_attention.launches
    with pytest.raises(RuntimeError):
        ops.flash_attention(q, q, q, causal=True)
    assert ops.flash_attention.launches == before


def test_wrapper_is_forward_only():
    """Under no_grad the wrapper is the served forward-only call (no graph);
    with grad enabled an input that requires grad goes through
    ``_FlashAttentionFn``, whose backward is tested in
    tests/test_torch_flash_backward.py."""
    q = torch.zeros(1, 8, 2, 32, requires_grad=True)
    with torch.no_grad():
        out = ops.flash_attention(q, q.detach(), q.detach(), causal=True)
    assert out.grad_fn is None and not out.requires_grad
    out = ops.flash_attention(q, q.detach(), q.detach(), causal=True)
    assert type(out.grad_fn).__name__ == "_FlashAttentionFnBackward"


def test_wrapper_rejects_bad_shapes():
    q = torch.zeros(1, 8, 3, 32)
    k = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, k, causal=True)       # 3 heads over 2
