"""The port's flash-decode wrapper and plain version (K3) against the
reference: its Pallas decode kernel in interpret mode, its oracle
``attention_ref``, and the chunked decode attention of its model.

Inputs come from numpy seeds and go to both packages.  On the CPU the
port's wrapper runs its plain version; the CUDA kernel itself is checked
against that plain version by ``tests/test_torch_cuda_kernels.py`` (marked
``cuda``, skipped without a card) and by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro_torch.configs as PC
from repro.kernels.flash_attention.ops import flash_decode as ref_flash_decode
from repro.kernels.flash_attention.ref import attention_ref
from repro.models import attention as ref_attention
from repro_torch.kernels.flash_attention import ops
from repro_torch.models import attention as port_attention

torch.set_num_threads(1)      # tier-1 runs several xdist workers

# tests/test_kernels.py::test_flash_decode_sweep: (Sk, lens), B 2, H 4 over
# Kh 2, D 32
SWEEP = [(160, (100, 37)), (128, (128, 1)), (512, (512, 300))]
TOL = dict(rtol=2e-3, atol=2e-3)      # f32 on both sides; summation order only


def _inputs(seed, B, Sk, H, Kh, D, scale):
    """q and k at ``scale`` x randn (0.3 as the reference sweep; 2.0 gives
    a peaked softmax, where a wrong mask or rescale moves outputs by about
    |v|), v at 0.3 x randn."""
    rng = np.random.RandomState(seed)
    return (rng.randn(B, 1, H, D).astype(np.float32) * scale,
            rng.randn(B, Sk, Kh, D).astype(np.float32) * scale,
            rng.randn(B, Sk, Kh, D).astype(np.float32) * 0.3)


@pytest.mark.parametrize("Sk,lens", SWEEP)
@pytest.mark.parametrize("scale", [0.3, 2.0])
def test_plain_matches_reference_kernel_and_oracle(Sk, lens, scale):
    B, H, Kh, D = 2, 4, 2, 32
    q, k, v = _inputs(0, B, Sk, H, Kh, D, scale)
    lens_np = np.asarray(lens, np.int32)
    ref = ref_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(lens_np))
    oracle = attention_ref(*(jnp.swapaxes(jnp.asarray(a), 1, 2)
                             for a in (q, k, v)),
                           causal=False, sm_scale=1 / np.sqrt(D),
                           lens=jnp.asarray(lens_np))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tl = torch.from_numpy(lens_np)
    plain = ops.flash_decode_plain(tq, tk, tv, tl)
    wrapped = ops.flash_decode(tq, tk, tv, tl)
    assert plain.shape == (B, 1, H, D) and plain.dtype == torch.float32
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(plain.numpy(),
                               np.swapaxes(np.asarray(oracle), 1, 2), **TOL)
    np.testing.assert_array_equal(wrapped.numpy(), plain.numpy())


def test_zero_length_gives_zeros():
    """``lens[b] = 0`` (decode never passes it): the port's plain version,
    like its kernel, gives zeros; the reference kernel's answer there is
    the mean of its zero-padded V blocks, which depends on its padding.
    The other row is unaffected."""
    B, Sk, H, Kh, D = 2, 160, 4, 2, 32
    q, k, v = _inputs(1, B, Sk, H, Kh, D, 2.0)
    lens = np.array([0, 57], np.int32)
    out = ops.flash_decode(*(torch.from_numpy(a) for a in (q, k, v)),
                           torch.from_numpy(lens))
    assert not out[0].any()
    oracle = attention_ref(*(jnp.swapaxes(jnp.asarray(a[1:]), 1, 2)
                             for a in (q, k, v)),
                           causal=False, sm_scale=1 / np.sqrt(D),
                           lens=jnp.asarray(lens[1:]))
    np.testing.assert_allclose(out[1:].numpy(),
                               np.swapaxes(np.asarray(oracle), 1, 2), **TOL)


@pytest.mark.parametrize("lens", [(1, 64), (40, 7), (64, 200)])
def test_flash_decode_attend_matches_reference_chunked(lens):
    """The port's decode attention under ``flash`` (the decode kernel's
    wrapper) against the reference's ``chunked`` decode ``_attend`` with
    ``kv_len`` (a length past the cache, as pos + 1 can be, included)."""
    rcfg = RC.get_reduced("llama3_2_1b").replace(attn_chunk=16)
    pcfg = PC.get_reduced("llama3_2_1b").replace(attn_impl="flash")
    B, Sk, H, Kh, D = 2, 64, rcfg.num_heads, rcfg.num_kv_heads, rcfg.head_dim
    q, k, v = _inputs(2, B, Sk, H, Kh, D, 2.0)
    kv_len = np.asarray(lens, np.int32)
    ref = ref_attention._attend(rcfg, jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=False,
                                kv_len=jnp.asarray(kv_len))
    before = ops.flash_decode.launches
    got = port_attention._attend(pcfg, *(torch.from_numpy(a)
                                         for a in (q, k, v)),
                                 causal=False,
                                 kv_len=torch.from_numpy(kv_len).long())
    assert ops.flash_decode.launches == before     # the CPU runs the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_cuda_path_raises_instead_of_falling_back(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel path, which
    raises here (no card) and never calls the plain version."""
    def fail(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")
    monkeypatch.setattr(ops, "flash_decode_plain", fail)
    q = torch.empty(1, 1, 2, 32, device="meta")
    k = torch.empty(1, 8, 2, 32, device="meta")
    lens = torch.ones(1, dtype=torch.int32, device="meta")
    before = ops.flash_decode.launches
    with pytest.raises(RuntimeError):
        ops.flash_decode(q, k, k, lens)
    assert ops.flash_decode.launches == before


def test_wrapper_rejects_bad_shapes():
    k = torch.zeros(2, 8, 2, 32)
    lens = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="one query token"):
        ops.flash_decode(torch.zeros(2, 2, 4, 32), k, k, lens)
    with pytest.raises(ValueError, match="kv_lens"):
        ops.flash_decode(torch.zeros(2, 1, 4, 32), k, k, lens[:1])
    with pytest.raises(RuntimeError, match="forward only"):
        ops.flash_decode(torch.zeros(2, 1, 4, 32, requires_grad=True), k, k,
                         lens)
