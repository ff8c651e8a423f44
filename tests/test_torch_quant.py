"""The port's int8 quantize / dequantize (K2a, K2b) against the reference,
on the CPU.

On the CPU the port's wrappers run their plain versions; the reference
runs its Pallas kernels in interpret mode (as ``tests/test_kernels.py``
runs them) and its pure-jnp oracle ``quant_offload/ref.py``.  Inputs are
drawn with numpy and handed to both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.quant_offload import ops as RQ
from repro.kernels.quant_offload.ref import dequantize_ref, quantize_ref
from repro_torch.kernels.quant_offload import ops as Q

torch.set_num_threads(1)      # tier-1 runs several xdist workers

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(x_np, dname):
    """The same values as a jax array and a torch tensor of ``dname``
    (bf16 rounding happens once, in JAX; the f32 copy of it is exact)."""
    xj = jnp.asarray(x_np, JDT[dname])
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(TDT[dname])
    return xj, xt


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("shape", [(4, 96, 128), (256, 64), (3, 7, 33),
                                   (13, 96), (5, 1, 17)])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_quantize_matches_reference(shape, dname):
    """Payload against the reference kernel within one quantum on < 1% of
    entries (XLA may fuse x/s into x*(1/s)) and against the oracle exactly
    (both divide in IEEE f32 and round half to even); scales to rtol 1e-6."""
    x_np = np.random.RandomState(0).randn(*shape).astype(np.float32)
    xj, xt = _pair(x_np, dname)
    before = Q.quantize.launches
    q, s = Q.quantize(xt)
    assert Q.quantize.launches == before          # the CPU runs no kernel
    assert q.dtype == torch.int8 and tuple(q.shape) == shape
    assert s.dtype == torch.float32 and tuple(s.shape) == shape[:-1] + (1,)
    qk, sk = RQ.quantize(xj)
    qr, sr = quantize_ref(xj.reshape(-1, shape[-1]))
    qa = q.numpy().reshape(-1, shape[-1]).astype(np.int32)
    diff = np.abs(qa - np.asarray(qk).reshape(qa.shape).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    np.testing.assert_array_equal(qa, np.asarray(qr).astype(np.int32))
    np.testing.assert_allclose(s.numpy().reshape(-1, 1),
                               np.asarray(sk).reshape(-1, 1), rtol=1e-6)
    np.testing.assert_array_equal(s.numpy().reshape(-1, 1), np.asarray(sr))


@pytest.mark.parametrize("shape", [(4, 96, 128), (256, 64), (3, 7, 33)])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_dequantize_bit_equal_to_reference(shape, dname):
    """The same (q, s) through the port, the reference kernel and the
    oracle: bit-equal outputs."""
    rng = np.random.RandomState(1)
    q_np = rng.randint(-127, 128, size=shape).astype(np.int8)
    s_np = (np.abs(rng.randn(*shape[:-1], 1)) / 127).astype(np.float32)
    out = Q.dequantize(torch.from_numpy(q_np), torch.from_numpy(s_np),
                       TDT[dname])
    assert out.dtype == TDT[dname] and tuple(out.shape) == shape
    ref_k = RQ.dequantize(jnp.asarray(q_np), jnp.asarray(s_np), JDT[dname])
    ref_o = dequantize_ref(jnp.asarray(q_np.reshape(-1, shape[-1])),
                           jnp.asarray(s_np.reshape(-1, 1)), JDT[dname])
    got = _np(out)
    np.testing.assert_array_equal(got, np.asarray(ref_k, np.float32))
    np.testing.assert_array_equal(got.reshape(-1, shape[-1]),
                                  np.asarray(ref_o, np.float32))


def test_quantize_rounds_half_to_even_and_zero_rows():
    """amax 127 gives scale 1, so x / scale lands on exact halves; a zero
    row gets the scale 1e-12/127 and a zero payload, as in the reference."""
    x_np = np.array([[127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5],
                     [0.0] * 8], np.float32)
    q, s = Q.quantize(torch.from_numpy(x_np))
    qr, sr = quantize_ref(jnp.asarray(x_np))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(q.numpy()[0], np.round(x_np[0]))
    assert not q.numpy()[1].any()
    np.testing.assert_array_equal(s.numpy(), np.asarray(sr))
    assert s.numpy()[1, 0] == np.float32(1e-12) / np.float32(127)


@given(st.integers(1, 8), st.integers(2, 64), st.integers(0, 2 ** 31 - 1))
@settings(max_examples=30, deadline=None)
def test_quant_error_bound(rows, cols, seed):
    """|x - dq(q(x))| <= amax/127 per row (tests/test_kernels.py), and the
    payload equals the reference oracle's."""
    rng = np.random.RandomState(seed)
    x_np = (rng.randn(rows, cols) * 10 ** rng.uniform(-3, 3)).astype(
        np.float32)
    q, s = Q.quantize(torch.from_numpy(x_np))
    xh = Q.dequantize(q, s, torch.float32).numpy()
    amax = np.max(np.abs(x_np), axis=-1, keepdims=True)
    assert np.all(np.abs(xh - x_np) <= amax / 127.0 + 1e-12)
    qr, _ = quantize_ref(jnp.asarray(x_np))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr))


@given(st.integers(1, 600), st.integers(2, 64),
       st.sampled_from([32, 64, 128, 256]), st.integers(0, 2 ** 31 - 1))
@settings(max_examples=20, deadline=None)
def test_quant_ragged_rows_match_reference_blocks(rows, cols, br, seed):
    """Ragged R: the reference pads to whole blocks of ``br`` rows and
    slices; the port masks rows by index.  Each row is quantized on its
    own, so the port equals the reference's padded kernel (to one quantum
    on < 1%) and its own row-by-row result bit for bit."""
    rng = np.random.RandomState(seed)
    x_np = rng.randn(rows, cols).astype(np.float32)
    xt = torch.from_numpy(x_np)
    q, s = Q.quantize(xt)
    assert tuple(q.shape) == (rows, cols) and tuple(s.shape) == (rows, 1)
    qk, sk = RQ.quantize(jnp.asarray(x_np), block_rows=br)
    diff = np.abs(q.numpy().astype(np.int32) - np.asarray(qk, np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    np.testing.assert_allclose(s.numpy(), np.asarray(sk), rtol=1e-6)
    i = int(rng.randint(rows))
    qi, si = Q.quantize(xt[i:i + 1])
    assert torch.equal(qi[0], q[i]) and torch.equal(si[0], s[i])
    xh = Q.dequantize(q, s, torch.float32).numpy()
    amax = np.max(np.abs(x_np), axis=-1, keepdims=True)
    assert np.all(np.abs(xh - x_np) <= amax / 127.0 + 1e-12)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_compressed_offload_value_and_grad_match_reference(dname):
    """Forward dequant(quant(x)) and the straight-through gradient of the
    reference's custom vjp: d/dx sum(co(x)^2) = 2 co(x)."""
    x_np = np.random.RandomState(2).randn(8, 64).astype(np.float32)
    xj, xt = _pair(x_np, dname)
    step = np.abs(np.asarray(xj, np.float32)).max(-1, keepdims=True) / 127

    def loss(x):
        return jnp.sum(RQ.compressed_offload(x, "ffn_act")
                       .astype(jnp.float32) ** 2)
    ref_v = np.asarray(RQ.compressed_offload(xj, "ffn_act"), np.float32)
    ref_g = np.asarray(jax.grad(loss)(xj), np.float32)
    xt = xt.clone().requires_grad_(True)
    y = Q.compressed_offload(xt, "ffn_act")
    (y.float() ** 2).sum().backward()
    # one quantum where XLA's fused x*(1/s) rounds the other way
    np.testing.assert_allclose(_np(y.detach()), ref_v, rtol=0,
                               atol=float(step.max()) * 1.01)
    assert (_np(y.detach()) != ref_v).mean() < 0.01
    g = _np(xt.grad)
    np.testing.assert_allclose(g, ref_g, rtol=0,
                               atol=2.02 * float(step.max()))
    np.testing.assert_array_equal(g, _np((2 * y.detach().float()).to(
        TDT[dname])))


def test_kernel_row_layout():
    """The layout the CUDA wrappers hand the kernels: one contiguous run,
    or runs along dim 0 (a KV slot row cache[:, b]); anything else raises
    (the CUDA path is not run here, but the layout is plain Python)."""
    x = torch.zeros(6, 5, 4)
    assert Q._layout(x) == (30, 120)
    cache = torch.zeros(3, 4, 10, 2, 8)          # (L, B, Smax, Kh, D)
    assert Q._layout(cache[:, 1]) == (20, 4 * 10 * 2 * 8)
    assert Q._layout(cache[:1, 2]) == (20, 160)   # L 1: contiguous
    with pytest.raises(ValueError, match="contiguous rows"):
        Q._layout(torch.zeros(8, 4).t())
    with pytest.raises(ValueError, match="contiguous rows"):
        Q._layout(cache[:, :, 1])


def test_wrappers_refuse_other_devices():
    """CPU tensors take the plain version; anything else that is not CUDA
    raises (no quiet fallback)."""
    with pytest.raises(RuntimeError, match="one CUDA device or on the CPU"):
        Q.quantize(torch.zeros(4, 8, device="meta"))
    with pytest.raises(TypeError, match="out_dtype or out"):
        Q.dequantize(torch.zeros(2, 4, dtype=torch.int8), torch.ones(2, 1))
    with pytest.raises(ValueError, match="scales"):
        Q.dequantize(torch.zeros(2, 4, dtype=torch.int8), torch.ones(3, 1),
                     torch.float32)


def test_dequantize_into_strided_slot_row():
    """K2b's restore path on the CPU: written into cache[:, b] in place,
    the other slots untouched."""
    rng = np.random.RandomState(3)
    cache = torch.from_numpy(rng.randn(3, 4, 10, 2, 8).astype(np.float32))
    q, s = Q.quantize(cache[:, 1])
    dst = torch.full_like(cache, 7.0)
    out = Q.dequantize(q, s, out=dst[:, 1])
    assert out.data_ptr() == dst[:, 1].data_ptr()
    np.testing.assert_array_equal(dst[:, 1].numpy(),
                                  Q.dequantize_plain(q, s, torch.float32))
    assert bool((dst[:, 0] == 7).all()) and bool((dst[:, 2:] == 7).all())
