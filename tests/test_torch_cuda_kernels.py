"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: without a card every test skips.  A GPU machine need not
have JAX, so this file imports neither JAX nor the reference and runs
without the repository's conftest (which imports JAX):

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops

SWEEP = [                      # tests/test_kernels.py::test_flash_attention_sweep
    (2, 256, 256, 4, 2, 64, True, None),
    (1, 128, 384, 4, 4, 32, False, None),
    (2, 100, 100, 2, 1, 64, True, None),
    (1, 512, 512, 8, 1, 128, True, None),
    (1, 64, 192, 6, 3, 16, False, None),
    (1, 100, 300, 4, 2, 32, True, None),        # causal, Sq != Sk (top-left)
    (1, 300, 100, 4, 2, 32, True, None),
    (2, 256, 256, 8, 2, 128, True, (256, 77)),  # kv_lens
    # the bf16 kernel's edges: Sq not a multiple of its 64- or 128-row query
    # tile or of its 128-key tile, Sk > Sq with kv_lens (a partly valid key
    # tile), head dims 16 / 32 / 64 (32- and 64-byte swizzles), GQA 32 / 8,
    # and B 2 (a tile past S must not read the next batch row)
    (2, 200, 200, 8, 2, 16, True, None),
    (2, 130, 330, 4, 4, 32, False, (330, 201)),
    (1, 193, 257, 4, 2, 64, True, (250,)),
    (2, 160, 160, 32, 8, 128, True, None),
    (2, 77, 300, 32, 8, 128, False, (300, 129)),
    # a GQA group of 7 (qwen2-7b: 28 query heads over 4 KV heads of 128),
    # then 7 over 1 at head dim 64 with a partly valid key tile
    (2, 200, 200, 28, 4, 128, True, None),
    (1, 150, 260, 7, 1, 64, False, (201,)),
]
# q and k at 2 x randn give scores q.k/sqrt(D) with a std of 4, so each
# row's softmax is peaked and a lost KV tile or a missing rescale moves the
# output by about |v|.  Limits as in chip_smoke.py: elementwise TOL, relative
# Frobenius FRO_TOL, and MAX_TOL of the largest |ref| (bf16: 2 to 4 ulps).
QK_SCALE = 2.0
TOL = {"float32": 2e-3, "bfloat16": 2e-2}
FRO_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
MAX_TOL = {"float32": 2.0 ** -14, "bfloat16": 2.0 ** -6}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,Kh,D,causal,lens", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_matches_plain(card, B, Sq, Sk, H, Kh, D,
                                              causal, lens, dtype):
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(*shape).astype(np.float32) * scale)
               .to(card, getattr(torch, dtype))
               for shape, scale in (((B, Sq, H, D), QK_SCALE),
                                    ((B, Sk, Kh, D), QK_SCALE),
                                    ((B, Sk, Kh, D), 1.0)))
    kv_lens = None if lens is None else torch.tensor(lens, device=card)
    before = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal=causal, kv_lens=kv_lens)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    ref = ops.flash_attention_plain(q, k, v, causal=causal, kv_lens=kv_lens)
    o, r = out.float().cpu().numpy(), ref.float().cpu().numpy()
    np.testing.assert_allclose(o, r, rtol=TOL[dtype], atol=TOL[dtype])
    assert np.linalg.norm(o - r) <= FRO_TOL[dtype] * np.linalg.norm(r)
    assert np.abs(o - r).max() <= MAX_TOL[dtype] * np.abs(r).max()


BWD_SWEEP = [                  # K1 backward: GQA, causal, Sq != Sk, kv_lens
    (2, 256, 256, 4, 2, 64, True, None),
    (1, 100, 300, 4, 2, 32, True, None),
    (1, 300, 100, 4, 4, 16, True, None),
    (2, 130, 330, 4, 4, 32, False, (330, 0)),
    (2, 160, 160, 32, 8, 128, True, (160, 77)),
    # the bf16 kernels' edges: Sq and Sk not multiples of their 64- and
    # 128-row tiles (the tensor maps zero-fill past S), head dims 16 and 32
    # (32- and 64-byte swizzles), a GQA group of 8 with a zero kv_len
    (2, 77, 201, 4, 2, 64, False, None),
    (1, 333, 333, 8, 4, 128, True, None),
    (2, 190, 95, 4, 4, 32, True, (95, 50)),
    (2, 131, 131, 4, 1, 16, True, None),
    (1, 250, 70, 8, 2, 32, False, (70,)),
    (2, 150, 150, 16, 2, 64, True, (150, 0)),
    # a GQA group of 7: dK / dV summed over 7 query heads (qwen2-7b's 28
    # over 4 at head dim 128, and 7 over 1 at 64)
    (2, 160, 160, 28, 4, 128, True, (160, 77)),
    (1, 130, 130, 7, 1, 64, True, None),
]
# dq, dk, dv against flash_attention_bwd_plain on the same inputs (o and lse
# from the forward kernel), as chip_smoke.py holds them: relative Frobenius
# and max error of the largest |ref|.  bf16: P and dS are rounded to bf16 for
# their products and the outputs to bf16; f32: summation order only.
BWD_FRO_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
BWD_MAX_TOL = {"float32": 2.0 ** -12, "bfloat16": 2.0 ** -5}


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,Kh,D,causal,lens", BWD_SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_kernel_matches_plain(card, B, Sq, Sk, H, Kh, D,
                                                  causal, lens, dtype):
    rng = np.random.RandomState(1)
    q, k, v, do = (torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                    * scale).to(card, getattr(torch, dtype))
                   for shape, scale in (((B, Sq, H, D), QK_SCALE),
                                        ((B, Sk, Kh, D), QK_SCALE),
                                        ((B, Sk, Kh, D), 1.0),
                                        ((B, Sq, H, D), 1.0)))
    kv_lens = None if lens is None else torch.tensor(lens, device=card)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    fwd = ops.flash_attention.launches
    bwd = ops.flash_attention_bwd.launches
    out = ops.flash_attention(qg, kg, vg, causal=causal, kv_lens=kv_lens)
    got = torch.autograd.grad(out, (qg, kg, vg), do)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == fwd + 1
    assert ops.flash_attention_bwd.launches == bwd + 1
    _, lse = ops.flash_attention_plain(q, k, v, causal=causal,
                                       kv_lens=kv_lens, return_lse=True)
    ref = ops.flash_attention_bwd_plain(q, k, v, out.detach(), lse, do,
                                        causal=causal, kv_lens=kv_lens)
    for g, r in zip(got, ref):
        g, r = g.float().cpu().numpy(), r.float().cpu().numpy()
        assert np.isfinite(g).all()
        assert np.linalg.norm(g - r) <= BWD_FRO_TOL[dtype] * np.linalg.norm(r)
        assert np.abs(g - r).max() <= BWD_MAX_TOL[dtype] * np.abs(r).max()


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,Kh,D,causal,lens", [
    (2, 256, 256, 8, 8, 128, True, (256, 100)),
    (1, 333, 333, 8, 4, 128, True, None),
    (2, 150, 150, 16, 2, 64, True, (150, 0)),
    (2, 160, 160, 28, 4, 128, True, (160, 77)),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_kernel_repeats_bit_for_bit(card, B, Sq, Sk, H, Kh,
                                                        D, causal, lens, dtype):
    """No atomics: two launches on the same inputs give the same bits, which
    is what makes training losses and resumes repeat exactly."""
    rng = np.random.RandomState(2)
    q, k, v, do = (torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                    * scale).to(card, getattr(torch, dtype))
                   for shape, scale in (((B, Sq, H, D), QK_SCALE),
                                        ((B, Sk, Kh, D), QK_SCALE),
                                        ((B, Sk, Kh, D), 1.0),
                                        ((B, Sq, H, D), 1.0)))
    kv_lens = None if lens is None else torch.tensor(lens, device=card)
    o, lse = ops._forward(q, k, v, causal=causal, sm_scale=D ** -0.5,
                          kv_lens=kv_lens, with_lse=True)
    first = ops.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                    kv_lens=kv_lens)
    second = ops.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                     kv_lens=kv_lens)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_attention_rejects_unsupported_head_dim(card):
    q = torch.zeros(1, 8, 2, 48, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, q, q, causal=True)


# ------------------------------------------- int8 quantize / dequantize
from repro_torch.kernels.quant_offload import ops as Q  # noqa: E402

# tests/test_kernels.py::test_quant_matches_ref, then ragged row counts (not
# a multiple of the kernels' 8 rows per block) and F below one warp
QUANT_SHAPES = [(4, 96, 128), (256, 64), (3, 7, 33), (1001, 128), (13, 96),
                (5, 17)]


def _quant_both(x, out=None):
    """K2a and K2b on ``x`` and their plain versions; K2b writes into
    ``out`` when given.  Returns kernel and plain (q, s, x) triples."""
    before = (Q.quantize.launches, Q.dequantize.launches)
    q, s = Q.quantize(x)
    y = Q.dequantize(q, s, x.dtype, out=out)
    torch.cuda.synchronize()
    assert (Q.quantize.launches, Q.dequantize.launches) == (before[0] + 1,
                                                            before[1] + 1)
    qp, sp = Q.quantize_plain(x)
    return (q, s, y), (qp, sp, Q.dequantize_plain(q, s, x.dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", QUANT_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_kernels_bit_exact(card, shape, dtype):
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32) * 3).to(
        card, getattr(torch, dtype))
    (q, s, y), (qp, sp, yp) = _quant_both(x)
    assert q.dtype == torch.int8 and q.shape == x.shape
    assert s.dtype == torch.float32 and s.shape == x.shape[:-1] + (1,)
    assert torch.equal(q, qp) and torch.equal(s, sp) and torch.equal(y, yp)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_kernels_strided_slot_row(card, dtype):
    """A KV slot row cache[:, b] of an (L, B, Smax, Kh, D) cache: quantized
    and restored in place, zero rows past the filled positions included;
    the other slots are untouched."""
    rng = np.random.RandomState(1)
    cache = torch.from_numpy(rng.randn(4, 3, 64, 4, 128).astype(np.float32)
                             ).to(card, getattr(torch, dtype))
    cache[:, :, 40:] = 0
    restored = torch.full_like(cache, 7.0)
    x, dst = cache[:, 1], restored[:, 1]
    assert not x.is_contiguous()
    (q, s, y), (qp, sp, yp) = _quant_both(x, out=dst)
    assert y.data_ptr() == dst.data_ptr()
    assert torch.equal(q, qp) and torch.equal(s, sp)
    assert torch.equal(restored[:, 1], yp)
    assert bool((restored[:, 0] == 7).all()) and bool((restored[:, 2] == 7).all())
    assert float(s[:, 40:].max()) == float(np.float32(1e-12) / np.float32(127))


def _quant_kernel(x):
    """The K2a kernel ``Q.quantize(x)`` launches, by the name torch.profiler
    records: "vector" (``quant_vec_rows``) or "scalar" (``quant_rows``).
    The profiler can miss a kernel in a process's first sessions, so a
    session that recorded neither kernel is run again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            Q.quantize(x)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA]
        if any("quant_vec_rows" in k for k in names):
            return "vector"
        if any("quant_rows" in k and "dequant_rows" not in k for k in names):
            return "scalar"
    raise AssertionError("the profiler recorded no K2a kernel in 5 sessions")


# K2a's kernel by layout: rows of 16 * 2^k bytes up to 512, 16-byte aligned
# (the KV spill's strided slot rows in both dtypes), take the vector kernel;
# F 96 in bf16 (12 lanes) or f32 (24), and F 33, take the warp-per-row one.
QUANT_PATHS = [
    ((6, 3, 96, 8, 128), "float32", True, "vector"),
    ((6, 3, 96, 8, 128), "bfloat16", True, "vector"),
    ((2, 40, 256), "bfloat16", False, "vector"),
    ((13, 96), "bfloat16", False, "scalar"),
    ((3, 7, 33), "float32", False, "scalar"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,slot_row,path", QUANT_PATHS)
def test_quant_kernel_path_and_bits(card, shape, dtype, slot_row, path):
    """Each layout takes the kernel it should (``quant_vec_rows`` or
    ``quant_rows``), and both are bit-exact; a slot row cache[:, 1] is
    quantized and restored in place, rows of zeros included."""
    rng = np.random.RandomState(2)
    full = torch.from_numpy(rng.randn(*shape).astype(np.float32) * 3).to(
        card, getattr(torch, dtype))
    out = None
    if slot_row:
        full[:, :, 70:] = 0
        x, out = full[:, 1], torch.zeros_like(full)[:, 1]
    else:
        x = full
    assert _quant_kernel(x) == path
    (q, s, y), (qp, sp, yp) = _quant_both(x, out=out)
    assert torch.equal(q, qp) and torch.equal(s, sp) and torch.equal(y, yp)


@pytest.mark.cuda
def test_quant_kernel_rounds_half_to_even(card):
    """amax 127 gives scale 1, so x / scale lands on exact halves."""
    row = np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5],
                   np.float32)
    x = torch.from_numpy(row[None]).to(card)
    q, s = Q.quantize(x)
    torch.cuda.synchronize()
    assert float(s) == 1.0
    np.testing.assert_array_equal(q.cpu().numpy()[0],
                                  np.round(row).astype(np.int8))


@pytest.mark.cuda
def test_quant_kernels_reject_what_they_do_not_take(card):
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        Q.quantize(torch.zeros(4, 8, device=card, dtype=torch.float16))
    with pytest.raises(ValueError, match="contiguous rows"):
        Q.quantize(torch.zeros(8, 4, device=card).t())
    with pytest.raises(RuntimeError, match="one CUDA device or on the CPU"):
        Q.dequantize(torch.zeros(2, 4, dtype=torch.int8, device=card),
                     torch.ones(2, 1), torch.float32)


@pytest.mark.cuda
def test_swap_out_source_released_at_issue(card):
    """A swap-out's device source is marked with record_stream on its
    class's D2H stream and dropped at issue: an int8 payload is no longer
    allocated once the caller lets go of it, before the engine retires the
    copy, and the staged bytes are still the payload's."""
    from repro_torch.hostmem import HostMemTier
    from repro_torch.hostmem.engine import TC_KV_SPILL
    eng = HostMemTier(device=card).engine
    q, s = Q.quantize(torch.randn(4096, 128, device=card))
    want = torch.cat([q.reshape(-1).view(torch.uint8),
                      s.reshape(-1).view(torch.uint8)]).cpu()
    nbytes = q.numel() + 4 * s.numel()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(card)
    ev = eng.submit_swap_out([q, s], "payload", cls=TC_KV_SPILL)
    assert ev._source is None and not ev.done
    del q, s
    assert torch.cuda.memory_allocated(card) <= before - nbytes
    back = eng.wait(eng.submit_swap_in(ev)).result
    torch.cuda.synchronize()
    assert torch.equal(back.cpu(), want)


# ------------------------------------------------------- flash-decode (K3)
# (B, Sk, H, Kh, D, lens): tests/test_kernels.py::test_flash_decode_sweep,
# then GQA groups of 4 and 8, head dim 16, llama2-paper's decode shape with
# ragged lens, and a zero length (zeros, by the kernel's contract)
DECODE_SWEEP = [
    (2, 160, 4, 2, 32, (100, 37)),
    (2, 128, 4, 2, 32, (128, 1)),
    (2, 512, 4, 2, 32, (512, 300)),
    (2, 256, 16, 4, 64, (200, 3)),
    (1, 300, 8, 1, 128, (299,)),
    (3, 96, 6, 3, 16, (96, 50, 0)),
    (4, 1024, 32, 32, 128, (1, 37, 700, 1024)),
    # the split kernel's edges (256 keys per split for the first two shapes,
    # 128 for the third, 64 with D 16): lens on a split boundary, one past
    # and one short of it, and Smax; B 1 with Smax 4096 (16 splits with
    # keys); B 8 with one long row and seven short; a split holding one key
    (4, 1024, 32, 32, 128, (256, 512, 257, 255)),
    (1, 4096, 32, 32, 128, (4000,)),
    (8, 1024, 32, 8, 128, (1000, 1, 2, 3, 5, 9, 17, 33)),
    (2, 200, 8, 2, 16, (129, 65)),
    (2, 160, 4, 2, 32, (300, 37)),              # lens past Smax: all rows
    # a GQA group of 7 splits into blocks of 4 and 3 query heads (the last
    # block partial): qwen2-7b's decode shape with ragged lens, one under a
    # split, and 7 over 1 at head dim 64
    (4, 1024, 28, 4, 128, (1, 100, 700, 1024)),
    (2, 300, 7, 1, 64, (299, 130)),
]


def _decode_inputs(card, B, Sk, H, Kh, D, dtype, seed=0):
    """Peaked q and k (2 x randn) and a random cache everywhere, rows past
    ``lens`` included: a kernel that reads them gives another answer."""
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randn(*shape).astype(np.float32) * scale)
            .to(card, getattr(torch, dtype))
            for shape, scale in (((B, 1, H, D), QK_SCALE),
                                 ((B, Sk, Kh, D), QK_SCALE),
                                 ((B, Sk, Kh, D), 1.0)))


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sk,H,Kh,D,lens", DECODE_SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_kernel_matches_plain(card, B, Sk, H, Kh, D, lens, dtype):
    q, k, v = _decode_inputs(card, B, Sk, H, Kh, D, dtype)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=card)
    before = ops.flash_decode.launches
    out = ops.flash_decode(q, k, v, lens_t)
    torch.cuda.synchronize()
    assert ops.flash_decode.launches == before + 1
    ref = ops.flash_decode_plain(q, k, v, lens_t)
    o, r = out.float().cpu().numpy(), ref.float().cpu().numpy()
    np.testing.assert_allclose(o, r, rtol=TOL[dtype], atol=TOL[dtype])
    assert np.linalg.norm(o - r) <= FRO_TOL[dtype] * np.linalg.norm(r)
    assert np.abs(o - r).max() <= MAX_TOL[dtype] * np.abs(r).max()
    for b, n in enumerate(lens):
        if n == 0:
            assert not o[b].any()


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sk,H,Kh,D,lens", DECODE_SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_lse_matches_plain(card, B, Sk, H, Kh, D, lens, dtype):
    """K3's optional log-sum-exp (the ``kv_seq`` cache's merge) against
    the plain version's: -inf exactly on the empty rows, else within 1e-4
    (f32 arithmetic in both dtypes); the output is the one without it."""
    q, k, v = _decode_inputs(card, B, Sk, H, Kh, D, dtype)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=card)
    before = ops.flash_decode.launches
    out, lse = ops.flash_decode(q, k, v, lens_t, return_lse=True)
    torch.cuda.synchronize()
    assert ops.flash_decode.launches == before + 1
    assert lse.shape == (B, H, 1) and lse.dtype == torch.float32
    assert torch.equal(out, ops.flash_decode(q, k, v, lens_t))
    _, ref = ops.flash_decode_plain(q, k, v, lens_t, return_lse=True)
    inf = torch.isinf(ref)
    assert torch.equal(torch.isinf(lse), inf) and (lse[inf] < 0).all()
    np.testing.assert_allclose(lse[~inf].cpu().numpy(),
                               ref[~inf].cpu().numpy(), rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_flash_decode_rejects_a_strided_cache(card):
    q, k, v = _decode_inputs(card, 2, 64, 4, 2, 32, "bfloat16")
    lens = torch.tensor([3, 4], dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_decode(q, k.transpose(0, 1).contiguous().transpose(0, 1),
                         v, lens)


# ----------------------------------------------------------- SSD scan (K4)
from repro_torch.kernels.ssd_scan import ops as SSD  # noqa: E402

# (B, S, H, P, N, chunk): tests/test_kernels.py::test_ssd_scan_sweep (padded
# tail and N 128 included), then mamba2-780m's widths at a ragged length
SSD_SWEEP = [
    (2, 256, 3, 32, 16, 64),
    (1, 128, 2, 64, 32, 128),
    (1, 100, 1, 16, 8, 32),
    (2, 64, 4, 32, 128, 64),
    (1, 301, 8, 64, 128, 256),
    # the bf16 passes' edges at mamba2's widths: S < chunk, S = chunk,
    # S = 2 chunk + 1 (a one-token last chunk), and B 2 with N 64
    (1, 100, 4, 64, 128, 256),
    (1, 256, 4, 64, 128, 256),
    (1, 513, 4, 64, 128, 256),
    (2, 300, 3, 64, 64, 128),
]
# y: f32 arithmetic in both, in another order (the running sum of dt * A
# reaches ~1e3 inside a chunk, so exp(cs_i - cs_j) carries ~1e-4 relative
# error in the terms that matter); bf16 adds the rounding of y (2^-9).
SSD_TOL = {"float32": (2e-3, 1e-4), "bfloat16": (2e-2, 1e-2)}


def ssd_inputs(card, B, S, H, P, N, dtype, seed=0):
    """The model's layout: x, Bm and Cm are views into one (B, S, H*P + 2N)
    convolution output; dt in [0.01, 1] and A = -(1..H), as the model's
    A_log gives, so decay and the carried state both matter."""
    rng = np.random.RandomState(seed)
    xbc = np.concatenate([rng.randn(B, S, H * P) * 0.5,
                          rng.randn(B, S, 2 * N) * 0.3], axis=-1)
    xbc = torch.from_numpy(xbc.astype(np.float32)).to(card, getattr(torch, dtype))
    x = xbc[..., :H * P].reshape(B, S, H, P)
    Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    dt = torch.from_numpy(rng.uniform(0.01, 1.0, (B, S, H)).astype(np.float32)
                          ).to(card)
    A = -torch.arange(1, H + 1, dtype=torch.float32, device=card)
    return x, dt, A, Bm, Cm


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_kernel_matches_plain(card, B, S, H, P, N, chunk, dtype):
    x, dt, A, Bm, Cm = ssd_inputs(card, B, S, H, P, N, dtype)
    assert not x.is_contiguous() and not Bm.is_contiguous()
    before = SSD.ssd_scan.launches
    y, st = SSD.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert SSD.ssd_scan.launches == before + 1
    yr, sr = SSD.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk)
    assert y.dtype == x.dtype and st.dtype == torch.float32
    tol, fro = SSD_TOL[dtype]
    for got, want, t, f in ((y, yr, tol, fro), (st, sr, 2e-3, 1e-4)):
        g, w = got.float().cpu().numpy(), want.float().cpu().numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=t, atol=t)
        assert np.linalg.norm(g - w) <= f * np.linalg.norm(w)


@pytest.mark.cuda
def test_ssd_scan_rejects_what_it_does_not_take(card):
    x, dt, A, Bm, Cm = ssd_inputs(card, 1, 64, 2, 16, 8, "float32")
    with pytest.raises(TypeError, match="one dtype"):
        SSD.ssd_scan(x, dt, A, Bm.bfloat16(), Cm, chunk=32)
    with pytest.raises(ValueError, match="unit stride"):
        SSD.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A,
                     Bm, Cm, chunk=32)
    big = torch.zeros(1, 64, 256, device=card)
    with pytest.raises(ValueError, match="multiple of 4 up to"):
        SSD.ssd_scan(x, dt, A, big, big, chunk=32)


# K4 backward, through ``ssd_scan``'s autograd Function on the card, against
# ``ssd_scan_bwd_plain`` on f32 copies of the same inputs: dx, ddt, dA, dB
# and dC each within (relative Frobenius, max |err| / max |ref|), as
# chip_smoke.py's SSD_BWD_TOL (bf16 outputs rounded to bf16; the running
# sums of dt * A in another order).  The sweep's shapes, the train phases'
# head widths at a short length, and a seeded final-state cotangent.
SSD_BWD_TOL = {"bfloat16": (1e-2, 2.0 ** -5), "float32": (1e-3, 2.0 ** -8)}
SSD_BWD_SWEEP = SSD_SWEEP + [
    (2, 300, 48, 64, 128, 256),      # mamba2-780m's heads, ragged
    (1, 520, 64, 64, 64, 256),       # zamba2-1.2b's heads, ragged
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_BWD_SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_backward_matches_plain(card, B, S, H, P, N, chunk, dtype):
    x, dt, A, Bm, Cm = ssd_inputs(card, B, S, H, P, N, dtype, seed=3)
    rng = np.random.RandomState(4)
    dy = torch.from_numpy(rng.randn(B, S, H, P).astype(np.float32)).to(
        card, x.dtype)
    dst = torch.from_numpy(rng.randn(B, H, P, N).astype(np.float32)).to(card)
    leaves = [t.detach().clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    fwd, bwd = SSD.ssd_scan.launches, SSD.ssd_scan_bwd.launches
    y, st = SSD.ssd_scan(*leaves, chunk=chunk)
    got = torch.autograd.grad((y, st), leaves, (dy, dst))
    torch.cuda.synchronize()
    assert (SSD.ssd_scan.launches, SSD.ssd_scan_bwd.launches) == (fwd + 1,
                                                                  bwd + 1)
    want = SSD.ssd_scan_bwd_plain(*(t.float() for t in (x, dt, A, Bm, Cm)),
                                  dy.float(), dst, chunk=chunk)
    fro, mx = SSD_BWD_TOL[dtype]
    for g, w, leaf in zip(got, want, leaves):
        assert g.dtype == leaf.dtype
        g, w = g.float().cpu().numpy(), w.float().cpu().numpy()
        assert np.isfinite(g).all()
        assert np.linalg.norm(g - w) <= fro * np.linalg.norm(w)
        assert np.abs(g - w).max() <= mx * np.abs(w).max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_backward_repeats_bit_for_bit(card, dtype):
    """dB, dC (shared by every head) and dA (summed over batch and
    sequence) are reduced in a fixed order with no atomics."""
    x, dt, A, Bm, Cm = ssd_inputs(card, 2, 700, 16, 64, 128, dtype, seed=5)
    dy = torch.randn(2, 700, 16, 64, device=card).to(x.dtype)
    _, _, saved = SSD.ssd_scan_saved(x, dt, A, Bm, Cm, chunk=256)
    first = SSD.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, None, saved=saved,
                             chunk=256)
    second = SSD.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, None, saved=saved,
                              chunk=256)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_keeps_only_what_its_backward_reads(card, dtype):
    """The Function saves the incoming states, C B^T and the running sums
    of dt * A, and not the bf16 passes' dS buffer: (B*nc*H*P*N) +
    (B*nc*chunk^2, rounded up to 4) + (B*nc*H*chunk) floats."""
    B, S, H, P, N, chunk = 2, 700, 16, 64, 128, 256
    x, dt, A, Bm, Cm = ssd_inputs(card, B, S, H, P, N, dtype, seed=6)
    leaves = [t.detach().clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    saved = []

    def pack(t):
        saved.append(t)
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y, st = SSD.ssd_scan(*leaves, chunk=chunk)
    nc = -(-S // chunk)
    want = (B * nc * H * P * N + -(-B * nc * chunk * chunk // 4) * 4
            + B * nc * H * chunk)
    flat = [t for t in saved if t.dim() == 1 and t.dtype == torch.float32
            and t.numel() > H]
    assert [t.numel() for t in flat] == [want]
    got = torch.autograd.grad((y, st), leaves,
                              (torch.ones_like(y), torch.ones_like(st)))
    assert all(bool(torch.isfinite(g).all()) for g in got)


@pytest.mark.cuda
def test_ssd_scan_backward_rejects_what_it_does_not_take(card):
    x, dt, A, Bm, Cm = ssd_inputs(card, 1, 64, 2, 128, 8, "float32")
    with pytest.raises(ValueError, match="up to 64"):
        SSD.ssd_scan(x.detach().clone().requires_grad_(), dt, A, Bm, Cm,
                     chunk=32)
    x, dt, A, Bm, Cm = ssd_inputs(card, 1, 64, 2, 16, 8, "float32")
    with pytest.raises(ValueError, match="scratch"):
        SSD.ssd_scan_bwd(x, dt, A, Bm, Cm, torch.zeros_like(x), chunk=32)


# K1 forward and backward and K3 at head dim 64, at the shapes the decoder
# zoo's train and serve phases give them: zamba2-1.2b's shared block (32
# heads, MHA) and granite-moe-1b-a400m (16 heads over 8 KV heads).
D64_SHAPES = [(2, 512, 32, 32), (2, 512, 16, 8), (1, 901, 16, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Kh", D64_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_d64_attention_kernels_match_plain(card, B, S, H, Kh, dtype):
    D = 64
    rng = np.random.RandomState(6)
    q, k, v, do = (torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                    * scale).to(card, getattr(torch, dtype))
                   for shape, scale in (((B, S, H, D), QK_SCALE),
                                        ((B, S, Kh, D), QK_SCALE),
                                        ((B, S, Kh, D), 1.0),
                                        ((B, S, H, D), 1.0)))
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = ops.flash_attention(qg, kg, vg, causal=True)
    got = torch.autograd.grad(out, (qg, kg, vg), do)
    o, lse = ops.flash_attention_plain(q, k, v, causal=True, return_lse=True)
    o_, r = out.detach().float().cpu().numpy(), o.float().cpu().numpy()
    assert np.linalg.norm(o_ - r) <= FRO_TOL[dtype] * np.linalg.norm(r)
    assert np.abs(o_ - r).max() <= MAX_TOL[dtype] * np.abs(r).max()
    ref = ops.flash_attention_bwd_plain(q, k, v, out.detach(), lse, do,
                                        causal=True)
    for g, w in zip(got, ref):
        g, w = g.float().cpu().numpy(), w.float().cpu().numpy()
        assert np.linalg.norm(g - w) <= BWD_FRO_TOL[dtype] * np.linalg.norm(w)
        assert np.abs(g - w).max() <= BWD_MAX_TOL[dtype] * np.abs(w).max()
    lens = torch.tensor([S - 7 * b for b in range(B)], dtype=torch.int32,
                        device=card)
    dq, dk, dv = _decode_inputs(card, B, S, H, Kh, D, dtype, seed=7)
    dout = ops.flash_decode(dq, dk, dv, lens)
    dref = ops.flash_decode_plain(dq, dk, dv, lens)
    a, b = dout.float().cpu().numpy(), dref.float().cpu().numpy()
    assert np.linalg.norm(a - b) <= FRO_TOL[dtype] * np.linalg.norm(b)
    assert np.abs(a - b).max() <= MAX_TOL[dtype] * np.abs(b).max()


# K1 and K3 at the second input path's shapes (chip_smoke.py's CROSS_CASES
# and DECODE_CROSS_CASES): whisper's encoder (non-causal over 1500 frames)
# and its decoder's cross-attention (448 into 1500), the vision model's
# cross-attention (512 into 6404, 64 heads over 8) and prefill
# self-attention; K3 over a whole memory as lens.
CROSS_SHAPES = [
    (8, 1500, 1500, 20, 20, 64, False),
    (8, 448, 1500, 20, 20, 64, False),
    (4, 512, 6404, 64, 8, 128, False),
    (4, 512, 512, 64, 8, 128, True),
]
DECODE_CROSS_SHAPES = [(4, 1500, 20, 20, 64), (4, 6404, 64, 8, 128)]


def _close(got, want, fro, mx):
    g, w = got.float().cpu().numpy(), want.float().cpu().numpy()
    assert np.isfinite(g).all()
    assert np.linalg.norm(g - w) <= fro * np.linalg.norm(w)
    assert np.abs(g - w).max() <= mx * np.abs(w).max()


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,Kh,D,causal", CROSS_SHAPES)
def test_cross_attention_shapes_match_plain(card, B, Sq, Sk, H, Kh, D,
                                            causal):
    """bf16 forward and backward through autograd, each launched twice
    (bit-equal), against the plain versions at K1's limits."""
    dtype = "bfloat16"
    rng = np.random.RandomState(8)
    q, k, v, do = (torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                    * scale).to(card, torch.bfloat16)
                   for shape, scale in (((B, Sq, H, D), QK_SCALE),
                                        ((B, Sk, Kh, D), QK_SCALE),
                                        ((B, Sk, Kh, D), 1.0),
                                        ((B, Sq, H, D), 1.0)))
    runs = []
    for _ in range(2):
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        out = ops.flash_attention(qg, kg, vg, causal=causal)
        runs.append((out.detach(),) + torch.autograd.grad(out, (qg, kg, vg),
                                                          do))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    out, got = runs[0][0], runs[0][1:]
    ref, lse = ops.flash_attention_plain(q, k, v, causal=causal,
                                         return_lse=True)
    _close(out, ref, FRO_TOL[dtype], MAX_TOL[dtype])
    refs = ops.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                         causal=causal)
    for g, r in zip(got, refs):
        _close(g, r, BWD_FRO_TOL[dtype], BWD_MAX_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sk,H,Kh,D", DECODE_CROSS_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_decode_shapes_match_plain(card, B, Sk, H, Kh, D, dtype):
    q, k, v = _decode_inputs(card, B, Sk, H, Kh, D, dtype, seed=9)
    lens = torch.full((B,), Sk, dtype=torch.int32, device=card)
    _close(ops.flash_decode(q, k, v, lens),
           ops.flash_decode_plain(q, k, v, lens), FRO_TOL[dtype],
           MAX_TOL[dtype])


# ------------------------------------- K1 as custom ops, in the op stream
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_custom_ops_launch_count_and_match_plain(card, dtype):
    """``repro_torch::flash_attention_fwd`` / ``_bwd`` launch the kernels
    (one count each) and match the plain versions at the limits above."""
    B, S, H, Kh, D = 2, 256, 8, 2, 64
    rng = np.random.RandomState(1)
    q, k, v, do = (torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                    * scale).to(card, getattr(torch, dtype))
                   for shape, scale in (((B, S, H, D), QK_SCALE),
                                        ((B, S, Kh, D), QK_SCALE),
                                        ((B, S, Kh, D), 1.0),
                                        ((B, S, H, D), 1.0)))
    before = (ops.flash_attention.launches, ops.flash_attention_bwd.launches)
    out, lse = torch.ops.repro_torch.flash_attention_fwd(
        q, k, v, None, True, D ** -0.5, True)
    dq, dk, dv = torch.ops.repro_torch.flash_attention_bwd(
        q, k, v, out, lse, do, None, True, D ** -0.5)
    torch.cuda.synchronize()
    assert (ops.flash_attention.launches,
            ops.flash_attention_bwd.launches) == (before[0] + 1, before[1] + 1)
    ref, ref_lse = ops.flash_attention_plain(q, k, v, causal=True,
                                             return_lse=True)
    o, r = out.float().cpu().numpy(), ref.float().cpu().numpy()
    assert np.linalg.norm(o - r) <= FRO_TOL[dtype] * np.linalg.norm(r)
    assert np.abs(o - r).max() <= MAX_TOL[dtype] * np.abs(r).max()
    refs = ops.flash_attention_bwd_plain(q, k, v, out, ref_lse, do,
                                         causal=True)
    for g, r in zip((dq, dk, dv), refs):
        g, r = g.float().cpu().numpy(), r.float().cpu().numpy()
        assert np.linalg.norm(g - r) <= BWD_FRO_TOL[dtype] * np.linalg.norm(r)
        assert np.abs(g - r).max() <= BWD_MAX_TOL[dtype] * np.abs(r).max()


@pytest.mark.cuda
def test_recorder_sees_k1_and_backward_ops_on_the_card(card):
    """A recorder over one CUDA grad step: the autograd engine runs the
    backward on its device thread, and the dispatch mode still records it
    (K1's backward token, and products on both sides of the peak)."""
    import repro_torch.configs as PC
    from repro_torch.common.config import TrainConfig
    from repro_torch.core.memtrace import build_timeline
    from repro_torch.core.profiler import profile_step
    from repro_torch.core.tokenizer import GLOBAL_VOCAB, OpStreamRecorder
    from repro_torch.distributed import steps as S
    from repro_torch.models import transformer as PT

    cfg = PC.get_reduced("llama2_paper").replace(attn_impl="flash")
    model = PT.init_model(cfg, seed=0, device=card)
    batch = {k: torch.ones((2, 64), dtype=torch.int64, device=card)
             for k in ("tokens", "labels")}
    grad = S.make_grad_step(cfg, TrainConfig())
    rec = OpStreamRecorder()
    with rec.iteration() as it:
        grad(model, batch, 1.0)
    names = {tok: n for n, tok in GLOBAL_VOCAB._ids.items()}
    ops_ = [names[t] for t in it.stream.tokens]
    L = cfg.num_layers
    assert ops_.count("repro_torch::flash_attention_fwd") == L
    assert ops_.count("repro_torch::flash_attention_bwd") == L
    prof = profile_step(lambda: grad(model, batch, 1.0), device=card)
    peak = build_timeline(prof).peak_op
    mm = [i for i, t in enumerate(prof.op_tokens) if names[t] == "aten::mm"]
    assert min(mm) < peak < max(mm)
    assert {(t.site, t.layer) for t in prof.candidates
            if t.site == "ffn_pre"} == {("ffn_pre", i) for i in range(L)}


def _exec_step(card, bf16=False):
    """Reduced llama2-paper on the card (flash attention: K1 both ways), one
    batch from a numpy seed, the baseline grad step and its profile."""
    import repro_torch.configs as PC
    from repro_torch.common.config import TrainConfig
    from repro_torch.core.profiler import profile_step
    from repro_torch.distributed import steps as S
    from repro_torch.models import transformer as PT

    cfg = PC.get_reduced("llama2_paper").replace(attn_impl="flash")
    model = PT.init_model(cfg, seed=0, device=card)
    rng = np.random.RandomState(0)
    tok = torch.as_tensor(rng.randint(0, cfg.vocab_size, (2, 64)),
                          device=card)
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    grad = S.make_grad_step(cfg, TrainConfig())
    loss, grads, _ = grad(model, batch, 1.0)
    prof = profile_step(lambda: grad(model, batch, 1.0), device=card)
    return cfg, model, batch, loss, grads, prof


@pytest.mark.cuda
def test_conservative_grad_step_on_the_card(card):
    """One reduced grad step on the card under ``conservative()`` (every
    site offloaded through the CUDA engine): loss and gradients bit-equal
    to the baseline's, D2H bytes equal to H2D bytes > 0, every H2D issued
    at its planned op (no on-demand fetch), no forced retire; and a
    recorder over the step counts the baseline's tokens."""
    from repro_torch.common.config import ChameleonConfig, TrainConfig
    from repro_torch.core.executor import Executor
    from repro_torch.core.tokenizer import OpStreamRecorder
    from repro_torch.distributed import steps as S
    from repro_torch.hostmem import HostMemTier

    cfg, model, batch, loss0, grads0, prof = _exec_step(card)
    tier = HostMemTier(device=card)
    x = Executor(ChameleonConfig())
    ex = x.execution(x.conservative(prof), tier.engine, prof)
    grad = S.make_grad_step(cfg, TrainConfig(), ex)
    rec = OpStreamRecorder()
    with rec.iteration() as it:
        loss, grads, _ = grad(model, batch, 1.0)
    torch.cuda.synchronize()
    assert torch.equal(loss, loss0)
    for k in grads0:
        assert torch.equal(grads[k], grads0[k]), k
    ex.settle()                      # after the sync: closes the books
    last = ex.last
    c = tier.engine.by_class["policy_swap"]
    assert c.bytes_out == c.bytes_in == last["staged_bytes"] > 0
    assert last["host_waits"] == 0
    assert ex.last["on_demand"] == 0 and ex.last["forced_retires"] == 0
    assert ex.last["prefetched"] == ex.last["staged"]
    np.testing.assert_array_equal(it.stream.tokens, prof.op_tokens)
    assert tier.pool.bytes_in_use == 0


@pytest.mark.cuda
def test_recorder_counts_the_same_tokens_under_the_executor(card):
    """A recorder over the card's grad step, with and without the executor
    (a lowered policy with remat): the same tokens, op for op."""
    from repro_torch.common.config import ChameleonConfig, TrainConfig
    from repro_torch.core.executor import Executor
    from repro_torch.core.memtrace import build_timeline
    from repro_torch.core.policy import ChameleonOOMError, generate_policy
    from repro_torch.core.tokenizer import OpStreamRecorder
    from repro_torch.distributed import steps as S
    from repro_torch.hostmem import HostMemTier

    cfg, model, batch, loss0, grads0, prof = _exec_step(card)
    tl = build_timeline(prof)
    pcfg = ChameleonConfig(groups_per_phase=cfg.num_layers)
    pol = None
    for frac in (0.9, 0.95, 0.98):       # the first budget a policy meets
        try:
            pol = generate_policy(prof, pcfg, int(
                prof.static_bytes + frac * (tl.peak - prof.static_bytes)),
                timeline=tl)
            break
        except ChameleonOOMError:
            continue
    assert pol is not None and pol.entries
    x = Executor(pcfg)
    ap = x.lower(pol, prof)
    tier = HostMemTier(device=card)
    x.bind_release_points(ap, tier.engine)
    streams = []
    for ex in (None, x.execution(ap, tier.engine, prof)):
        rec = OpStreamRecorder()
        with rec.iteration() as it:
            loss, grads, _ = S.make_grad_step(cfg, TrainConfig(), ex)(
                model, batch, 1.0)
        streams.append(it.stream.tokens)
        assert torch.equal(loss, loss0)
        assert all(torch.equal(grads[k], grads0[k]) for k in grads0)
    np.testing.assert_array_equal(streams[0], streams[1])
    assert ex.last["recomputed"] == cfg.num_layers


# --------------------------------------------- the autotuner's variants
from repro_torch.kernels.autotune import table as TUNED  # noqa: E402
from repro_torch.kernels.autotune.space import SPACES  # noqa: E402


def _check_k1(out, ref, dtype):
    o, r = out.float().cpu().numpy(), ref.float().cpu().numpy()
    np.testing.assert_allclose(o, r, rtol=TOL[dtype], atol=TOL[dtype])
    assert np.linalg.norm(o - r) <= FRO_TOL[dtype] * np.linalg.norm(r)
    assert np.abs(o - r).max() <= MAX_TOL[dtype] * np.abs(r).max()


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Kh,D", [(2, 200, 8, 2, 64),
                                        (1, 384, 32, 32, 128),
                                        (1, 77, 4, 4, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autotune_k1_rows_per_block_match_plain(card, B, S, H, Kh, D, dtype):
    """Every query-rows variant the tuner measures (bf16 64 and 128, f32's
    one tile) against the plain version, K1's limits, peaked inputs."""
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(*shape).astype(np.float32) * scale)
               .to(card, getattr(torch, dtype))
               for shape, scale in (((B, S, H, D), QK_SCALE),
                                    ((B, S, Kh, D), QK_SCALE),
                                    ((B, S, Kh, D), 1.0)))
    ref = ops.flash_attention_plain(q, k, v, causal=True)
    space = SPACES["flash_attention"]
    for config in space.variants_for(dtype):
        before = ops.flash_attention.launches
        out = space.run((q, k, v), config)
        torch.cuda.synchronize()
        assert ops.flash_attention.launches == before + 1
        _check_k1(out, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,P,N", [(1, 600, 4, 64, 128),
                                       (2, 300, 3, 64, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autotune_k4_chunks_match_plain(card, B, S, H, P, N, dtype):
    """Every chunk the tuner measures against the plain version at that
    chunk, y and the final state (SSD_TOL)."""
    x, dt, A, Bm, Cm = ssd_inputs(card, B, S, H, P, N, dtype)
    space = SPACES["ssd_scan"]
    for config in space.variants_for(dtype):
        y, st = space.run((x, dt, A, Bm, Cm), config)
        torch.cuda.synchronize()
        yr, sr = SSD.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=config["chunk"])
        tol, fro = SSD_TOL[dtype]
        for got, want, t, f in ((y, yr, tol, fro), (st, sr, 2e-3, 1e-4)):
            g, w = got.float().cpu().numpy(), want.float().cpu().numpy()
            np.testing.assert_allclose(g, w, rtol=t, atol=t)
            assert np.linalg.norm(g - w) <= f * np.linalg.norm(w)


@pytest.mark.cuda
def test_wrappers_launch_with_the_installed_table(card):
    """With a table installed, K1 takes its rows, K4 its chunk, and K2a /
    K2b count their launches under an entry; outputs as without it."""
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(1, 300, 8, 64).astype(np.float32)
                                * s).to(card, torch.bfloat16)
               for s in (QK_SCALE, QK_SCALE, 1.0))
    x = torch.from_numpy(rng.randn(64, 128).astype(np.float32)).to(
        card, torch.bfloat16)
    ins = ssd_inputs(card, 1, 300, 4, 64, 128, "bfloat16")
    TUNED.install({
        TUNED.table_key("flash_attention", q.shape, q.dtype): {"block_q": 64},
        TUNED.table_key("ssd_scan", ins[0].shape, ins[0].dtype): {"chunk": 64},
        TUNED.table_key("quantize", x.shape, x.dtype): {},
        TUNED.table_key("dequantize", x.shape, x.dtype): {}})
    counts = [f.tuned_launches for f in (ops.flash_attention, SSD.ssd_scan,
                                         Q.quantize, Q.dequantize)]
    try:
        out = ops.flash_attention(q, k, v, causal=True)
        y, _ = SSD.ssd_scan(*ins)
        qx, sx = Q.quantize(x)
        back = Q.dequantize(qx, sx, x.dtype)
        torch.cuda.synchronize()
    finally:
        TUNED.clear()
    assert [f.tuned_launches for f in (ops.flash_attention, SSD.ssd_scan,
                                       Q.quantize, Q.dequantize)] == [
        c + 1 for c in counts]
    _check_k1(out, ops.flash_attention_plain(q, k, v, causal=True),
              "bfloat16")
    assert torch.equal(y, SSD.ssd_scan(*ins, chunk=64)[0])
    assert torch.equal(back, Q.dequantize(*Q.quantize(x), x.dtype))
