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


@pytest.mark.cuda
def test_flash_attention_rejects_unsupported_head_dim(card):
    q = torch.zeros(1, 8, 2, 48, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, q, q, causal=True)
