"""CPU evidence for the split-KV design of the flash-decode kernel (K3).

The CUDA kernel (``csrc/flash_decode_fwd.cu``) splits each batch row's keys
into runs of T, reduces every split that holds keys to an unnormalised
(m, l, acc) in f32, and a combine step rescales the splits below
ceil(lens[b] / T) to their common max and sums them.  ``split_decode`` below
is that algorithm in plain PyTorch (kept here, not in the package); it must
equal the port's ``flash_decode_plain`` within f32 rounding on the edges of
the split (T dividing Smax and not, lens on a split boundary, lens = Smax, a
split holding one key, lens = 0, GQA groups 1, 4 and 8), and the reference's
Pallas decode kernel (interpret mode) on one case.  The kernel itself runs
only on a card (``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_decode as ref_flash_decode
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ops

torch.set_num_threads(1)      # tier-1 runs several xdist workers

FRO_TOL = 1e-6                # the plain version's f32 rounding


def split_decode(q, k, v, lens, T, sm_scale=None, dtype=torch.float64):
    """Split-KV decode attention: q (B,1,H,D), k/v (B,Sk,Kh,D), lens (B,).
    Per (batch row, query head) and split of T keys with keys, the split's
    max m, sum l = sum exp(s - m) and acc = sum exp(s - m) v; then the
    combine over the splits below ceil(n / T) with n = clamp(lens, 0, Sk).
    Computed in ``dtype`` (f64 by default, so that what is compared is the
    algorithm and the plain version's own f32 rounding), returned in f32."""
    B, _, H, D = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    G = H // Kh
    scale = 1 / math.sqrt(D) if sm_scale is None else sm_scale
    nsplit = -(-Sk // T)
    out = torch.zeros(B, 1, H, D, dtype=dtype)
    for b in range(B):
        n = min(max(int(lens[b]), 0), Sk)
        ns = -(-n // T)
        if ns == 0:
            continue
        assert ns <= nsplit
        ms, ls, accs = [], [], []
        for s in range(ns):
            k0, k1 = s * T, min(s * T + T, n)
            kk = k[b, k0:k1].to(dtype).repeat_interleave(G, dim=1)  # (keys,H,D)
            vv = v[b, k0:k1].to(dtype).repeat_interleave(G, dim=1)
            sc = torch.einsum("hd,thd->ht", q[b, 0].to(dtype) * scale, kk)
            m = sc.amax(dim=1)                                     # (H,)
            p = torch.exp(sc - m[:, None])
            ms.append(m)
            ls.append(p.sum(dim=1))
            accs.append(torch.einsum("ht,thd->hd", p, vv))
        m_all = torch.stack(ms)                                    # (ns,H)
        mx = m_all.amax(dim=0)
        f = torch.exp(m_all - mx)
        num = (torch.stack(accs) * f[..., None]).sum(dim=0)
        den = (torch.stack(ls) * f).sum(dim=0)
        out[b, 0] = num / den[:, None]
    return out.float()


def _inputs(seed, B, Sk, H, Kh, D):
    """Peaked q and k (2 x randn: a lost key or a missing rescale moves an
    output by about |v|) and v at randn, in f32."""
    rng = np.random.RandomState(seed)
    return (rng.randn(B, 1, H, D).astype(np.float32) * 2.0,
            rng.randn(B, Sk, Kh, D).astype(np.float32) * 2.0,
            rng.randn(B, Sk, Kh, D).astype(np.float32))


# (B, Sk, H, Kh, D, lens, T)
CASES = [
    (2, 256, 4, 4, 32, (256, 100), 64),      # T divides Sk; lens = Sk; GQA 1
    (2, 200, 8, 2, 32, (200, 130), 64),      # T does not divide Sk; GQA 4
    (2, 256, 16, 2, 16, (128, 64), 64),      # lens on split boundaries; GQA 8
    (2, 160, 4, 4, 32, (129, 1), 64),        # a last split holding one key
    (3, 128, 8, 2, 32, (0, 128, 65), 64),    # lens = 0 gives zeros
    (2, 512, 16, 2, 64, (300, 512), 128),    # GQA 8, T 128
    (1, 1024, 8, 8, 128, (1000,), 256),      # T 256, llama2-paper's D
]


@pytest.mark.parametrize("B,Sk,H,Kh,D,lens,T", CASES)
def test_split_decode_matches_plain(B, Sk, H, Kh, D, lens, T):
    q, k, v = (torch.from_numpy(a) for a in _inputs(0, B, Sk, H, Kh, D))
    lens_t = torch.tensor(lens, dtype=torch.int32)
    got = split_decode(q, k, v, lens_t, T)
    want = ops.flash_decode_plain(q, k, v, lens_t)
    assert torch.isfinite(got).all()
    rel = float((got - want).norm() / want.norm())
    assert rel <= FRO_TOL, rel
    for b, n in enumerate(lens):
        if n <= 0:
            assert not got[b].any()


def test_split_decode_combine_needs_every_split_rescaled():
    """The combine's two steps each matter at a split boundary: dropping
    the last split with keys, or summing the splits without rescaling them
    to their common max, leaves the plain version's answer by far more than
    f32 rounding (what the kernel's mutants plant on the card)."""
    B, Sk, H, Kh, D, T = 1, 256, 4, 4, 32, 64
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, B, Sk, H, Kh, D))
    lens = torch.tensor([200], dtype=torch.int32)
    want = ops.flash_decode_plain(q, k, v, lens)
    short = split_decode(q, k, v, torch.tensor([192]), T)   # last split lost
    assert float((short - want).norm() / want.norm()) > 1e-3
    # unrescaled: each split normalised on its own max, then summed
    n, G = 200, H // Kh
    num = torch.zeros(H, D)
    den = torch.zeros(H)
    for s in range(-(-n // T)):
        kk = k[0, s * T:min(s * T + T, n)]
        vv = v[0, s * T:min(s * T + T, n)]
        sc = torch.einsum("hd,thd->ht", q[0, 0] / math.sqrt(D),
                          kk.repeat_interleave(G, dim=1))
        p = torch.exp(sc - sc.amax(dim=1, keepdim=True))
        num += torch.einsum("ht,thd->hd", p, vv.repeat_interleave(G, dim=1))
        den += p.sum(dim=1)
    bad = (num / den[:, None])[None, None]
    assert float((bad - want).norm() / want.norm()) > 1e-2


def test_split_decode_matches_reference_kernel():
    """The split model against the reference's Pallas decode kernel
    (interpret mode) at the reference sweep's widths, with lens that end
    inside a split and on a split boundary."""
    B, Sk, H, Kh, D, T = 2, 512, 4, 2, 32, 64
    q, k, v = _inputs(2, B, Sk, H, Kh, D)
    lens = np.array([300, 128], np.int32)
    ref = ref_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(lens))
    got = split_decode(*(torch.from_numpy(a) for a in (q, k, v)),
                       torch.from_numpy(lens), T)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-3,
                               atol=2e-3)


def test_split_keys_and_workspace_at_the_served_shapes():
    """The wrapper's keys per split come from shapes alone: 256 at the serve
    decode shape (512 blocks, 352 of them with keys at the first tick's
    lens), fewer where a smaller grid needs more splits to give every SM two
    blocks; the workspace is B * H * nsplit * (D + 2) floats (0.27 MB at the
    serve shape)."""
    assert K.split_keys(4, 32, 1024) == 256
    assert K.split_keys(1, 32, 4096) == 256
    assert K.split_keys(8, 8, 1024) == 128
    assert K.split_keys(2, 2, 160) == 64
    assert K.split_keys(64, 32, 1024) == 256
    assert K.decode_workspace_floats(4, 32, 1024, 128, 256) * 4 == 266240
    assert K.decode_workspace_floats(2, 4, 200, 32, 64) == 2 * 4 * 4 * 34
