"""CPU evidence for the split-bf16 precision of the SSD scan's CUDA passes.

The bf16 CUDA kernel (``src/repro_torch/kernels/ssd_scan/csrc/
ssd_scan_fwd.cu``) runs every product on the tensor cores: one operand is
exact in bf16 (x, B or C), the other is f32 (the weighted x of the state
update, M = CB o L o dt, the incoming state S) and is split into
``hi = bf16(v)`` and ``lo = bf16(v - hi)``, multiplied twice with f32 sums.
``split_passes`` below is a plain PyTorch emulation of its four passes
(CB and cs; each chunk's own state; the state recurrence over chunks; y),
written here and not in the package.  At mamba2-780m's widths (P 64, N 128,
chunk 256) with 4 heads it is held to the reference's ``ssd_chunked``
within the limits ``chip_smoke.py`` holds the kernel to, and the variant
that rounds each f32 operand to bf16 once is shown to break the state
limit, so the check can see that fault.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import ssd_chunked

torch.set_num_threads(1)      # tier-1 runs several xdist workers

H, P, N, CHUNK = 4, 64, 128, 256
A_HEADS = (-1.0, -7.0, -20.0, -48.0)    # the range of mamba2's -(1..48)
SSD_TOL_BF16 = (2e-2, 1e-2)             # chip_smoke.py: SSD_TOL["bfloat16"]
SSD_STATE_TOL = (2e-3, 1e-4)            # chip_smoke.py: SSD_STATE_TOL


def _inputs(S, seed=0):
    """x, B and C hold bf16 values (the kernel's inputs), dt in [0.01, 1],
    as chip_smoke.py draws them."""
    rng = np.random.RandomState(seed)

    def bf16(a):
        return torch.from_numpy(a.astype(np.float32)).bfloat16().float()
    x = bf16(rng.randn(1, S, H, P) * 0.5)
    Bm, Cm = bf16(rng.randn(1, S, N) * 0.3), bf16(rng.randn(1, S, N) * 0.3)
    dt = torch.from_numpy(rng.uniform(0.01, 1.0, (1, S, H)).astype(np.float32))
    return x, dt, torch.tensor(A_HEADS), Bm, Cm


def _bf16(v):
    return v.bfloat16().float()


def _product(v, exact, eq, mode):
    """einsum(eq, v, exact) with f32 ``v`` as the kernel feeds it to the
    tensor cores: split in two bf16 halves ("split"), rounded once
    ("bf16"), or kept in f32 ("f32")."""
    if mode == "f32":
        return torch.einsum(eq, v, exact)
    hi = _bf16(v)
    out = torch.einsum(eq, hi, exact)
    return out + torch.einsum(eq, _bf16(v - hi), exact) if mode == "split" else out


def split_passes(x, dt, A, Bm, Cm, chunk, mode="split"):
    """The CUDA passes in plain PyTorch: returns (y rounded to bf16, final
    state f32)."""
    Bn, S = x.shape[:2]
    nc = -(-S // chunk)
    pad = nc * chunk - S
    if pad:      # the kernel masks by index: dt = x = B = C = 0 past S
        x, dt, Bm, Cm = (torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2)
                                                 + (0, pad))
                         for t in (x, dt, Bm, Cm))
    xs = x.reshape(Bn, nc, chunk, H, P)
    dts = dt.reshape(Bn, nc, chunk, H)
    Bs, Cs = Bm.reshape(Bn, nc, chunk, N), Cm.reshape(Bn, nc, chunk, N)
    # pass 1: CB once per chunk (bf16 x bf16, exact products), cs, dS
    cb = torch.einsum("bcin,bcjn->bcij", Cs, Bs)
    cs = torch.cumsum(dts * A, dim=2)                         # (B,nc,c,H)
    w = dts * torch.exp(cs[:, :, -1:] - cs)
    ds = _product(xs * w[..., None], Bs, "bcjhp,bcjn->bchpn", mode)
    # pass 2: the state entering each chunk, and the final state
    s = torch.zeros(Bn, H, P, N)
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = torch.exp(cs[:, c, -1])[:, :, None, None] * s + ds[:, c]
    s_in = torch.stack(s_in, dim=1)                            # (B,nc,H,P,N)
    # pass 3: y = (CB o L o dt) x + exp(cs) C . S_in
    idx = torch.arange(chunk)
    causal = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]           # (B,nc,i,j,H)
    L = torch.exp(seg.masked_fill(~causal, float("-inf")))
    M = cb[..., None] * L * dts[:, :, None, :, :]
    y = _product(M, xs, "bcijh,bcjhp->bcihp", mode)
    y = y + (torch.exp(cs)[..., None]
             * _product(s_in, Cs, "bchpn,bcin->bcihp", mode))
    return _bf16(y.reshape(Bn, nc * chunk, H, P)[:, :S]), s


def _reference(x, dt, A, Bm, Cm):
    y, st = ssd_chunked(*(jnp.asarray(t.numpy()) for t in (x, dt, A, Bm, Cm)),
                        chunk=CHUNK)
    return np.asarray(y), np.asarray(st)


def _errors(got, want):
    g, w = got.numpy().astype(np.float64), want.astype(np.float64)
    diff = np.abs(g - w)
    return float(np.linalg.norm(diff) / np.linalg.norm(w)), diff, np.abs(w)


def _within(got, want, tol):
    rel_fro, diff, mag = _errors(got, want)
    return (rel_fro <= tol[1] and bool((diff <= tol[0] + tol[0] * mag).all())
            and bool(np.isfinite(got.numpy()).all())), rel_fro


@pytest.mark.parametrize("S", [77, 384, 901])
def test_split_passes_match_reference(S):
    """Split-bf16 passes: y within SSD_TOL (bf16) and the final state within
    SSD_STATE_TOL of the reference's ssd_chunked."""
    x, dt, A, Bm, Cm = _inputs(S)
    y_ref, st_ref = _reference(x, dt, A, Bm, Cm)
    y, st = split_passes(x, dt, A, Bm, Cm, min(CHUNK, S))
    ok_y, fro_y = _within(y, y_ref, SSD_TOL_BF16)
    ok_s, fro_s = _within(st, st_ref, SSD_STATE_TOL)
    assert ok_y, f"y rel_fro {fro_y}"
    assert ok_s, f"state rel_fro {fro_s}"


@pytest.mark.parametrize("S", [384, 901])
def test_unsplit_bf16_operands_break_the_state_limit(S):
    """Rounding each f32 operand to bf16 once, instead of splitting it,
    puts the final state outside SSD_STATE_TOL: the limit sees the fault."""
    x, dt, A, Bm, Cm = _inputs(S)
    _, st_ref = _reference(x, dt, A, Bm, Cm)
    _, st = split_passes(x, dt, A, Bm, Cm, CHUNK, mode="bf16")
    ok, rel_fro = _within(st, st_ref, SSD_STATE_TOL)
    assert not ok and rel_fro > SSD_STATE_TOL[1]


def test_passes_in_f32_are_the_reference_algebra():
    """With f32 operands (no rounding) the four passes are the chunked
    scan's algebra: y and state within f32 summation-order error."""
    x, dt, A, Bm, Cm = _inputs(901, seed=1)
    y_ref, st_ref = _reference(x, dt, A, Bm, Cm)
    y, st = split_passes(x, dt, A, Bm, Cm, CHUNK, mode="f32")
    y_f32 = _errors(y, y_ref)[0]
    np.testing.assert_allclose(st.numpy(), st_ref, rtol=1e-4, atol=1e-5)
    assert y_f32 <= 4e-3        # only y's bf16 rounding (2^-9 relative)
