"""CPU evidence for the arithmetic of K4 backward's bf16 CUDA passes.

The bf16 backward (``src/repro_torch/kernels/ssd_scan/csrc/
ssd_scan_bwd.cu``) runs every product on wgmma with f32 sums.  x, dy, B and
C are exact in bf16; every f32 operand (dy weighted by exp(cs), x weighted
by w, M = G o L o dt, D, S_0, dG) is split into ``hi = bf16(v)`` and ``lo =
bf16(v - hi)``: a product with one split operand is taken twice (hi, lo),
one with two split operands three times (hi hi, hi lo, lo hi).  dG is
summed over the heads of a head group, then over the groups in order.
``split_bwd`` below is a plain PyTorch emulation of those passes, written
here and not in the package.  At reduced widths (4 heads, P 16, N 16,
chunk 32, ragged last chunks) it is held to ``ssd_scan_bwd_plain`` in f32
within chip_smoke.py's ``SSD_BWD_TOL["bfloat16"]``, and to ``jax.grad`` of
the reference's ``ssd_chunked`` where that is finite; rounding the split
operands to one bf16 each instead is shown to leave the split's limit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import ssd_chunked
from repro_torch.kernels.ssd_scan import ops

torch.set_num_threads(1)      # tier-1 runs several xdist workers

B_, H, P, N, CHUNK = 2, 4, 16, 16, 32
SSD_BWD_TOL_BF16 = (1e-2, 2.0 ** -5)   # chip_smoke.py: SSD_BWD_TOL["bfloat16"]
# The split's own limit on the f32 outputs (ddt, dA), relative Frobenius
# against the plain version: the hi / lo products are good to ~2^-16, so
# what is left is the f32 sums' order.
SPLIT_F32_TOL = 1e-4
NAMES = ("dx", "ddt", "dA", "dB", "dC")


def _bf16(v):
    return v.bfloat16().float()


def _inputs(S, seed=0, a_heads=(-0.3, -1.0, -2.0, -4.0)):
    """x, Bm, Cm and dy hold bf16 values (the kernel's inputs), dt in [0.01,
    1], a final-state cotangent; f32 tensors."""
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.from_numpy(a.astype(np.float32))
    x = _bf16(t(rng.randn(B_, S, H, P) * 0.5))
    Bm, Cm = _bf16(t(rng.randn(B_, S, N) * 0.3)), _bf16(t(rng.randn(B_, S, N) * 0.3))
    dt = t(rng.uniform(0.01, 1.0, (B_, S, H)))
    dy = _bf16(t(rng.randn(B_, S, H, P)))
    dst = t(rng.randn(B_, H, P, N))
    return x, dt, torch.tensor(a_heads), Bm, Cm, dy, dst


def head_groups(B, nc, njt, H):
    """ssd_scan_bwd.cu::head_groups."""
    g = min(H, 8, max(1, -(-264 // (B * nc * njt))))
    hg = -(-H // g)
    return -(-H // hg)


def _product(a, b, eq, sa, sb, mode):
    """einsum(eq, a, b) as the kernel feeds the tensor cores: a split
    operand (``sa`` / ``sb``) as hi + lo with the lo x lo term left out
    ("split"), rounded once ("bf16"), or kept in f32 ("f32")."""
    if mode == "f32":
        return torch.einsum(eq, a, b)
    ah, bh = (_bf16(a) if sa else a), (_bf16(b) if sb else b)
    out = torch.einsum(eq, ah, bh)
    if mode == "split":
        if sb:
            out = out + torch.einsum(eq, ah, _bf16(b - bh))
        if sa:
            out = out + torch.einsum(eq, _bf16(a - ah), bh)
    return out


def split_bwd(x, dt, A, Bm, Cm, dy, dstate, chunk, groups, mode="split"):
    """The bf16 passes in plain PyTorch: returns (dx, dB, dC rounded to
    bf16; ddt, dA f32)."""
    Bn, S = x.shape[:2]
    nc = -(-S // chunk)
    pad = nc * chunk - S
    if pad:      # the kernel masks by index: dt = x = dy = B = C = 0 past S
        x, dt, Bm, Cm, dy = (torch.nn.functional.pad(
            t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (x, dt, Bm, Cm, dy))
    xs, dys = x.reshape(Bn, nc, chunk, H, P), dy.reshape(Bn, nc, chunk, H, P)
    dts = dt.reshape(Bn, nc, chunk, H)
    Bs, Cs = Bm.reshape(Bn, nc, chunk, N), Cm.reshape(Bn, nc, chunk, N)
    valid = (torch.arange(nc * chunk) < S).reshape(1, nc, chunk, 1)
    cs = torch.cumsum(dts * A, dim=2)                          # (B,nc,c,H)
    cs_last = cs[:, :, -1]                                     # (B,nc,H)
    ecs = torch.exp(cs) * valid
    dec = torch.exp(cs_last[:, :, None] - cs) * valid
    w = dec * dts
    # the forward's saved state entering each chunk, and CB (f32)
    s_in, s = [], torch.zeros(Bn, H, P, N)
    for c in range(nc):
        s_in.append(s)
        s = (torch.exp(cs_last[:, c])[:, :, None, None] * s
             + torch.einsum("bjhp,bjn->bhpn", xs[:, c] * w[:, c, :, :, None],
                            Bs[:, c]))
    S0 = torch.stack(s_in, dim=1)                              # (B,nc,H,P,N)
    G = torch.einsum("bcin,bcjn->bcij", Cs, Bs)
    # A: Q = (exp(cs) dy)^T C, V = C S_0^T, vin = exp(cs) dy . V
    edy = dys * ecs[..., None]
    Q = _product(edy, Cs, "bcihp,bcin->bchpn", True, False, mode)
    V = _product(Cs, S0, "bcin,bchpn->bcihp", False, True, mode)
    vin = ecs * (dys * V).sum(-1)
    # B: D of each chunk, last to first
    D = torch.empty_like(Q)
    d = dstate.expand(Bn, H, P, N)
    for c in reversed(range(nc)):
        D[:, c] = d
        d = torch.exp(cs_last[:, c])[:, :, None, None] * d + Q[:, c]
    # C: U = B D^T, dM = dy x^T (exact), M, dx, dG by head group
    U = _product(Bs, D, "bcjn,bchpn->bcjhp", False, True, mode)
    xU = (xs * U).sum(-1)
    idx = torch.arange(chunk)
    causal = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    inside = causal & valid[:, :, :, None, :]
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]          # (B,nc,i,j,H)
    L = torch.exp(seg.masked_fill(~inside, float("-inf")))
    dM = torch.einsum("bcihp,bcjhp->bcijh", dys, xs)
    GL = G[..., None] * L
    M = GL * dts[:, :, None]
    Qm = dM * GL
    T = Qm * dts[:, :, None]
    dx = (_product(M, dys, "bcijh,bcihp->bcjhp", True, False, mode)
          + w[..., None] * U)
    dGh = dM * L * dts[:, :, None]
    hg = -(-H // groups)
    dG = torch.zeros(Bn, nc, chunk, chunk)
    for g in range(groups):                 # heads in order inside a group
        part = torch.zeros(Bn, nc, chunk, chunk)
        for h in range(g * hg, min(H, (g + 1) * hg)):
            part = part + dGh[..., h]
        dG = dG + part
    # D: dB / dC, the dG term and one K = P term a head, summed as one product
    wx = xs * w[..., None]
    dC = (_product(dG, Bs, "bcij,bcjn->bcin", True, False, mode)
          + _product(edy, S0, "bcihp,bchpn->bcin", True, True, mode))
    dB = (_product(dG, Cs, "bcij,bcin->bcjn", True, False, mode)
          + _product(wx, D, "bcjhp,bchpn->bcjn", True, True, mode))
    # E: dcs, its reverse running sum, ddt, dA (f32)
    dcs = T.sum(3) - T.sum(2) + vin - w * xU
    last = torch.clamp(torch.tensor([S - c * chunk for c in range(nc)]), max=chunk) - 1
    extra = (torch.exp(cs_last) * (D * S0).sum((-1, -2))
             + (w * xU).sum(2))                               # (B,nc,H)
    dcs[:, torch.arange(nc), last] += extra
    da = torch.flip(torch.cumsum(torch.flip(dcs, [2]), 2), [2]) * valid
    ddt = Qm.sum(2) + dec * xU + da * A
    dA = (da * dts).sum((0, 1, 2))

    def out(t, shape):
        return t.reshape(shape)[:, :S]
    return (_bf16(out(dx, (Bn, nc * chunk, H, P))), out(ddt, (Bn, nc * chunk, H)),
            dA, _bf16(out(dB, (Bn, nc * chunk, N))),
            _bf16(out(dC, (Bn, nc * chunk, N))))


def _rel(got, want):
    g, w = got.double(), want.double()
    return float((g - w).norm() / w.norm()), float((g - w).abs().max() / w.abs().max())


def _groups(S, chunk):
    nc = -(-S // chunk)
    return head_groups(B_, nc, -(-chunk // 64), H)


@pytest.mark.parametrize("S,groups", [(77, None), (77, 3), (64, 2), (20, None)])
def test_split_bwd_matches_plain(S, groups):
    """Split passes within SSD_BWD_TOL (bf16) of the f32 plain backward on
    every output, at chunk 32 with ragged last chunks (77 = 2 x 32 + 13; 20
    < chunk), the kernel's head groups and others; ddt and dA within the
    split's own f32 limit."""
    x, dt, A, Bm, Cm, dy, dst = _inputs(S)
    chunk = min(CHUNK, S)
    got = split_bwd(x, dt, A, Bm, Cm, dy, dst, chunk,
                    groups or _groups(S, chunk))
    want = ops.ssd_scan_bwd_plain(x, dt, A, Bm, Cm, dy, dst, chunk=chunk)
    for name, g, w in zip(NAMES, got, want):
        fro, mx = _rel(g, w)
        assert bool(torch.isfinite(g).all()), name
        assert fro <= SSD_BWD_TOL_BF16[0] and mx <= SSD_BWD_TOL_BF16[1], (name, fro, mx)
        if name in ("ddt", "dA"):
            assert fro <= SPLIT_F32_TOL, (name, fro)


@pytest.mark.parametrize("S", [48, 45])
def test_split_bwd_matches_reference_grad(S):
    """jax.grad of the reference's ``ssd_chunked`` (finite here: small dt
    |A| over a chunk) against the split passes, with the same dy and no
    final-state cotangent."""
    x, dt, A, Bm, Cm, dy, _ = _inputs(S, seed=1, a_heads=(-0.05, -0.1, -0.2, -0.3))
    dt = dt * 0.2

    def loss(x_, dt_, A_, B_, C_):
        y, _ = ssd_chunked(x_, dt_, A_, B_, C_, CHUNK)
        return jnp.sum(y * jnp.asarray(dy.numpy()))

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(t.numpy()) for t in (x, dt, A, Bm, Cm)))
    got = split_bwd(x, dt, A, Bm, Cm, dy, torch.zeros(B_, H, P, N),
                    min(CHUNK, S), _groups(S, min(CHUNK, S)))
    for name, g, w in zip(NAMES, got, want):
        w = torch.from_numpy(np.array(w))
        assert bool(torch.isfinite(w).all()), name
        fro, mx = _rel(g, w)
        assert fro <= SSD_BWD_TOL_BF16[0] and mx <= SSD_BWD_TOL_BF16[1], (name, fro, mx)


@pytest.mark.parametrize("S", [77, 64])
def test_unsplit_bf16_operands_leave_the_split_limit(S):
    """Rounding each f32 operand to bf16 once, instead of splitting it,
    moves ddt and dA out of the split's limit: the emulation, and a check
    held to that limit, can see a dropped lo half."""
    x, dt, A, Bm, Cm, dy, dst = _inputs(S)
    chunk = min(CHUNK, S)
    want = ops.ssd_scan_bwd_plain(x, dt, A, Bm, Cm, dy, dst, chunk=chunk)
    got = split_bwd(x, dt, A, Bm, Cm, dy, dst, chunk, _groups(S, chunk),
                    mode="bf16")
    worst = max(_rel(got[k], want[k])[0] for k in (1, 2))
    assert worst > SPLIT_F32_TOL


def test_split_bwd_in_f32_is_the_plain_algebra():
    """With f32 operands (no rounding but the outputs') the passes are the
    plain backward's algebra: ddt and dA within f32 summation order."""
    x, dt, A, Bm, Cm, dy, dst = _inputs(77, seed=2)
    got = split_bwd(x, dt, A, Bm, Cm, dy, dst, CHUNK, 3, mode="f32")
    want = ops.ssd_scan_bwd_plain(x, dt, A, Bm, Cm, dy, dst, chunk=CHUNK)
    for k in (1, 2):
        assert _rel(got[k], want[k])[0] <= 1e-5, NAMES[k]
    for k in (0, 3, 4):                 # bf16 rounding of the output only
        assert _rel(got[k], want[k])[0] <= 4e-3, NAMES[k]
