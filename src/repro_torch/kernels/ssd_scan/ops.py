"""Model-layout wrapper of the SSD scan kernels, and their plain versions.

``ssd_scan`` takes the model zoo's layout, as ``repro/kernels/ssd_scan/
ops.py`` does: x (B,S,H,P) in the activation dtype, dt (B,S,H) f32 after
softplus, A (H,) f32 (negative), Bm/Cm (B,S,N) shared by all heads.  It
returns what ``repro/models/ssm.py::ssd_chunked`` returns: y (B,S,H,P), here
in x's dtype, and the final state (B,H,P,N) in f32, from one call.  The
CUDA kernels read their inputs through their strides (the model passes
column slices of its convolution output) and mask a ragged last chunk by
index, so the reference wrapper's pad and transposes are gone; the final
state is the state after token S - 1, as the reference's zero padding
leaves it.  In bf16 one call runs three passes that are parallel over
chunks, with scratch that this wrapper allocates; in f32 one kernel.

Tensors on the CPU go to ``ssd_scan_plain``; CUDA tensors launch the kernel
or raise, with no fallback.  ``ssd_scan_plain`` is plain differentiable
PyTorch, so on the CPU a train step runs through it, as the reference's
``apply_ssm`` trains through its differentiable ``ssd_chunked``.  On the
card, when an input requires grad, the scan is ``_SSDScanFn``: the forward
kernel keeps what its backward reads (the state entering every chunk, C
B^T and the running sums of dt * A: the bf16 passes' scratch, which the f32
kernel fills too when given it; the bf16 passes' dS buffer is freed when
the call returns), tagged ``ssm_state`` as the reference tags its chunk
states, and the backward is the hand-written K4 backward
(``csrc/ssd_scan_bwd.cu``, through ``ssd_scan_bwd``).
``ssd_scan_bwd_plain`` is the same chunked backward in plain PyTorch, for
the tests and for holding the kernel to on the card; it never runs on a
CUDA tensor inside ``ssd_scan_bwd``.  ``ssd_scan.launches`` and
``ssd_scan_bwd.launches`` count calls that launch a kernel: one per call,
whatever the passes.

``ssd_scan(chunk=None)`` reads the chunk from the autotuner's installed
table (``repro_torch.kernels.autotune.table``), else takes 256, as the
reference's wrapper does; the model zoo passes ``cfg.ssm_chunk``.
``ssd_scan.tuned_launches`` counts launches whose chunk came from the table.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.core.sites import tag
from repro_torch.kernels.autotune.table import tuned_config
from repro_torch.kernels.ssd_scan import kernel as K

DEFAULT_CHUNK = 256


def _check_shapes(x, dt, A, Bm, Cm, chunk):
    if x.dim() != 4 or Bm.dim() != 3 or Bm.shape != Cm.shape:
        raise ValueError(f"want x (B,S,H,P), Bm/Cm (B,S,N); got "
                         f"{tuple(x.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    B, S, H, _ = x.shape
    if (tuple(dt.shape) != (B, S, H) or tuple(A.shape) != (H,)
            or tuple(Bm.shape[:2]) != (B, S)):
        raise ValueError(f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)} and Bm {tuple(Bm.shape)} disagree")
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 256
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``ssd_chunked`` ported (zero-padded tail, one
    chunk at a time, f32 arithmetic, each chunk's state tagged
    ``ssm_state`` as the reference tags it).  Returns (y in x's dtype, final
    state (B,H,P,N) f32)."""
    _check_shapes(x, dt, A, Bm, Cm, chunk)
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    cl = min(chunk, S)
    pad = (-S) % cl
    xf, dtf, Bf, Cf = x.float(), dt.float(), Bm.float(), Cm.float()
    if pad:
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        Bf = F.pad(Bf, (0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, pad))
    nc = (S + pad) // cl
    xc = xf.reshape(B, nc, cl, H, P)
    dtc = dtf.reshape(B, nc, cl, H)
    Bc = Bf.reshape(B, nc, cl, N)
    Cc = Cf.reshape(B, nc, cl, N)
    Af = A.float()
    idx = torch.arange(cl, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[None, :, :, None]   # (1,i,j,1)
    state = torch.zeros(B, H, P, N, dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        xb, dtb, Bb, Cb = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c]
        cs = torch.cumsum(dtb * Af[None, None, :], dim=1)      # (B,cl,H)
        CB = torch.einsum("bin,bjn->bij", Cb, Bb)
        seg = cs[:, :, None, :] - cs[:, None, :, :]             # (B,i,j,H)
        # select before the exp: cs_i - cs_j > 0 above the diagonal
        L = torch.exp(seg.masked_fill(~causal, float("-inf")))
        M = CB[..., None] * L * dtb[:, None, :, :]
        y = torch.einsum("bijh,bjhp->bihp", M, xb)
        y = y + (torch.einsum("bin,bhpn->bihp", Cb, state)
                 * torch.exp(cs)[..., None])
        decay = torch.exp(cs[:, -1:, :] - cs)                   # (B,cl,H)
        xw = xb * (dtb * decay)[..., None]
        state = tag(state * torch.exp(cs[:, -1, :])[:, :, None, None]
                    + torch.einsum("bjhp,bjn->bhpn", xw, Bb), "ssm_state")
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(B, nc * cl, H, P)[:, :S]
    return y.to(x.dtype), state


def ssd_scan_bwd_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor,
                       dstate: Optional[torch.Tensor] = None, *,
                       chunk: int = 256) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of K4's backward: the gradient of
    ``ssd_scan_plain``'s (y, final state) against (dy, dstate) written out
    chunk by chunk in f32, last chunk first, as the kernel computes it (see
    ``csrc/ssd_scan_bwd.cu`` for the formulas).  Returns (dx, ddt, dA, dB,
    dC) in the dtypes of x, dt, A, Bm and Cm."""
    _check_shapes(x, dt, A, Bm, Cm, chunk)
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    cl = min(chunk, S)
    pad = (-S) % cl
    xf, dtf, Bf, Cf, dyf = (t.float() for t in (x, dt, Bm, Cm, dy))
    if pad:
        xf, dyf = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xf, dyf))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        Bf, Cf = (F.pad(t, (0, 0, 0, pad)) for t in (Bf, Cf))
    nc = (S + pad) // cl
    xc, dyc = xf.reshape(B, nc, cl, H, P), dyf.reshape(B, nc, cl, H, P)
    dtc = dtf.reshape(B, nc, cl, H)
    Bc, Cc = Bf.reshape(B, nc, cl, N), Cf.reshape(B, nc, cl, N)
    Af = A.float()
    idx = torch.arange(cl, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[None, :, :, None]   # (1,i,j,1)
    cs = torch.cumsum(dtc * Af, dim=2)                          # (B,nc,cl,H)
    states, st = [], torch.zeros(B, H, P, N, dtype=torch.float32,
                                 device=x.device)
    for c in range(nc):                                         # S_0 of each chunk
        states.append(st)
        w = torch.exp(cs[:, c, -1:] - cs[:, c]) * dtc[:, c]
        st = (st * torch.exp(cs[:, c, -1])[:, :, None, None]
              + torch.einsum("bjhp,bjn->bhpn", xc[:, c] * w[..., None],
                             Bc[:, c]))
    D = (torch.zeros_like(st) if dstate is None
         else dstate.float().expand(B, H, P, N))
    dx, ddt, dB, dC = (torch.empty_like(t) for t in (xc, dtc, Bc, Cc))
    dA = torch.zeros(H, dtype=torch.float32, device=x.device)
    for c in reversed(range(nc)):
        xb, dyb, dtb, Bb, Cb = xc[:, c], dyc[:, c], dtc[:, c], Bc[:, c], Cc[:, c]
        csb, S0 = cs[:, c], states[c]
        cs_last = csb[:, -1]                                    # (B,H)
        G = torch.einsum("bin,bjn->bij", Cb, Bb)
        seg = csb[:, :, None, :] - csb[:, None, :, :]           # (B,i,j,H)
        L = torch.exp(seg.masked_fill(~causal, float("-inf")))
        M = G[..., None] * L * dtb[:, None]
        dM = torch.einsum("bihp,bjhp->bijh", dyb, xb)
        Q = dM * G[..., None] * L                               # dM o G o L
        T = Q * dtb[:, None]                                    # dM o M
        dG = (dM * L * dtb[:, None]).sum(-1)                    # over heads
        ecs = torch.exp(csb)
        dec = torch.exp(cs_last[:, None] - csb)                 # (B,cl,H)
        w = dec * dtb
        U = torch.einsum("bjn,bhpn->bjhp", Bb, D)               # D B_j
        V = torch.einsum("bin,bhpn->bihp", Cb, S0)              # S_0 C_i
        xU = (xb * U).sum(-1)
        dx[:, c] = torch.einsum("bijh,bihp->bjhp", M, dyb) + w[..., None] * U
        dC[:, c] = (torch.einsum("bij,bjn->bin", dG, Bb)
                    + torch.einsum("bihp,bhpn->bin", dyb * ecs[..., None], S0))
        dB[:, c] = (torch.einsum("bij,bin->bjn", dG, Cb)
                    + torch.einsum("bjhp,bhpn->bjn", xb * w[..., None], D))
        dcs = T.sum(2) - T.sum(1) + ecs * (dyb * V).sum(-1) - w * xU
        dcs[:, -1] += (torch.exp(cs_last) * (D * S0).sum((-1, -2))
                       + (w * xU).sum(1))
        da = torch.flip(torch.cumsum(torch.flip(dcs, [1]), 1), [1])
        ddt[:, c] = Q.sum(1) + dec * xU + da * Af
        dA += (da * dtb).sum((0, 1))
        D = (torch.exp(cs_last)[:, :, None, None] * D
             + torch.einsum("bihp,bin->bhpn", dyb * ecs[..., None], Cb))

    def out(g, like, shape):
        return g.reshape(shape)[:, :S].to(like.dtype)
    return (out(dx, x, (B, nc * cl, H, P)), out(ddt, dt, (B, nc * cl, H)),
            dA.to(A.dtype), out(dB, Bm, (B, nc * cl, N)),
            out(dC, Cm, (B, nc * cl, N)))


def _cuda_checks(ts, x, Bm, Cm, what: str) -> None:
    if x.device.type != "cuda" or any(t.device != x.device for t in ts):
        raise RuntimeError(f"{what} runs on one CUDA device or on the CPU; "
                           f"got {[str(t.device) for t in ts]}")
    if (x.dtype not in K.DTYPE_CODES or Bm.dtype != x.dtype
            or Cm.dtype != x.dtype):
        raise TypeError(f"{what} takes float32 or bfloat16 x, Bm and Cm of "
                        f"one dtype; got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if Bm.shape[2] > K.MAX_STATE or Bm.shape[2] % 4:
        raise ValueError(f"state size {Bm.shape[2]}: the kernel takes a "
                         f"multiple of 4 up to {K.MAX_STATE}")
    if any(t.stride(-1) != 1 for t in (x, Bm, Cm)):
        raise ValueError(f"{what} reads x, Bm and Cm through their strides "
                         "but needs unit stride in the last dim")


def _check_bwd_shape(x, chunk: int) -> None:
    """Raise for a head dim or chunk (already cut to S) that K4's backward
    does not take in x's dtype."""
    P = x.shape[3]
    if P > K.MAX_HEAD_DIM_BWD:
        raise ValueError(f"head dim {P}: the SSD backward kernel takes up to "
                         f"{K.MAX_HEAD_DIM_BWD}")
    if x.dtype == torch.bfloat16 and (P % 8 or chunk > K.MAX_CHUNK_BWD_BF16):
        raise ValueError(f"head dim {P}, chunk {chunk}: the bf16 SSD backward "
                         f"takes a head dim that is a multiple of 8 and a "
                         f"chunk of up to {K.MAX_CHUNK_BWD_BF16}")


def _forward(x, dt, A, Bm, Cm, chunk: int, keep: bool):
    """Launch the forward on the card; with ``keep`` also return the
    scratch its backward reads (else None).  The dS buffer of the bf16
    passes lives only for the call."""
    _cuda_checks((x, dt, A, Bm, Cm), x, Bm, Cm, "ssd_scan")
    B, S, H, P = x.shape
    if keep:
        _check_bwd_shape(x, min(chunk, S))
    dt = dt.to(torch.float32)
    A = A.to(torch.float32).contiguous()
    N, chunk = Bm.shape[2], min(chunk, S)
    y = torch.empty(B, S, H, P, dtype=x.dtype, device=x.device)
    state = torch.empty(B, H, P, N, dtype=torch.float32, device=x.device)
    n = (K.saved_floats(B, S, H, P, N, chunk) if keep
         else K.scratch_floats(B, S, H, P, N, chunk, x.dtype))
    scratch = (torch.empty(n, dtype=torch.float32, device=x.device)
               if n else None)
    ds = (torch.empty(K.ds_floats(B, S, H, P, N, chunk), dtype=torch.float32,
                      device=x.device)
          if x.dtype == torch.bfloat16 else None)
    K.ssd_scan_fwd(x, dt, A, Bm, Cm, y, state, scratch, ds, chunk=chunk)
    ssd_scan.launches += 1
    return y, state, scratch if keep else None


class _SSDScanFn(torch.autograd.Function):
    """K4 forward and backward on the card.  The forward keeps the inputs
    and the scratch its backward reads (the ``ssm_state`` site)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        y, state, saved = _forward(x, dt, A, Bm, Cm, chunk, keep=True)
        tag(saved, "ssm_state")
        ctx.save_for_backward(x, dt, A, Bm, Cm, saved)
        ctx.chunk = chunk
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, Bm, Cm, saved = ctx.saved_tensors
        return (*ssd_scan_bwd(x, dt, A, Bm, Cm, dy, dstate, saved=saved,
                              chunk=ctx.chunk), None)


def ssd_scan_saved(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 256
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward kernel on CUDA tensors as ``_SSDScanFn`` launches it:
    (y, final state, the scratch ``ssd_scan_bwd`` reads)."""
    _check_shapes(x, dt, A, Bm, Cm, chunk)
    return _forward(x, dt, A, Bm, Cm, chunk, keep=True)


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor,
                 dstate: Optional[torch.Tensor] = None, *,
                 saved: Optional[torch.Tensor] = None, chunk: int = 256
                 ) -> Tuple[torch.Tensor, ...]:
    """(dx, ddt, dA, dB, dC) of the SSD scan against dy (B,S,H,P) and the
    final state's cotangent ``dstate`` (B,H,P,N, or None for zero).  CPU
    tensors go to ``ssd_scan_bwd_plain``; CUDA tensors launch K4's backward
    on ``saved``, the scratch of the forward on the same inputs
    (``ssd_scan_saved``), which it only reads."""
    _check_shapes(x, dt, A, Bm, Cm, chunk)
    ts = (x, dt, A, Bm, Cm, dy)
    if all(t.device.type == "cpu" for t in ts):
        return ssd_scan_bwd_plain(x, dt, A, Bm, Cm, dy, dstate, chunk=chunk)
    _cuda_checks(ts, x, Bm, Cm, "ssd_scan_bwd")
    B, S, H, P = x.shape
    N, chunk = Bm.shape[2], min(chunk, S)
    if tuple(dy.shape) != (B, S, H, P):
        raise ValueError(f"dy {tuple(dy.shape)} != x {tuple(x.shape)}")
    _check_bwd_shape(x, chunk)
    if saved is None or saved.numel() < K.saved_floats(B, S, H, P, N, chunk):
        raise ValueError("ssd_scan_bwd needs the scratch of the forward on "
                         "these inputs (ssd_scan_saved)")
    dt32 = dt.to(torch.float32)
    A32 = A.to(torch.float32).contiguous()
    dy = dy.to(x.dtype).contiguous()
    dfin = None
    if dstate is not None:
        dfin = dstate.to(torch.float32).expand(B, H, P, N).contiguous()
        if dfin.data_ptr() % 16:
            dfin = dfin.clone()
    dev = x.device
    dx = torch.empty(B, S, H, P, dtype=x.dtype, device=dev)
    ddt = torch.empty(B, S, H, dtype=torch.float32, device=dev)
    dA = torch.empty(H, dtype=torch.float32, device=dev)
    dB = torch.empty(B, S, N, dtype=x.dtype, device=dev)
    dC = torch.empty(B, S, N, dtype=x.dtype, device=dev)
    work = torch.empty(K.bwd_workspace_floats(B, S, H, P, N, chunk, x.dtype),
                       dtype=torch.float32, device=dev)
    K.ssd_scan_bwd(x, dt32, A32, Bm, Cm, dy, dfin, saved, work, dx, ddt, dA,
                   dB, dC, chunk=chunk)
    ssd_scan_bwd.launches += 1
    return dx, ddt.to(dt.dtype), dA.to(A.dtype), dB, dC


ssd_scan_bwd.launches = 0


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *,
             chunk: Optional[int] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,H,P); dt (B,S,H); A (H,); Bm/Cm (B,S,N) -> (y (B,S,H,P) in
    x's dtype, final state (B,H,P,N) f32).  Differentiable on the CPU
    (autograd through the plain version) and on the card (``_SSDScanFn``).
    ``chunk=None`` takes the installed autotune table's, else 256."""
    tuned = None
    if chunk is None:
        tuned = tuned_config("ssd_scan", x.shape, x.dtype)
        chunk = int(tuned["chunk"]) if tuned else DEFAULT_CHUNK
    _check_shapes(x, dt, A, Bm, Cm, chunk)
    ts = (x, dt, A, Bm, Cm)
    if all(t.device.type == "cpu" for t in ts):
        return ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk)
    if isinstance(x, FakeTensor):
        return _FakeScan.apply(x, dt, A, Bm, Cm)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        out = _SSDScanFn.apply(x, dt.to(torch.float32), A.to(torch.float32),
                               Bm, Cm, chunk)
    else:
        out = _forward(x, dt, A, Bm, Cm, chunk, keep=False)[:2]
    if tuned:
        ssd_scan.tuned_launches += 1
    return out


ssd_scan.launches = 0
ssd_scan.tuned_launches = 0


class _FakeScan(torch.autograd.Function):
    """The scan's shape rule, which only fake tensors take (the dry run
    traces the card's path on them; the kernel reads raw pointers): y and
    the final state, and in the backward the inputs' gradients, all
    unwritten."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm):
        ctx.metas = [(t.shape, t.dtype) for t in (x, dt, A, Bm, Cm)]
        B, S, H, P = x.shape
        N = Bm.shape[-1]
        return (torch.empty_like(x),
                x.new_empty((B, H, P, N), dtype=torch.float32))

    @staticmethod
    def backward(ctx, dy, dstate):
        return tuple(dy.new_empty(shape, dtype=dtype)
                     for shape, dtype in ctx.metas)
