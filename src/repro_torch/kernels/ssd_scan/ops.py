"""Model-layout wrapper of the SSD scan kernel, and its plain version.

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
card the kernel is forward only: a CUDA input that requires grad raises
(its backward, K4 backward, is owed to ROADMAP.md queue 1 item 7).
``ssd_scan.launches`` counts calls that launch the kernel: one per call,
whatever the passes.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import kernel as K


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
    chunk at a time, f32 arithmetic).  Returns (y in x's dtype, final state
    (B,H,P,N) f32)."""
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
        state = (state * torch.exp(cs[:, -1, :])[:, :, None, None]
                 + torch.einsum("bjhp,bjn->bhpn", xw, Bb))
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(B, nc * cl, H, P)[:, :S]
    return y.to(x.dtype), state


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 256
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,H,P); dt (B,S,H); A (H,); Bm/Cm (B,S,N) -> (y (B,S,H,P) in
    x's dtype, final state (B,H,P,N) f32)."""
    _check_shapes(x, dt, A, Bm, Cm, chunk)
    ts = (x, dt, A, Bm, Cm)
    if all(t.device.type == "cpu" for t in ts):
        return ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError("ssd_scan is forward only on the card: the K4 "
                           "backward kernel is not ported yet (ROADMAP.md "
                           "queue 1 item 7); call it under torch.no_grad()")
    if x.device.type != "cuda" or any(t.device != x.device for t in ts):
        raise RuntimeError(f"ssd_scan runs on one CUDA device or on the CPU; "
                           f"got {[str(t.device) for t in ts]}")
    if (x.dtype not in K.DTYPE_CODES or Bm.dtype != x.dtype
            or Cm.dtype != x.dtype):
        raise TypeError(f"ssd_scan takes float32 or bfloat16 x, Bm and Cm of "
                        f"one dtype; got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if Bm.shape[2] > K.MAX_STATE or Bm.shape[2] % 4:
        raise ValueError(f"state size {Bm.shape[2]}: the kernel takes a "
                         f"multiple of 4 up to {K.MAX_STATE}")
    if any(t.stride(-1) != 1 for t in (x, Bm, Cm)):
        raise ValueError("ssd_scan reads x, Bm and Cm through their strides "
                         "but needs unit stride in the last dim")
    dt = dt.to(torch.float32)
    A = A.to(torch.float32).contiguous()
    B, S, H, P = x.shape
    N, chunk = Bm.shape[2], min(chunk, S)
    y = torch.empty(B, S, H, P, dtype=x.dtype, device=x.device)
    state = torch.empty(B, H, P, N, dtype=torch.float32, device=x.device)
    n = K.scratch_floats(B, S, H, P, N, chunk, x.dtype)
    scratch = (torch.empty(n, dtype=torch.float32, device=x.device)
               if n else None)
    K.ssd_scan_fwd(x, dt, A, Bm, Cm, y, state, scratch, chunk=chunk)
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
