"""Model-layout wrappers of the flash-attention forward and flash-decode
kernels, and their plain versions.

``flash_attention`` takes the model zoo's layout, q (B,Sq,H,D) and k/v
(B,Sk,Kh,D), as ``repro/kernels/flash_attention/ops.py`` does.  The CUDA
kernel masks ragged Sq/Sk edges itself, so the reference's pad-to-block,
transpose and slice are gone.  Semantics, shared by the kernel and
``flash_attention_plain``: the top-left causal mask ``qpos >= kpos`` of
``models/attention.py`` (not ``attention_ref``'s bottom-right one), keys
at or past ``kv_lens[b]`` masked, f32 softmax and sums, output in
``q.dtype``; a row with no valid key gives zeros.

``flash_decode`` is one query token over a KV cache, as the decode step
calls it: q (B,1,H,D), the cache k/v (B,Smax,Kh,D) read in place, and the
valid lengths ``lens`` (B,) on the device.  Rows at or past ``lens[b]`` are
masked (the kernel never reads them); a row with ``lens[b] <= 0`` gives
zeros, in the kernel and in ``flash_decode_plain`` alike.

Tensors on the CPU go to the plain versions; CUDA tensors launch the
kernels or raise, with no fallback.  The wrappers are forward only: an
input that requires grad raises (the backward kernel comes with the
training slice).  ``flash_attention.launches`` and
``flash_decode.launches`` count kernel launches; one ``flash_decode`` call
is one launch, though on the card it runs two kernels (the split-KV pass
and its combine, ``csrc/flash_decode_fwd.cu``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.flash_attention import kernel as K

NEG_INF = -1e30


def _check_shapes(q, k, v, kv_lens):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,Sq,H,D), k/v (B,Sk,Kh,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} "
                         "disagree on batch, head dim or head grouping")
    if kv_lens is not None and tuple(kv_lens.shape) != (B,):
        raise ValueError(f"kv_lens must have shape ({B},), got "
                         f"{tuple(kv_lens.shape)}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool, sm_scale: Optional[float] = None,
                          kv_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same masks, the same f32
    arithmetic, one (Sq, Sk) score matrix per head instead of tiles."""
    _check_shapes(q, k, v, kv_lens)
    B, Sq, H, D = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    G = H // Kh
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, Sq, Kh, G, D) * sm_scale
    s = torch.einsum("bqkgd,bckd->bkgqc", qf, k.float())
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones(B, Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        qpos = torch.arange(Sq, device=q.device)
        mask = mask & (qpos[:, None] >= kpos[None, :])
    if kv_lens is not None:
        lens = kv_lens.to(device=q.device, dtype=torch.int64)
        mask = mask & (kpos[None, None, :] < lens[:, None, None])
    mask = mask[:, None, None]                       # (B,1,1,Sq,Sk)
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * mask
    l = p.sum(dim=-1, keepdim=True)
    ctx = torch.einsum("bkgqc,bckd->bkgqd", p, v.float())
    ctx = ctx / torch.clamp(l, min=1e-30)
    return ctx.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, sm_scale: Optional[float] = None,
                    kv_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B,Sq,H,D); k/v (B,Sk,Kh,D); kv_lens (B,) or None -> (B,Sq,H,D)."""
    _check_shapes(q, k, v, kv_lens)
    if any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention is forward only; call it under "
                           "torch.no_grad() (the backward kernel is not "
                           "ported yet)")
    D = q.shape[3]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     sm_scale=sm_scale, kv_lens=kv_lens)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise RuntimeError(f"flash_attention runs on one CUDA device or on the "
                           f"CPU; got {q.device}, {k.device}, {v.device}")
    if q.dtype not in K.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q/k/v of "
                        f"one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in K.HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {K.HEAD_DIMS}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention reads q, k and v through tensor "
                         "maps: they must start 16-byte aligned")
    if kv_lens is not None:
        kv_lens = kv_lens.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    K.flash_attention_fwd(q, k, v, out, kv_lens, causal=causal,
                          sm_scale=sm_scale)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _check_decode(q, k, v, lens):
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"flash_decode takes one query token, q (B,1,H,D); "
                         f"got {tuple(q.shape)}")
    _check_shapes(q, k, v, lens)


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       lens: torch.Tensor, *,
                       sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of the decode kernel: a masked softmax in f32
    over the first ``lens[b]`` cache rows; zeros where ``lens[b] <= 0``."""
    _check_decode(q, k, v, lens)
    return flash_attention_plain(q, k, v, causal=False, sm_scale=sm_scale,
                                 kv_lens=lens)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lens: torch.Tensor, *,
                 sm_scale: Optional[float] = None) -> torch.Tensor:
    """q (B,1,H,D); k/v (B,Smax,Kh,D), contiguous; lens (B,) -> (B,1,H,D)."""
    _check_decode(q, k, v, lens)
    if any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_decode is forward only; call it under "
                           "torch.no_grad()")
    D = q.shape[3]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    if all(t.device.type == "cpu" for t in (q, k, v, lens)):
        return flash_decode_plain(q, k, v, lens, sm_scale=sm_scale)
    if (q.device.type != "cuda"
            or any(t.device != q.device for t in (k, v, lens))):
        raise RuntimeError(f"flash_decode runs on one CUDA device or on the "
                           f"CPU; got {q.device}, {k.device}, {v.device}, "
                           f"{lens.device}")
    if q.dtype not in K.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_decode takes float32 or bfloat16 q/k/v of "
                        f"one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in K.HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {K.HEAD_DIMS}")
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_decode reads the cache in place: k and v "
                         "must be contiguous (B,Smax,Kh,D)")
    q = q.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_decode loads 16-byte vectors: q, k and v "
                         "must start 16-byte aligned")
    lens = lens.to(dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    K.flash_decode_fwd(q, k, v, out, lens, sm_scale=sm_scale)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
