"""Model-layout wrappers of the flash-attention forward, flash-attention
backward and flash-decode kernels, and their plain versions.

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

K1's forward and backward are ``torch.library`` custom ops,
``repro_torch::flash_attention_fwd`` and ``repro_torch::flash_attention_bwd``,
so the dispatch stream (``core.tokenizer``, ``core.profiler``) holds one
op per launch with its real inputs and outputs, on the card and on the
CPU alike.  Training: when grad is enabled and an input requires grad,
``flash_attention`` goes through ``_FlashAttentionFn``, whose forward
calls the forward op with its ``lse`` output and saves q, k, v, o and lse,
and whose backward calls the backward op (the port of the reference's
``_flash_bwd`` rule, with the forward's own masks: see
``flash_attention_bwd_plain``).  The ops register no autograd:
``flash_attention`` is the differentiable entry.  Their fake kernels are
shape rules that only fake tensors take (the dry run, ``launch.dryrun``,
traces the card's path on them): a real tensor on neither the CPU nor a
CUDA device (``meta``) still raises.  ``flash_decode`` takes fake tensors
the same way (an unwritten output), before its checks.  Under
``torch.no_grad`` it stays the served forward-only call.
``flash_decode`` is forward only.

Tensors on the CPU go to the plain versions; CUDA tensors launch the
kernels or raise, with no fallback.  ``flash_attention.launches``,
``flash_attention_bwd.launches`` and ``flash_decode.launches`` count kernel
launches; one ``flash_decode`` call is one launch, though on the card it
runs two kernels (the split-KV pass and its combine,
``csrc/flash_decode_fwd.cu``), and one ``flash_attention_bwd`` call is one
launch of three kernels (delta, dK/dV, dQ).

The forward reads the autotuner's installed table
(``repro_torch.kernels.autotune.table``) where the caller names no query
rows per block, as the reference's wrapper reads ``block_q``: below the
custom op, in ``_forward``, so the op's schema and the token the recorder
sees stay the same.  With no table installed every launch is the kernel's
own rule.  ``flash_attention.tuned_launches`` counts launches whose rows
came from the table.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels.autotune.table import tuned_config
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


def _mask(B, Sq, Sk, causal, kv_lens, device) -> torch.Tensor:
    """(B,1,1,Sq,Sk) bool: the top-left causal mask and kv_lens."""
    kpos = torch.arange(Sk, device=device)
    mask = torch.ones(B, Sq, Sk, dtype=torch.bool, device=device)
    if causal:
        qpos = torch.arange(Sq, device=device)
        mask = mask & (qpos[:, None] >= kpos[None, :])
    if kv_lens is not None:
        lens = kv_lens.to(device=device, dtype=torch.int64)
        mask = mask & (kpos[None, None, :] < lens[:, None, None])
    return mask[:, None, None]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool, sm_scale: Optional[float] = None,
                          kv_lens: Optional[torch.Tensor] = None,
                          return_lse: bool = False):
    """Plain PyTorch version of the kernel: the same masks, the same f32
    arithmetic, one (Sq, Sk) score matrix per head instead of tiles.  With
    ``return_lse`` it returns (out, lse): lse (B,H,Sq) f32 is each row's
    log-sum-exp of its scaled scores, -inf for a row with no valid key."""
    _check_shapes(q, k, v, kv_lens)
    B, Sq, H, D = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    G = H // Kh
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, Sq, Kh, G, D) * sm_scale
    s = torch.einsum("bqkgd,bckd->bkgqc", qf, k.float())
    mask = _mask(B, Sq, Sk, causal, kv_lens, q.device)
    s = s.masked_fill(~mask, NEG_INF)
    mx = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - mx) * mask
    l = p.sum(dim=-1, keepdim=True)
    ctx = torch.einsum("bkgqc,bckd->bkgqd", p, v.float())
    ctx = ctx / torch.clamp(l, min=1e-30)
    out = ctx.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)
    if not return_lse:
        return out
    lse = (mx + torch.log(l)).reshape(B, H, Sq)      # log(0) = -inf: no key
    return out, lse


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor, *,
                              causal: bool, sm_scale: Optional[float] = None,
                              kv_lens: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the backward kernel: whole (Sq, Sk) matrices
    per head in f32.  For every valid pair (the forward's top-left causal
    mask and kv_lens), P = exp(scale q.k - lse), dV = P^T dO, dP = dO V^T,
    delta = rowsum(dO * O), dS = P (dP - delta), dQ = scale dS K,
    dK = scale dS^T Q; dK and dV sum over a KV head's query heads.
    Returns (dq, dk, dv) in the inputs' dtype; masked pairs add nothing."""
    _check_shapes(q, k, v, kv_lens)
    B, Sq, H, D = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    G = H // Kh
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, Sq, Kh, G, D)
    of = o.float().reshape(B, Sq, Kh, G, D)
    dof = do.float().reshape(B, Sq, Kh, G, D)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkgd,bckd->bkgqc", qf, kf) * sm_scale
    mask = _mask(B, Sq, Sk, causal, kv_lens, q.device)
    lse_ = lse.float().reshape(B, Kh, G, Sq, 1)
    # where a row has no valid key lse is -inf and exp overflows: masked out
    p = torch.where(mask, torch.exp(s - lse_), torch.zeros((), device=q.device))
    dp = torch.einsum("bqkgd,bckd->bkgqc", dof, vf)
    delta = (dof * of).sum(-1).permute(0, 2, 3, 1)[..., None]   # (B,Kh,G,Sq,1)
    ds = p * (dp - delta)
    dv = torch.einsum("bkgqc,bqkgd->bckd", p, dof)
    dk = torch.einsum("bkgqc,bqkgd->bckd", ds, qf) * sm_scale
    dq = torch.einsum("bkgqc,bckd->bqkgd", ds, kf) * sm_scale
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _on_cpu(*ts) -> bool:
    return all(t is None or t.device.type == "cpu" for t in ts)


def _check_cuda(name: str, q, *ts) -> None:
    """What the CUDA kernels take: one device, one dtype, a head dim of
    HEAD_DIMS, 16-byte aligned (after ``contiguous``)."""
    if q.device.type != "cuda" or any(t.device != q.device for t in ts):
        raise RuntimeError(f"{name} runs on one CUDA device or on the CPU; "
                           f"got {[str(t.device) for t in (q, *ts)]}")
    if q.dtype not in K.DTYPE_CODES or any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"{name} takes float32 or bfloat16 tensors of one "
                        f"dtype; got {[t.dtype for t in (q, *ts)]}")
    if q.shape[3] not in K.HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[3]} not in {K.HEAD_DIMS}")
    if any(t.data_ptr() % 16 for t in (q, *ts)):
        raise ValueError(f"{name} reads its tensors in 16-byte vectors or "
                         "through tensor maps: they must start 16-byte "
                         "aligned")


def _lens32(kv_lens, device):
    if kv_lens is None:
        return None
    return kv_lens.to(device=device, dtype=torch.int32).contiguous()


def tuned_block_q(q: torch.Tensor) -> Optional[int]:
    """Query rows per block the installed autotune table holds for q's
    shape bucket and dtype, or None."""
    cfg = tuned_config("flash_attention", q.shape, q.dtype)
    return int(cfg["block_q"]) if cfg else None


def _forward(q, k, v, *, causal, sm_scale, kv_lens, with_lse: bool,
             block_q: Optional[int] = None):
    """The forward on the CPU (plain) or the card (the kernel); returns
    (out, lse or None).  ``block_q``: query rows per block on the card
    (None: the tuned table's, else the kernel's own rule)."""
    if _on_cpu(q, k, v):
        if with_lse:
            return flash_attention_plain(q, k, v, causal=causal,
                                         sm_scale=sm_scale, kv_lens=kv_lens,
                                         return_lse=True)
        return flash_attention_plain(q, k, v, causal=causal,
                                     sm_scale=sm_scale, kv_lens=kv_lens), None
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check_cuda("flash_attention", q, k, v)
    kv_lens = _lens32(kv_lens, q.device)
    out = torch.empty_like(q)
    lse = None
    if with_lse:
        B, Sq, H, _ = q.shape
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    tuned = tuned_block_q(q) if block_q is None else None
    K.flash_attention_fwd(q, k, v, out, kv_lens, causal=causal,
                          sm_scale=sm_scale, lse=lse,
                          block_q=block_q or tuned)
    flash_attention.launches += 1
    if tuned:
        flash_attention.tuned_launches += 1
    return out, lse


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def _fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            kv_lens: Optional[torch.Tensor], causal: bool, sm_scale: float,
            with_lse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's forward as one op of the dispatch stream: (out, lse), lse
    empty unless ``with_lse``."""
    out, lse = _forward(q, k, v, causal=causal, sm_scale=sm_scale,
                        kv_lens=kv_lens, with_lse=with_lse)
    if lse is None:
        lse = torch.empty((0,), dtype=torch.float32, device=q.device)
    return out, lse


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def _bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
            kv_lens: Optional[torch.Tensor], causal: bool, sm_scale: float
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1's backward as one op of the dispatch stream: (dq, dk, dv), from
    the plain version on the CPU or the kernel on the card."""
    if _on_cpu(q, k, v, o, lse, do):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         sm_scale=sm_scale, kv_lens=kv_lens)
    q, k, v, o, do = (t.contiguous() for t in (q, k, v, o, do))
    _check_cuda("flash_attention_bwd", q, k, v, o, do)
    if lse.dtype != torch.float32 or lse.device != q.device:
        raise TypeError(f"lse must be float32 on {q.device}; got {lse.dtype} "
                        f"on {lse.device}")
    lse = lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    K.flash_attention_bwd(q, k, v, o, lse, do, dq, dk, dv,
                          _lens32(kv_lens, q.device), causal=causal,
                          sm_scale=sm_scale)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def _check_fake(name: str, *ts) -> None:
    """The fake kernels are shape rules for fake tensors (the dry run); a
    real ``meta`` tensor still has no kernel and raises."""
    if not all(t is None or isinstance(t, FakeTensor) for t in ts):
        raise RuntimeError(f"{name} runs on one CUDA device or on the CPU; "
                           f"got {[str(t.device) for t in ts if t is not None]}")


@_fwd_op.register_fake
def _fwd_fake(q, k, v, kv_lens, causal, sm_scale, with_lse):
    _check_fake("flash_attention", q, k, v, kv_lens)
    B, Sq, H, _ = q.shape
    lse = q.new_empty((B, H, Sq) if with_lse else (0,), dtype=torch.float32)
    return torch.empty_like(q), lse


@_bwd_op.register_fake
def _bwd_fake(q, k, v, o, lse, do, kv_lens, causal, sm_scale):
    _check_fake("flash_attention_bwd", q, k, v, o, lse, do, kv_lens)
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool, sm_scale: Optional[float] = None,
                        kv_lens: Optional[torch.Tensor] = None):
    """q/o/do (B,Sq,H,D); k/v (B,Sk,Kh,D); lse (B,H,Sq) f32 from the forward
    -> (dq, dk, dv) in the inputs' dtype.  CPU tensors take
    ``flash_attention_bwd_plain``; CUDA tensors launch the kernel."""
    _check_shapes(q, k, v, kv_lens)
    B, Sq, H, D = q.shape
    if tuple(o.shape) != tuple(q.shape) or tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"have q's shape {tuple(q.shape)}")
    if tuple(lse.shape) != (B, H, Sq):
        raise ValueError(f"lse must have shape {(B, H, Sq)}, got "
                         f"{tuple(lse.shape)}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    return _bwd_op(q, k, v, o, lse, do, kv_lens, causal, float(sm_scale))


flash_attention_bwd.launches = 0


class _FlashAttentionFn(torch.autograd.Function):
    """Flash attention with its backward kernel, both through the custom
    ops: the forward saves q, k, v, the output and its lse (nothing
    quadratic), the backward recomputes P."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lens, causal, sm_scale):
        out, lse = _fwd_op(q, k, v, kv_lens, causal, sm_scale, True)
        ctx.save_for_backward(q, k, v, out, lse, kv_lens)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, kv_lens = ctx.saved_tensors
        dq, dk, dv = _bwd_op(q, k, v, out, lse, do, kv_lens, ctx.causal,
                             ctx.sm_scale)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, sm_scale: Optional[float] = None,
                    kv_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B,Sq,H,D); k/v (B,Sk,Kh,D); kv_lens (B,) or None -> (B,Sq,H,D).
    Differentiable in q, k and v through ``_FlashAttentionFn``."""
    _check_shapes(q, k, v, kv_lens)
    sm_scale = float(1.0 / math.sqrt(q.shape[3]) if sm_scale is None
                     else sm_scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttentionFn.apply(q, k, v, kv_lens, causal, sm_scale)
    out, _ = _fwd_op(q, k, v, kv_lens, causal, sm_scale, False)
    return out


flash_attention.launches = 0
flash_attention.tuned_launches = 0


def _check_decode(q, k, v, lens):
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"flash_decode takes one query token, q (B,1,H,D); "
                         f"got {tuple(q.shape)}")
    _check_shapes(q, k, v, lens)


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       lens: torch.Tensor, *,
                       sm_scale: Optional[float] = None,
                       return_lse: bool = False):
    """Plain PyTorch version of the decode kernel: a masked softmax in f32
    over the first ``lens[b]`` cache rows; zeros where ``lens[b] <= 0``.
    With ``return_lse`` also each row's log-sum-exp (B,H,1) f32, -inf where
    ``lens[b] <= 0``."""
    _check_decode(q, k, v, lens)
    return flash_attention_plain(q, k, v, causal=False, sm_scale=sm_scale,
                                 kv_lens=lens, return_lse=return_lse)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lens: torch.Tensor, *,
                 sm_scale: Optional[float] = None, return_lse: bool = False):
    """q (B,1,H,D); k/v (B,Smax,Kh,D), contiguous; lens (B,) -> (B,1,H,D),
    or with ``return_lse`` (out, lse (B,H,1) f32): each row's log-sum-exp,
    which merges attention over positions split between ranks
    (``models.attention``, the ``kv_seq`` cache)."""
    _check_decode(q, k, v, lens)
    if any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_decode is forward only; call it under "
                           "torch.no_grad()")
    B, _, H, D = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    if all(t.device.type == "cpu" for t in (q, k, v, lens)):
        return flash_decode_plain(q, k, v, lens, sm_scale=sm_scale,
                                  return_lse=return_lse)
    if isinstance(q, FakeTensor):   # the shape rule the dry run traces
        out = torch.empty_like(q)
        return ((out, q.new_empty((B, H, 1), dtype=torch.float32))
                if return_lse else out)
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
    lse = (torch.empty((B, H, 1), dtype=torch.float32, device=q.device)
           if return_lse else None)
    K.flash_decode_fwd(q, k, v, out, lens, sm_scale=sm_scale, lse=lse)
    flash_decode.launches += 1
    return (out, lse) if return_lse else out


flash_decode.launches = 0
