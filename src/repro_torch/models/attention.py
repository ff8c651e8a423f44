"""GQA attention: dense / chunked (online-softmax) / flash impls, plus the
decode path over an explicit KV cache.

Port of ``repro/models/attention.py``.  ``chunked`` is the memory-safe
plain-PyTorch default (a loop over KV chunks with running (m, l)
statistics); ``flash`` routes every prefill attention to the hand-written
CUDA flash-attention kernel in ``repro_torch.kernels.flash_attention``,
the place where the reference routes ``pallas`` to its TPU kernel, and
every decode attention (one query row with ``kv_len``) to the flash-decode
kernel of the same package, which reads only the valid cache rows in the
cache's dtype.  The reference never calls its decode kernel from a model;
its decode stays on the chunked path, which ``flash`` decode matches.  In a
train step (grad enabled) ``flash`` prefill attention goes through the
kernels' autograd function: the forward kernel also writes each row's
log-sum-exp and the backward kernel computes dq, dk and dv from it.

Cross-attention (``cross_attention``, over K/V that ``project_cross_kv``
projects once from the encoder output or the image embeddings) attends
non-causally: under ``flash`` a full sequence goes to the flash-attention
kernel with Sq != Sk (forward and backward), and a decode step's one query
row, given ``mem_lens`` (every row the memory's length), to the
flash-decode kernel, which computes exactly that attention.  The
reference computes decode cross-attention on its chunked path, outside
any kernel: the routing to the decode kernel is the port's.

Under a plan that splits the attention over the model dim each rank
computes its run of query heads (``sharding.head_runs``) and the KV heads
they read: from its slices of the projections where the model dim divides
the heads, else out of whole weights (``sharding.kv_slice``,
``sharding.q_slice``); a rank with no heads launches no kernel
(``_NoHeads``) and its share of the output projection's sum is zero.

Under a plan whose decode cache splits positions over the model dim
(``TpPlan.kv_seq``: the reference's cache spec ``("batch", "kv_seq",
"act_kv_heads", None)``), rank r holds positions ``[r * S/tp, (r+1) *
S/tp)`` of every KV head (``init_kv_cache``, ``fill_cache``).  A decode
step gathers every query head and the new K/V row of every KV head over
the model group (a few KB; runs of unequal length padded), writes the row
on the rank that owns its position, attends its own positions for every
head through the decode kernel with each row's log-sum-exp, merges the
ranks' (o, lse) by weights exp(lse - max), and keeps its own heads for
``wo``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.common.config import ModelConfig
from repro_torch.core.sites import tag
from repro_torch.distributed import sharding as shd
from repro_torch.models.layers import (_const, apply_rope, dense_init,
                                       rope_frequencies, torch_dtype)

NEG_INF = -1e30


class Attention(nn.Module):
    AXES = {"wq": ("embed", "q_dim"), "wk": ("embed", "kv_dim"),
            "wv": ("embed", "kv_dim"), "wo": ("q_dim", "embed"),
            "bq": ("q_dim",), "bk": ("kv_dim",), "bv": ("kv_dim",)}

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator], device: torch.device):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.wq = dense_init(cfg.d_model, cfg.q_dim, cfg, **kw)
        self.wk = dense_init(cfg.d_model, cfg.kv_dim, cfg, **kw)
        self.wv = dense_init(cfg.d_model, cfg.kv_dim, cfg, **kw)
        self.wo = dense_init(cfg.q_dim, cfg.d_model, cfg, **kw)
        if cfg.qkv_bias:
            self.bq = _const((cfg.q_dim,), 0.0, cfg, device)
            self.bk = _const((cfg.kv_dim,), 0.0, cfg, device)
            self.bv = _const((cfg.kv_dim,), 0.0, cfg, device)


def _project_q(cfg: ModelConfig, p: Attention, x):
    """This rank's query heads (B,S,H_local,D) of ``x``, which has entered
    the block (``sharding.tp_enter``: its gradient summed over the model
    group once, for the query and the KV projections of the same input)."""
    D = cfg.head_dim
    q = x @ shd.q_slice(p.wq, D)
    if cfg.qkv_bias:
        q = q + shd.q_slice(p.bq, D).to(q.dtype)
    B, S = q.shape[:2]
    return q.reshape(B, S, cfg.num_heads, cfg.head_dim)


def _project_kv(cfg: ModelConfig, p: Attention, x):
    """The KV heads (B,S,Kh_local,D) this rank's query heads read, of
    ``x``, which has entered the block (``_project_q``)."""
    D = cfg.head_dim
    k = x @ shd.kv_slice(p.wk, D)
    v = x @ shd.kv_slice(p.wv, D)
    if cfg.qkv_bias:
        k = k + shd.kv_slice(p.bk, D).to(k.dtype)
        v = v + shd.kv_slice(p.bv, D).to(v.dtype)
    B, S = k.shape[:2]
    k = k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    return k, v


# ------------------------------------------------------------------ core
def dense_attention(cfg: ModelConfig, q, k, v, *, causal: bool,
                    q_offset: int = 0, kv_len: Optional[torch.Tensor] = None):
    """Reference O(S^2)-memory attention. q (B,Sq,H,D), k/v (B,Sk,Kh,D)."""
    B, Sq, H, D = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    G = H // Kh
    qf = q.reshape(B, Sq, Kh, G, D).float()
    scores = torch.einsum("bqkgd,bckd->bkgqc", qf, k.float())
    scores = scores * (1.0 / math.sqrt(D))
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(Sk, device=q.device)[None, :]
        scores = scores.masked_fill(~(qpos >= kpos), NEG_INF)
    if kv_len is not None:
        valid = torch.arange(Sk, device=q.device)[None, :] < kv_len[:, None]
        scores = scores.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bkgqc,bckd->bqkgd", w, v.float())
    return ctx.reshape(B, Sq, H, D).to(q.dtype)


def chunked_attention(cfg: ModelConfig, q, k, v, *, causal: bool,
                      q_offset: int = 0, kv_len: Optional[torch.Tensor] = None):
    """Online-softmax attention over KV chunks: O(Sq·chunk) memory.

    Where autograd records (grad enabled and an input requires grad) the
    no-``kv_len`` case runs under ``torch.utils.checkpoint``, the
    reference's ``jax.checkpoint`` remat boundary: no per-chunk
    probabilities are saved for backward; they are recomputed from q, k, v.
    """
    if (kv_len is None and torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v))):
        return torch.utils.checkpoint.checkpoint(
            _chunked_attention_raw, cfg, q, k, v, causal, q_offset, None,
            use_reentrant=False)
    return _chunked_attention_raw(cfg, q, k, v, causal, q_offset, kv_len)


def _chunked_attention_raw(cfg: ModelConfig, q, k, v, causal: bool,
                           q_offset: int = 0,
                           kv_len: Optional[torch.Tensor] = None):
    B, Sq, H, D = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    G = H // Kh
    C = min(cfg.attn_chunk, Sk)
    if Sk % C:  # pad KV to a chunk multiple with masked tail
        pad = C - Sk % C
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        base_len = torch.full((B,), Sk, dtype=torch.int64, device=q.device)
        kv_len = base_len if kv_len is None else torch.minimum(kv_len, base_len)
        Sk = Sk + pad
    n_chunks = Sk // C
    qf = q.reshape(B, Sq, Kh, G, D).float() / math.sqrt(D)
    qpos = torch.arange(Sq, device=q.device) + q_offset

    m = torch.full((B, Kh, G, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Kh, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Kh, G, Sq, D), dtype=torch.float32,
                      device=q.device)
    for idx in range(n_chunks):
        kb = k[:, idx * C:(idx + 1) * C].float()
        vb = v[:, idx * C:(idx + 1) * C].float()
        kpos = idx * C + torch.arange(C, device=q.device)
        s = torch.einsum("bqkgd,bckd->bkgqc", qf, kb)
        if causal:
            s = s.masked_fill(~(qpos[:, None] >= kpos[None, :]), NEG_INF)
        if kv_len is not None:
            valid = kpos[None, :] < kv_len[:, None]
            s = s.masked_fill(~valid[:, None, None, None, :], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        scale = torch.exp(m - m_new)
        l = l * scale + p.sum(dim=-1)
        acc = acc * scale[..., None] + torch.einsum("bkgqc,bckd->bkgqd", p, vb)
        m = m_new
    ctx = acc / torch.clamp(l, min=1e-30)[..., None]
    ctx = ctx.movedim(3, 1)  # (B, Sq, Kh, G, D)
    return ctx.reshape(B, Sq, H, D).to(q.dtype)


class _NoHeads(torch.autograd.Function):
    """The attention of a model rank that holds no query heads (the model
    dim exceeds them, ``sharding.head_runs``): an empty context and no
    kernel; the backward gives the empty q, k and v their empty gradients,
    so the projections are reached, and their gradients' collectives
    issued, as on every other rank."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.metas = [(t.shape, t.dtype) for t in (q, k, v)]
        return q.new_empty(q.shape)

    @staticmethod
    def backward(ctx, g):
        return tuple(g.new_empty(shape, dtype=dtype)
                     for shape, dtype in ctx.metas)


def _attend(cfg: ModelConfig, q, k, v, *, causal: bool, q_offset: int = 0,
            kv_len=None):
    if q.shape[2] == 0:
        return _NoHeads.apply(q, k, v)
    if cfg.attn_impl == "flash":
        from repro_torch.kernels.flash_attention import ops as fa_ops
        if kv_len is None and q.shape[1] > 1:
            return fa_ops.flash_attention(q, k, v, causal=causal)
        if kv_len is not None and q.shape[1] == 1:
            return fa_ops.flash_decode(q, k, v, kv_len)
    if cfg.attn_impl == "dense" and kv_len is None:
        return dense_attention(cfg, q, k, v, causal=causal, q_offset=q_offset)
    return chunked_attention(cfg, q, k, v, causal=causal, q_offset=q_offset,
                             kv_len=kv_len)


# -------------------------------------------------------------- fwd paths
def self_attention(cfg: ModelConfig, p: Attention, x, positions, *,
                   causal: bool = True, return_kv: bool = False):
    """Full-sequence self-attention (train / prefill). x (B,S,d).

    With ``return_kv`` it also returns the rope'd (k, v) it attended over,
    which is what ``transformer.prefill`` stores in the decode cache."""
    x = shd.tp_enter(x, "attn")
    q = _project_q(cfg, p, x)
    k, v = _project_kv(cfg, p, x)
    if cfg.pos_embedding == "rope":
        cos, sin = rope_frequencies(cfg, positions)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    q = shd.constrain(q, ("batch", "seq", "act_heads", None))
    q = tag(q, "qkv_proj")
    k = tag(k, "qkv_proj")
    v = tag(v, "qkv_proj")
    ctx = _attend(cfg, q, k, v, causal=causal)
    ctx = tag(ctx, "attn_ctx")
    out = _out_proj(cfg, p, ctx)
    return (out, (k, v)) if return_kv else out


def _out_proj(cfg: ModelConfig, p: Attention, ctx):
    B, S = ctx.shape[:2]
    wo = shd.q_slice(p.wo, cfg.head_dim, 0)
    out = shd.tp_exit(ctx.reshape(B, S, cfg.q_dim) @ wo, "attn")
    out = shd.constrain(out, ("batch", "seq", "act_embed"))
    return tag(out, "attn_out")


def cross_attention(cfg: ModelConfig, p: Attention, x,
                    kv_cache: Tuple[torch.Tensor, torch.Tensor], *,
                    mem_lens: Optional[torch.Tensor] = None):
    """Cross-attention against precomputed encoder / image K/V
    (B,T_mem,Kh,D). x (B,S,d).  ``mem_lens`` (B,), each the memory's
    length, routes a decode step's one query row to the flash-decode
    kernel under ``flash``; every other case attends as the reference
    does."""
    q = tag(_project_q(cfg, p, shd.tp_enter(x, "attn")), "qkv_proj")
    k, v = kv_cache
    if (cfg.attn_impl == "flash" and mem_lens is not None
            and q.shape[1] == 1 and q.shape[2]):
        from repro_torch.kernels.flash_attention import ops as fa_ops
        ctx = fa_ops.flash_decode(q, k, v, mem_lens)
    else:
        ctx = _attend(cfg, q, k, v, causal=False)
    ctx = tag(ctx, "cross_ctx")
    return _out_proj(cfg, p, ctx)


def project_cross_kv(cfg: ModelConfig, p: Attention, memory):
    """Precompute cross-attention K/V (B,T_mem,Kh,D) from the encoder
    output or the image embeddings (B,T_mem,d)."""
    k, v = _project_kv(cfg, p, shd.tp_enter(memory, "attn"))
    return tag(k, "cross_kv"), tag(v, "cross_kv")


# ------------------------------------------------------------ decode path
class KVCache(NamedTuple):
    k: torch.Tensor       # (L, B, Smax, Kh, D)
    v: torch.Tensor       # (L, B, Smax, Kh, D)
    length: torch.Tensor  # (B,) int64 — tokens already in cache


def _kv_seq_plan():
    """The installed plan when its decode cache splits positions over more
    than one model rank, else None."""
    plan = shd.current_tp()
    return plan if plan is not None and plan.kv_seq and plan.size > 1 \
        else None


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                  device: torch.device) -> KVCache:
    """Zeroed (L, B, Smax, Kh, D) caches; under a ``kv_seq`` plan this
    rank's Smax / tp positions of every KV head of the model."""
    dtype = torch_dtype(cfg.dtype)
    S, Kh = max_len, cfg.num_kv_heads
    plan = _kv_seq_plan()
    if plan is not None:
        if max_len % plan.size:
            raise ValueError(f"a cache of {max_len} positions does not "
                             f"split over {plan.size} model ranks")
        S, Kh = max_len // plan.size, plan.kv_seq
    shape = (cfg.num_layers, batch, S, Kh, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros((batch,), dtype=torch.int64, device=device))


def decode_self_attention(cfg: ModelConfig, p: Attention, x, layer_cache,
                          positions):
    """One-token decode. x (B,1,d); layer_cache (k,v) (B,Smax,Kh,D);
    positions (B,) current index. Returns (out, (k,v) updated).

    The cache is updated in place.  The reference blends with a one-hot
    row, ``ck * (1 - oh) + oh * k_new``; writing ``k_new`` at
    ``[b, positions[b]]`` gives identical values, and a position at or
    past ``Smax`` leaves the row unchanged, as the all-zero one-hot does."""
    ck, cv = layer_cache
    ck = shd.constrain(ck, ("batch", "kv_seq", "act_kv_heads", None))
    cv = shd.constrain(cv, ("batch", "kv_seq", "act_kv_heads", None))
    x = shd.tp_enter(x, "attn")
    q = _project_q(cfg, p, x)
    k_new, v_new = _project_kv(cfg, p, x)
    if cfg.pos_embedding == "rope":
        cos, sin = rope_frequencies(cfg, positions[:, None])
        q = apply_rope(q, cos, sin)
        k_new = apply_rope(k_new, cos, sin)
    plan = _kv_seq_plan()
    if plan is not None:
        q, k_new, v_new = (_every_head(cfg, plan, q, False),
                           _every_head(cfg, plan, k_new, True),
                           _every_head(cfg, plan, v_new, True))
    B, Smax = ck.shape[:2]
    rows = torch.arange(B, device=ck.device)
    if plan is None:
        idx = torch.clamp(positions, max=Smax - 1)
        keep = (positions < Smax)[:, None, None]
    else:                               # this rank's positions only
        local = positions - plan.rank * Smax
        idx = torch.clamp(local, min=0, max=Smax - 1)
        keep = ((local >= 0) & (local < Smax))[:, None, None]
    ck[rows, idx] = torch.where(keep, k_new[:, 0].to(ck.dtype), ck[rows, idx])
    cv[rows, idx] = torch.where(keep, v_new[:, 0].to(cv.dtype), cv[rows, idx])
    if plan is None:
        ctx = _attend(cfg, q, ck, cv, causal=False, kv_len=positions + 1)
    else:
        ctx = _merged(cfg, plan, q, ck, cv,
                      torch.clamp(local + 1, min=0, max=Smax))
    ctx = tag(ctx, "attn_ctx")
    return _out_proj(cfg, p, ctx), (ck, cv)


def _every_head(cfg: ModelConfig, plan, t, kv: bool):
    """q (B,1,H_local,D) or a new K/V row (B,1,Kh_local,D) with every head
    of the model, gathered over the model group where the plan splits the
    attention.  Where the ranks' runs differ (``TpPlan.heads``) each pads
    its heads to the longest run's before the gather; a KV head that
    several ranks hold is taken from the first of them."""
    if "attn" not in plan.blocks:
        return t
    if plan.heads is None:
        return shd.all_gather(t, 2, plan.group)
    width = max(len(r.kv) if kv else r.count for r in plan.heads)
    t = shd.all_gather(torch.nn.functional.pad(
        t, (0, 0, 0, width - t.shape[2])), 2, plan.group)
    if kv:
        where = {}
        for r, run in enumerate(plan.heads):
            for i, h in enumerate(run.kv):
                where.setdefault(h, r * width + i)
        pick = [where[h] for h in range(plan.kv_seq)]
    else:
        pick = [r * width + i for r, run in enumerate(plan.heads)
                for i in range(run.count)]
    return t[:, :, pick]


def _merged(cfg: ModelConfig, plan, q, ck, cv, lens):
    """Attention of every query head over all positions from each rank's
    (o, lse) over its own: weights exp(lse - max) over the model group;
    this rank's query heads of it (B,1,H_local,D)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    attend = (fa_ops.flash_decode if cfg.attn_impl == "flash"
              else fa_ops.flash_decode_plain)
    o, lse = attend(q, ck, cv, lens, return_lse=True)
    B, _, H, D = q.shape
    n = plan.size
    os_ = shd.all_gather(o.float(), 0, plan.group).reshape(n, B, 1, H, D)
    lses = shd.all_gather(lse, 0, plan.group).reshape(n, B, 1, H, 1)
    w = torch.exp(lses - lses.amax(dim=0))
    ctx = ((w * os_).sum(0) / w.sum(0)).to(q.dtype)
    if "attn" in plan.blocks:
        first = (plan.heads[plan.rank].first if plan.heads is not None
                 else plan.rank * cfg.num_heads)
        ctx = ctx.narrow(2, first, cfg.num_heads)
    return ctx


def fill_cache(cfg: ModelConfig, ck: torch.Tensor, cv: torch.Tensor,
               k: torch.Tensor, v: torch.Tensor) -> None:
    """Write a prompt's rope'd K/V (B,S,Kh,D) at positions 0..S-1 of one
    layer's cache, in place; under a ``kv_seq`` plan the positions this
    rank holds, of every KV head (gathered as a decode step gathers the
    new row's)."""
    plan = _kv_seq_plan()
    if plan is not None:
        k, v = _every_head(cfg, plan, k, True), _every_head(cfg, plan, v, True)
        lo = plan.rank * ck.shape[1]
        k, v = k[:, lo:lo + ck.shape[1]], v[:, lo:lo + ck.shape[1]]
    S = k.shape[1]
    ck[:, :S] = k.to(ck.dtype)
    cv[:, :S] = v.to(cv.dtype)
