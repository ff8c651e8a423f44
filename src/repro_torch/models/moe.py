"""Token-choice top-k Mixture-of-Experts with capacity-based sort dispatch.

Port of ``repro/models/moe.py`` on one device.  Tokens are sorted by expert
id (a stable sort), ranked within their expert's group, and gathered into a
dense (E, C, d) batch; tokens past an expert's capacity C are dropped, as
the reference drops them.  The reference's ``.at[slot].set(..., mode=
"drop")`` is a scatter into a buffer of E * C + 1 slots whose last slot
takes every dropped token, sliced off.  Dispatch and combine move rows
with ``_RowGather``: a gather whose backward is a gather too (each source
row sums the gradients of the rows that read it, through the inverse
map), where autograd's own backward of ``x[idx]`` is a scatter-add that
serialises repeated indices (every empty slot reads token 0) and ran ~0.3
s a layer at granite-moe's width.  The expert products ``ecd,edf->ecf``
are plain batched matrix products (``torch.bmm``), as the reference leaves
them to XLA outside any Pallas kernel.  ``apply_moe_auto`` takes
``apply_moe`` on one device; the expert-parallel ``apply_moe_ep`` needs a
mesh and comes with ROADMAP.md queue 1 item 11.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.common.config import ModelConfig
from repro_torch.core.sites import tag
from repro_torch.models.layers import _act, _normal, dense_init


class Moe(nn.Module):
    """Router (d, E) and the experts' stacked SiLU/GELU-GLU weights:
    ``wi_gate``/``wi_up`` (E, d, f), ``wo`` (E, f, d)."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator], device: torch.device):
        super().__init__()
        E, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
        kw = dict(generator=generator, device=device)
        self.router = dense_init(d, E, cfg, **kw)
        self.wi_gate = _normal((E, d, f), 1.0 / math.sqrt(d), cfg, **kw)
        self.wi_up = _normal((E, d, f), 1.0 / math.sqrt(d), cfg, **kw)
        self.wo = _normal((E, f, d), 1.0 / math.sqrt(f), cfg, **kw)


class _RowGather(torch.autograd.Function):
    """out[r] = src[idx[r]] where ``valid[r]``, else 0.  The backward is the
    inverse gather: grad_src[m] = sum_j grad[inv[m, j]] over the j with
    ``inv_valid[m, j]`` (every r with valid[r] and idx[r] = m, in a fixed
    order), so it runs no scatter and repeats bit for bit."""

    @staticmethod
    def forward(ctx, src, idx, valid, inv, inv_valid):
        ctx.save_for_backward(inv, inv_valid)
        return src[idx] * valid[:, None].to(src.dtype)

    @staticmethod
    def backward(ctx, grad):
        inv, inv_valid = ctx.saved_tensors
        g = grad[inv] * inv_valid[..., None].to(grad.dtype)
        return g.sum(1), None, None, None, None


def capacity(cfg: ModelConfig, num_tokens: int) -> int:
    c = int(math.ceil(num_tokens * cfg.experts_per_token
                      * cfg.moe_capacity_factor / cfg.num_experts))
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def route(probs: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing of (T,E) router probabilities: (gate values
    renormalised over the k chosen, expert ids), each (T,k)."""
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)
    return gate_vals / gate_vals.sum(-1, keepdim=True), expert_idx


def apply_moe_auto(cfg: ModelConfig, p: Moe, x: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One device: the gather implementation."""
    return apply_moe(cfg, p, x)


def apply_moe(cfg: ModelConfig, p: Moe, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,d) -> (out (B,S,d), the Switch-style load-balance loss, an f32
    scalar)."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    T = B * S
    C = capacity(cfg, T)
    dev = x.device
    xf = x.reshape(T, d)

    logits = tag((xf @ p.router).float(), "router_logits")
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = route(probs, K)                     # (T,K)

    # ---- load-balance aux loss (Switch-style)
    me = probs.mean(0)                                          # (E,)
    ce = F.one_hot(expert_idx, E).float().sum(1).mean(0)
    aux = cfg.router_aux_coef * E * torch.sum(me * ce)

    # ---- sort-based dispatch
    N = T * K
    e_flat = expert_idx.reshape(N)
    sort_idx = torch.argsort(e_flat, stable=True)               # (N,)
    sorted_e = e_flat[sort_idx]
    first = torch.searchsorted(sorted_e, torch.arange(E, device=dev),
                               side="left")
    pos = torch.arange(N, device=dev) - first[sorted_e]
    slot = torch.where(pos < C, sorted_e * C + pos,
                       torch.full_like(pos, E * C))             # E*C: dropped
    # each slot's assignment (token t, choice k) as t * K + k + 1, 0 = empty
    slot_a = torch.zeros(E * C + 1, dtype=torch.int64, device=dev)
    slot_a.scatter_(0, slot, sort_idx + 1)
    slot_a = slot_a[:E * C]
    filled = slot_a > 0
    slot_a = (slot_a - 1).clamp(min=0)
    # each assignment's slot, if kept
    a_slot = torch.empty_like(slot).scatter_(0, sort_idx, slot)
    a_keep = a_slot < E * C
    a_slot = a_slot.clamp(max=E * C - 1)
    expert_in = _RowGather.apply(xf, slot_a // K, filled,
                                 a_slot.reshape(T, K), a_keep.reshape(T, K))
    expert_in = tag(expert_in.reshape(E, C, d), "moe_dispatch")

    # ---- expert computation
    gate = torch.bmm(expert_in, p.wi_gate)
    up = torch.bmm(expert_in, p.wi_up)
    h = tag(_act(cfg, gate) * up, "moe_act")
    expert_out = torch.bmm(h, p.wo)

    # ---- combine: each assignment's expert row (0 where dropped)
    y = _RowGather.apply(expert_out.reshape(E * C, d), a_slot, a_keep,
                         slot_a[:, None], filled[:, None])
    y = y.reshape(T, K, d)
    out = torch.sum(y * gate_vals[..., None].to(y.dtype), dim=1)
    out = tag(out.reshape(B, S, d), "moe_out")
    return out, aux.float()
