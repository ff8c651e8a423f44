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
them to XLA outside any Pallas kernel.  ``apply_moe_auto`` takes the
expert-parallel ``apply_moe_ep`` where the active mesh's rules put experts
on its model dim (explicit local compute on the mesh's groups, the
reference's ``shard_map``), else ``apply_moe``; on a one-rank model dim
the two run the same ops.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.common.config import ModelConfig
from repro_torch.core.sites import tag
from repro_torch.distributed import sharding as shd
from repro_torch.models.layers import _act, _normal, dense_init


class Moe(nn.Module):
    """Router (d, E) and the experts' stacked SiLU/GELU-GLU weights:
    ``wi_gate``/``wi_up`` (E, d, f), ``wo`` (E, f, d)."""
    AXES = {"router": ("embed", "experts"),
            "wi_gate": ("experts", "embed", "expert_mlp"),
            "wi_up": ("experts", "embed", "expert_mlp"),
            "wo": ("experts", "expert_mlp", "embed")}

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
    """Expert parallelism when the active rules put experts on the model
    dim of the mesh, else the gather implementation (one device, or
    dp_only rules, where experts are data-local)."""
    mesh = shd.current_mesh()
    if mesh is not None and "model" in shd.mesh_names(mesh):
        tp = shd.mesh_shape(mesh)["model"]
        if (cfg.num_experts % tp == 0
                and shd.partition_spec(("experts",))[:1] == ("model",)):
            return apply_moe_ep(cfg, p, x)
    return apply_moe(cfg, p, x)


def _route(cfg: ModelConfig, p: Moe, xf: torch.Tensor):
    """Router, top-k and the load-balance loss over the tokens ``xf``
    (T,d): (gate values (T,K), expert ids (T,K), aux)."""
    E, K = cfg.num_experts, cfg.experts_per_token
    logits = tag((xf @ p.router).float(), "router_logits")
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = route(probs, K)                     # (T,K)

    # ---- load-balance aux loss (Switch-style)
    me = probs.mean(0)                                          # (E,)
    ce = F.one_hot(expert_idx, E).float().sum(1).mean(0)
    aux = cfg.router_aux_coef * E * torch.sum(me * ce)
    return gate_vals, expert_idx, aux


def _experts(cfg: ModelConfig, wi_gate, wi_up, wo, xf, gate_vals,
             expert_idx, C: int, e_lo: int = 0) -> torch.Tensor:
    """Dispatch the tokens ``xf`` (T,d) to the experts ``e_lo ..
    e_lo + E_loc - 1`` whose weights are given (E_loc leads each), run
    them and combine: (T,d), the sum over each token's choices of its gate
    value times its expert's row, 0 where the choice is dropped or, under
    expert parallelism, lives on another rank."""
    T, d = xf.shape
    K = cfg.experts_per_token
    E = wi_gate.shape[0]                                        # local experts
    dev = xf.device
    local = E != cfg.num_experts or e_lo != 0

    # ---- sort-based dispatch
    N = T * K
    e_flat = expert_idx.reshape(N)
    if local:                       # another rank's expert: id E, dropped
        e_flat = e_flat - e_lo
        e_flat = torch.where((e_flat >= 0) & (e_flat < E), e_flat,
                             torch.full_like(e_flat, E))
    sort_idx = torch.argsort(e_flat, stable=True)               # (N,)
    sorted_e = e_flat[sort_idx]
    first = torch.searchsorted(sorted_e, torch.arange(E, device=dev),
                               side="left")
    if local:
        pos = torch.arange(N, device=dev) - first[sorted_e.clamp(max=E - 1)]
        keep = (sorted_e < E) & (pos < C)
    else:
        pos = torch.arange(N, device=dev) - first[sorted_e]
        keep = pos < C
    slot = torch.where(keep, sorted_e * C + pos,
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
    expert_in = shd.constrain(expert_in.reshape(E, C, d),
                              ("experts", None, "act_embed"))
    expert_in = tag(expert_in, "moe_dispatch")

    # ---- expert computation
    gate = torch.bmm(expert_in, wi_gate)
    up = torch.bmm(expert_in, wi_up)
    h = shd.constrain(_act(cfg, gate) * up, ("experts", None, "expert_mlp"))
    h = tag(h, "moe_act")
    expert_out = torch.bmm(h, wo)
    expert_out = shd.constrain(expert_out, ("experts", None, "act_embed"))

    # ---- combine: each assignment's expert row (0 where dropped)
    y = _RowGather.apply(expert_out.reshape(E * C, d), a_slot, a_keep,
                         slot_a[:, None], filled[:, None])
    y = y.reshape(T, K, d)
    return torch.sum(y * gate_vals[..., None].to(y.dtype), dim=1)


def apply_moe(cfg: ModelConfig, p: Moe, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,d) -> (out (B,S,d), the Switch-style load-balance loss, an f32
    scalar)."""
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    gate_vals, expert_idx, aux = _route(cfg, p, xf)
    out = _experts(cfg, p.wi_gate, p.wi_up, p.wo, xf, gate_vals, expert_idx,
                   capacity(cfg, T))
    out = tag(out.reshape(B, S, d), "moe_out")
    out = shd.constrain(out, ("batch", "seq", "act_embed"))
    return out, aux.float()


def apply_moe_ep(cfg: ModelConfig, p: Moe, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism on the active mesh: x (B_loc,S,d) is this rank's
    share of the batch over the batch dims.  Routing and dispatch stay
    local to the rank's tokens (capacity over the local tokens); each
    ``model`` rank runs its E/tp experts (``p``'s expert weights hold
    either those E/tp or all E, of which it takes its slice); one sum of
    the combine over the model group; ``aux`` the mean over the batch
    dims.  Gradients: the router and ``aux`` are replicated over the model
    group, so the tokens and the gate values enter the local experts
    through ``sharding.enter`` (their partial gradients summed), and
    ``aux``'s mean carries the local loss's gradient, as a data-parallel
    step averages its ranks' gradients."""
    mesh = shd.current_mesh()
    if mesh is None or "model" not in shd.mesh_names(mesh):
        raise ValueError("apply_moe_ep needs a mesh with a model dim")
    E = cfg.num_experts
    r, tp = shd.coordinate(mesh, ("model",))
    if E % tp:
        raise ValueError(f"{E} experts do not split over {tp} model ranks")
    E_loc = E // tp
    e_lo = r * E_loc
    wg, wu, wo = p.wi_gate, p.wi_up, p.wo
    if wg.shape[0] == E and tp > 1:
        wg, wu, wo = (w[e_lo:e_lo + E_loc] for w in (wg, wu, wo))
    if wg.shape[0] != E_loc:
        raise ValueError(f"expert weights lead with {wg.shape[0]}, not "
                         f"{E_loc} (local) or {E}")
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    gate_vals, expert_idx, aux = _route(cfg, p, xf)
    group = shd.group_of(mesh, ("model",)) if tp > 1 else None
    out = _experts(cfg, wg, wu, wo, shd.enter(xf, group),
                   shd.enter(gate_vals, group), expert_idx,
                   capacity(cfg, T), e_lo)
    out = shd.exit(out, group)               # the combine over the experts
    out = tag(out.reshape(B, S, d), "moe_out")
    batch = shd.resolve_axes("batch", mesh)
    if batch and shd.coordinate(mesh, batch)[1] > 1:
        aux = aux + (shd.mean(aux.detach(), shd.group_of(mesh, batch))
                     - aux.detach())
    return out, aux.float()
