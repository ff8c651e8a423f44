"""The plain reference: a decoder of the ``dense`` or ``moe`` family, its
loss and its gradients, in plain PyTorch.

It follows the published equations of the configuration file
(``portbench/configs/<name>.json``): token embedding; per layer a pre-norm
(RMSNorm) grouped-query causal self-attention with rotary positions
(rotate-half, ``rope_theta``) and optional q / k / v biases, then a
pre-norm SiLU-gated MLP, or for the ``moe`` family a router softmax over
the experts, the top ``num_experts_per_tok`` renormalised, each expert a
SiLU-gated MLP, the assignments past an expert's capacity dropped in
token order, and the Switch load-balance loss ``coef * E * sum(mean
probability x mean assignments)`` added to the loss; a final RMSNorm, the
output head and the mean next-token cross-entropy.  It imports nothing of
the program and computes in float32 with TF32 off.

``Precision("fp8")`` is the control: every product's operands are rounded
to float8 e4m3 (one scale a tensor, its largest magnitude at 448) in the
forward, as an fp8 product would read them; the backward passes the
gradient through the rounding unchanged.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.yardstick import head_dim

F8_MAX = 448.0


class _RoundF8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax()
        scale = torch.where(amax > 0, amax / F8_MAX, torch.ones_like(amax))
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


class Precision:
    """``f32``: plain products; ``fp8``: the control's rounded operands."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"precision {name!r} is not f32 or fp8")
        self.name = name

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "fp8":
            a, b = _RoundF8.apply(a), _RoundF8.apply(b)
        return a @ b


def rms_norm(x, scale, eps: float):
    ms = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(ms + eps) * scale


def rope(x, positions, theta: float):
    """x (B, S, H, D): rotate-half rotary positions."""
    half = x.shape[-1] // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                        device=x.device) / half))
    ang = positions.float()[:, None] * inv              # (S, half)
    c, s = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(cfg: Mapping, prec: Precision, p: Dict[str, torch.Tensor],
              pre: str, h):
    B, S, d = h.shape
    H, Kh = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D = head_dim(cfg)
    q = prec.mm(h, p[pre + "wq"])
    k = prec.mm(h, p[pre + "wk"])
    v = prec.mm(h, p[pre + "wv"])
    if cfg.get("qkv_bias"):
        q, k, v = q + p[pre + "bq"], k + p[pre + "bk"], v + p[pre + "bv"]
    pos = torch.arange(S, device=h.device)
    q = rope(q.view(B, S, H, D), pos, cfg["rope_theta"])
    k = rope(k.view(B, S, Kh, D), pos, cfg["rope_theta"])
    v = v.view(B, S, Kh, D)
    # query head j reads KV head j // (H / Kh)
    k = k.repeat_interleave(H // Kh, dim=2)
    v = v.repeat_interleave(H // Kh, dim=2)
    mask = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    ctx = []
    for b in range(B):                    # one row at a time: (H, S, S) scores
        qb, kb, vb = (t[b].transpose(0, 1) for t in (q, k, v))
        s = prec.mm(qb, kb.transpose(1, 2)) / math.sqrt(D)
        w = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        ctx.append(prec.mm(w, vb).transpose(0, 1).reshape(S, H * D))
    return prec.mm(torch.stack(ctx), p[pre + "wo"])


def mlp(prec: Precision, x, wg, wu, wo):
    return prec.mm(F.silu(prec.mm(x, wg)) * prec.mm(x, wu), wo)


def capacity(cfg: Mapping, tokens: int) -> int:
    c = math.ceil(tokens * cfg["num_experts_per_tok"] * cfg["capacity_factor"]
                  / cfg["num_experts"])
    return max(8, -(-c // 8) * 8)


def experts(cfg: Mapping, prec: Precision, p: Dict[str, torch.Tensor],
            pre: str, h, route: Optional[torch.Tensor] = None,
            stats: Optional[dict] = None, layer: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert layer over h (B, S, d): (out, load-balance loss).

    ``route`` (T, K): experts chosen elsewhere, followed instead of this
    layer's own top-k; ``stats["route_gap"]`` then keeps the widest gap by
    which a followed choice's router logit lies below this layer's K-th
    largest (0 where every choice is in its own top K).  Where ``stats``
    has ``routes``, the experts this layer chose go there by ``layer``."""
    B, S, d = h.shape
    T, E, K = B * S, cfg["num_experts"], cfg["num_experts_per_tok"]
    x = h.reshape(T, d)
    logits = prec.mm(x, p[pre + "router"])
    probs = torch.softmax(logits, dim=-1)
    if route is None:
        top, idx = torch.topk(probs, K, dim=-1)
    else:
        idx = route
        top = probs.gather(1, idx)
        kth = torch.topk(logits.detach(), K, dim=-1).values[:, -1:]
        gap = float((kth - logits.detach().gather(1, idx)).clamp(min=0).max())
        stats["route_gap"] = max(stats.get("route_gap", 0.0), gap)
    if stats is not None and "routes" in stats:
        stats["routes"][layer] = idx.detach()
    if cfg.get("norm_topk_prob", True):
        top = top / top.sum(-1, keepdim=True)
    counts = F.one_hot(idx, E).float().sum(1).mean(0)
    aux = cfg["router_aux_loss_coef"] * E * torch.sum(probs.mean(0) * counts)
    # assignment a = t * K + k; its rank among the earlier assignments to
    # the same expert decides whether it fits
    flat = idx.reshape(T * K)
    onehot = F.one_hot(flat, E)
    rank = (onehot.cumsum(0) * onehot).sum(1) - 1
    kept = rank < capacity(cfg, T)
    gates = top.reshape(T * K)
    out = torch.zeros_like(x)
    for e in range(E):
        a = torch.nonzero((flat == e) & kept, as_tuple=True)[0]
        if a.numel() == 0:
            continue
        t = a // K
        y = mlp(prec, x[t], p[pre + "wi_gate"][e], p[pre + "wi_up"][e],
                p[pre + "wo"][e])
        out = out.index_add(0, t, y * gates[a, None])
    return out.view(B, S, d), aux


def block(cfg: Mapping, prec: Precision, p: Dict[str, torch.Tensor], i: int,
          x, routes: Optional[dict] = None, stats: Optional[dict] = None):
    pre = f"blocks.{i}."
    eps = cfg["rms_norm_eps"]
    x = x + attention(cfg, prec, p, pre + "attn.",
                      rms_norm(x, p[pre + "ln1.scale"], eps))
    h = rms_norm(x, p[pre + "ln2.scale"], eps)
    if cfg["family"] == "moe":
        y, aux = experts(cfg, prec, p, pre + "moe.", h,
                         None if routes is None else routes[i], stats, i)
    else:
        y = mlp(prec, h, p[pre + "mlp.wi_gate"], p[pre + "mlp.wi_up"],
                p[pre + "mlp.wo"])
        aux = torch.zeros((), device=x.device)
    return x + y, aux


def head_loss(cfg: Mapping, prec: Precision, p: Dict[str, torch.Tensor], x,
              labels):
    x = rms_norm(x, p["ln_f.scale"], cfg["rms_norm_eps"])
    logits = prec.mm(x, p["embed.unembed"])
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long())


def loss(cfg: Mapping, p: Dict[str, torch.Tensor], tokens, labels,
         prec: Optional[Precision] = None, routes: Optional[dict] = None,
         stats: Optional[dict] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cross-entropy + load-balance loss, cross-entropy) of one batch.
    Each layer, and the head, is recomputed in the backward
    (``checkpoint``), so one layer's activations are held at a time.
    ``routes``: {layer: (T, K) experts} to follow (``experts``), which
    keeps the widest gap in ``stats``."""
    prec = prec or Precision()
    x = p["embed.tok"][tokens.long()]
    aux = torch.zeros((), device=x.device)
    for i in range(cfg["num_hidden_layers"]):
        x, a = checkpoint(
            lambda x_, i_=i: block(cfg, prec, p, i_, x_, routes, stats), x,
            use_reentrant=False)
        aux = aux + a
    xent = checkpoint(lambda x_: head_loss(cfg, prec, p, x_, labels), x,
                      use_reentrant=False)
    return xent + aux, xent
