"""Shared building blocks: init, norms, RoPE, MLP, embeddings.

Port of ``repro/models/layers.py``.  Parameters live in ``nn.Module``s
whose attribute names are the reference's dict keys (``scale``, ``wi_up``,
``tok`` ...), and weights keep the reference's ``(in, out)`` layout, so
``x @ w`` here is the reference's ``einsum("bsd,df->bsf", x, w)`` and
``models.convert`` copies a reference pytree leaf for leaf.  Each module
declares its parameters' logical axes in ``AXES`` (what the reference's
init returns beside the pytree; ``distributed.steps.param_axes``), and
the activations carry the reference's ``sharding.constrain`` marks.  Each module
draws its weights from the ``torch.Generator`` it is given, on the target
device; with no generator it allocates them uninitialised, to be filled by
``models.convert.params_from_reference``.  The MLP is gated, with SiLU or
GELU (``_act``: the reference's ``jax.nn.gelu`` is the tanh approximation
by default, so ``F.gelu(approximate="tanh")``).  The non-gated MLP,
learned positions and the logit soft-cap come with the encoder-decoder and
VLM families (``transformer.check_family`` refuses them until then).

The modules the model code runs as a whole (``Norm``, ``Embedding``, the
blocks, whisper's root) are ``Unit``s: the code calls ``unit(fn, cfg,
...)``, which runs ``fn(cfg, unit, ...)`` through ``nn.Module.__call__``,
so hooks on the module bracket every use of its weights
(``distributed.steps`` gathers weights sharded at rest that way).  Under a
plan that splits the vocabulary over the model dim (``vocab``), each rank
holds its rows of ``tok`` and the matching columns of ``unembed``: the
embedding looks up its own rows and sums over the model group, the
unembedding gives this rank's logits, and ``cross_entropy`` is the
vocab-parallel loss over them.
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

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _param_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.param_dtype)


def dense_init(in_dim: int, out_dim: int, cfg: ModelConfig, *,
               generator: Optional[torch.Generator],
               device: torch.device) -> nn.Parameter:
    """``N(0, 1) / sqrt(in_dim)`` of shape ``(in_dim, out_dim)``, drawn in
    f32 on ``device`` and cast to the parameter dtype (empty where a model
    rank holds none of ``in_dim``)."""
    return _normal((in_dim, out_dim), 1.0 / math.sqrt(max(in_dim, 1)), cfg,
                   generator=generator, device=device)


def _normal(shape, std: float, cfg: ModelConfig, *,
            generator: Optional[torch.Generator],
            device: torch.device) -> nn.Parameter:
    if generator is None:
        t = torch.empty(shape, dtype=_param_dtype(cfg), device=device)
    else:
        t = (torch.randn(shape, generator=generator, device=device,
                         dtype=torch.float32) * std).to(_param_dtype(cfg))
    return nn.Parameter(t)


def _const(shape, value: float, cfg: ModelConfig,
           device: torch.device) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, value, dtype=_param_dtype(cfg),
                                   device=device))


class Unit(nn.Module):
    """A module whose weights the model code uses through one call:
    ``unit(fn, cfg, *args)`` is ``fn(cfg, unit, *args)`` run by
    ``nn.Module.__call__`` (so its forward hooks fire around it)."""

    def forward(self, fn, cfg, *args, **kw):
        return fn(cfg, self, *args, **kw)


# ----------------------------------------------------------------- norms
class Norm(Unit):
    AXES = {"scale": ("embed",), "bias": ("embed",)}

    def __init__(self, cfg: ModelConfig, *, device: torch.device):
        super().__init__()
        self.scale = _const((cfg.d_model,), 1.0, cfg, device)
        if cfg.norm != "rmsnorm":
            self.bias = _const((cfg.d_model,), 0.0, cfg, device)


def apply_norm(cfg: ModelConfig, p: Norm, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + 1e-6)
        return (y * p.scale.float()).to(x.dtype)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mean) ** 2, dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + 1e-5)
    return (y * p.scale.float() + p.bias.float()).to(x.dtype)


# ------------------------------------------------------------------ RoPE
def rope_frequencies(cfg: ModelConfig, positions: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) -> cos/sin of shape (..., S, head_dim/2), f32."""
    half = cfg.head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    inv = 1.0 / (cfg.rope_theta ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, hd); cos/sin (..., S, hd/2). Rotate-half convention."""
    half = x.shape[-1] // 2
    c = cos[..., None, :].float()
    s = sin[..., None, :].float()
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1f * c - x2f * s, x2f * c + x1f * s],
                     dim=-1).to(x.dtype)


# ------------------------------------------------------------------- MLP
class Mlp(nn.Module):
    AXES = {"wi_gate": ("embed", "mlp"), "wi_up": ("embed", "mlp"),
            "wo": ("mlp", "embed")}

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator], device: torch.device):
        super().__init__()
        kw = dict(generator=generator, device=device)
        if cfg.glu:
            self.wi_gate = dense_init(cfg.d_model, cfg.d_ff, cfg, **kw)
        self.wi_up = dense_init(cfg.d_model, cfg.d_ff, cfg, **kw)
        self.wo = dense_init(cfg.d_ff, cfg.d_model, cfg, **kw)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _act(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return F.silu(x) if cfg.act == "silu" else _gelu(x)


def _glu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def _gelu_glu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return _gelu(gate) * up


def apply_mlp(cfg: ModelConfig, p: Mlp, x: torch.Tensor) -> torch.Tensor:
    """Gated MLP ``act(x Wg) * (x Wu)``, or ``act(x Wu)`` without ``glu``:
    x (B, S, d) -> (B, S, d).  ``ffn_act`` carries its recompute recipe: an
    applied policy that remats it rebuilds it from ``gate`` and ``up`` (or
    ``up`` alone) in the backward (``core.executor``)."""
    x = shd.tp_enter(x, "mlp")
    up = tag(x @ p.wi_up, "ffn_pre")
    if cfg.glu:
        gate = tag(x @ p.wi_gate, "ffn_pre")
        fn, args = (_glu if cfg.act == "silu" else _gelu_glu), (gate, up)
    else:
        fn, args = (F.silu if cfg.act == "silu" else _gelu), (up,)
    h = shd.constrain(fn(*args), ("batch", "seq", "act_mlp"))
    h = tag(h, "ffn_act", recompute=(fn, args))
    out = shd.tp_exit(h @ p.wo, "mlp")
    out = shd.constrain(out, ("batch", "seq", "act_embed"))
    return tag(out, "ffn_out")


# ------------------------------------------------------------- embedding
class Embedding(Unit):
    AXES = {"tok": ("vocab", "embed"), "unembed": ("embed", "vocab"),
            "pos": ("pos", "embed")}

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator], device: torch.device):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.tok = _normal((cfg.vocab_size, cfg.d_model), 0.02, cfg, **kw)
        if not cfg.tie_embeddings:
            self.unembed = dense_init(cfg.d_model, cfg.vocab_size, cfg, **kw)
        if cfg.pos_embedding == "learned":
            self.pos = _normal((cfg.max_position, cfg.d_model), 0.02, cfg,
                               **kw)


def embed_tokens(cfg: ModelConfig, p: Embedding, tokens: torch.Tensor,
                 positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings in the activation dtype, plus the learned position
    embeddings at ``positions`` (the shape of ``tokens``) when the config
    learns them."""
    group = shd.tp_group("vocab")
    if group is None:
        x = p.tok[tokens].to(torch_dtype(cfg.dtype))
    else:                   # this rank's rows; the others' tokens give 0
        V = p.tok.shape[0]
        local = tokens - shd.tp_rank("vocab") * V
        own = (local >= 0) & (local < V)
        rows = p.tok[torch.where(own, local, 0)].to(torch_dtype(cfg.dtype))
        x = shd.exit(torch.where(own[..., None], rows, 0), group)
    if cfg.pos_embedding == "learned":
        if positions is None:
            raise ValueError("learned position embeddings need positions")
        x = x + p.pos[positions].to(x.dtype)
    x = shd.constrain(x, ("batch", "seq", "act_embed"))
    return tag(x, "embed_out")


def unembed(cfg: ModelConfig, p: Embedding, x: torch.Tensor) -> torch.Tensor:
    """Logits (B,S,V), or this rank's (B,S,V/tp) under a ``vocab`` plan."""
    x = shd.tp_enter(x, "vocab")
    w = p.tok.T if cfg.tie_embeddings else p.unembed
    logits = x @ w.to(x.dtype)
    logits = shd.constrain(logits, ("batch", "seq", "act_vocab"))
    if cfg.logits_softcap:
        logits = cfg.logits_softcap * torch.tanh(logits / cfg.logits_softcap)
    return logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stable softmax cross-entropy in f32; logits (B,S,V), labels (B,S);
    the mean over tokens, or over the tokens where ``mask`` is 1.  Under a
    ``vocab`` plan ``logits`` are this rank's columns (``unembed``) and the
    loss is vocab-parallel (``_vocab_parallel``)."""
    lf = logits.float()
    group = shd.tp_group("vocab")
    if group is None:
        lse = torch.logsumexp(lf, dim=-1)
        picked = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    else:
        lse, picked = _vocab_parallel(lf, labels.long(), group)
    nll = lse - picked
    if mask is not None:
        mask = mask.to(nll.dtype)
        nll = nll * mask
        return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def _vocab_parallel(lf: torch.Tensor, labels: torch.Tensor, group):
    """(log-sum-exp, the label's logit) over the whole vocabulary from this
    rank's f32 logit columns: the row max over the model group (no
    gradient), the sum of exp and the owner's label logit summed over it
    (forward; the backward of both sums is the identity, so each rank's
    gradient is its softmax columns less its part of the one-hot)."""
    V = lf.shape[-1]
    mx = shd.all_max(lf.amax(dim=-1), group)
    lse = mx + torch.log(shd.exit(torch.exp(lf - mx[..., None]).sum(-1),
                                  group))
    local = labels - shd.tp_rank("vocab") * V
    own = (local >= 0) & (local < V)
    picked = torch.gather(lf, -1, torch.where(own, local, 0)[..., None])
    return lse, shd.exit(torch.where(own, picked[..., 0], 0.0), group)
