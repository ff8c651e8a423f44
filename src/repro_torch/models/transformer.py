"""Decoder-only LM: the dense, moe, ssm (Mamba-2) and hybrid (zamba2)
families.

Port of the decoder-only families of ``repro/models/transformer.py``.  The
layer stack is a Python loop over an ``nn.ModuleList`` where the reference
scans over stacked parameters.  A moe block is a dense block whose MLP is
``models.moe`` (its load-balance loss summed into ``aux``).  The hybrid
family runs ``hybrid_attn_every`` Mamba-2 layers, then one dense block
whose parameters (``shared_attn``) are shared by every application, with
``num_layers % hybrid_attn_every`` Mamba-2 layers left after the last one;
each application keeps its own KV cache when decoding.  The vlm and encdec
families raise ``NotImplementedError`` naming the slice of ROADMAP.md
queue 1 that ports them (7b: cross-attention and the second input path).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import resolve_device
from repro_torch.core import sites
from repro_torch.core.sites import tag
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib

PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid")
_SLICE_7B = ("slice 7b of ROADMAP.md queue 1 (cross-attention, the second "
             "input path through Trainer and Server(memory=), the non-gated "
             "MLP, learned positions and the logit soft-cap)")


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: it comes with "
            f"{_SLICE_7B}; the port runs {PORTED_FAMILIES}")
    if cfg.family == "ssm":
        if (cfg.pos_embedding, cfg.tie_embeddings, cfg.logits_softcap) != (
                "none", True, 0.0):
            raise NotImplementedError(
                "the ssm port runs tied embeddings with no position "
                f"embedding and no logit soft-cap; other variants come with "
                f"{_SLICE_7B}")
    elif (cfg.glu, cfg.pos_embedding, cfg.logits_softcap) != (
            True, "rope", 0.0):
        raise NotImplementedError(
            f"the {cfg.family} port runs a gated MLP with RoPE and no logit "
            f"soft-cap; other variants come with {_SLICE_7B}")


# ===================================================================== init
class DenseBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator], device: torch.device):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.ln1 = L.Norm(cfg, device=device)
        self.attn = attn.Attention(cfg, **kw)
        self.ln2 = L.Norm(cfg, device=device)
        if cfg.family == "moe":
            self.moe = moe_lib.Moe(cfg, **kw)
        else:
            self.mlp = L.Mlp(cfg, **kw)


class SsmBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator], device: torch.device):
        super().__init__()
        self.ln = L.Norm(cfg, device=device)
        self.ssm = ssm_lib.Ssm(cfg, generator=generator, device=device)


class Model(nn.Module):
    """Parameters of a decoder; attribute names follow the reference's
    parameter pytree (``embed``, ``ln_f``, ``blocks``, and for the hybrid
    family ``shared_attn``)."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator], device: torch.device):
        super().__init__()
        check_family(cfg)
        kw = dict(generator=generator, device=device)
        self.embed = L.Embedding(cfg, **kw)
        self.ln_f = L.Norm(cfg, device=device)
        block = SsmBlock if cfg.family in ("ssm", "hybrid") else DenseBlock
        self.blocks = nn.ModuleList(
            [block(cfg, **kw) for _ in range(cfg.num_layers)])
        if cfg.family == "hybrid":
            self.shared_attn = DenseBlock(cfg, **kw)

    @property
    def device(self) -> torch.device:
        return self.embed.tok.device


def init_model(cfg: ModelConfig, *, seed: int = 0,
               device: Union[str, torch.device, None] = None) -> Model:
    """Random weights drawn on ``device`` (default ``cuda``) from a
    ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return Model(cfg, generator=gen, device=dev)


# ================================================================= blocks
def dense_block(cfg: ModelConfig, p: DenseBlock, x, positions, *,
                causal: bool = True, return_kv: bool = False):
    """Pre-norm transformer block; returns (x, aux), or (x, aux, (k, v))
    with ``return_kv``."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = tag(x, "ln_in")
    h = L.apply_norm(cfg, p.ln1, x)
    a = attn.self_attention(cfg, p.attn, h, positions, causal=causal,
                            return_kv=return_kv)
    a_out, kv = a if return_kv else (a, None)
    x = tag(x + a_out, "resid_mid")
    h = L.apply_norm(cfg, p.ln2, x)
    if hasattr(p, "moe"):
        out, aux = moe_lib.apply_moe_auto(cfg, p.moe, h)
    else:
        out = L.apply_mlp(cfg, p.mlp, h)
    x = tag(x + out, "resid_post")
    return (x, aux, kv) if return_kv else (x, aux)


def ssm_block(cfg: ModelConfig, p: SsmBlock, x, *, return_state: bool = False):
    """Pre-norm Mamba-2 block; returns x, or (x, (conv, ssd)) with
    ``return_state``."""
    x = tag(x, "ln_in")
    h = L.apply_norm(cfg, p.ln, x)
    out = ssm_lib.apply_ssm(cfg, p.ssm, h, return_state=return_state)
    out, st = out if return_state else (out, None)
    x = tag(x + out, "resid_post")
    return (x, st) if return_state else x


# ============================================================ full forward
def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None, :].expand(B, S)


def _forward(cfg: ModelConfig, model: Model, tokens, positions, causal: bool,
             kv_sink: Optional[List[Tuple[torch.Tensor, torch.Tensor]]]):
    """The layer stack.  ``kv_sink`` collects each layer's decode state:
    (k, v) for dense blocks, (conv, ssd) for ssm blocks."""
    check_family(cfg)
    x = L.embed_tokens(cfg, model.embed, tokens)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    every = cfg.hybrid_attn_every
    for i, blk in enumerate(model.blocks):
        with sites.layer(i):        # the layer a detailed profile records
            if cfg.family == "hybrid":
                if kv_sink is not None:
                    raise NotImplementedError(
                        "the hybrid family has no prefill: the reference "
                        "serves it by decode_step only")
                x = ssm_block(cfg, blk, x)
                if (i + 1) % every == 0:      # the shared block, after a segment
                    x, a = dense_block(cfg, model.shared_attn, x, positions,
                                       causal=causal)
                    aux_total = aux_total + a
                continue
            if cfg.family == "ssm":
                if kv_sink is None:
                    x = ssm_block(cfg, blk, x)
                else:
                    x, st = ssm_block(cfg, blk, x, return_state=True)
                    kv_sink.append(st)
                continue
            if kv_sink is None:
                x, a = dense_block(cfg, blk, x, positions, causal=causal)
            else:
                x, a, kv = dense_block(cfg, blk, x, positions, causal=causal,
                                       return_kv=True)
                kv_sink.append(kv)
        aux_total = aux_total + a
    x = L.apply_norm(cfg, model.ln_f, x)
    x = tag(x, "final_norm")
    return L.unembed(cfg, model.embed, x), aux_total


def forward(cfg: ModelConfig, model: Model, tokens, *, positions=None,
            causal: bool = True):
    """tokens (B,S) -> (logits (B,S,V), aux)."""
    B, S = tokens.shape
    if positions is None:
        positions = _positions(B, S, tokens.device)
    return _forward(cfg, model, tokens, positions, causal, None)


def loss_fn(cfg: ModelConfig, model: Model, batch):
    """Next-token loss of ``batch`` (``tokens``, ``labels``, optional
    ``mask``): (xent + aux, {"xent": xent, "aux": aux})."""
    logits, aux = forward(cfg, model, batch["tokens"])
    loss = L.cross_entropy(logits, batch["labels"], batch.get("mask"))
    return loss + aux, {"xent": loss, "aux": aux}


# ============================================================ decode paths
class DecodeState(NamedTuple):
    """Per-request generation state (stacked over layers where applicable).
    Fields a family does not use stay ``None``."""
    attn_k: Optional[torch.Tensor]    # (L_attn, B, Smax, Kh, D)
    attn_v: Optional[torch.Tensor]
    ssm_conv: Optional[torch.Tensor]  # (L_ssm, B, W-1, ch)
    ssm_ssd: Optional[torch.Tensor]   # (L_ssm, B, H, P, N)
    cross_k: Optional[torch.Tensor]   # (L_cross, B, T_mem, Kh, D)
    cross_v: Optional[torch.Tensor]
    pos: torch.Tensor                 # (B,) int64 next write index


def _n_attn_layers(cfg: ModelConfig) -> int:
    if cfg.family in ("dense", "moe"):
        return cfg.num_layers
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.hybrid_attn_every
    return 0


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      params: Optional[Model] = None, *,
                      device: Union[str, torch.device, None] = None
                      ) -> DecodeState:
    """Zeroed cache on ``params``' device when given, else on ``device``
    (default ``cuda``).  The ssm family keeps no KV cache: its state is the
    conv window (L,B,W-1,ch) in the activation dtype and the SSD state
    (L,B,H,P,N) in f32, whatever ``max_len``.  The hybrid family keeps both:
    a KV cache per application of its shared block, and every Mamba-2
    layer's state."""
    check_family(cfg)
    dev = params.device if params is not None else resolve_device(device)
    pos = torch.zeros((batch,), dtype=torch.int64, device=dev)
    k = v = conv = ssd = None
    n_attn = _n_attn_layers(cfg)
    if n_attn:
        cache = attn.init_kv_cache(cfg.replace(num_layers=n_attn), batch,
                                   max_len, device=dev)
        k, v = cache.k, cache.v
    if cfg.family in ("ssm", "hybrid"):
        st = ssm_lib.init_ssm_state(cfg, batch, device=dev)
        conv, ssd = st.conv, st.ssd
    return DecodeState(k, v, conv, ssd, None, None, pos)


def _dense_decode_block(cfg, p: DenseBlock, x, kv, positions):
    h = L.apply_norm(cfg, p.ln1, x)
    a_out, kv = attn.decode_self_attention(cfg, p.attn, h, kv, positions)
    x = x + a_out
    h = L.apply_norm(cfg, p.ln2, x)
    if hasattr(p, "moe"):
        out, _ = moe_lib.apply_moe(cfg, p.moe, h)
    else:
        out = L.apply_mlp(cfg, p.mlp, h)
    return x + out, kv


def _ssm_decode_block(cfg, p: SsmBlock, x, state):
    h = L.apply_norm(cfg, p.ln, x)
    out, state = ssm_lib.decode_ssm(cfg, p.ssm, h, state)
    return x + out, state


def decode_step(cfg: ModelConfig, model: Model, tokens, state: DecodeState):
    """tokens (B,1) -> (logits (B,1,V), new state).  The cache / SSM state
    tensors of ``state`` are updated in place; the returned state shares
    them."""
    check_family(cfg)
    positions = state.pos
    x = L.embed_tokens(cfg, model.embed, tokens)
    every = cfg.hybrid_attn_every
    for i, blk in enumerate(model.blocks):
        if cfg.family in ("ssm", "hybrid"):
            x, (conv, ssd) = _ssm_decode_block(
                cfg, blk, x, (state.ssm_conv[i], state.ssm_ssd[i]))
            state.ssm_conv[i] = conv
            state.ssm_ssd[i] = ssd
            if cfg.family == "hybrid" and (i + 1) % every == 0:
                a = (i + 1) // every - 1      # this application's cache
                x, _ = _dense_decode_block(cfg, model.shared_attn, x,
                                           (state.attn_k[a], state.attn_v[a]),
                                           positions)
            continue
        x, _ = _dense_decode_block(cfg, blk, x,
                                   (state.attn_k[i], state.attn_v[i]),
                                   positions)
    x = L.apply_norm(cfg, model.ln_f, x)
    logits = L.unembed(cfg, model.embed, x)
    return logits, state._replace(pos=state.pos + 1)


def prefill(cfg: ModelConfig, model: Model, tokens, max_len: int):
    """Run the full-sequence forward and build the decode state.

    The reference runs the layer stack a second time to re-project K/V or
    to rerun each SSM layer's scan for its final state; here each layer's
    rope'd K/V, or its conv window and the SSD scan's final state, are
    collected in the same pass, which gives the same state and logits."""
    B, S = tokens.shape
    if S > max_len:
        raise ValueError(f"prompt of {S} tokens exceeds max_len {max_len}")
    kvs: List[Tuple[torch.Tensor, torch.Tensor]] = []
    logits, _ = _forward(cfg, model, tokens, _positions(B, S, tokens.device),
                         True, kvs)
    state = init_decode_state(cfg, B, max_len, params=model)
    pos = torch.full((B,), S, dtype=torch.int64, device=tokens.device)
    if cfg.family == "ssm":
        for i, (conv, ssd) in enumerate(kvs):
            state.ssm_conv[i] = conv
            state.ssm_ssd[i] = ssd
        return logits, state._replace(pos=pos)
    for i, (k, v) in enumerate(kvs):
        state.attn_k[i, :, :S] = k.to(state.attn_k.dtype)
        state.attn_v[i, :, :S] = v.to(state.attn_v.dtype)
    return logits, state._replace(pos=pos)
