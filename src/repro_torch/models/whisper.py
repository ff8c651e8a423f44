"""Whisper-style encoder-decoder backbone (the encdec family).

Port of ``repro/models/whisper.py``.  The audio conv frontend is a stub, as
in the reference: the second input ``memory`` is precomputed frame
embeddings (B, S_enc, d).  The encoder adds its learned positions
(``enc_pos``) and runs non-causal self-attention blocks, then ``ln_enc``;
the decoder embeds tokens with learned positions and runs causal
self-attention blocks that each cross-attend into the encoder output
through their own projection of it (``dense_block(memory=)``), then
``ln_f``.  No RoPE anywhere (``pos_embedding == "learned"``).  A detailed
profile numbers the encoder's blocks 0..L_enc-1 and the decoder's
0..L-1, as the reference's two scans slice their residuals.

Decoding: ``init_decode_state(memory=, params=)`` encodes once and projects
every decoder block's cross K/V (``EncDecState.cross_k`` / ``cross_v``);
``decode_step`` appends one token to each block's self-attention cache.
The reference has no batched prefill for this family and serves it by
``decode_step`` alone; ``prefill`` here feeds the prompt through
``decode_step`` token by token.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
from torch import nn

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import resolve_device
from repro_torch.core import sites
from repro_torch.core.sites import tag
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.transformer import (DenseBlock, _dense_decode_block,
                                            _memory, _positions, cross_lens,
                                            dense_block, project_cross_state)


class Model(L.Unit):
    """Parameters of the encoder-decoder; attribute names follow the
    reference's pytree (``embed`` with ``pos``, ``enc_pos``, ``enc_blocks``,
    ``dec_blocks``, ``ln_enc``, ``ln_f``)."""
    AXES = {"enc_pos": ("pos", "embed")}

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator], device: torch.device):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"models.whisper is the encdec family, not "
                             f"{cfg.family!r}")
        kw = dict(generator=generator, device=device)
        self.embed = L.Embedding(cfg, **kw)
        self.enc_pos = L._normal((cfg.encoder_seq, cfg.d_model), 0.02, cfg,
                                 **kw)
        self.enc_blocks = nn.ModuleList(
            [DenseBlock(cfg, **kw) for _ in range(cfg.encoder_layers)])
        self.dec_blocks = nn.ModuleList(
            [DenseBlock(cfg, cross=True, **kw) for _ in range(cfg.num_layers)])
        self.ln_enc = L.Norm(cfg, device=device)
        self.ln_f = L.Norm(cfg, device=device)

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


def encode(cfg: ModelConfig, model: Model, frames) -> torch.Tensor:
    """frames (B, S_enc, d) stub embeddings -> encoder output (B, S_enc, d)."""
    B, S, _ = frames.shape
    x = tag(model(_frames_in, cfg, frames), "embed_out")
    pos = _positions(B, S, x.device)
    for i, blk in enumerate(model.enc_blocks):
        with sites.layer(i):
            x, _ = blk(dense_block, cfg, x, pos, causal=False)
    return model.ln_enc(L.apply_norm, cfg, x)


def _frames_in(cfg: ModelConfig, model: Model, frames) -> torch.Tensor:
    """The stub frames plus the encoder's learned positions."""
    S = frames.shape[1]
    return _memory(cfg, frames) + model.enc_pos[:S][None].to(
        L.torch_dtype(cfg.dtype))


def forward(cfg: ModelConfig, model: Model, tokens, *, memory=None,
            positions=None):
    """memory = precomputed frame embeddings (stub frontend).  Returns
    (logits (B,S,V), aux), aux 0."""
    enc = encode(cfg, model, memory)
    B, S = tokens.shape
    if positions is None:
        positions = _positions(B, S, tokens.device)
    x = model.embed(L.embed_tokens, cfg, tokens, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, blk in enumerate(model.dec_blocks):
        with sites.layer(i):
            x, a = blk(dense_block, cfg, x, positions, memory=enc)
        aux = aux + a
    x = model.ln_f(L.apply_norm, cfg, x)
    x = tag(x, "final_norm")
    return model.embed(L.unembed, cfg, x), aux


def loss_fn(cfg: ModelConfig, model: Model, batch):
    """Next-token loss of ``batch`` (``tokens``, ``labels``, ``memory``,
    optional ``mask``): (xent + aux, {"xent": xent, "aux": aux})."""
    logits, aux = forward(cfg, model, batch["tokens"],
                          memory=batch["memory"])
    loss = L.cross_entropy(logits, batch["labels"], batch.get("mask"))
    return loss + aux, {"xent": loss, "aux": aux}


class EncDecState(NamedTuple):
    attn_k: torch.Tensor    # (L, B, Smax, Kh, D) decoder self KV
    attn_v: torch.Tensor
    cross_k: torch.Tensor   # (L, B, S_enc, Kh, D) static
    cross_v: torch.Tensor
    pos: torch.Tensor       # (B,) int64 next write index


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      params: Optional[Model] = None, *, memory=None
                      ) -> EncDecState:
    """Encode ``memory`` once and project every decoder block's cross K/V
    over it; zeroed self-attention caches on ``params``' device."""
    if params is None or memory is None:
        raise ValueError("the encdec decode state encodes memory: pass "
                         "params= and memory=")
    with torch.no_grad():
        enc = encode(cfg, params, memory)
    ck, cv = project_cross_state(cfg, params.dec_blocks, enc)
    cache = attn.init_kv_cache(cfg, batch, max_len, device=params.device)
    pos = torch.zeros((batch,), dtype=torch.int64, device=params.device)
    return EncDecState(cache.k, cache.v, ck, cv, pos)


def decode_step(cfg: ModelConfig, model: Model, tokens, state: EncDecState):
    """tokens (B,1) -> (logits (B,1,V), new state); the self-attention
    caches are updated in place."""
    positions = state.pos
    x = model.embed(L.embed_tokens, cfg, tokens, positions[:, None])
    lens = cross_lens(state.cross_k)
    for i, blk in enumerate(model.dec_blocks):
        x, _ = blk(_dense_decode_block, cfg, x,
                   (state.attn_k[i], state.attn_v[i]), positions,
                   (state.cross_k[i], state.cross_v[i], lens))
    x = model.ln_f(L.apply_norm, cfg, x)
    logits = model.embed(L.unembed, cfg, x)
    return logits, state._replace(pos=state.pos + 1)


def prefill(cfg: ModelConfig, model: Model, tokens, max_len: int, *,
            memory=None):
    """The prompt (B,S) through ``decode_step`` token by token, as the
    reference serves this family: (logits (B,S,V), state at pos S)."""
    B, S = tokens.shape
    if S > max_len:
        raise ValueError(f"prompt of {S} tokens exceeds max_len {max_len}")
    state = init_decode_state(cfg, B, max_len, params=model, memory=memory)
    logits = []
    for t in range(S):
        lg, state = decode_step(cfg, model, tokens[:, t:t + 1], state)
        logits.append(lg)
    return torch.cat(logits, dim=1), state
