"""Decoder LM: the dense, moe, ssm (Mamba-2), hybrid (zamba2) and vlm
families.

Port of ``repro/models/transformer.py``.  The layer stack is a Python loop
over ``nn.ModuleList``s where the reference scans over stacked parameters.
A moe block is a dense block whose MLP is ``models.moe`` (its
load-balance loss summed into ``aux``).  The hybrid family runs
``hybrid_attn_every`` Mamba-2 layers, then one dense block whose
parameters (``shared_attn``) are shared by every application, with
``num_layers % hybrid_attn_every`` Mamba-2 layers left after the last one;
each application keeps its own KV cache when decoding.  The vlm family
(llama-3.2-vision) takes a second input, ``memory``: the image-patch
embeddings of a stubbed frontend (B, image_tokens, d).  Its stack runs, for
each of the ``num_layers // cross_attn_every`` cross blocks, ``every - 1``
self blocks and then the cross block (self-attention, then gated
cross-attention into ``memory``, ``x + tanh(xgate) * xa``), then the self
blocks left over (``_stack``).  Its self-attention caches keep the
reference's layout, which is not the execution order: the grouped self
blocks first, then the cross blocks, then the remainder.  The encdec
family (whisper) is ``models.whisper``.
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

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"family {cfg.family!r} is not a decoder family "
                         f"{FAMILIES}; encdec is models.whisper")


# ===================================================================== init
class DenseBlock(L.Unit):
    """Pre-norm block: ``ln1``, ``attn``, ``ln2`` and ``mlp`` (``moe`` for
    the moe family); a cross block adds ``lnx``, ``xattn`` and ``xgate``,
    an f32 scalar whatever the parameter dtype, zero at init as in the
    reference, so ``tanh(xgate)`` starts the cross-attention shut."""
    AXES = {"xgate": ()}

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator], device: torch.device,
                 cross: bool = False):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.ln1 = L.Norm(cfg, device=device)
        self.attn = attn.Attention(cfg, **kw)
        if cross:
            self.lnx = L.Norm(cfg, device=device)
            self.xattn = attn.Attention(cfg, **kw)
            self.xgate = nn.Parameter(torch.zeros((), dtype=torch.float32,
                                                  device=device))
        self.ln2 = L.Norm(cfg, device=device)
        if cfg.family == "moe" and not cross:
            self.moe = moe_lib.Moe(cfg, **kw)
        else:
            self.mlp = L.Mlp(cfg, **kw)


class SsmBlock(L.Unit):
    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator], device: torch.device):
        super().__init__()
        self.ln = L.Norm(cfg, device=device)
        self.ssm = ssm_lib.Ssm(cfg, generator=generator, device=device)


def _vlm_sizes(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(cross blocks, self blocks, self blocks before each cross block)."""
    n_cross = cfg.num_layers // cfg.cross_attn_every
    return n_cross, cfg.num_layers - n_cross, cfg.cross_attn_every - 1


class Model(nn.Module):
    """Parameters of a decoder; attribute names follow the reference's
    parameter pytree (``embed``, ``ln_f``, ``blocks``, and for the hybrid
    family ``shared_attn``, for the vlm family ``cross_blocks``)."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator], device: torch.device):
        super().__init__()
        check_family(cfg)
        kw = dict(generator=generator, device=device)
        self.embed = L.Embedding(cfg, **kw)
        self.ln_f = L.Norm(cfg, device=device)
        block = SsmBlock if cfg.family in ("ssm", "hybrid") else DenseBlock
        n_self = cfg.num_layers
        if cfg.family == "vlm":
            n_cross, n_self, _ = _vlm_sizes(cfg)
        self.blocks = nn.ModuleList([block(cfg, **kw) for _ in range(n_self)])
        if cfg.family == "hybrid":
            self.shared_attn = DenseBlock(cfg, **kw)
        if cfg.family == "vlm":
            self.cross_blocks = nn.ModuleList(
                [DenseBlock(cfg, cross=True, **kw) for _ in range(n_cross)])

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


def _stack(cfg: ModelConfig, model: Model
           ) -> List[Tuple[DenseBlock, int, Optional[int]]]:
    """The dense and vlm stacks in execution order: (block, its
    self-attention cache index, its cross index or None)."""
    if cfg.family != "vlm":
        return [(blk, i, None) for i, blk in enumerate(model.blocks)]
    n_cross, n_self, inner = _vlm_sizes(cfg)
    grouped = n_cross * inner
    order = []
    for g in range(n_cross):
        order += [(model.blocks[j], j, None)
                  for j in range(g * inner, (g + 1) * inner)]
        order.append((model.cross_blocks[g], grouped + g, g))
    order += [(model.blocks[j], j + n_cross, None)
              for j in range(grouped, n_self)]
    return order


# ================================================================= blocks
def _cross(cfg: ModelConfig, p: DenseBlock, x, cross_kv, mem_lens=None):
    """x + tanh(xgate) * cross-attention(lnx(x)) (the gate in f32, cast to
    the activations' dtype as the reference does)."""
    h = L.apply_norm(cfg, p.lnx, x)
    xa = attn.cross_attention(cfg, p.xattn, h, cross_kv, mem_lens=mem_lens)
    return x + torch.tanh(p.xgate).to(x.dtype) * xa


def dense_block(cfg: ModelConfig, p: DenseBlock, x, positions, *,
                causal: bool = True, return_kv: bool = False,
                cross_kv=None, memory=None):
    """Pre-norm transformer block; returns (x, aux), or (x, aux, (k, v))
    with ``return_kv``.  ``cross_kv`` (k, v) of a cross block adds its
    gated cross-attention after the self-attention; ``memory`` instead
    has the block project them from the encoder output or the image
    embeddings first."""
    if memory is not None:
        cross_kv = attn.project_cross_kv(cfg, p.xattn, memory)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = tag(x, "ln_in")
    h = L.apply_norm(cfg, p.ln1, x)
    a = attn.self_attention(cfg, p.attn, h, positions, causal=causal,
                            return_kv=return_kv)
    a_out, kv = a if return_kv else (a, None)
    x = tag(x + a_out, "resid_mid")
    if cross_kv is not None:
        x = _cross(cfg, p, x, cross_kv)
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


def _memory(cfg: ModelConfig, memory) -> torch.Tensor:
    if memory is None:
        raise ValueError(f"the {cfg.family} family needs its second input "
                         "`memory` (the stub frontend's embeddings)")
    return memory.to(L.torch_dtype(cfg.dtype))


def _forward(cfg: ModelConfig, model: Model, tokens, positions, causal: bool,
             kv_sink: Optional[List[Tuple[torch.Tensor, torch.Tensor]]],
             memory=None):
    """The layer stack.  ``kv_sink`` collects each layer's decode state in
    execution order: (k, v) for dense blocks, (conv, ssd) for ssm blocks."""
    check_family(cfg)
    x = model.embed(L.embed_tokens, cfg, tokens, positions)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family in ("ssm", "hybrid"):
        every = cfg.hybrid_attn_every
        for i, blk in enumerate(model.blocks):
            with sites.layer(i):    # the layer a detailed profile records
                if cfg.family == "hybrid":
                    if kv_sink is not None:
                        raise NotImplementedError(
                            "the hybrid family has no prefill: the "
                            "reference serves it by decode_step only")
                    x = blk(ssm_block, cfg, x)
                    if (i + 1) % every == 0:  # the shared block, after a segment
                        x, a = model.shared_attn(dense_block, cfg, x,
                                                 positions, causal=causal)
                        aux_total = aux_total + a
                elif kv_sink is None:
                    x = blk(ssm_block, cfg, x)
                else:
                    x, st = blk(ssm_block, cfg, x, return_state=True)
                    kv_sink.append(st)
    else:
        if cfg.family == "vlm":
            memory = _memory(cfg, memory)
        for i, (blk, _, g) in enumerate(_stack(cfg, model)):
            with sites.layer(i):
                out = blk(dense_block, cfg, x, positions, causal=causal,
                          return_kv=kv_sink is not None,
                          memory=None if g is None else memory)
            x, a = out[:2]
            if kv_sink is not None:
                kv_sink.append(out[2])
            aux_total = aux_total + a
    x = model.ln_f(L.apply_norm, cfg, x)
    x = tag(x, "final_norm")
    return model.embed(L.unembed, cfg, x), aux_total


def forward(cfg: ModelConfig, model: Model, tokens, *, positions=None,
            memory=None, causal: bool = True):
    """tokens (B,S) -> (logits (B,S,V), aux).  ``memory`` is the vlm
    family's image-patch embeddings (B,T_img,d)."""
    B, S = tokens.shape
    if positions is None:
        positions = _positions(B, S, tokens.device)
    return _forward(cfg, model, tokens, positions, causal, None, memory)


def loss_fn(cfg: ModelConfig, model: Model, batch):
    """Next-token loss of ``batch`` (``tokens``, ``labels``, optional
    ``mask``, and ``memory`` for vlm): (xent + aux, {"xent": xent,
    "aux": aux})."""
    logits, aux = forward(cfg, model, batch["tokens"],
                          memory=batch.get("memory"))
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
    if cfg.family in ("dense", "moe", "vlm"):
        return cfg.num_layers     # vlm: self-attention in every layer
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.hybrid_attn_every
    return 0


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      params: Optional[Model] = None, *, memory=None,
                      device: Union[str, torch.device, None] = None
                      ) -> DecodeState:
    """Zeroed cache on ``params``' device when given, else on ``device``
    (default ``cuda``).  The ssm family keeps no KV cache: its state is the
    conv window (L,B,W-1,ch) in the activation dtype and the SSD state
    (L,B,H,P,N) in f32, whatever ``max_len``.  The hybrid family keeps both:
    a KV cache per application of its shared block, and every Mamba-2
    layer's state.  The vlm family needs ``params`` and ``memory``: every
    cross block's K/V over ``memory`` is projected here, once, into
    ``cross_k`` / ``cross_v``, each layer's (B,T_mem,Kh,D) contiguous."""
    check_family(cfg)
    dev = params.device if params is not None else resolve_device(device)
    pos = torch.zeros((batch,), dtype=torch.int64, device=dev)
    k = v = conv = ssd = ck = cv = None
    n_attn = _n_attn_layers(cfg)
    if n_attn:
        cache = attn.init_kv_cache(cfg.replace(num_layers=n_attn), batch,
                                   max_len, device=dev)
        k, v = cache.k, cache.v
    if cfg.family in ("ssm", "hybrid"):
        st = ssm_lib.init_ssm_state(cfg, batch, device=dev)
        conv, ssd = st.conv, st.ssd
    if cfg.family == "vlm":
        if params is None:
            raise ValueError("the vlm decode state projects the cross K/V: "
                             "pass params= and memory=")
        ck, cv = project_cross_state(cfg, params.cross_blocks,
                                     _memory(cfg, memory))
    return DecodeState(k, v, conv, ssd, ck, cv, pos)


@torch.no_grad()
def project_cross_state(cfg: ModelConfig, blocks, memory
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every cross block's K/V over ``memory``, stacked: (L_cross, B,
    T_mem, Kh, D) each, in the activation dtype."""
    kvs = [blk(_cross_kv, cfg, memory) for blk in blocks]
    dt = L.torch_dtype(cfg.dtype)
    return (torch.stack([k for k, _ in kvs]).to(dt),
            torch.stack([v for _, v in kvs]).to(dt))


def _cross_kv(cfg: ModelConfig, p: DenseBlock, memory):
    return attn.project_cross_kv(cfg, p.xattn, memory)


def cross_lens(cross_k: torch.Tensor) -> torch.Tensor:
    """(B,) int32, each the memory's length: what the decode step's
    cross-attention passes to the flash-decode kernel."""
    _, B, T = cross_k.shape[:3]
    return torch.full((B,), T, dtype=torch.int32, device=cross_k.device)


def _dense_decode_block(cfg, p: DenseBlock, x, kv, positions, cross=None):
    """One token through a dense block; ``cross`` is (k, v, mem_lens) of a
    cross block."""
    h = L.apply_norm(cfg, p.ln1, x)
    a_out, kv = attn.decode_self_attention(cfg, p.attn, h, kv, positions)
    x = x + a_out
    if cross is not None:
        x = _cross(cfg, p, x, cross[:2], cross[2])
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
    x = model.embed(L.embed_tokens, cfg, tokens, positions[:, None])
    if cfg.family in ("ssm", "hybrid"):
        every = cfg.hybrid_attn_every
        for i, blk in enumerate(model.blocks):
            x, (conv, ssd) = blk(_ssm_decode_block, cfg, x,
                                 (state.ssm_conv[i], state.ssm_ssd[i]))
            state.ssm_conv[i] = conv
            state.ssm_ssd[i] = ssd
            if cfg.family == "hybrid" and (i + 1) % every == 0:
                a = (i + 1) // every - 1      # this application's cache
                x, _ = model.shared_attn(_dense_decode_block, cfg, x,
                                         (state.attn_k[a], state.attn_v[a]),
                                         positions)
    else:
        lens = None if state.cross_k is None else cross_lens(state.cross_k)
        for blk, c, g in _stack(cfg, model):
            cross = (None if g is None else
                     (state.cross_k[g], state.cross_v[g], lens))
            x, _ = blk(_dense_decode_block, cfg, x,
                       (state.attn_k[c], state.attn_v[c]), positions, cross)
    x = model.ln_f(L.apply_norm, cfg, x)
    logits = model.embed(L.unembed, cfg, x)
    return logits, state._replace(pos=state.pos + 1)


def prefill(cfg: ModelConfig, model: Model, tokens, max_len: int, *,
            memory=None):
    """Run the full-sequence forward and build the decode state.

    The reference runs the layer stack a second time to re-project K/V or
    to rerun each SSM layer's scan for its final state; here each layer's
    rope'd K/V, or its conv window and the SSD scan's final state, are
    collected in the same pass, which gives the same state and logits.
    The vlm family's cache is filled at every layer's cache index (F6: the
    reference's ``prefill`` leaves it zero for vlm, so its decode after a
    prefill attends to zeros over the prompt)."""
    B, S = tokens.shape
    if S > max_len:
        raise ValueError(f"prompt of {S} tokens exceeds max_len {max_len}")
    kvs: List[Tuple[torch.Tensor, torch.Tensor]] = []
    logits, _ = _forward(cfg, model, tokens, _positions(B, S, tokens.device),
                         True, kvs, memory)
    state = init_decode_state(cfg, B, max_len, params=model, memory=memory)
    pos = torch.full((B,), S, dtype=torch.int64, device=tokens.device)
    if cfg.family == "ssm":
        for i, (conv, ssd) in enumerate(kvs):
            state.ssm_conv[i] = conv
            state.ssm_ssd[i] = ssd
        return logits, state._replace(pos=pos)
    for (_, c, _), (k, v) in zip(_stack(cfg, model), kvs):
        attn.fill_cache(cfg, state.attn_k[c], state.attn_v[c], k, v)
    return logits, state._replace(pos=pos)
