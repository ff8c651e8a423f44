"""Weights made from ``--seed``, the same for the program and the reference.

Every leaf is named as the program's model names its parameter and laid
out as the published equations use it (``x @ w``: (in, out)).  Its values
are ``mean + std * z``, with ``z`` a slice of one flat bf16 tensor of
standard normals drawn on the device in chunks of ``CHUNK`` elements, each
chunk from its own ``torch.Generator`` seeded by (seed, chunk): a few large
calls, the same on every call with the same seed.  The values are rounded to
bf16, the type the parameters are trained in, so the reference's f32 copy
holds exactly the program's starting point.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Mapping, NamedTuple, Optional, Tuple

import torch

from portbench.yardstick import head_dim

CHUNK = 1 << 28
_MASK64 = (1 << 64) - 1


class Leaf(NamedTuple):
    name: str
    shape: Tuple[int, ...]
    mean: float
    std: float

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


def leaves(cfg: Mapping) -> List[Leaf]:
    """Every leaf of a decoder of the ``dense`` or ``moe`` family, in a
    fixed order.  Norm scales are 1 + 0.02 z, biases 0.02 z, the token
    embedding 0.02 z, every product's weight z / sqrt(fan_in)."""
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    hd = head_dim(cfg)
    q, kv = cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd

    def mat(name, fan_in, *shape):
        return Leaf(name, tuple(shape), 0.0, 1.0 / math.sqrt(fan_in))

    out = [Leaf("embed.tok", (V, d), 0.0, 0.02),
           mat("embed.unembed", d, d, V),
           Leaf("ln_f.scale", (d,), 1.0, 0.02)]
    for i in range(cfg["num_hidden_layers"]):
        b = f"blocks.{i}."
        out += [Leaf(b + "ln1.scale", (d,), 1.0, 0.02),
                mat(b + "attn.wq", d, d, q), mat(b + "attn.wk", d, d, kv),
                mat(b + "attn.wv", d, d, kv), mat(b + "attn.wo", q, q, d)]
        if cfg.get("qkv_bias"):
            out += [Leaf(b + "attn.bq", (q,), 0.0, 0.02),
                    Leaf(b + "attn.bk", (kv,), 0.0, 0.02),
                    Leaf(b + "attn.bv", (kv,), 0.0, 0.02)]
        out.append(Leaf(b + "ln2.scale", (d,), 1.0, 0.02))
        if cfg["family"] == "moe":
            E, f = cfg["num_experts"], cfg["moe_intermediate_size"]
            out += [mat(b + "moe.router", d, d, E),
                    mat(b + "moe.wi_gate", d, E, d, f),
                    mat(b + "moe.wi_up", d, E, d, f),
                    mat(b + "moe.wo", f, E, f, d)]
        else:
            f = cfg["intermediate_size"]
            out += [mat(b + "mlp.wi_gate", d, d, f),
                    mat(b + "mlp.wi_up", d, d, f),
                    mat(b + "mlp.wo", f, f, d)]
    return out


def _chunk_seed(seed: int, chunk: int) -> int:
    return ((seed & _MASK64) ^ ((chunk + 1) * 0x9E3779B97F4A7C15)) & _MASK64


def normals(seed: int, total: int, device: torch.device) -> torch.Tensor:
    """``total`` standard normals in bf16, drawn in chunks of ``CHUNK``."""
    flat = torch.empty(total, dtype=torch.bfloat16, device=device)
    for c, lo in enumerate(range(0, total, CHUNK)):
        gen = torch.Generator(device=device)
        gen.manual_seed(_chunk_seed(seed, c))
        n = min(CHUNK, total - lo)
        flat[lo:lo + n] = torch.randn(n, generator=gen, dtype=torch.bfloat16,
                                      device=device)
    return flat


def values(cfg: Mapping, seed: int, device: torch.device
           ) -> Iterator[Tuple[Leaf, torch.Tensor]]:
    """(leaf, its bf16 values) for every leaf, in ``leaves`` order.  The
    flat tensor of normals lives until the last leaf is taken."""
    specs = leaves(cfg)
    flat = normals(seed, sum(s.numel for s in specs), device)
    off = 0
    for s in specs:
        z = flat[off:off + s.numel].view(s.shape)
        off += s.numel
        yield s, (z.float() * s.std + s.mean).to(torch.bfloat16)


def load_into(model: torch.nn.Module,
              master: Optional[Dict[str, torch.Tensor]], cfg: Mapping,
              seed: int) -> None:
    """Copy the seed's weights into the program's parameters and into its
    f32 master copies (None where the parameters are f32); refuses a model
    whose leaves differ from ``leaves(cfg)`` by name or shape."""
    params = dict(model.named_parameters())
    specs = leaves(cfg)
    want = {s.name: s.shape for s in specs}
    got = {n: tuple(p.shape) for n, p in params.items()}
    if want != got:
        diff = sorted(set(want.items()) ^ set(got.items()))
        raise ValueError(f"the program's parameters differ from the "
                         f"configuration's leaves: {diff[:6]}")
    device = next(iter(params.values())).device
    with torch.no_grad():
        for s, v in values(cfg, seed, device):
            params[s.name].copy_(v)
            if master is not None:
                master[s.name].copy_(v.float())
