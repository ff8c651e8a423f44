"""The benchmark's own arithmetic: the H100's peaks, the model flops of a
training step, K1 backward's operations and AdamW's bytes.

Each count is worked out from a configuration file's published keys
(``portbench/configs/<name>.json``) and a step's shapes, never read from
the program, so a change to the program cannot change what it is held to.
"""
from __future__ import annotations

from typing import Mapping

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12


def head_dim(cfg: Mapping) -> int:
    return int(cfg.get("head_dim") or cfg["hidden_size"]
               // cfg["num_attention_heads"])


def causal_pairs(batch: int, seq: int) -> int:
    """(query, key) pairs a causal attention over ``batch`` rows of
    ``seq`` tokens computes: each query sees itself and the keys before."""
    return batch * seq * (seq + 1) // 2


def matmul_params(cfg: Mapping) -> int:
    """Weights a token multiplies by in one forward pass (the embedding's
    lookup is no product; the output head is): for an expert layer the
    router and the experts it is routed to."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    hd = head_dim(cfg)
    q, kv = cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd
    attn = d * q + 2 * d * kv + q * d
    if cfg["family"] == "moe":
        E, K = cfg["num_experts"], cfg["num_experts_per_tok"]
        mlp = d * E + K * 3 * d * cfg["moe_intermediate_size"]
    else:
        mlp = 3 * d * cfg["intermediate_size"]
    return L * (attn + mlp) + d * cfg["vocab_size"]


def attention_fwd_flops(cfg: Mapping, batch: int, seq: int) -> float:
    """QK^T and PV of every layer: 4 x head_dim flops a causal pair and
    query head."""
    return (4.0 * cfg["num_attention_heads"] * head_dim(cfg)
            * causal_pairs(batch, seq) * cfg["num_hidden_layers"])


def train_step_flops(cfg: Mapping, batch: int, seq: int) -> float:
    """Model flops of one training step: forward and backward (three
    times the forward's products), no recomputation counted."""
    tokens = batch * seq
    return 3.0 * (2.0 * matmul_params(cfg) * tokens
                  + attention_fwd_flops(cfg, batch, seq))


def k1_bwd_flops(cfg: Mapping, batch: int, seq: int) -> float:
    """K1 backward's work in one step, every layer: five products (S, dP,
    dV, dK, dQ) of 2 x head_dim flops a causal pair and query head."""
    return (10.0 * cfg["num_attention_heads"] * head_dim(cfg)
            * causal_pairs(batch, seq) * cfg["num_hidden_layers"])


# AdamW with an f32 master (bf16 parameters): per parameter the update
# reads the f32 gradient (4 B), reads and writes m, v and the master
# (3 x 8 B) and writes the bf16 parameter (2 B)
ADAMW_BYTES_PER_PARAM = 4 + 3 * 8 + 2


def param_count(cfg: Mapping) -> int:
    """Every parameter of the configuration as run."""
    d, L, V = cfg["hidden_size"], cfg["num_hidden_layers"], cfg["vocab_size"]
    hd = head_dim(cfg)
    q, kv = cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd
    attn = d * q + 2 * d * kv + q * d
    if cfg.get("qkv_bias"):
        attn += q + 2 * kv
    if cfg["family"] == "moe":
        mlp = (d * cfg["num_experts"]
               + cfg["num_experts"] * 3 * d * cfg["moe_intermediate_size"])
    else:
        mlp = 3 * d * cfg["intermediate_size"]
    emb = V * d * (1 if cfg.get("tie_word_embeddings") else 2)
    return emb + d + L * (attn + mlp + 2 * d)


def adamw_bytes(cfg: Mapping) -> float:
    """The least bytes one AdamW update moves over HBM."""
    return float(ADAMW_BYTES_PER_PARAM * param_count(cfg))
