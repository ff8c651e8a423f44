"""The yardstick's counts against hand counts at small shapes."""
from __future__ import annotations

from portbench import yardstick as Y

# d 4, 2 query heads over 1 KV head of 2, d_ff 8, vocab 10, one layer
TINY = {"hidden_size": 4, "num_attention_heads": 2, "num_key_value_heads": 1,
        "head_dim": 2, "intermediate_size": 8, "vocab_size": 10,
        "num_hidden_layers": 1, "family": "dense", "qkv_bias": False}
TINY_MOE = {**TINY, "family": "moe", "num_experts": 4,
            "num_experts_per_tok": 2, "moe_intermediate_size": 3}


def test_causal_pairs():
    assert Y.causal_pairs(1, 3) == 1 + 2 + 3
    assert Y.causal_pairs(2, 4) == 2 * (1 + 2 + 3 + 4)


def test_train_step_flops_by_hand():
    # products a token: wq 4x4, wk 4x2, wv 4x2, wo 4x4, 3 x 4x8 MLP, 4x10 head
    per_token = 16 + 8 + 8 + 16 + 96 + 40
    # attention: 4 * head_dim flops a (query, key) pair and query head
    attn = 4 * 2 * 2 * (1 + 2 + 3)
    assert Y.train_step_flops(TINY, 1, 3) == 3 * (2 * per_token * 3 + attn)


def test_moe_counts_only_the_routed_experts():
    # router 4x4 and 2 of the experts' 3 x 4x3 products
    per_token = 16 + 8 + 8 + 16 + 4 * 4 + 2 * 3 * 4 * 3 + 40
    assert Y.matmul_params(TINY_MOE) == per_token


def test_k1_backward_flops_by_hand():
    # five products of 2 * head_dim flops a pair and query head
    assert Y.k1_bwd_flops(TINY, 2, 3) == 5 * 2 * 2 * 2 * (2 * 6)


def test_adamw_bytes_by_hand():
    # embedding and head 2 x 10 x 4, final norm 4, attention 48, MLP 96,
    # two norms 8
    n = 80 + 4 + 48 + 96 + 8
    assert Y.param_count(TINY) == n
    assert Y.adamw_bytes(TINY) == n * (4 + 8 + 8 + 8 + 2)


def test_peaks_are_the_data_sheet():
    assert Y.PEAK_BF16_FLOPS == 989e12 and Y.PEAK_HBM_BYTES_S == 3.35e12
