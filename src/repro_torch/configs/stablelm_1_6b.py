"""stablelm-2-1.6b [dense]: MHA, layernorm.
[hf:stabilityai/stablelm-2-1_6b; unverified]"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="dense",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=5632, vocab_size=100352, qkv_bias=False,
    norm="layernorm", act="silu", glu=True, rope_theta=1e4,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=4,
                          num_kv_heads=4, head_dim=16, d_ff=128,
                          vocab_size=256, dtype="float32",
                          param_dtype="float32")
