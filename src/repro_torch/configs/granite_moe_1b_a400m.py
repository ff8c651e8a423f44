"""granite-moe-1b-a400m [moe]: 32 experts top-8, GQA kv=8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
    d_ff=512, vocab_size=49155, qkv_bias=False,
    norm="rmsnorm", act="silu", glu=True, rope_theta=1e4,
    num_experts=32, experts_per_token=8, moe_d_ff=512,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=4,
                          num_kv_heads=2, head_dim=16, d_ff=64,
                          vocab_size=256, num_experts=8,
                          experts_per_token=2, moe_d_ff=64,
                          dtype="float32", param_dtype="float32")
