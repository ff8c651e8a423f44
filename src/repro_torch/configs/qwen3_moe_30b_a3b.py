"""qwen3-moe-30b-a3b [moe]: 128 experts top-8, GQA kv=4, head_dim 128.
[hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
    head_dim=128, d_ff=768, vocab_size=151936, qkv_bias=False,
    norm="rmsnorm", act="silu", glu=True, rope_theta=1e6,
    num_experts=128, experts_per_token=8, moe_d_ff=768,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=4,
                          num_kv_heads=2, head_dim=16, d_ff=64,
                          vocab_size=256, num_experts=8,
                          experts_per_token=2, moe_d_ff=64,
                          dtype="float32", param_dtype="float32")
