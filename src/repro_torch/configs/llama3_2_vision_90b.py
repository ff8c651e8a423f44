"""llama-3.2-vision-90b [vlm]: cross-attn image layers every 5th layer;
patch-embedding frontend stubbed. [hf:meta-llama/Llama-3.2-11B-Vision;
unverified]"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    num_layers=100, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=28672, vocab_size=128256, qkv_bias=False,
    norm="rmsnorm", act="silu", glu=True, rope_theta=5e5,
    cross_attn_every=5, image_tokens=6404,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(num_layers=6, d_model=64, num_heads=4,
                          num_kv_heads=2, head_dim=16, d_ff=128,
                          vocab_size=256, cross_attn_every=3,
                          image_tokens=16, dtype="float32",
                          param_dtype="float32")
