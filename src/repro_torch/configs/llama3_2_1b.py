"""llama3.2-1b [dense]: small llama3, GQA kv=8, tied embeddings.
[hf:meta-llama/Llama-3.2-1B; unverified]"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b", family="dense",
    num_layers=16, d_model=2048, num_heads=32, num_kv_heads=8,
    d_ff=8192, vocab_size=128256, qkv_bias=False,
    norm="rmsnorm", act="silu", glu=True, rope_theta=5e5,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=4,
                          num_kv_heads=2, head_dim=16, d_ff=128,
                          vocab_size=256, dtype="float32",
                          param_dtype="float32")
