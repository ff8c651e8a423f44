"""qwen1.5-0.5b [dense]: QKV bias, MHA. [hf:Qwen/Qwen1.5-0.5B; hf]"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", family="dense",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=2816, vocab_size=151936, qkv_bias=True,
    norm="rmsnorm", act="silu", glu=True, rope_theta=1e6,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=4,
                          num_kv_heads=4, head_dim=16, d_ff=128,
                          vocab_size=256, dtype="float32",
                          param_dtype="float32")
