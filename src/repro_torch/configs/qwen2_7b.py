"""qwen2-7b [dense]: GQA kv=4, QKV bias. [arXiv:2407.10671; hf]"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b", family="dense",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18944, vocab_size=152064, qkv_bias=True,
    norm="rmsnorm", act="silu", glu=True, rope_theta=1e6,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=4,
                          num_kv_heads=2, head_dim=16, d_ff=160,
                          vocab_size=256, dtype="float32",
                          param_dtype="float32")
