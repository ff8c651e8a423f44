"""The paper's own evaluation model: Llama2 (32L, d=4096, ffn=11008) —
used by the faithful-reproduction benchmarks (Tables 1-4, Figs 4-8)."""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="llama2-paper", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=11008, vocab_size=32000, qkv_bias=False,
    norm="rmsnorm", act="silu", glu=True, rope_theta=1e4,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(num_layers=4, d_model=128, num_heads=4,
                          num_kv_heads=4, head_dim=32, d_ff=344,
                          vocab_size=512, dtype="float32",
                          param_dtype="float32")
