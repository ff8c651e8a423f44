"""zamba2-1.2b [hybrid]: Mamba2 backbone + shared attention block.
[arXiv:2411.15242; hf]"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_conv_width=4,
    hybrid_attn_every=6, norm="rmsnorm", act="gelu", glu=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(num_layers=5, d_model=64, num_heads=4,
                          num_kv_heads=4, head_dim=16, d_ff=128,
                          vocab_size=256, ssm_state=16, ssm_head_dim=16,
                          ssm_chunk=32, hybrid_attn_every=2,
                          dtype="float32", param_dtype="float32")
