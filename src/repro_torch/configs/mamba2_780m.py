"""mamba2-780m [ssm]: SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv_width=4,
    norm="rmsnorm", tie_embeddings=True, pos_embedding="none",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=64, vocab_size=256,
                          ssm_state=16, ssm_head_dim=16, ssm_chunk=32,
                          dtype="float32", param_dtype="float32")
