"""whisper-large-v3 [audio]: enc-dec, conv frontend stubbed.
[arXiv:2212.04356; unverified]"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="encdec",
    num_layers=32, encoder_layers=32, d_model=1280,
    num_heads=20, num_kv_heads=20, d_ff=5120, vocab_size=51866,
    qkv_bias=True, norm="layernorm", act="gelu", glu=False,
    pos_embedding="learned", max_position=1 << 16, encoder_seq=1500,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(num_layers=2, encoder_layers=2, d_model=64,
                          num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
                          vocab_size=256, encoder_seq=32, max_position=512,
                          dtype="float32", param_dtype="float32")
