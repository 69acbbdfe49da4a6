"""whisper-base [audio]: 6L enc + 6L dec; conv frontend STUB (precomputed
frame embeddings (B, 1500, 512)). [arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig, TrainConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    n_layers=6, encoder_layers=6, encoder_len=1500,
    d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
    vocab_size=51865, mlp_type="gelu")

TRAIN = TrainConfig(optimizer="adam", microbatch=8, replicate_params=True)

SMOKE = ModelConfig(
    name="whisper-smoke", family="encdec",
    n_layers=2, encoder_layers=2, encoder_len=8,
    d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=97, mlp_type="gelu", attn_chunk=16, dtype="float32")
