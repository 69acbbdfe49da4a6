"""mamba2-130m [ssm]: pure SSD (state-space duality), attention-free.
All four shapes incl. long_500k run. [arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig, TrainConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=12, n_kv_heads=12, d_ff=0,
    vocab_size=50280, ssm_state=128, expand=2, head_p=64)

TRAIN = TrainConfig(optimizer="adam", microbatch=4, replicate_params=True)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab_size=97, ssm_state=16, expand=2, head_p=16, ssm_chunk=8,
    dtype="float32")
