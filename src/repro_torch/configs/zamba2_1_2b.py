"""zamba2-1.2b [hybrid]: Mamba2 backbone + ONE shared attn+MLP block
applied every 6 layers (params reused across call sites). [arXiv:2411.15242]"""
from repro_torch.configs.base import ModelConfig, TrainConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=32000, ssm_state=64, expand=2, head_p=64,
    shared_attn_every=6, mlp_type="swiglu")

TRAIN = TrainConfig(optimizer="adam", microbatch=2)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=97, ssm_state=16, expand=2, head_p=16,
    shared_attn_every=2, mlp_type="swiglu", ssm_chunk=8, attn_chunk=16,
    dtype="float32")
