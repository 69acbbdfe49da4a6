"""granite-34b [dense]: 88L llama-arch code model, MQA (kv=1). [arXiv:2405.04324]"""
from repro_torch.configs.base import ModelConfig, TrainConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, d_ff=24576,
    vocab_size=49152, d_head=128, mlp_type="swiglu")

TRAIN = TrainConfig(optimizer="adam", microbatch=1)

SMOKE = ModelConfig(
    name="granite-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
    vocab_size=97, d_head=16, mlp_type="swiglu", attn_chunk=16,
    dtype="float32")
