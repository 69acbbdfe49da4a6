"""stablelm-3b [dense]: GQA kv=32 (MHA), d_head=80. [hf:stabilityai]"""
from repro_torch.configs.base import ModelConfig, TrainConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=6912,
    vocab_size=50304, mlp_type="swiglu")

TRAIN = TrainConfig(optimizer="adam", microbatch=2)

SMOKE = ModelConfig(
    name="stablelm-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=97, mlp_type="swiglu", attn_chunk=16, dtype="float32")
