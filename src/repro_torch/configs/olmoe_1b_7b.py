"""olmoe-1b-7b [moe]: 64 experts, top-8. [arXiv:2409.02060]"""
from repro_torch.configs.base import ModelConfig, TrainConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1024,
    vocab_size=50304, n_experts=64, top_k=8, moe_group_size=512,
    mlp_type="swiglu")

TRAIN = TrainConfig(optimizer="adam", microbatch=2)

SMOKE = ModelConfig(
    name="olmoe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=64,
    vocab_size=97, n_experts=8, top_k=4, moe_group_size=32,
    mlp_type="swiglu", attn_chunk=16, dtype="float32")
