"""arctic-480b [moe]: 128-expert top-2 MoE with parallel dense residual MLP
(Arctic's dense+MoE hybrid). Adafactor: 480B of Adam state does not fit
16 GB/chip even fully sharded (see DESIGN.md §5). [hf:Snowflake/arctic-base]"""
from repro_torch.configs.base import ModelConfig, TrainConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=4864,
    vocab_size=32000, n_experts=128, top_k=2, dense_residual=True,
    moe_group_size=512, mlp_type="swiglu")

TRAIN = TrainConfig(optimizer="adafactor", microbatch=1)

SMOKE = ModelConfig(
    name="arctic-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
    vocab_size=97, n_experts=8, top_k=2, dense_residual=True,
    moe_group_size=32, mlp_type="swiglu", attn_chunk=16, dtype="float32")
