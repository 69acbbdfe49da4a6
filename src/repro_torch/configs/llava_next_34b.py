"""llava-next-34b [vlm]: 34B decoder backbone; anyres vision frontend is a
STUB (precomputed patch embeddings prepended). [hf:llava-hf/llava-v1.6]"""
from repro_torch.configs.base import ModelConfig, TrainConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=20480,
    vocab_size=64000, n_patches=2880, mlp_type="swiglu")

TRAIN = TrainConfig(optimizer="adam", microbatch=1)

SMOKE = ModelConfig(
    name="llava-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=97, n_patches=4, mlp_type="swiglu", attn_chunk=16,
    dtype="float32")
