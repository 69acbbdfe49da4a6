"""minitron-8b [dense]: pruned nemotron, 256k vocab. [arXiv:2407.14679]"""
from repro_torch.configs.base import ModelConfig, TrainConfig

CONFIG = ModelConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=16384,
    vocab_size=256000, d_head=128, mlp_type="relu2")

TRAIN = TrainConfig(optimizer="adam", microbatch=1)

SMOKE = ModelConfig(
    name="minitron-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=199, d_head=16, mlp_type="relu2", attn_chunk=16,
    dtype="float32")
