"""nemotron-4-15b [dense]: GQA kv=8, squared-ReLU MLP, 256k vocab.
[arXiv:2402.16819]"""
from repro_torch.configs.base import ModelConfig, TrainConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=24576,
    vocab_size=256000, d_head=128, mlp_type="relu2")

TRAIN = TrainConfig(optimizer="adam", microbatch=1)

SMOKE = ModelConfig(
    name="nemotron-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=199, d_head=16, mlp_type="relu2", attn_chunk=16,
    dtype="float32")
