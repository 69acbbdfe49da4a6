"""Config dataclasses + the architecture/shape registry."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0             # 0 -> d_model // n_heads
    mlp_type: str = "swiglu"    # swiglu | relu2 | gelu
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    dense_residual: bool = False     # arctic: dense MLP in parallel with MoE
    moe_group_size: int = 512
    capacity_factor: float = 1.25
    # --- SSM (mamba2) ---
    ssm_state: int = 0
    expand: int = 2
    d_conv: int = 4
    head_p: int = 64                 # mamba2 head dim
    ssm_chunk: int = 128
    # --- hybrid (zamba2) ---
    shared_attn_every: int = 0       # apply shared attn+mlp block every k layers
    # --- enc-dec (whisper) ---
    encoder_layers: int = 0
    encoder_len: int = 1500
    # --- vlm (llava) ---
    n_patches: int = 0               # anyres patch embeddings prepended
    # --- common ---
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    attn_chunk: int = 1024           # flash-scan KV chunk
    dtype: str = "bfloat16"          # param/activation dtype
    tie_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def ssm_heads(self) -> int:
        return (self.expand * self.d_model) // self.head_p

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    def param_count(self) -> int:
        """Analytic parameter count (for MODEL_FLOPS = 6*N*D roofline term)."""
        d, hd = self.d_model, self.head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = d * hd * (self.n_heads * 2 + self.n_kv_heads * 2)
        if self.mlp_type == "swiglu":
            mlp = 3 * d * self.d_ff
        else:
            mlp = 2 * d * self.d_ff
        moe = 0
        if self.n_experts:
            per = mlp
            moe = self.n_experts * per + d * self.n_experts
            mlp = per if self.dense_residual else 0
        if self.family == "ssm" or self.family == "hybrid":
            n, h = self.ssm_state, self.ssm_heads
            din = self.d_inner
            mamba = (d * (2 * din + 2 * n + h) + self.d_conv * (din + 2 * n)
                     + din * d + din + 3 * h)
            if self.family == "ssm":
                return emb + self.n_layers * mamba
            shared = attn + 3 * d * 8192  # zamba2 shared block (counted once)
            return emb + self.n_layers * mamba + shared
        layer = attn + mlp + moe
        if self.family == "encdec":
            enc_layer = attn + mlp
            dec_layer = 2 * attn + mlp
            return emb + self.encoder_layers * enc_layer + \
                self.n_layers * dec_layer
        return emb + self.n_layers * layer

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k experts only)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        per_expert = (3 if self.mlp_type == "swiglu" else 2) * \
            self.d_model * self.d_ff
        inactive = self.n_layers * (self.n_experts - self.top_k) * per_expert
        return full - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell."""
    name: str                   # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                   # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Trainer knobs (per arch x shape, overridable from the launcher)."""
    optimizer: str = "adam"       # adam | adafactor
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    microbatch: int = 0           # per-device microbatch; 0 -> auto
    remat: str = "full"           # full | dots | none
    zloss: float = 1e-3
    moe_aux: float = 1e-2
    grad_dtype: str = "bfloat16"  # gradient all-reduce compression dtype
    replicate_params: bool = False  # small models: pure DP beats TP=16
                                  # (EXPERIMENTS.md §Perf P2: 3x on whisper)
