"""Decoder-only LM, dense family (the ``attn`` block kind).

Counterpart of :mod:`repro.models.lm` for ``family="dense"`` (stablelm,
minitron, granite, nemotron): token embedding, a stack of pre-norm
GQA-attention + MLP blocks, a final RMS norm and an untied (or tied)
unembedding.  The reference scans one stacked set of block weights; here
each block is its own module in a :class:`torch.nn.ModuleList`, run by a
Python loop.

Caches keep the reference's layout, ``{"blocks": {"k": (L, B, S, KV, hd),
"v": ...}, "len": int}``.  Prefill returns one the length of the prompt;
decode writes the new token's keys and values into the given cache in
place and returns it with ``len + 1``.

The MoE, SSM, hybrid, VLM and encoder-decoder families and the training
forward are later slices of the port.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.attention import Attention
from repro_torch.models.layers import MLP, init_, rms_norm, weight

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Block(nn.Module):
    """Pre-norm GQA attention + dense MLP, each with a residual add."""

    def __init__(self, cfg, dtype: torch.dtype, device):
        super().__init__()
        self.eps = cfg.norm_eps
        self.ln1 = weight((cfg.d_model,), dtype, device)
        self.ln2 = weight((cfg.d_model,), dtype, device)
        self.attn = Attention(cfg, dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.ln1.fill_(1.0)
            self.ln2.fill_(1.0)
        self.attn.reset_parameters(generator)
        self.mlp.reset_parameters(generator)

    def forward(self, x, *, positions, cache=None):
        h, cache_out = self.attn(rms_norm(self.ln1, x, self.eps),
                                 positions=positions, cache=cache)
        x = x + h
        return x + self.mlp(rms_norm(self.ln2, x, self.eps)), cache_out


class DecoderLM(nn.Module):
    """Dense decoder-only LM.  Weights are allocated uninitialised on
    ``device`` in ``cfg.dtype``: fill them with :meth:`reset_parameters`
    or a state dict (:func:`repro_torch.models.convert.lm_params_from_numpy`)."""

    def __init__(self, cfg, *, device):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"DecoderLM takes the dense family only, got {cfg.family!r}")
        self.cfg = cfg
        dtype = DTYPES[cfg.dtype]
        self.embed = weight((cfg.vocab_size, cfg.d_model), dtype, device)
        self.blocks = nn.ModuleList(Block(cfg, dtype, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = weight((cfg.d_model,), dtype, device)
        if not cfg.tie_embeddings:
            self.unembed = weight((cfg.d_model, cfg.vocab_size), dtype,
                                  device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random weights from ``generator`` (on the weights' device), with
        the reference's distributions: embedding N(0, 1) cut at +-2, the
        other matrices fan-in scaled, norms 1."""
        init_(self.embed, generator, scale=1.0)
        for blk in self.blocks:
            blk.reset_parameters(generator)
        with torch.no_grad():
            self.final_norm.fill_(1.0)
        if not self.cfg.tie_embeddings:
            init_(self.unembed, generator)

    def init_cache(self, batch: int, max_len: int) -> dict:
        """Empty decode caches of ``max_len`` slots in the weights' dtype."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        return {"blocks": {name: self.embed.new_zeros(shape)
                           for name in ("k", "v")}, "len": 0}

    @staticmethod
    def extend_cache(cache: dict, extra: int) -> dict:
        """A copy of ``cache`` with ``extra`` more empty slots."""
        def grow(x):
            pad = x.new_zeros((*x.shape[:2], extra, *x.shape[3:]))
            return torch.cat([x, pad], dim=2)
        return {"blocks": {name: grow(x) for name, x in
                           cache["blocks"].items()},
                "len": cache["len"]}

    def forward(self, tokens: torch.Tensor, *, mode: str = "prefill",
                cache: dict | None = None):
        """Returns ``(hidden, cache_out)``.

        prefill: ``tokens (B, T)``, returns the cache of the T positions;
        decode: ``tokens (B, 1)`` and a cache with a free slot.
        """
        x = torch.nn.functional.embedding(tokens, self.embed)
        b, t, _ = x.shape
        if mode == "prefill":
            positions = torch.arange(t, device=x.device).expand(b, t)
            ks, vs = [], []
            for blk in self.blocks:
                x, (k, v) = blk(x, positions=positions)
                ks.append(k)
                vs.append(v)
            cache_out = {"blocks": {"k": torch.stack(ks),
                                    "v": torch.stack(vs)}, "len": t}
        elif mode == "decode":
            length = cache["len"]
            positions = torch.full((b, 1), length, device=x.device)
            kc, vc = cache["blocks"]["k"], cache["blocks"]["v"]
            for i, blk in enumerate(self.blocks):
                x, _ = blk(x, positions=positions,
                           cache=(kc[i], vc[i], length))
            cache_out = {"blocks": {"k": kc, "v": vc}, "len": length + 1}
        else:
            raise ValueError(f"mode must be 'prefill' or 'decode', got "
                             f"{mode!r}")
        return rms_norm(self.final_norm, x, self.cfg.norm_eps), cache_out

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        w = self.embed.t() if self.cfg.tie_embeddings else self.unembed
        return hidden @ w
