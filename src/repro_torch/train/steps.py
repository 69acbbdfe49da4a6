"""Prefill and decode step builders.

Counterpart of :func:`repro.train.steps.make_prefill_step` and
:func:`repro.train.steps.make_decode_step`.  The weights live in the model
(an ``nn.Module``), so the steps take no parameter argument; both run
without autograd.  The training step waits for the training slice.
"""

from __future__ import annotations

import torch


def make_prefill_step(model):
    """``prefill(tokens (B, T), extra=None) -> (last-position logits (B, 1,
    V), cache)``; ``extra`` is the vlm family's patch embeddings (B,
    n_patches, d) or the encdec family's frames (B, encoder_len, d)."""
    family = model.cfg.family

    @torch.no_grad()
    def prefill_step(tokens: torch.Tensor, extra=None):
        if family == "encdec":
            hidden, cache = model(tokens, frames=extra, mode="prefill")
        else:
            hidden, cache = model(tokens, mode="prefill",
                                  patches=extra if family == "vlm" else None)
        return model.logits(hidden[:, -1:]), cache

    return prefill_step


def make_decode_step(model):
    """``decode(token (B, 1), cache) -> (next token (B, 1) int64, logits
    (B, 1, V), cache)``; the cache is updated in place."""

    @torch.no_grad()
    def decode_step(token: torch.Tensor, cache: dict):
        hidden, cache = model(token, mode="decode", cache=cache)
        logits = model.logits(hidden)
        return torch.argmax(logits, dim=-1), logits, cache

    return decode_step
