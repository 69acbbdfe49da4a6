"""Prefill and decode step builders.

Counterpart of :func:`repro.train.steps.make_prefill_step` and
:func:`repro.train.steps.make_decode_step`.  The weights live in the model
(an ``nn.Module``), so the steps take no parameter argument; both run
without autograd.  The training step waits for the training slice.
"""

from __future__ import annotations

import torch


def make_prefill_step(model):
    """``prefill(tokens (B, T)) -> (last-position logits (B, 1, V),
    cache)``."""

    @torch.no_grad()
    def prefill_step(tokens: torch.Tensor):
        hidden, cache = model(tokens, mode="prefill")
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
