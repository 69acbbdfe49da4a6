"""Softmax cross-entropy over the vocabulary.

Counterpart of :mod:`repro.train.losses`.  The reference shards the
unembed matrix's vocab dim over its ``model`` axis so that the full
``(B, T, V)`` logits never exist on one device; the port runs on one
device, where they do: the logits of one microbatch in f32 (stablelm-3b at
2 x 2048 tokens: 824 MB).
"""

from __future__ import annotations

import torch


def softmax_xent(hidden: torch.Tensor, unembed: torch.Tensor,
                 labels: torch.Tensor):
    """hidden: (B, T, d); unembed: (d, V); labels: (B, T) integers.

    Returns ``(mean loss, n_tokens)``: the loss an f32 0-d tensor.  The
    reference's arithmetic: logits ``(hidden @ unembed)`` in f32, the max
    taken out without gradient, ``log(sum(exp(shifted))) + max``, less the
    label's logit picked by equality with the vocab ids.
    """
    logits = (hidden @ unembed).float()
    m = logits.amax(-1, keepdim=True).detach()
    lse = torch.log(torch.exp(logits - m).sum(-1)) + m[..., 0]
    vocab_ids = torch.arange(logits.shape[-1], device=logits.device)
    label_logit = torch.where(vocab_ids == labels[..., None], logits,
                              0.0).sum(-1)
    loss = lse - label_logit
    return loss.mean(), loss.numel()
