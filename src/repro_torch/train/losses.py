"""Softmax cross-entropy over the vocabulary.

Counterpart of :mod:`repro.train.losses`.  The reference shards the
unembed matrix's vocab dim over its ``model`` axis so that the full
``(B, T, V)`` logits never exist on one device, and GSPMD lowers the
max, the sum of exponentials and the label's pick over the sharded V to
all-reduces.  The port writes them (``vocab``): each rank holds the logits
of its vocab slice, the max and the sum of exponentials are all-reduced
over the axis, and the label's logit comes from the rank whose slice holds
it.  On one device (no axis) the f32 logits of a microbatch exist whole
(stablelm-3b at 2 x 2048 tokens: 824 MB).
"""

from __future__ import annotations

import torch

from repro_torch.models.parallel import all_max, copy_to, reduce_from


def softmax_xent(hidden: torch.Tensor, unembed: torch.Tensor,
                 labels: torch.Tensor, *, vocab=None, batch=None):
    """hidden: (B, T, d); unembed: (d, V); labels: (B, T) integers.

    Returns ``(mean loss, n_tokens)``: the loss an f32 0-d tensor.  The
    reference's arithmetic: logits ``(hidden @ unembed)`` in f32, the max
    taken out without gradient, ``log(sum(exp(shifted))) + max``, less the
    label's logit picked by equality with the vocab ids.

    ``vocab`` (a :class:`repro_torch.models.parallel.Axis`): ``unembed``
    is this rank's slice of the vocab (rank ``r`` holds ids ``[r V, (r +
    1) V)``).  ``batch``: the tokens are this rank's share of a batch split
    evenly over the axis, and the mean and ``n_tokens`` are the whole
    batch's, on every rank."""
    hidden = copy_to(hidden, vocab)
    logits = (hidden @ unembed).float()
    m = all_max(logits.amax(-1, keepdim=True).detach(), vocab)
    lse = torch.log(reduce_from(torch.exp(logits - m).sum(-1), vocab)) \
        + m[..., 0]
    v = logits.shape[-1]
    first = 0 if vocab is None else vocab.rank * v
    vocab_ids = torch.arange(first, first + v, device=logits.device)
    label_logit = reduce_from(torch.where(vocab_ids == labels[..., None],
                                          logits, 0.0).sum(-1), vocab)
    loss = lse - label_logit
    if batch is None:
        return loss.mean(), loss.numel()
    return reduce_from(loss.mean() / batch.size, batch), \
        loss.numel() * batch.size
