"""Train, prefill and decode step builders.

Counterpart of :mod:`repro.train.steps`.  The weights live in the model
(an ``nn.Module``), so the steps take no parameter argument:
``make_train_step`` updates the module's weights in place (through
:func:`repro_torch.train.optimizer.apply_updates`), and the serving steps
run without autograd.

The train step is the reference's:

* the batch cut into ``n_microbatches`` equal parts along its leading
  dim, each part's gradients summed into an accumulator of
  ``TrainConfig.grad_dtype`` (the reference's ``lax.scan``), then divided
  by ``n_microbatches`` in that dtype (with one microbatch the gradients
  stay in the weights' dtype, uncast, as in the reference);
* per-layer remat (``TrainConfig.remat``) inside the model, the attention
  through the chunked scan (never the flash kernel, which has no
  backward);
* the loss ``xent + moe_aux * load_balance + zloss * router_z``; the
  metrics the microbatches' means of the cross-entropy and each aux loss,
  and the global grad norm.

Where the accumulator's dtype is the weights' (bf16 weights, the bf16
default), autograd's own ``.grad`` accumulation is that bf16 sum; else
each microbatch's ``.grad`` is added into a buffer of the accumulator's
dtype.

On a model placed over a mesh (:func:`repro_torch.train.sharding.place`,
``mesh=``) the step takes the global batch, the same on every rank, and
keeps the rank's share of each microbatch
(:func:`repro_torch.train.sharding.batch_rows`); each microbatch's
gradients land, summed over the batch axes, on their weights' placements
(the gathers' backward), its loss and aux losses are the whole
microbatch's (:mod:`repro_torch.train.losses`,
:mod:`repro_torch.models.moe`), and the update runs on the local blocks.

The serving steps take a placed model as they are (``model.placed``), and
then the global batch too: the rank runs its rows where the batch splits
over the batch axes, else the whole batch
(:meth:`repro_torch.models.parallel.Placed.serving`); its caches are its
blocks on the reference's ``cache_spec``
(:func:`repro_torch.train.sharding.place_cache`), and the logits and next
tokens every rank returns are the whole batch's, the rows all-gathered.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.models.parallel import all_gather, gathered
from repro_torch.train.losses import softmax_xent
from repro_torch.train.optimizer import apply_updates, local


def acc_dtype(tcfg) -> torch.dtype:
    """The gradient accumulator's dtype: ``TrainConfig.grad_dtype`` (a
    torch dtype name), f32 when unset."""
    return getattr(torch, tcfg.grad_dtype) if tcfg.grad_dtype \
        else torch.float32


def _loss_fn(model, tcfg, tokens, labels, patches=None, unroll=False):
    """``(total loss, {"loss", "load_balance_loss", "router_z_loss"})``
    of one microbatch, through the train mode."""
    kw = {"frames" if model.cfg.family == "encdec" else "patches": patches}
    hidden, aux = model(tokens, mode="train", remat=tcfg.remat,
                        unroll=unroll, **kw)
    pl = model.placed
    tied = model.cfg.tie_embeddings
    with gathered(pl, model, "", ["embed" if tied else "unembed"]):
        w = model.embed.t() if tied else model.unembed
        loss, _ = softmax_xent(hidden, w, labels,
                               vocab=pl and pl.unembed_tp,
                               batch=pl and pl.batch)
    total = loss + tcfg.moe_aux * aux["load_balance_loss"] \
        + tcfg.zloss * aux["router_z_loss"]
    return total, {"loss": loss, **aux}


def accumulate_grads(model, tcfg, batch: dict, *, n_microbatches: int = 1,
                     unroll: bool = False):
    """The gradient half of the train step: ``(grads, metrics)``, grads a
    ``{name: tensor}`` of every parameter (the accumulator's dtype, divided
    by ``n_microbatches``; the weights' dtype with one microbatch),
    metrics f32 0-d tensors.  Leaves no ``.grad`` on the weights.  On a
    placed model ``batch`` is the rank's rows and each gradient its
    weight's local block."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
        p.grad = None

    def grad_of(p, dt):      # a weight the loss never reached: zeros
        return torch.zeros_like(local(p), dtype=dt) if p.grad is None \
            else local(p.grad).to(dt)

    if n_microbatches == 1:
        total, metrics = _loss_fn(model, tcfg, batch["tokens"],
                                  batch["labels"], batch.get("patches"),
                                  unroll)
        total.backward()
        grads = {n: grad_of(p, p.dtype) for n, p in params.items()}
        for p in params.values():
            p.grad = None
        return grads, {k: v.detach() for k, v in metrics.items()}

    b = batch["tokens"].shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} does not split into {n_microbatches} "
                         f"microbatches")
    acc_dt = acc_dtype(tcfg)
    mbs = [dict(zip(batch, parts)) for parts in
           zip(*(x.chunk(n_microbatches) for x in batch.values()))]
    bufs, sums = {}, None
    for mb in mbs:
        total, aux = _loss_fn(model, tcfg, mb["tokens"], mb["labels"],
                              mb.get("patches"), unroll)
        total.backward()
        sums = {k: v.detach() + (0 if sums is None else sums[k])
                for k, v in aux.items()}
        for n, p in params.items():
            if p.dtype != acc_dt:    # else autograd sums into .grad in acc_dt
                g = grad_of(p, acc_dt)
                bufs[n] = g if n not in bufs else bufs[n] + g
                p.grad = None
    grads = {n: (bufs[n] if n in bufs else grad_of(p, acc_dt))
             .div_(n_microbatches) for n, p in params.items()}
    for p in params.values():
        p.grad = None
    return grads, {k: v / n_microbatches for k, v in sums.items()}


def make_train_step(model, tcfg, *, n_microbatches: int = 1,
                    unroll: bool = False, mesh=None):
    """``train_step(opt_state, step, batch) -> (opt_state, metrics)``:
    batch ``{"tokens" (B, T), "labels" (B, T)[, "patches"]}`` (the vlm's
    patch embeddings or the encdec's frames under ``"patches"``, as the
    reference's), B a multiple of ``n_microbatches``; the module's weights
    and ``opt_state`` updated in place; metrics ``loss``,
    ``load_balance_loss``, ``router_z_loss`` and ``grad_norm``, f32 0-d
    tensors on the device.

    ``mesh``: the ``DeviceMesh`` the model was placed on; ``batch`` is
    then the global batch (every rank's alike), B a multiple of
    ``n_microbatches`` times the batch axes' size, and the metrics are
    global."""
    placed = model.placed
    if (mesh is None) != (placed is None) or \
            (mesh is not None and mesh is not placed.mesh):
        raise ValueError("a model placed on a mesh trains with mesh= that "
                         "mesh, and an unplaced one without")

    def train_step(opt_state: dict, step: int, batch: dict):
        if mesh is not None:
            from repro_torch.train.sharding import batch_rows

            batch = batch_rows(batch, mesh, n_microbatches)
        grads, metrics = accumulate_grads(
            model, tcfg, batch, n_microbatches=n_microbatches, unroll=unroll)
        opt_state, gnorm = apply_updates(model, grads, opt_state, step, tcfg)
        return opt_state, {**metrics, "grad_norm": gnorm}

    return train_step


@contextlib.contextmanager
def serving(model, batch: int):
    """``(rows, whole)`` for a serving step of ``batch`` rows: ``rows(x)``
    the rank's rows of a global ``(B, ...)`` input (None as it is),
    ``whole(y)`` the whole batch's output from the rank's (both the
    identity on an unplaced model), inside
    :meth:`repro_torch.models.parallel.Placed.serving`."""
    pl = model.placed
    if pl is None:
        yield (lambda x: x), (lambda y: y)
        return
    from repro_torch.train.sharding import batch_rows, batch_split

    split = batch_split(pl.mesh, batch)

    def rows(x):
        if x is None or not split:
            return x
        return batch_rows({"x": x}, pl.mesh)["x"]

    with pl.serving(model, split):
        yield rows, (lambda y: all_gather(y, pl.batch) if split else y)


def make_prefill_step(model):
    """``prefill(tokens (B, T), extra=None) -> (last-position logits (B, 1,
    V), cache)``; ``extra`` is the vlm family's patch embeddings (B,
    n_patches, d) or the encdec family's frames (B, encoder_len, d).  On a
    placed model the cache is the rank's (module docstring), its sequence
    whole: where the batch does not split, :func:`repro_torch.train.
    sharding.place_cache` cuts it after ``extend_cache``."""
    family = model.cfg.family

    @torch.no_grad()
    def prefill_step(tokens: torch.Tensor, extra=None):
        with serving(model, tokens.shape[0]) as (rows, whole):
            tokens, extra = rows(tokens), rows(extra)
            if family == "encdec":
                hidden, cache = model(tokens, frames=extra, mode="prefill")
            else:
                hidden, cache = model(tokens, mode="prefill",
                                      patches=extra if family == "vlm"
                                      else None)
            return whole(model.logits(hidden[:, -1:])), cache

    return prefill_step


def make_decode_step(model):
    """``decode(token (B, 1), cache) -> (next token (B, 1) int64, logits
    (B, 1, V), cache)``; the cache is updated in place (on a placed model
    the rank's blocks, module docstring)."""

    @torch.no_grad()
    def decode_step(token: torch.Tensor, cache: dict):
        with serving(model, token.shape[0]) as (rows, whole):
            hidden, cache = model(rows(token), mode="decode", cache=cache)
            logits = whole(model.logits(hidden))
        return torch.argmax(logits, dim=-1), logits, cache

    return decode_step
