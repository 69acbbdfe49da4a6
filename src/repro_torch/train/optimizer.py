"""Optimizers: Adam(W) and Adafactor, both with f32 master weights.

Counterpart of :mod:`repro.train.optimizer`.  Memory per parameter
(bytes):

  adam:      2 (bf16 param) + 4 (master) + 4 (m) + 4 (v)  = 14
  adafactor: 2 (bf16 param) + 4 (master) + ~0 (factored)  = ~6

The state is ``{"master", "m", "v"}`` (Adam) or ``{"master", "vr",
"vc"}`` (Adafactor), each a dict keyed by the model's parameter names.
:func:`apply_updates` updates it in place, writes the masters back into
the module's weights in their dtype, and returns it with the global grad
norm.

**Layer groups.**  The reference stacks a layer stack's weights on a
leading ``L`` axis, and three of its rules read the stacked leaf; the port
keeps one tensor a layer and applies each rule to the *group* of a
reference leaf (``blocks.{i}.attn.wq`` for every ``i`` is the group
``blocks.attn.wq``, of stacked shape ``(L, d, H * hd)``):

* weight decay applies when the stacked leaf has 2 dims or more, so a
  layer's RMS-norm scale ``(d,)`` is decayed (stacked ``(L, d)``) and the
  unstacked ``final_norm (d,)`` is not;
* Adafactor factors the second moment when the stacked leaf's last two
  dims are both at least 128 (:func:`_is_factorable`);
* Adafactor's RMS-1 update clip takes the RMS over the whole group, all
  layers together (two passes: the sum of squares, then the update).

The per-element math is the reference's, tensor by tensor.  The schedule's
scalars (lr, the bias corrections, Adafactor's decay) are f32, as the
reference computes them without ``jax_enable_x64``.
"""

from __future__ import annotations

import torch

# the layer stacks the reference scans (a leading L axis on each leaf)
STACKED = ("blocks", "encoder", "decoder")
B1, B2, EPS = 0.9, 0.95, 1e-8
WARMUP = 100.0


def _is_factorable(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 128 and shape[-2] >= 128


def group_of(name: str) -> tuple[str, bool]:
    """``(group, stacked)``: the reference leaf a parameter name belongs
    to, the layer index of a stacked group left out (``blocks.3.attn.wq``
    -> ``("blocks.attn.wq", True)``)."""
    parts = name.split(".")
    keep = [p for i, p in enumerate(parts)
            if not (p.isdigit() and i and parts[i - 1] in STACKED)]
    return ".".join(keep), len(keep) < len(parts)


def layer_groups(shapes: dict) -> dict:
    """``{group: (names, stacked shape)}`` in the order of ``shapes``
    (``{name: shape}``): a stacked group's shape gains a leading axis of
    its layer count."""
    out: dict = {}
    for name, shape in shapes.items():
        group, stacked = group_of(name)
        names, _ = out.get(group, ([], None))
        names.append(name)
        out[group] = (names, (len(names), *shape) if stacked
                      else tuple(shape))
    return out


def _stacked_shapes(model) -> dict:
    """``{name: its group's stacked shape}`` for every parameter."""
    groups = layer_groups({n: p.shape for n, p in model.named_parameters()})
    return {n: shape for names, shape in groups.values() for n in names}


def init_opt_state(model, tcfg) -> dict:
    """The optimizer state of ``model``'s parameters, on their device
    (``meta`` included): f32 masters and zero moments."""
    f32 = torch.float32
    params = dict(model.named_parameters())
    master = {n: p.detach().to(f32, copy=True) for n, p in params.items()}
    zeros = lambda shape, p: torch.zeros(shape, dtype=f32, device=p.device)
    if tcfg.optimizer == "adam":
        return {"master": master,
                "m": {n: zeros(p.shape, p) for n, p in params.items()},
                "v": {n: zeros(p.shape, p) for n, p in params.items()}}
    if tcfg.optimizer == "adafactor":
        stacked = _stacked_shapes(model)
        vr, vc = {}, {}
        for n, p in params.items():
            fact = _is_factorable(stacked[n])
            if fact and p.dim() < 2:
                raise ValueError(
                    f"{n}: the stacked shape {stacked[n]} factors across "
                    f"layers, which a per-layer state cannot hold")
            vr[n] = zeros(p.shape[:-1] if fact else p.shape, p)
            vc[n] = zeros(p.shape[:-2] + p.shape[-1:] if fact else (), p)
        return {"master": master, "vr": vr, "vc": vc}
    raise ValueError(tcfg.optimizer)


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def _schedule(step: int, tcfg, device=None) -> torch.Tensor:
    """Linear warmup over ``WARMUP`` steps to ``tcfg.learning_rate``, an
    f32 scalar."""
    warm = _f32(step + 1, device) / WARMUP
    return tcfg.learning_rate * torch.clamp(warm, max=1.0)


def _adafactor_u(g, vr, vc, d, factored: bool, *, update: bool):
    """Adafactor's unclipped update of ``g``; with ``update`` the second
    moments ``vr`` / ``vc`` first take this step's ``g * g`` (in place)."""
    if factored:
        if update:
            gg = g * g
            vr.mul_(d).add_((1 - d) * gg.mean(-1))
            vc.mul_(d).add_((1 - d) * gg.mean(-2))
        r = vr / torch.clamp(vr.mean(-1, keepdim=True), min=1e-30)
        return g / (torch.sqrt(r)[..., None] * torch.sqrt(vc)[..., None, :]
                    + EPS)
    if update:
        vr.mul_(d).add_((1 - d) * (g * g))
    return g / (torch.sqrt(vr) + EPS)


@torch.no_grad()
def apply_updates(model, grads: dict, opt_state: dict, step: int, tcfg):
    """One optimizer step: ``grads`` (``{name: tensor}``, any float dtype)
    clipped to the global norm ``tcfg.grad_clip`` in f32, the masters and
    moments updated in place, the masters written into the module's
    weights in their dtype.  Returns ``(opt_state, grad_norm)``, the norm
    an f32 0-d tensor on the weights' device."""
    params = dict(model.named_parameters())
    master = opt_state["master"]
    dev = next(iter(master.values())).device
    lr = _schedule(step, tcfg, dev)
    wd = tcfg.weight_decay

    sq = torch.zeros((), dtype=torch.float32, device=dev)
    for n in params:
        g = grads[n].float().reshape(-1)
        sq += torch.dot(g, g)
    gnorm = torch.sqrt(sq)
    scale = torch.clamp(tcfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    groups = layer_groups({n: p.shape for n, p in params.items()})

    def finish(n, u, stacked_shape):
        if len(stacked_shape) >= 2:
            u = u + wd * master[n]
        master[n].sub_(lr * u)
        params[n].copy_(master[n])

    if tcfg.optimizer == "adam":
        t = step + 1
        bc1 = 1 - _f32(B1, dev) ** t
        bc2 = 1 - _f32(B2, dev) ** t
        m, v = opt_state["m"], opt_state["v"]
        for names, shape in groups.values():
            for n in names:
                g = grads[n].float() * scale
                m[n].mul_(B1).add_((1 - B1) * g)
                v[n].mul_(B2).add_((1 - B2) * g * g)
                u = (m[n] / bc1) / (torch.sqrt(v[n] / bc2) + EPS)
                finish(n, u, shape)
        return opt_state, gnorm

    if tcfg.optimizer != "adafactor":
        raise ValueError(tcfg.optimizer)
    d = 1 - (1.0 / _f32(step + 2, dev)) ** 0.8    # decay-to-one schedule
    vr, vc = opt_state["vr"], opt_state["vc"]
    for names, shape in groups.values():
        factored = _is_factorable(shape)
        one = len(names) == 1
        total = sum(params[n].numel() for n in names)
        usq = torch.zeros((), dtype=torch.float32, device=dev)
        for n in names:       # pass 1: the moments, the group's sum of u^2
            u = _adafactor_u(grads[n].float() * scale, vr[n], vc[n], d,
                             factored, update=True)
            usq += (u * u).sum()
        # update clipping (Shazeer & Stern RMS-1) over the group
        div = torch.clamp(torch.sqrt(usq / total + 1e-30), min=1.0)
        for n in names:       # pass 2: the same u again (kept if alone)
            if not one:
                u = _adafactor_u(grads[n].float() * scale, vr[n], vc[n], d,
                                 factored, update=False)
            finish(n, u / div, shape)
    return opt_state, gnorm
