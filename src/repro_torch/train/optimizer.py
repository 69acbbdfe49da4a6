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

**Placed models** (:func:`repro_torch.train.sharding.place`).  The state
is ``DTensor`` objects on the reference's specs of the optimizer tree
(:func:`repro_torch.train.sharding.infer_param_specs` of its names): the
masters and moments on their weight's, Adafactor's ``vr`` / ``vc`` on the
rules evaluated on their own shapes.  The update runs on local blocks:
the global grad norm is one sum of squares over the blocks a rank owns
(:meth:`repro_torch.models.parallel.Placed.owns`), all-reduced once;
Adafactor's row and column means and the mean of ``vr`` sum over the
ranks that split the reduced dim, and its group RMS clip sums over the
world; the factored statistics then move onto the gradient's blocks.
Where no dim is split over more than one rank (a world of one) every step
is the unplaced arithmetic.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

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


def local(t: torch.Tensor) -> torch.Tensor:
    """A ``DTensor``'s local block (a view: writes reach it), or ``t``."""
    return t.to_local() if isinstance(t, DTensor) else t


def _placed_zeros(mesh, spec, shape, device) -> DTensor:
    """Zeros of global ``shape`` on ``mesh`` under ``spec``'s placements."""
    from repro_torch.train.sharding import local_block, placements

    pls = placements(spec, mesh)
    block = local_block(torch.empty(shape, device="meta"), mesh, pls)
    return DTensor.from_local(
        torch.zeros(block.shape, dtype=torch.float32, device=device), mesh,
        pls, run_check=False)


def _state_shapes(model, tcfg) -> dict:
    """``{key: {name: shape}}`` of the moments (``m``, ``v`` or ``vr``,
    ``vc``) of every parameter."""
    params = dict(model.named_parameters())
    if tcfg.optimizer == "adam":
        return {k: {n: tuple(p.shape) for n, p in params.items()}
                for k in ("m", "v")}
    if tcfg.optimizer != "adafactor":
        raise ValueError(tcfg.optimizer)
    stacked = _stacked_shapes(model)
    vr, vc = {}, {}
    for n, p in params.items():
        fact = _is_factorable(stacked[n])
        if fact and p.dim() < 2:
            raise ValueError(
                f"{n}: the stacked shape {stacked[n]} factors across "
                f"layers, which a per-layer state cannot hold")
        vr[n] = tuple(p.shape[:-1] if fact else p.shape)
        vc[n] = tuple(p.shape[:-2] + p.shape[-1:] if fact else ())
    return {"vr": vr, "vc": vc}


def init_opt_state(model, tcfg, specs: dict | None = None) -> dict:
    """The optimizer state of ``model``'s parameters, on their device
    (``meta`` included): f32 masters and zero moments; on a placed model
    ``DTensor`` objects on the reference's specs (module docstring), or on
    ``specs`` (``{key: {name: spec}}`` of the moments, as
    :func:`repro_torch.launch.specs.opt_specs` gives them: replicated
    where ``TrainConfig.replicate_params``); the masters lie on their
    weights'."""
    f32 = torch.float32
    params = dict(model.named_parameters())
    master = {n: p.detach().to(f32, copy=True) for n, p in params.items()}
    shapes = _state_shapes(model, tcfg)
    placed = getattr(model, "placed", None)
    if placed is None:
        return {"master": master, **{
            k: {n: torch.zeros(s, dtype=f32, device=params[n].device)
                for n, s in d.items()} for k, d in shapes.items()}}
    if specs is None:
        from repro_torch.train.sharding import infer_param_specs

        flat = infer_param_specs({f"{k}.{n}": s for k, d in shapes.items()
                                  for n, s in d.items()}, placed.mesh)
        specs = {k: {n: flat[f"{k}.{n}"] for n in d}
                 for k, d in shapes.items()}
    return {"master": master, **{
        k: {n: _placed_zeros(placed.mesh, specs[k][n], s,
                             local(params[n]).device)
            for n, s in d.items()} for k, d in shapes.items()}}


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


def _reduce_mean(x, dim: int, pls, mesh, n: int, *, keepdim=False):
    """The mean over global dim ``dim`` (``n`` entries) of a tensor whose
    local block is ``x`` under placements ``pls``: ``(the result's block,
    its placements)``, replicated over the ranks that split ``dim`` (their
    partial sums all-reduced)."""
    split = [i for i, pl in enumerate(pls)
             if isinstance(pl, Shard) and pl.dim == dim]
    out = tuple(Replicate() if i in split else
                Shard(pl.dim - 1) if not keepdim and isinstance(pl, Shard)
                and pl.dim > dim else pl for i, pl in enumerate(pls))
    if all(mesh.size(i) == 1 for i in split):
        return x.mean(dim, keepdim=keepdim), out
    partial = tuple(Partial() if i in split else pl
                    for i, pl in enumerate(out))
    s = DTensor.from_local(x.sum(dim, keepdim=keepdim), mesh, partial,
                           run_check=False)
    return s.redistribute(mesh, out).to_local() / n, out


def _moved(x, mesh, src, dst):
    """The local block ``x`` under placements ``src`` -> its block under
    ``dst`` (nothing to do where they differ on dims of size 1 alone)."""
    if all(a == b or mesh.size(i) == 1
           for i, (a, b) in enumerate(zip(src, dst))):
        return x
    return DTensor.from_local(x, mesh, src, run_check=False).redistribute(
        mesh, dst).to_local()


def _adafactor_u_split(g, vr, vc, d, shape, pls, mesh, *, update: bool):
    """:func:`_adafactor_u`'s factored branch on local blocks: ``g`` under
    its weight's placements ``pls[0]``, ``vr`` / ``vc`` under ``pls[1]`` /
    ``pls[2]`` (their own specs); ``shape`` the weight's global shape.
    The row and column means reduce over the ranks that split them; the
    statistics then move onto ``g``'s rows and columns."""
    gp, rp, cp = pls
    nd = len(shape)
    if update:
        gg = g * g
        row, at = _reduce_mean(gg, nd - 1, gp, mesh, shape[-1])
        vr.mul_(d).add_((1 - d) * _moved(row, mesh, at, rp))
        col, at = _reduce_mean(gg, nd - 2, gp, mesh, shape[-2])
        vc.mul_(d).add_((1 - d) * _moved(col, mesh, at, cp))
    mean, _ = _reduce_mean(vr, nd - 2, rp, mesh, shape[-2], keepdim=True)
    r = vr / torch.clamp(mean, min=1e-30)
    rows = tuple(Replicate() if isinstance(pl, Shard) and pl.dim == nd - 1
                 else pl for pl in gp)
    cols = tuple(Replicate() if isinstance(pl, Shard) and pl.dim == nd - 2
                 else Shard(nd - 2) if isinstance(pl, Shard)
                 and pl.dim == nd - 1 else pl for pl in gp)
    r, c = _moved(r, mesh, rp, rows), _moved(vc, mesh, cp, cols)
    return g / (torch.sqrt(r)[..., None] * torch.sqrt(c)[..., None, :] + EPS)


def _sum_world(x: torch.Tensor, placed) -> torch.Tensor:
    """``x`` summed over every rank of a placed model's mesh, in place."""
    if placed is not None and placed.world is not None:
        dist.all_reduce(x, group=placed.world.group)
    return x


@torch.no_grad()
def apply_updates(model, grads: dict, opt_state: dict, step: int, tcfg):
    """One optimizer step: ``grads`` (``{name: tensor}``, any float dtype;
    on a placed model each weight's local block) clipped to the global
    norm ``tcfg.grad_clip`` in f32, the masters and moments updated in
    place, the masters written into the module's weights in their dtype.
    Returns ``(opt_state, grad_norm)``, the norm an f32 0-d tensor on the
    weights' device."""
    placed = getattr(model, "placed", None)
    params = dict(model.named_parameters())
    master = {n: local(t) for n, t in opt_state["master"].items()}
    dev = next(iter(master.values())).device
    lr = _schedule(step, tcfg, dev)
    wd = tcfg.weight_decay
    owns = (lambda n: True) if placed is None else \
        (lambda n: placed.owns(params[n].placements))

    sq = torch.zeros((), dtype=torch.float32, device=dev)
    for n in params:
        if owns(n):
            g = grads[n].float().reshape(-1)
            sq += torch.dot(g, g)
    gnorm = torch.sqrt(_sum_world(sq, placed))
    scale = torch.clamp(tcfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    groups = layer_groups({n: p.shape for n, p in params.items()})

    def finish(n, u, stacked_shape):
        if len(stacked_shape) >= 2:
            u = u + wd * master[n]
        master[n].sub_(lr * u)
        local(params[n]).copy_(master[n])

    if tcfg.optimizer == "adam":
        t = step + 1
        bc1 = 1 - _f32(B1, dev) ** t
        bc2 = 1 - _f32(B2, dev) ** t
        m = {n: local(x) for n, x in opt_state["m"].items()}
        v = {n: local(x) for n, x in opt_state["v"].items()}
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
    vr = {n: local(x) for n, x in opt_state["vr"].items()}
    vc = {n: local(x) for n, x in opt_state["vc"].items()}

    def u_of(n, factored, *, update):
        g = grads[n].float() * scale
        if placed is None or not factored:
            return _adafactor_u(g, vr[n], vc[n], d, factored, update=update)
        pls = (params[n].placements, opt_state["vr"][n].placements,
               opt_state["vc"][n].placements)
        return _adafactor_u_split(g, vr[n], vc[n], d, params[n].shape, pls,
                                  placed.mesh, update=update)

    for names, shape in groups.values():
        factored = _is_factorable(shape)
        one = len(names) == 1
        total = sum(params[n].numel() for n in names)
        usq = torch.zeros((), dtype=torch.float32, device=dev)
        for n in names:       # pass 1: the moments, the group's sum of u^2
            u = u_of(n, factored, update=True)
            if owns(n):
                usq += (u * u).sum()
        # update clipping (Shazeer & Stern RMS-1) over the group
        usq = _sum_world(usq, placed)
        div = torch.clamp(torch.sqrt(usq / total + 1e-30), min=1.0)
        for n in names:       # pass 2: the same u again (kept if alone)
            if not one:
                u = u_of(n, factored, update=False)
            finish(n, u / div, shape)
    return opt_state, gnorm
