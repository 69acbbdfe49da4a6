"""Sharding-rule inference for the LM substrate: the spec rules.

Counterpart of the rules of :mod:`repro.train.sharding` (one rule set):

* TP over the ``model`` axis — attention head projections, FFN hidden dim,
  MoE expert axis (EP), vocab dim of embed/unembed;
* FSDP over the ``data`` axis — every parameter of at least
  ``FSDP_THRESHOLD`` entries shards its largest still-unsharded dim over
  ``data``; optimizer states inherit the parameter's spec;
* the leading ``L`` axis of a layer stack is never sharded;
* the ``pod`` axis is pure DP: the batch shards over ``(pod, data)``.

A spec is a tuple with one entry a dim: an axis name, a tuple of axis
names, or None (the reference's ``PartitionSpec`` entries).  A mesh is a
mapping of axis name to size, or a :class:`torch.distributed.DeviceMesh`
(its ``mesh_dim_names`` and shape).

The reference evaluates the rules on its stacked leaves ``(L, ...)``; the
port keeps a tensor a layer, so :func:`infer_param_specs` evaluates them
on the stacked shape of a tensor's layer group
(:func:`repro_torch.train.optimizer.layer_groups`) and gives each layer
the stacked spec without its leading ``L`` entry (FSDP's threshold reads
the stacked size: olmoe's router is 2.1M entries stacked, 131k a layer).

Placing (the reference's ``place``, ``jax.device_put`` by
``NamedSharding``): :func:`placements` turns a spec into ``DTensor``
placements over a ``DeviceMesh``; :func:`place` makes every parameter of a
model (or every tensor of a dict) a ``DTensor`` holding this rank's block
and records, on the model, how its train mode reads each weight
(:class:`repro_torch.models.parallel.Placed`): attention heads, the FFN's
``d_ff`` and mamba's heads split over ``model`` (TP) where they divide,
MoE experts over ``model`` (EP), the vocab of ``embed`` / ``unembed``
over ``model``, everything else gathered.  :func:`batch_rows` is the
batch's counterpart of :func:`data_spec`: a rank's rows of each
microbatch.  :func:`place_cache` is the decode cache's counterpart of
:func:`place`: each leaf the rank's block on :func:`cache_spec`.
"""

from __future__ import annotations

import math
from collections.abc import Mapping

import torch
from torch import nn

from repro_torch.models.attention import Attention
from repro_torch.models.layers import MLP
from repro_torch.models.mamba2 import Mamba2
from repro_torch.models.moe import MoE
from repro_torch.models.parallel import Placed
from repro_torch.train.optimizer import STACKED, group_of, layer_groups

FSDP_THRESHOLD = 1 << 20  # params smaller than 1M entries stay unsharded

# param name -> the dim (counted from the end, so robust to the stacking
# axis) that takes the TP ("model") axis
_TP_RULES = {
    "wq": -1, "wk": -1, "wv": -1, "w_gate": -1, "w_up": -1,
    "in_proj": -1, "unembed": -1, "patch_proj": -1,
    "wo": -2, "w_down": -2, "out_proj": -2,
    "embed": -2,   # (V, d): shard vocab
}
# MoE expert tensors (under a "moe" sub-tree): shard the expert axis (EP)
_EP_NAMES = {"w_gate", "w_up", "w_down"}


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a mapping or a ``DeviceMesh``."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _names(path) -> list[str]:
    """A dotted name or a sequence of names -> its non-index names."""
    parts = path.split(".") if isinstance(path, str) else list(path)
    return [str(p) for p in parts if not str(p).isdigit()]


def param_spec(path, shape, *, model_axis="model", data_axis="data",
               model_size=1, data_size=1, fsdp: bool = True) -> tuple:
    """The reference's spec of the leaf at ``path`` of (stacked) ``shape``:
    the TP or EP entry, then FSDP's."""
    names = _names(path)
    leaf = names[-1]
    stacked = any(n in STACKED for n in names)
    nd = len(shape)
    spec: list = [None] * nd

    if "moe" in names and leaf in _EP_NAMES:
        e_dim = 1 if stacked else 0
        if shape[e_dim] % model_size == 0:
            spec[e_dim] = model_axis
    elif leaf in _TP_RULES:
        d = nd + _TP_RULES[leaf]
        if 0 <= d < nd and shape[d] % model_size == 0:
            spec[d] = model_axis

    if fsdp and math.prod(shape) >= FSDP_THRESHOLD:
        # the largest unsharded, divisible dim; never the stacking axis
        cand = [(shape[d], d) for d in range(nd)
                if spec[d] is None and not (stacked and d == 0)
                and shape[d] % data_size == 0]
        if cand:
            _, d = max(cand)
            spec[d] = data_axis
    return tuple(spec)


def infer_param_specs(shapes, mesh, *, fsdp: bool = True) -> dict:
    """``{name: spec}`` for a model's parameters (or any ``{name:
    shape}``, optimizer state names like ``m.blocks.0.attn.wq`` included):
    each tensor's rule evaluated on its layer group's stacked shape, the
    leading ``L`` entry dropped for a tensor of a stack."""
    if not isinstance(shapes, Mapping):
        shapes = dict(shapes.named_parameters())
    shapes = {n: tuple(getattr(s, "shape", s)) for n, s in shapes.items()}
    sizes = mesh_shape(mesh)
    out = {}
    for group, (names, stacked_shape) in layer_groups(shapes).items():
        for n in names:
            if not shapes[n]:
                out[n] = ()
                continue
            spec = param_spec(group, stacked_shape,
                              model_size=sizes.get("model", 1),
                              data_size=sizes.get("data", 1), fsdp=fsdp)
            out[n] = spec[1:] if group_of(n)[1] else spec
    return out


def batch_axes(mesh) -> tuple:
    """Axis names over which the global batch is sharded (DP incl. pod)."""
    sizes = mesh_shape(mesh)
    return tuple(n for n in ("pod", "data") if n in sizes)


def data_spec(mesh, ndim: int) -> tuple:
    """Spec of ``(B, ...)`` host data: the batch over ``(pod, data)``."""
    return (batch_axes(mesh), *([None] * (ndim - 1)))


def cache_spec(cfg, mesh, batch: int) -> dict:
    """Decode-cache specs: the batch over the DP axes if it divides, else
    the *sequence* dim over them (the long_500k B=1 sequence-parallel
    case); KV heads over ``model`` when divisible."""
    sizes = mesh_shape(mesh)
    dp = batch_axes(mesh)
    dp_size = math.prod(sizes[a] for a in dp) if dp else 1
    model_size = sizes.get("model", 1)
    batch_ok = dp and batch % dp_size == 0
    kv_ok = cfg.n_kv_heads % model_size == 0
    b_ax = dp if batch_ok else None
    s_ax = None if batch_ok else (dp if dp else None)
    h_ax = "model" if kv_ok and "model" in sizes else None
    attn = (None, b_ax, s_ax, h_ax, None)          # (L, B, S, KV, hd)
    conv = (None, b_ax, None, "model") \
        if (cfg.d_inner + 2 * cfg.ssm_state) % max(model_size, 1) == 0 \
        else (None, b_ax, None, None)
    ssm = (None, b_ax, None, None, None)
    return dict(attn=attn, conv=conv, ssm=ssm, batch_sharded=batch_ok)


def _axes(entry) -> tuple:
    """The axis names of one spec entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec, mesh) -> tuple:
    """The ``DTensor`` placements of ``spec`` on ``mesh`` (a
    ``DeviceMesh``): each mesh dim the spec names at tensor dim ``d``
    becomes ``Shard(d)``, every other one ``Replicate()``.  Mesh dims that
    shard one tensor dim split it in mesh-dim order, so ``("pod",
    "data")`` is JAX's major-to-minor; axes the mesh lacks are size 1."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    at = {}
    for d, entry in enumerate(spec):
        axes = [a for a in _axes(entry) if a in names]
        if axes != sorted(axes, key=names.index):
            raise ValueError(f"spec {spec}: dim {d} names {tuple(axes)} "
                             f"against the mesh's order {names}")
        for a in axes:
            if a in at:
                raise ValueError(f"spec {spec} names {a!r} twice")
            at[a] = d
    return tuple(Shard(at[n]) if n in at else Replicate() for n in names)


def local_block(t: torch.Tensor, mesh, pls) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` under placements
    ``pls`` (a view; the rules shard only dims the mesh dims divide)."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    for i, pl in enumerate(pls):
        if isinstance(pl, Shard):
            size = mesh.size(i)
            if t.shape[pl.dim] % size:
                raise ValueError(f"dim {pl.dim} of {tuple(t.shape)} does not "
                                 f"split over {size} ranks")
            t = t.chunk(size, pl.dim)[coord[i]]
    return t


def _dtensor(t: torch.Tensor, mesh, pls):
    from torch.distributed.tensor import DTensor, Shard

    local = local_block(t, mesh, pls)
    if any(isinstance(pl, Shard) and mesh.size(i) > 1
           for i, pl in enumerate(pls)):
        local = local.clone()      # the whole tensor is not kept
    return DTensor.from_local(local, mesh, pls, run_check=False)


def _uses(model: nn.Module, specs: dict, model_size: int) -> tuple:
    """How the train mode reads each weight (``"shard"``, ``"partial"`` or
    ``"full"``, :mod:`repro_torch.models.parallel`), and which modules run
    on their ``model`` split: ``{name: use}``, ``[module]``."""
    uses = {n: "full" for n, _ in model.named_parameters()}
    split = []
    if model_size == 1:
        return uses, split
    for prefix, mod in model.named_modules():
        pre = f"{prefix}." if prefix else ""
        on = lambda leaf, d: "model" in _axes(specs[pre + leaf][d])
        if isinstance(mod, Attention):
            ok = mod.cfg.n_heads % model_size == 0 and on("wq", -1) \
                and on("wo", -2)
            if ok:
                kv = "shard" if mod.cfg.n_kv_heads % model_size == 0 \
                    and on("wk", -1) else "partial"
                uses.update({pre + "wq": "shard", pre + "wo": "shard",
                             pre + "wk": kv, pre + "wv": kv})
        elif isinstance(mod, MLP):
            leaves = [n for n, _ in mod.named_parameters()]
            ok = all(on(n, -2 if n == "w_down" else -1) for n in leaves)
            if ok:
                uses.update({pre + n: "shard" for n in leaves})
        elif isinstance(mod, MoE):
            experts = [n for n in ("w_gate", "w_up", "w_down")
                       if hasattr(mod, n)]
            ok = all(on(n, 0) for n in experts)
            if ok:
                uses.update({pre + n: "shard" for n in experts})
        elif isinstance(mod, Mamba2):
            ok = mod.cfg.ssm_heads % model_size == 0 and on("out_proj", 0)
            if ok:
                uses.update({pre + n: "partial"
                             for n, _ in mod.named_parameters()})
                uses[pre + "out_proj"] = "shard"
        else:
            continue
        if ok:
            split.append(mod)
    for n, d in (("embed", 0), ("unembed", 1)):    # the vocab dims
        if n in uses and "model" in _axes(specs[n][d]):
            uses[n] = "shard"
    return uses, split


def place(model_or_tensors, mesh, specs: dict):
    """The reference's ``place``: each tensor a ``DTensor`` on ``mesh``
    (a ``DeviceMesh``) holding this rank's block of it under
    :func:`placements` of its spec.

    A dict ``{name: tensor}`` comes back as ``{name: DTensor}``.  A model's
    parameters are replaced in place (every rank holds the same whole
    weights, from the same seed or file, and keeps its block), and the
    model records how its train mode reads them (``model.placed``, a
    :class:`repro_torch.models.parallel.Placed`); its attention, MLP, MoE
    and mamba modules whose split over ``model`` falls on heads, ``d_ff``
    or experts get ``tp``, and its MoE modules ``dp``.  Returns the model
    or the dict."""
    if not isinstance(model_or_tensors, nn.Module):
        return {n: _dtensor(t, mesh, placements(specs[n], mesh))
                for n, t in model_or_tensors.items()}
    model = model_or_tensors
    if getattr(model, "placed", None) is not None:
        raise ValueError("the model is placed already")
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        model.get_submodule(owner)._parameters[leaf] = nn.Parameter(
            _dtensor(p.detach(), mesh, placements(specs[name], mesh)),
            requires_grad=p.requires_grad)
    names = tuple(mesh.mesh_dim_names)
    size = mesh.size(names.index("model")) if "model" in names else 1
    uses, split = _uses(model, specs, size)
    model.placed = Placed(mesh, uses)
    for mod in split:
        mod.tp = model.placed.model
    for mod in model.modules():
        if isinstance(mod, MoE):
            mod.dp = model.placed.batch
        if isinstance(mod, Mamba2) and size > 1 and \
                (mod.cfg.d_inner + 2 * mod.cfg.ssm_state) % size == 0:
            mod.conv_ax = model.placed.model   # cache_spec's conv split
    return model


CACHE_KINDS = {"k": "attn", "v": "attn", "enc_k": "attn", "enc_v": "attn",
               "conv": "conv", "ssm": "ssm"}


def cache_leaf_specs(cfg, mesh, batch: int, cache: dict) -> dict:
    """``{key: spec}`` (a dict for a dict of leaves) of a decode cache's
    leaves by :func:`cache_spec` (``"len"``: ``()``)."""
    cs = cache_spec(cfg, mesh, batch)
    out = {}
    for key, val in cache.items():
        if isinstance(val, dict):
            out[key] = {n: cs[CACHE_KINDS[n]] for n in val}
        elif isinstance(val, torch.Tensor):
            out[key] = cs[CACHE_KINDS[key]]
        else:
            out[key] = ()
    return out


def place_cache(cache: dict, mesh, cfg, batch: int) -> dict:
    """The decode ``cache`` (a model's ``init_cache`` or what its prefill
    returns, extended or not) with each leaf this rank's block on
    :func:`cache_spec` of the global ``batch``, ``"len"`` as it is.

    A leaf may come whole, or already the rank's block along the dims a
    placed prefill splits (its rows, KV heads, conv channels): a dim of
    the whole size (``batch``, ``n_kv_heads``, ``d_inner + 2 N``) is cut
    to the rank's block, one of the block's size kept.  The sequence
    (split only where the batch does not divide the batch axes) always
    comes whole.  A leaf that is cut is copied, so the whole is not kept
    and the decode's writes stay the rank's."""
    names = tuple(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    specs = cache_leaf_specs(cfg, mesh, batch, cache)

    def one(name, x, spec):
        whole = {1: batch, 2: x.shape[2],
                 3: cfg.n_kv_heads if CACHE_KINDS[name] == "attn"
                 else cfg.d_inner + 2 * cfg.ssm_state}
        out = x
        for d, entry in enumerate(spec):
            axes = [a for a in _axes(entry) if a in names]
            n = math.prod(mesh.size(names.index(a)) for a in axes)
            if n == 1:
                continue
            k = 0
            for a in axes:
                k = k * mesh.size(names.index(a)) + coord[names.index(a)]
            if x.shape[d] == whole[d]:
                if whole[d] % n:
                    raise ValueError(f"cache leaf {name}: dim {d} of "
                                     f"{tuple(x.shape)} does not split over "
                                     f"{n} ranks")
                out = out.chunk(n, d)[k]
            elif x.shape[d] * n != whole[d]:
                raise ValueError(f"cache leaf {name}: dim {d} of "
                                 f"{tuple(x.shape)} is neither {whole[d]} "
                                 f"nor its block over {n} ranks")
        return out if out is x else out.clone()

    placed = {}
    for key, val in cache.items():
        if isinstance(val, dict):
            placed[key] = {n: one(n, x, specs[key][n]) for n, x in val.items()}
        elif isinstance(val, torch.Tensor):
            placed[key] = one(key, val, specs[key])
        else:
            placed[key] = val
    return placed


def batch_split(mesh, batch: int) -> bool:
    """Whether a serving batch of ``batch`` rows splits over the batch
    axes (:func:`cache_spec`'s ``batch_sharded``; a mesh without them
    counts as one rank)."""
    sizes = mesh_shape(mesh)
    return batch % math.prod(sizes[a] for a in batch_axes(mesh)) == 0


def batch_rows(batch: dict, mesh, n_microbatches: int = 1) -> dict:
    """This rank's rows of the global ``batch`` (``{name: (B, ...)}``, the
    same on every rank): the batch's counterpart of :func:`data_spec`.
    Microbatch ``i`` is global rows ``[i B / n, (i + 1) B / n)``, the
    reference's ``reshape(n, B / n, ...)``, and the rank keeps its ``1 /
    dp`` of each (over the batch axes, major to minor), so that its
    ``i``-th chunk of ``B / (n dp)`` rows is its share of microbatch
    ``i``."""
    names = tuple(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    k, dp = 0, 1
    for a in batch_axes(mesh):
        i = names.index(a)
        k, dp = k * mesh.size(i) + coord[i], dp * mesh.size(i)
    out = {}
    for key, x in batch.items():
        b = x.shape[0]
        if b % (n_microbatches * dp):
            raise ValueError(f"a batch of {b} does not split into "
                             f"{n_microbatches} microbatches over {dp} "
                             f"batch ranks")
        rows = x.reshape(n_microbatches, dp, b // (n_microbatches * dp),
                         *x.shape[1:])[:, k]
        out[key] = rows.reshape(-1, *x.shape[1:])
    return out
