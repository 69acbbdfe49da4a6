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
Placing tensors by these specs over a ``torch.distributed`` world is not
ported yet (ROADMAP queue 1 item 16).
"""

from __future__ import annotations

import math
from collections.abc import Mapping

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
