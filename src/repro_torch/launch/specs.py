"""Abstract inputs of every (arch x shape x mesh) cell, on the ``meta``
device.

Counterpart of :mod:`repro.launch.specs`.  Where the reference builds
``jax.ShapeDtypeStruct`` trees with ``eval_shape``, the port builds the
model, its optimizer state, the batch and the decode cache on PyTorch's
``meta`` device: every shape and dtype, no memory, no data.  Specs are
the rules of :mod:`repro_torch.train.sharding` (tuples of axis names).
The same builders size the full configs without allocating them:
:func:`state_bytes` is what a trainer holds before its activations, and
:func:`rank_bytes` what one rank of a mesh holds of it under given specs.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs import get_config, get_train_config
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.models import DecoderLM, WhisperModel
from repro_torch.train import sharding as shd
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.steps import acc_dtype

META = torch.device("meta")


def dp_size(mesh) -> int:
    sizes = shd.mesh_shape(mesh)
    return math.prod(sizes[a] for a in shd.batch_axes(mesh))


def n_microbatches(arch: str, shape: ShapeConfig, mesh) -> int:
    tcfg = get_train_config(arch)
    per_dev = shape.global_batch // dp_size(mesh)
    return max(per_dev // max(tcfg.microbatch, 1), 1)


def _replicated(tensors: dict) -> dict:
    return {n: (None,) * t.dim() for n, t in tensors.items()}


def meta_model(cfg):
    """The model of ``cfg`` on the meta device (no weights)."""
    cls = WhisperModel if cfg.family == "encdec" else DecoderLM
    return cls(cfg, device=META)


def param_specs(arch: str, mesh, *, fsdp: bool = True):
    """``(model, params, specs)``: the meta model of ``arch``, ``{name:
    meta tensor}`` and ``{name: spec}`` (replicated where
    ``TrainConfig.replicate_params``)."""
    model = meta_model(get_config(arch))
    params = dict(model.named_parameters())
    specs = _replicated(params) if get_train_config(arch).replicate_params \
        else shd.infer_param_specs(params, mesh, fsdp=fsdp)
    return model, params, specs


def opt_specs(arch: str, mesh, model, *, fsdp: bool = True):
    """``(state, specs)``: the optimizer state of the meta ``model`` by
    ``TrainConfig.optimizer`` (``{"master", "m", "v"}`` or ``{"master",
    "vr", "vc"}`` of meta tensors) and its specs, keyed alike."""
    tcfg = get_train_config(arch)
    state = init_opt_state(model, tcfg)
    flat = {f"{k}.{n}": t for k, d in state.items() for n, t in d.items()}
    specs = _replicated(flat) if tcfg.replicate_params \
        else shd.infer_param_specs(flat, mesh, fsdp=fsdp)
    return state, {k: {n: specs[f"{k}.{n}"] for n in d}
                   for k, d in state.items()}


def batch_specs(arch: str, shape: ShapeConfig, mesh=None) -> dict:
    """The train or prefill batch: tokens / labels int32 ``(B, T)`` (the
    vlm's tokens ``(B, T - n_patches)``) and the vlm's patches or the
    encdec's frames ``(B, n, d)`` bf16, under ``"patches"``."""
    cfg = get_config(arch)
    b, t = shape.global_batch, shape.seq_len
    i32 = dict(dtype=torch.int32, device=META)
    bf16 = dict(dtype=torch.bfloat16, device=META)
    out = {"tokens": torch.empty((b, t), **i32),
           "labels": torch.empty((b, t), **i32)}
    if cfg.family == "vlm":
        out["tokens"] = torch.empty((b, t - cfg.n_patches), **i32)
        out["patches"] = torch.empty((b, cfg.n_patches, cfg.d_model), **bf16)
    elif cfg.family == "encdec":
        out["patches"] = torch.empty((b, cfg.encoder_len, cfg.d_model),
                                     **bf16)
    return out


def cache_specs(arch: str, shape: ShapeConfig, mesh) -> tuple:
    """``(cache, specs)``: the decode cache of ``shape``'s batch and
    length on the meta device (the model's ``init_cache``: the weights'
    dtype, the SSD state f32) and each leaf's spec."""
    cfg = get_config(arch)
    cache = meta_model(cfg).init_cache(shape.global_batch, shape.seq_len)
    return cache, shd.cache_leaf_specs(cfg, mesh, shape.global_batch, cache)


def decode_token_specs(arch: str, shape: ShapeConfig, mesh) -> tuple:
    """``(token (B, 1) int32 on meta, its spec)``."""
    b = shape.global_batch
    dp = dp_size(mesh)
    spec = shd.data_spec(mesh, 2) if b % dp == 0 and b >= dp \
        else (None, None)
    return torch.empty((b, 1), dtype=torch.int32, device=META), spec


def input_specs(arch: str, shape_name: str, mesh) -> dict:
    """Every abstract input of the cell's step, by kind."""
    shape = SHAPES[shape_name]
    model, params, pspecs = param_specs(arch, mesh)
    out = dict(model=model, params=params, param_specs=pspecs, shape=shape)
    if shape.kind == "train":
        out["opt"], out["opt_specs"] = opt_specs(arch, mesh, model)
        out["batch"] = batch_specs(arch, shape, mesh)
        out["step"] = 0
        out["n_micro"] = n_microbatches(arch, shape, mesh)
    elif shape.kind == "prefill":
        out["batch"] = batch_specs(arch, shape, mesh)
    else:
        out["cache"], out["cache_specs"] = cache_specs(arch, shape, mesh)
        out["token"], out["token_spec"] = decode_token_specs(arch, shape,
                                                             mesh)
    return out


def state_bytes(model, opt_state: dict, tcfg) -> dict:
    """What a trainer of ``model`` (meta or real) holds before its
    activations: the weights, the optimizer state and one gradient a
    weight in the accumulator's dtype, in bytes."""
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    params = list(model.parameters())
    grads = sum(p.numel() for p in params) * acc_dtype(tcfg).itemsize
    out = dict(params=nbytes(params),
               opt_state=sum(nbytes(d.values()) for d in opt_state.values()),
               grads=grads)
    out["total"] = sum(out.values())
    return out


def rank_bytes(model, opt_state: dict, tcfg, mesh, param_specs: dict,
               opt_specs: dict) -> dict:
    """:func:`state_bytes` of one rank of ``mesh`` (a mapping of axis
    sizes or a ``DeviceMesh``) when the weights lie on ``param_specs`` and
    the optimizer state on ``opt_specs`` (keyed as ``opt_state``): each
    tensor's local block, a dim named by axes divided by their sizes (the
    rules split only dims they divide); one gradient a weight on its
    weight's block, in the accumulator's dtype."""
    sizes = shd.mesh_shape(mesh)

    def local(t, spec) -> int:
        n = t.numel()
        for entry in spec:
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                n //= sizes.get(a, 1)
        return n

    named = dict(model.named_parameters())
    params = sum(local(p, param_specs[n]) * p.element_size()
                 for n, p in named.items())
    opt = sum(local(t, opt_specs[k][n]) * t.element_size()
              for k, d in opt_state.items() for n, t in d.items())
    grads = sum(local(p, param_specs[n]) for n, p in named.items()) \
        * acc_dtype(tcfg).itemsize
    return dict(params=params, opt_state=opt, grads=grads,
                total=params + opt + grads)
