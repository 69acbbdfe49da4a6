"""Tensor, expert and data parallelism inside the train mode.

The reference writes no collective: GSPMD derives them from the weights'
``PartitionSpec`` objects.  The port writes each one, Megatron-style, on the
local shards of a model placed by :func:`repro_torch.train.sharding.place`:

* :class:`Axis` is a group of ranks that one collective spans: the mesh's
  ``model`` dim, or its batch dims (``pod``, ``data``) flattened;
* :func:`copy_to` (identity forward, all-reduce backward) where a tensor
  replicated over ``model`` enters a product with local shards, whose
  gradients are then partial sums; :func:`reduce_from` (all-reduce
  forward, identity backward) where partial sums leave it, and wherever a
  sum over ranks feeds values that every rank holds alike (the loss, the
  MoE statistics); :func:`all_reduce` (all-reduce both ways) where the
  sum feeds partial work again (mamba's norm over the split ``d_inner``);
  :func:`all_max` for the softmax's max, which takes no gradient;
  :func:`all_gather` (serving only, no gradient) where the ranks' slices
  of a dim are put back together: the logits' vocab and rows, mamba's
  heads and conv channels for the decode cache;
* :class:`Placed` records, on the model, how each weight is stored (a
  ``DTensor``'s placements) and how the compute reads it:

  - ``"shard"``: its ``model`` split kept (a TP or EP shard, a vocab
    slice), the gradient exact for that shard;
  - ``"partial"``: gathered over ``model`` and read by a tensor-parallel
    region, whose gradient on each rank is a partial sum;
  - ``"full"``: gathered over ``model`` and read by replicated compute,
    whose gradient every rank of ``model`` computes alike.

  Every weight is gathered over the batch dims (FSDP) before use; its
  gradient is a partial sum over them, reduce-scattered back onto its
  shard (or all-reduced where it is replicated) by the gather's backward.

A module's ``tp`` attribute (``None`` unless placed over a ``model`` dim of
size > 1 whose split that module can run on) switches it to the local
compute; ``dp`` is the batch axis a MoE's statistics reduce over.

Prefill and decode run on the same local shards, without remat and
without autograd, the batch's rows split over the batch dims where they
divide (:meth:`Placed.serving`).  Where they do not (the long_500k cell's
B = 1), every rank of the batch dims holds the whole batch, and the decode
cache's *sequence* lies over those dims instead: an attention module's
``sp`` is then the batch :class:`Axis`, over which its decode softmax is
combined.
"""

from __future__ import annotations

import contextlib
import functools
import math

import torch
import torch.distributed as dist

BATCH_AXES = ("pod", "data")
MESH_AXES = (*BATCH_AXES, "model")


class Axis:
    """The ranks one collective spans: ``group``, its ``size`` and this
    rank's index in it."""

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, size, rank


def _reduce(x: torch.Tensor, axis: Axis, op=dist.ReduceOp.SUM):
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=axis.group)
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.axis), None


def copy_to(x: torch.Tensor, axis: Axis | None) -> torch.Tensor:
    """Megatron's ``f``: ``x`` as it is; its gradient summed over ``axis``."""
    return x if axis is None else _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis: Axis | None) -> torch.Tensor:
    """Megatron's ``g``: ``x`` summed over ``axis``; its gradient as it is
    (every rank holds the sum's gradient whole)."""
    return x if axis is None else _ReduceFrom.apply(x, axis)


def all_reduce(x: torch.Tensor, axis: Axis | None) -> torch.Tensor:
    """``x`` summed over ``axis``, its gradient summed too (the sum feeds
    work whose gradients are partial on each rank)."""
    return x if axis is None else _AllReduce.apply(x, axis)


def all_max(x: torch.Tensor, axis: Axis | None) -> torch.Tensor:
    """The elementwise max over ``axis``, without gradient."""
    return x if axis is None else _reduce(x.detach(), axis,
                                          dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, axis: Axis | None,
               dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order (no
    gradient; ``x`` itself where ``axis`` is None)."""
    if axis is None:
        return x
    x = x.detach().contiguous()
    out = x.new_empty((axis.size * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=axis.group)
    dim = dim % x.dim()
    if dim == 0:
        return out
    return out.view(axis.size, *x.shape).movedim(0, dim).flatten(dim, dim + 1)


def rms_norm_split(w: torch.Tensor, x: torch.Tensor, n: int, axis: Axis,
                   eps: float = 1e-5) -> torch.Tensor:
    """:func:`repro_torch.models.layers.rms_norm` over a last dim of ``n``
    entries split over ``axis``: ``x`` and ``w`` are this rank's slice; the
    sum of squares is all-reduced."""
    dt = x.dtype
    x = x.float()
    ss = all_reduce((x * x).sum(-1, keepdim=True), axis)
    x = x * torch.rsqrt(ss / n + eps)
    return (x * w.float()).to(dt)


def embed_lookup(tokens: torch.Tensor, w: torch.Tensor,
                 axis: Axis | None) -> torch.Tensor:
    """``embedding(tokens, w)``; under ``axis`` ``w`` is this rank's slice
    of the vocab (rank ``r`` holds rows ``[r V_l, (r + 1) V_l)``): tokens
    outside it look up zeros, and the ranks' rows are summed."""
    if axis is None:
        return torch.nn.functional.embedding(tokens, w)
    n = w.shape[0]
    local = tokens - axis.rank * n
    out = (local < 0) | (local >= n)
    e = torch.nn.functional.embedding(local.masked_fill(out, 0), w)
    return reduce_from(e.masked_fill(out[..., None], 0), axis)


@contextlib.contextmanager
def swapped(module: torch.nn.Module, tensors: dict):
    """``module``'s parameters named in ``tensors`` (dotted, relative)
    replaced by those tensors for the block's duration."""
    saved = []
    try:
        for name, t in tensors.items():
            owner, _, leaf = name.rpartition(".")
            mod = module.get_submodule(owner)
            saved.append((mod, leaf, mod._parameters[leaf]))
            mod._parameters[leaf] = t
        yield module
    finally:
        for mod, leaf, p in reversed(saved):
            mod._parameters[leaf] = p


class Placed:
    """How a placed model's weights lie on ``mesh`` and how its compute
    reads them (module docstring).  ``uses`` is keyed by parameter name;
    ``model`` is the ``model`` dim's :class:`Axis`, ``batch`` the batch
    dims', ``world`` every dim's (each None where the mesh has none of
    those dims; an axis of one rank issues collectives that copy)."""

    def __init__(self, mesh, uses: dict):
        names = tuple(mesh.mesh_dim_names)
        unknown = set(names) - set(MESH_AXES)
        if unknown:
            raise ValueError(f"mesh dims {sorted(unknown)}: a train mesh "
                             f"names {MESH_AXES} only")
        self.mesh, self.dims, self.uses = mesh, names, uses
        self.model = self._axis(("model",))
        self.batch = self._axis(BATCH_AXES)
        self.world = self._axis(MESH_AXES)
        # the vocab-parallel lookup and loss, where embed / unembed keep
        # their vocab split
        vocab = lambda n: self.model if uses.get(n) == "shard" else None
        self.embed_tp = vocab("embed")
        self.unembed_tp = vocab("unembed") if "unembed" in uses \
            else self.embed_tp
        self.coord = mesh.get_coordinate()

    @contextlib.contextmanager
    def serving(self, model: torch.nn.Module, split: bool):
        """Prefill and decode of a batch whose rows are split over the
        batch axis (``split``) or held whole by every rank of it: MoE
        groups count the batch axis's tokens only where they are split
        (``dp``), and attention reads a decode cache whose sequence lies
        over that axis where they are not (``sp``)."""
        from repro_torch.models.attention import Attention
        from repro_torch.models.moe import MoE

        moes = [m for m in model.modules() if isinstance(m, MoE)]
        attns = [m for m in model.modules() if isinstance(m, Attention)]
        try:
            for m in moes:
                m.dp = self.batch if split else None
            for m in attns:
                m.sp = None if split else self.batch
            yield self
        finally:
            for m in moes:
                m.dp = self.batch      # as place leaves it, for training
            for m in attns:
                m.sp = None

    def owns(self, pls) -> bool:
        """Whether this rank's block of a tensor of placements ``pls`` is
        the one a sum over the world counts: its coordinate is 0 on every
        dim the tensor is replicated over."""
        from torch.distributed.tensor import Replicate

        return all(self.coord[i] == 0 for i, pl in enumerate(pls)
                   if isinstance(pl, Replicate))

    def _axis(self, dims: tuple) -> Axis | None:
        """The :class:`Axis` over the mesh's ``dims`` (flattened, major to
        minor), None where the mesh has none of them."""
        dims = tuple(d for d in self.dims if d in dims)
        if not dims:
            return None
        size = math.prod(self.mesh.size(self.dims.index(d)) for d in dims)
        sub = self.mesh if dims == self.dims else self.mesh[dims]
        if len(dims) > 1:
            sub = sub._flatten("_".join(dims))
        return Axis(sub.get_group(), size, sub.get_local_rank())

    def local(self, module: torch.nn.Module, prefix: str,
              names=None) -> dict:
        """``{relative name: local tensor}`` of ``module``'s parameters (or
        those ``names``) gathered as their uses ask, differentiably: the
        backward returns each gradient onto its parameter's placements."""
        from torch.distributed.tensor import Partial, Replicate

        out = {}
        params = dict(module.named_parameters()) if names is None else \
            {n: module.get_parameter(n) for n in names}
        for rel, p in params.items():
            name = prefix + rel
            use = self.uses[name]
            want, grad = [], []
            for dim, pl in zip(self.dims, p.placements):
                if dim != "model":
                    want.append(Replicate())
                    grad.append(Partial())
                elif use == "shard":
                    want.append(pl)
                    grad.append(pl)
                else:
                    want.append(Replicate())
                    grad.append(Partial() if use == "partial"
                                else Replicate())
            out[rel] = p.redistribute(self.mesh, want).to_local(
                grad_placements=grad)
        return out

    @contextlib.contextmanager
    def gathered(self, module: torch.nn.Module, prefix: str, names=None):
        """``module`` with its parameters (or those ``names``) swapped for
        their gathered local tensors (:meth:`local`) inside the block; the
        gathered tensors are freed when the block's autograd graph is."""
        with swapped(module, self.local(module, prefix, names)):
            yield module

    def run(self, module: torch.nn.Module, prefix: str, names, method: str,
            *args, **kwargs):
        """``module.<method>(*args, **kwargs)`` on its gathered parameters:
        the function a block's remat wraps, so that its recompute gathers
        them again."""
        with self.gathered(module, prefix, names):
            return getattr(module, method)(*args, **kwargs)


def gathered(placed: Placed | None, module: torch.nn.Module, prefix: str,
             names=None):
    """:meth:`Placed.gathered`, or nothing to do on an unplaced model."""
    if placed is None:
        return contextlib.nullcontext(module)
    return placed.gathered(module, prefix, names)


def block_fn(placed: Placed | None, module: torch.nn.Module, prefix: str,
             method: str = "forward", names=None):
    """``module``'s ``method``, run on its gathered parameters where the
    model is placed (:meth:`Placed.run`)."""
    if placed is None:
        return getattr(module, method)
    return functools.partial(placed.run, module, prefix, names, method)
