"""Shared primitives: init, norms (RMS, layer), rotary embeddings, MLPs,
and per-layer remat for the train mode.

Counterpart of :mod:`repro.models.layers`.  Weights keep the reference's
``x @ W`` layout, ``(d_in, d_out)``, so a weight carries over from the JAX
package unchanged (:mod:`repro_torch.models.convert`).
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.models.parallel import copy_to, reduce_from

REMAT = ("full", "dots", "none")
# the plain 2-D products (``x @ W`` lowers to ``mm``): what the
# reference's ``dots_with_no_batch_dims_saveable`` keeps; batched ones
# (``bmm`` of the einsums) are recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def init_(w: torch.Tensor, generator: torch.Generator,
          scale: float | None = None) -> torch.Tensor:
    """Truncated-normal fan-in init in place: a standard normal cut at
    +-2, drawn in f32 on ``generator``, times ``scale`` (default
    ``fan_in ** -0.5``, fan-in the leading dim), then cast to ``w``'s
    dtype.  The reference's distribution; not its numbers.  A tensor of
    more than two dims (the MoE experts' ``(E, d, f)``) is drawn slice by
    slice along its leading dim, so the f32 temporary is one slice (an
    arctic expert's 139 MB, not the stack's 17.8 GB)."""
    fan_in = w.shape[0] if w.dim() > 1 else 1
    scale = scale if scale is not None else fan_in ** -0.5
    if w.dim() > 2:
        for part in w:
            init_(part, generator, scale)
        return w
    tmp = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    torch.nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0, generator=generator)
    with torch.no_grad():
        w.copy_(tmp.mul_(scale))
    return w


def weight(shape, dtype: torch.dtype, device) -> nn.Parameter:
    """An uninitialised parameter (filled by ``init_`` or a state dict)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def rms_norm(w: torch.Tensor, x: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMS norm in f32, result in x's dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def layer_norm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm in f32 (biased variance), result in x's dtype."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


class LayerNorm(nn.Module):
    """The reference's ``{"scale", "bias"}`` pair (whisper's norms)."""

    def __init__(self, d: int, dtype: torch.dtype, device, eps: float):
        super().__init__()
        self.eps = eps
        self.scale = weight((d,), dtype, device)
        self.bias = weight((d,), dtype, device)

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(self.scale, self.bias, x, self.eps)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding, split-half convention (the first and second halves
    of the head dim rotate as pairs).  x: (..., T, n_heads, d_head);
    positions: broadcastable to (..., T).  In f32, result in x's dtype."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs             # (..., T, d/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().split(half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _ffn(x: torch.Tensor, w_gate, w_up: torch.Tensor, w_down: torch.Tensor,
         mlp_type: str) -> torch.Tensor:
    up = x @ w_up
    if mlp_type == "swiglu":
        h = torch.nn.functional.silu(x @ w_gate) * up
    elif mlp_type == "relu2":
        h = torch.square(torch.relu(up))
    elif mlp_type == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = torch.nn.functional.gelu(up, approximate="tanh")
    else:
        raise ValueError(f"unknown mlp_type {mlp_type!r}")
    return h @ w_down


def apply_mlp(params, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    """The dense FFN over a mapping of weights (``w_gate`` for swiglu,
    ``w_up``, ``w_down``), the reference's functional form; :class:`MLP`
    runs the same ops on its own weights."""
    return _ffn(x, params["w_gate"] if mlp_type == "swiglu" else None,
                params["w_up"], params["w_down"], mlp_type)


class MLP(nn.Module):
    """Dense FFN: ``swiglu`` (gate, up, down), ``relu2`` (squared ReLU) or
    ``gelu`` (up, down).  With ``tp`` (a placed model's ``model`` axis) the
    weights are this rank's slices of ``d_ff`` and the output is summed
    over the axis."""

    def __init__(self, d_model: int, d_ff: int, mlp_type: str,
                 dtype: torch.dtype, device):
        super().__init__()
        if mlp_type not in ("swiglu", "relu2", "gelu"):
            raise ValueError(f"unknown mlp_type {mlp_type!r}")
        self.mlp_type = mlp_type
        self.tp = None
        if mlp_type == "swiglu":
            self.w_gate = weight((d_model, d_ff), dtype, device)
        self.w_up = weight((d_model, d_ff), dtype, device)
        self.w_down = weight((d_ff, d_model), dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.mlp_type == "swiglu":
            init_(self.w_gate, generator)
        init_(self.w_up, generator)
        init_(self.w_down, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w_gate = self.w_gate if self.mlp_type == "swiglu" else None
        return reduce_from(_ffn(copy_to(x, self.tp), w_gate, self.w_up,
                                self.w_down, self.mlp_type), self.tp)


def _dots_policy(ctx, op, *args, **kwargs):
    return ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn, policy: str, *args, **kwargs):
    """``fn(*args, **kwargs)`` under the reference's per-layer remat
    (``jax.checkpoint``): ``"full"`` saves the inputs alone and recomputes
    the rest in the backward pass, ``"dots"`` also saves the plain 2-D
    products (a selective-checkpoint policy), ``"none"`` runs ``fn`` as it
    is.  Values and gradients are the same bits under every policy."""
    if policy not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {policy!r}")
    if policy == "none":
        return fn(*args, **kwargs)
    context_fn = ckpt.noop_context_fn if policy == "full" else \
        functools.partial(ckpt.create_selective_checkpoint_contexts,
                          _dots_policy)
    return ckpt.checkpoint(fn, *args, use_reentrant=False,
                           context_fn=context_fn, **kwargs)
