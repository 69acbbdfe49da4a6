"""Mixture-of-Experts layer (GShard/Switch-style capacity dispatch).

Counterpart of :mod:`repro.models.moe`, plain torch as the reference is
plain ``jnp``: tokens are cut into groups of ``s`` and routed to their
top-k experts, each expert taking at most ``capacity`` tokens of a group
(the rest drop: their slot adds nothing).  The dispatch and combine
tensors are built slot by slot, so the peak intermediate is ``(G, s, E,
C)``, and the experts run as batched einsums over the ``E`` axis.

Which tokens drop is decided by integers (the top-k experts and the
running per-expert counts), so it matches the reference exactly:

* top-k is a stable descending sort, so ties go to the lower expert
  index, as ``jax.lax.top_k`` breaks them (``torch.topk`` promises no
  order among equal values);
* positions are the reference's f32 cumsum of one-hot rows (exact
  integers), ``keep = pos < capacity``.

Aux outputs: the Switch load-balance loss and the router z-loss, returned
beside ``y`` (serving drops them; training weights them in).

On a placed model (:mod:`repro_torch.models.parallel`) the router runs
on every rank of the ``model`` axis alike; with ``tp`` each rank holds
``E / model`` experts (EP) and computes their share of the output, summed
over the axis.  With ``dp`` (the batch axes) the group size comes from the
global token count, a rank's tokens must split into whole groups, and the
aux losses are those of every rank's tokens: ``me`` and ``ce`` summed
over the batch axes before their product, the z-loss's mean global.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.layers import init_, weight
from repro_torch.models.parallel import copy_to, reduce_from


class MoE(nn.Module):
    """``router`` f32 ``(d, E)``; ``w_up`` (and ``w_gate`` for swiglu)
    ``(E, d, f)``, ``w_down`` ``(E, f, d)`` in the model dtype."""

    def __init__(self, cfg, dtype: torch.dtype, device):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.cfg = cfg
        self.tp = self.dp = None
        self.router = weight((d, e), torch.float32, device)
        self.w_up = weight((e, d, f), dtype, device)
        self.w_down = weight((e, f, d), dtype, device)
        if cfg.mlp_type == "swiglu":
            self.w_gate = weight((e, d, f), dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        # the reference's explicit scales: fan-in d (f for w_down), not the
        # leading E the default would take
        d, f = self.cfg.d_model, self.cfg.d_ff
        init_(self.router, generator, scale=d ** -0.5)
        init_(self.w_up, generator, scale=d ** -0.5)
        init_(self.w_down, generator, scale=f ** -0.5)
        if self.cfg.mlp_type == "swiglu":
            init_(self.w_gate, generator, scale=d ** -0.5)

    def forward(self, x: torch.Tensor):
        return apply_moe(self, x, self.cfg)


def _capacity(s: int, top_k: int, n_experts: int, factor: float) -> int:
    """Tokens an expert takes from a group of ``s``: dropless (``s``) when
    ``s * top_k <= 256`` (every decode step), else ``s * top_k * factor /
    E`` rounded down, at least 1."""
    if s * top_k <= 256:
        return s
    return max(1, int(s * top_k * factor / n_experts))


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last dim: the k largest values, ties to
    the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def apply_moe(p: MoE, x: torch.Tensor, cfg):
    """x: (B, T, d) -> ``(y, aux)``, aux = ``{"load_balance_loss",
    "router_z_loss"}`` (f32 scalars)."""
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    tp, dp = p.tp, p.dp
    ranks = 1 if dp is None else dp.size
    s = min(cfg.moe_group_size, b * t * ranks)
    tokens = x.reshape(-1, d)
    n_tok = tokens.shape[0]
    pad = (-n_tok) % s
    if pad and ranks > 1:
        raise ValueError(
            f"MoE over {ranks} batch ranks: a rank's {b} x {t} = {n_tok} "
            f"tokens do not split into groups of {s} (moe_group_size "
            f"{cfg.moe_group_size}, {b * t * ranks} tokens in all); a group "
            f"across ranks would route with another capacity")
    if pad:   # zero rows to a full group; they route too, and go below
        tokens = torch.cat([tokens, tokens.new_zeros((pad, d))])
    g = tokens.shape[0] // s
    xg = tokens.view(g, s, d)
    c = _capacity(s, k, e, cfg.capacity_factor)

    logits = xg.float() @ p.router                               # (G,S,E)
    probs = torch.softmax(logits, dim=-1)
    gates, experts = _top_k(probs, k)                            # (G,S,k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # aux losses on slot-0 statistics, Switch-style
    me = probs.mean(dim=(0, 1))                                  # (E,)
    ce = nn.functional.one_hot(experts[..., 0], e).float().mean(dim=(0, 1))
    z = torch.mean(torch.logsumexp(logits, -1) ** 2)
    if dp is not None:    # the means over every rank's (equal) token count
        me = reduce_from(me, dp) / ranks
        ce = reduce_from(ce, dp) / ranks
        z = reduce_from(z, dp) / ranks
    aux = {"load_balance_loss": e * torch.sum(me * ce), "router_z_loss": z}

    slots = torch.arange(c, device=x.device, dtype=torch.float32)
    dispatch = torch.zeros((g, s, e, c), dtype=torch.float32,
                           device=x.device)
    combine = torch.zeros_like(dispatch)
    counts = torch.zeros((g, e), dtype=torch.float32, device=x.device)
    for slot in range(k):
        m = nn.functional.one_hot(experts[..., slot], e).float()  # (G,S,E)
        pos = counts[:, None, :] + torch.cumsum(m, dim=1) - m    # 0-based
        keep = (pos < c) * m
        sl = (pos[..., None] == slots).float() * keep[..., None]
        dispatch += sl
        combine += sl * gates[..., slot, None, None]
        counts += m.sum(dim=1)

    dt = x.dtype
    if tp is not None:    # this rank's experts; the others' add elsewhere
        lo = tp.rank * p.w_up.shape[0]
        sl = slice(lo, lo + p.w_up.shape[0])
        dispatch = dispatch[:, :, sl]
        combine = copy_to(combine, tp)[:, :, sl]
        xg = copy_to(xg, tp)
    xe = torch.einsum("gsec,gsd->egcd", dispatch.to(dt), xg)
    up = torch.einsum("egcd,edf->egcf", xe, p.w_up)
    if cfg.mlp_type == "swiglu":
        h = nn.functional.silu(torch.einsum("egcd,edf->egcf", xe, p.w_gate)) \
            * up
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = nn.functional.gelu(up, approximate="tanh")
    ye = torch.einsum("egcf,efd->egcd", h, p.w_down)
    y = reduce_from(torch.einsum("gsec,egcd->gsd", combine.to(dt), ye), tp)
    return y.reshape(-1, d)[:n_tok].view(b, t, d), aux
