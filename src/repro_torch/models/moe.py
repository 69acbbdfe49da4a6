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
global token count and the aux losses are those of every rank's tokens:
``me`` and ``ce`` summed over the batch axes before their product, the
z-loss's mean global.  The groups are the global token list's (the ranks'
tokens in rank order, as on one device).  Where a rank's tokens do not
split into whole groups (a decode step's batch of one token a row, a
group across two ranks' rows), its tokens' places in their experts'
queues are those of the whole list: the ranks' top-k experts are
all-gathered over ``dp`` and queued as on one device, so the same tokens
drop, and each of the rank's tokens is dispatched into its own group's
buffers.  Serving (``aux=False``) computes no aux losses.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.layers import init_, weight
from repro_torch.models.parallel import all_gather, copy_to, reduce_from


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

    def forward(self, x: torch.Tensor, *, aux: bool = True):
        return apply_moe(self, x, self.cfg, aux=aux)


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


def _dispatch_across(experts: torch.Tensor, gates: torch.Tensor,
                     tokens: torch.Tensor, s: int, c: int, e: int, dp):
    """Dispatch and combine ``(Gl, n, E, C)`` of the rank's ``n`` tokens
    (``experts`` / ``gates (n, k)``) over the ``Gl`` global groups of
    ``s`` they fall in, and the tokens ``(Gl, n, d)`` for each: every
    rank's experts all-gathered over ``dp``, then queued group by group,
    slot by slot, as on one device (the zero rows that pad the last group
    come after every token, so they move no token's place)."""
    n, k = experts.shape
    first = dp.rank * n
    allx = all_gather(experts, dp)                               # (R n, k)
    pad = (-allx.shape[0]) % s
    m_all = nn.functional.one_hot(allx, e).float()
    if pad:
        m_all = torch.cat([m_all, m_all.new_zeros((pad, k, e))])
    m_all = m_all.view(-1, s, k, e)
    counts = torch.zeros((m_all.shape[0], e), dtype=torch.float32,
                         device=experts.device)
    pos = torch.empty_like(m_all)
    for slot in range(k):
        m = m_all[:, :, slot]
        pos[:, :, slot] = counts[:, None, :] + torch.cumsum(m, dim=1) - m
        counts += m.sum(dim=1)
    pos = pos.view(-1, k, e)[first:first + n]                    # (n,k,E)
    g0, g1 = first // s, (first + n - 1) // s
    group = (first + torch.arange(n, device=experts.device)) // s - g0
    mine = nn.functional.one_hot(group, g1 - g0 + 1).float().t()  # (Gl,n)
    slots = torch.arange(c, device=experts.device, dtype=torch.float32)
    dispatch = torch.zeros((n, e, c), dtype=torch.float32,
                           device=experts.device)
    combine = torch.zeros_like(dispatch)
    for slot in range(k):
        m = nn.functional.one_hot(experts[:, slot], e).float()
        keep = (pos[:, slot] < c) * m
        sl = (pos[:, slot, :, None] == slots).float() * keep[..., None]
        dispatch += sl
        combine += sl * gates[:, slot, None, None]
    per_group = mine[:, :, None, None]
    return dispatch * per_group, combine * per_group, \
        tokens.expand(mine.shape[0], n, tokens.shape[-1])


def apply_moe(p: MoE, x: torch.Tensor, cfg, *, aux: bool = True):
    """x: (B, T, d) -> ``(y, aux)``, aux = ``{"load_balance_loss",
    "router_z_loss"}`` (f32 scalars), None without ``aux``."""
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    tp, dp = p.tp, p.dp
    ranks = 1 if dp is None else dp.size
    s = min(cfg.moe_group_size, b * t * ranks)
    tokens = x.reshape(-1, d)
    n_tok = tokens.shape[0]
    pad = (-n_tok) % s
    across = ranks > 1 and pad > 0      # groups across the ranks' tokens
    if pad and not across:  # zero rows to a full group; they route too
        tokens = torch.cat([tokens, tokens.new_zeros((pad, d))])
    xg = tokens[None] if across else tokens.view(-1, s, d)
    c = _capacity(s, k, e, cfg.capacity_factor)

    logits = xg.float() @ p.router                               # (G,S,E)
    probs = torch.softmax(logits, dim=-1)
    gates, experts = _top_k(probs, k)                            # (G,S,k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    if aux:   # aux losses on slot-0 statistics, Switch-style
        me = probs.mean(dim=(0, 1))                              # (E,)
        ce = nn.functional.one_hot(experts[..., 0], e).float() \
            .mean(dim=(0, 1))
        z = torch.mean(torch.logsumexp(logits, -1) ** 2)
        if dp is not None:  # the means over every rank's (equal) tokens
            me = reduce_from(me, dp) / ranks
            ce = reduce_from(ce, dp) / ranks
            z = reduce_from(z, dp) / ranks
        if across:  # and over the zero rows that pad the last group
            extra = (-n_tok * ranks) % s
            w = n_tok * ranks / (n_tok * ranks + extra)
            me = me * w + (1 - w) / e
            ce = ce * w + (1 - w) * nn.functional.one_hot(
                torch.zeros((), dtype=torch.long, device=x.device), e)
            z = z * w + (1 - w) * math.log(e) ** 2
        aux = {"load_balance_loss": e * torch.sum(me * ce),
               "router_z_loss": z}
    else:
        aux = None

    slots = torch.arange(c, device=x.device, dtype=torch.float32)
    if across:
        dispatch, combine, xg = _dispatch_across(experts[0], gates[0], xg[0],
                                                 s, c, e, dp)
    else:
        g = xg.shape[0]
        dispatch = torch.zeros((g, s, e, c), dtype=torch.float32,
                               device=x.device)
        combine = torch.zeros_like(dispatch)
        counts = torch.zeros((g, e), dtype=torch.float32, device=x.device)
        for slot in range(k):
            m = nn.functional.one_hot(experts[..., slot], e).float()
            pos = counts[:, None, :] + torch.cumsum(m, dim=1) - m  # 0-based
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
    if across:    # a token's output is in its own group's row, 0 elsewhere
        y = y.sum(0)
    return y.reshape(-1, d)[:n_tok].view(b, t, d), aux
