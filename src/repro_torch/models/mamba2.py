"""Mamba2 (SSD, state-space duality) block: the chunked scan (prefill and
train) and the one-token decode recurrence.

Counterpart of :mod:`repro.models.mamba2`, plain torch as the reference is
plain ``jnp``, everything in f32.  The sequence is cut into chunks of
``L``; within a chunk the recurrence is a masked, decay-weighted
attention-like product, and across chunks a ``(H, P, N)`` state is
carried by a loop over the chunks.  Decode is the recurrence itself:
``S <- a * S + dt * B (x) x``, ``y = C . S + D x``.

Shapes: ``d_inner = expand * d_model``; ``H = d_inner / head_p`` heads of
``P = head_p``; B and C are shared by the heads (one group) with state
size ``N``.  The decode caches are the conv window ``(B, K-1, C)``, the
last ``K - 1`` *pre-conv* rows of ``[x, B, C]`` in the model dtype, and
the SSD state ``(B, H, P, N)`` in f32.

On a placed model with ``tp`` (the ``model`` axis;
:mod:`repro_torch.models.parallel`) a rank runs ``H / model`` heads: its
columns of ``z``, ``x`` and ``dt`` and all of ``B`` and ``C`` out of the
gathered ``in_proj`` (whose split over the axis does not fall on heads),
its channels of the conv and the per-head vectors, the gated norm over
the whole ``d_inner`` (its sum of squares all-reduced), and its rows of
``out_proj``, whose product is summed over the axis.

The decode caches stay on the reference's ``cache_spec``, which is not
the layout the heads' compute reads: ``conv`` splits its ``C`` channels
over ``model`` in contiguous blocks (``conv_ax``, set wherever ``C``
divides, with or without ``tp``), while a rank's heads read their ``x``
channels and the shared ``B``, ``C``; and ``ssm`` holds every head on
every rank.  So the cache moves between the layouts by all-gathers over
``model``, each counted in the dry run
(:mod:`repro_torch.launch.dryrun`): a prefill gathers the heads' ``x``
rows of the conv window (with ``tp``) and their SSD states; a decode step
gathers the conv window's blocks, the new row's ``x`` channels (with
``tp``) and the updated states, and keeps its block of each.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.layers import init_, rms_norm, weight
from repro_torch.models.parallel import (all_gather, copy_to, reduce_from,
                                         rms_norm_split)


class Mamba2(nn.Module):
    """``in_proj (d, 2 d_inner + 2N + H)`` -> ``[z, x, B, C, dt]``, the
    depthwise ``conv_w (K, C)`` / ``conv_b (C,)`` with ``C = d_inner +
    2N``, f32 ``a_log`` / ``dt_bias`` / ``d_skip (H,)``, ``norm_w
    (d_inner,)`` and ``out_proj (d_inner, d)``."""

    def __init__(self, cfg, dtype: torch.dtype, device):
        super().__init__()
        d, n, h = cfg.d_model, cfg.ssm_state, cfg.ssm_heads
        d_inner = cfg.expand * d
        conv_dim = d_inner + 2 * n
        self.cfg = cfg
        self.tp = self.conv_ax = None
        self.in_proj = weight((d, 2 * d_inner + 2 * n + h), dtype, device)
        self.conv_w = weight((cfg.d_conv, conv_dim), dtype, device)
        self.conv_b = weight((conv_dim,), dtype, device)
        self.a_log = weight((h,), torch.float32, device)
        self.dt_bias = weight((h,), torch.float32, device)
        self.d_skip = weight((h,), torch.float32, device)
        self.norm_w = weight((d_inner,), dtype, device)
        self.out_proj = weight((d_inner, d), dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's init: fan-in matrices, ``conv_w`` at
        ``d_conv ** -0.5``, ``a_log = log(linspace(1, 16, H))``, ``dt_bias
        = log(expm1(dt))`` (the inverse softplus) of ``dt`` log-uniform in
        ``[1e-3, 1e-1]``, ``d_skip = 1``, ``conv_b = 0``, ``norm_w = 1``."""
        h = self.cfg.ssm_heads
        init_(self.in_proj, generator)
        init_(self.conv_w, generator, scale=self.cfg.d_conv ** -0.5)
        init_(self.out_proj, generator)
        with torch.no_grad():
            self.conv_b.zero_()
            self.a_log.copy_(torch.log(torch.linspace(1.0, 16.0, h)))
            u = torch.empty(h, device=self.dt_bias.device).uniform_(
                math.log(1e-3), math.log(1e-1), generator=generator)
            self.dt_bias.copy_(torch.log(torch.expm1(torch.exp(u))))
            self.d_skip.fill_(1.0)
            self.norm_w.fill_(1.0)

    def forward(self, x: torch.Tensor, *, cache=None, train: bool = False):
        return apply_mamba2(self, x, self.cfg, cache=cache, train=train)


def _split_proj(cfg, proj: torch.Tensor):
    """``in_proj``'s output -> ``z (d_inner)``, ``xbc (d_inner + 2N)``,
    ``dt (H)``."""
    d_inner = cfg.expand * cfg.d_model
    n, h = cfg.ssm_state, cfg.ssm_heads
    return proj.split([d_inner, d_inner + 2 * n, h], dim=-1)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time, then SiLU.  xbc: (B, T, C); w:
    (K, C).  The reference's sum of K shifted products, in xbc's dtype."""
    k, t = w.shape[0], xbc.shape[1]
    pad = nn.functional.pad(xbc, (0, 0, k - 1, 0))
    out = pad[:, 0:t] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + t] * w[i]
    return nn.functional.silu(out + b)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (no linear cut-off)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b_mat: torch.Tensor, c_mat: torch.Tensor, chunk: int):
    """Chunked SSD.  x: (B, T, H, P); dt: (B, T, H); b_mat / c_mat: (B, T,
    N).  Returns y (B, T, H, P) and the final state (B, H, P, N), f32.

    A ragged tail is padded with ``dt = 0`` and zero inputs: decay
    ``exp(0) = 1`` and no input, so pad steps leave the state as it is."""
    bsz, t, h, p = x.shape
    n = b_mat.shape[-1]
    l = min(chunk, t)
    pad = (-t) % l
    f32 = torch.float32
    x, dt, b_mat, c_mat = (v.to(f32) for v in (x, dt, b_mat, c_mat))
    if pad:
        x = nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = nn.functional.pad(dt, (0, 0, 0, pad))
        b_mat = nn.functional.pad(b_mat, (0, 0, 0, pad))
        c_mat = nn.functional.pad(c_mat, (0, 0, 0, pad))
    nc = (t + pad) // l
    xc = x.reshape(bsz, nc, l, h, p)
    dtc = dt.reshape(bsz, nc, l, h)
    bc = b_mat.reshape(bsz, nc, l, n)
    cc = c_mat.reshape(bsz, nc, l, n)

    log_a = -torch.exp(a_log.to(f32)) * dtc          # (B,nc,L,H), <= 0
    cum = torch.cumsum(log_a, dim=2)                 # within a chunk
    dtx = xc * dtc[..., None]                        # dt folded into x

    # intra-chunk: y_i += C_i.B_j * exp(cum_i - cum_j) * dtx_j  (j <= i)
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)           # (B,nc,L,L)
    ii = torch.arange(l, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[..., None]           # (L,L,1)
    # masked before the exp: above the diagonal cum_i - cum_j > 0 can
    # overflow to inf, and the reference's where-after-exp then passes
    # 0 * inf = NaN back through exp (mamba2-130m's chunk of 128 does);
    # the values kept are the same bits
    diff = cum[:, :, :, None] - cum[:, :, None, :]             # (B,nc,L,L,H)
    decay = torch.exp(torch.where(causal, diff, torch.full(
        (), float("-inf"), dtype=f32, device=x.device)))
    m = decay * scores[..., None]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", m, dtx)

    # chunk-local end states: S_c = sum_j exp(cum_end - cum_j) B_j (x) dtx_j
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)             # (B,nc,L,H)
    states = torch.einsum("bcln,bclhp->bchpn", bc,
                          decay_end[..., None] * dtx)
    chunk_decay = torch.exp(cum[:, :, -1, :])                  # (B,nc,H)

    # carried state: S before chunk c, for every c, and after the last
    s_cur = x.new_zeros((bsz, h, p, n))
    s_prevs = []
    for ci in range(nc):
        s_prevs.append(s_cur)
        s_cur = s_cur * chunk_decay[:, ci, :, None, None] + states[:, ci]
    s_prev = torch.stack(s_prevs, dim=1)                       # (B,nc,H,P,N)

    # inter-chunk: y_i += (C_i * exp(cum_i)) . S_prev
    y_inter = torch.einsum("bcin,bchpn->bcihp", cc, s_prev) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(bsz, nc * l, h, p)[:, :t]
    return y, s_cur


def _head_columns(cfg, rank: int, size: int, device):
    """Under a ``model`` axis of ``size``: the ``in_proj`` columns of rank
    ``rank``'s heads (``z``, ``x``, then all of ``B`` and ``C``, then
    ``dt``), and the conv channels among them (``x``, ``B``, ``C``)."""
    d_inner, n, h = cfg.expand * cfg.d_model, cfg.ssm_state, cfg.ssm_heads
    di, hl = d_inner // size, h // size
    ar = lambda lo, k: torch.arange(lo, lo + k, device=device)
    conv = torch.cat([ar(rank * di, di), ar(d_inner, 2 * n)])
    cols = torch.cat([ar(rank * di, di), d_inner + conv,
                      ar(2 * d_inner + 2 * n + rank * hl, hl)])
    return cols, conv


def _conv_block(window: torch.Tensor, ax) -> torch.Tensor:
    """The rank's contiguous block of the conv window's channels (its
    ``cache_spec`` block), or the window where ``ax`` is None."""
    if ax is None:
        return window
    c = window.shape[-1] // ax.size
    return window[..., ax.rank * c:(ax.rank + 1) * c]


def _conv_step(window: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """The depthwise conv of one new row over its ``(B, K, C)`` window,
    then SiLU: the reference's decode conv, in the window's dtype."""
    conv = window[:, 0:1] * w[0]
    for i in range(1, w.shape[0]):
        conv = conv + window[:, i:i + 1] * w[i]
    return nn.functional.silu(conv + b)


def _ssd_step(s_prev: torch.Tensor, xs: torch.Tensor, dt: torch.Tensor,
              a_log: torch.Tensor, b_mat: torch.Tensor,
              c_mat: torch.Tensor) -> torch.Tensor:
    """One step of the recurrence on ``s_prev (B, H, P, N)`` **in place**
    for ``xs (B, 1, H * P)``, ``dt (B, 1, H)`` and ``b_mat`` / ``c_mat
    (B, 1, N)``; returns ``y (B, 1, H, P)``, f32."""
    bsz, h = dt.shape[0], dt.shape[-1]
    xh = xs.reshape(bsz, h, -1).float()
    a = torch.exp(-torch.exp(a_log) * dt[:, 0])          # (B,H)
    dbx = torch.einsum("bh,bn,bhp->bhpn", dt[:, 0], b_mat[:, 0].float(), xh)
    s_prev.mul_(a[..., None, None]).add_(dbx)
    return torch.einsum("bn,bhpn->bhp", c_mat[:, 0].float(), s_prev)[:, None]


def _tp_mamba2(p: Mamba2, x: torch.Tensor, cfg, tp, cache=None,
               serve: bool = False):
    """The route on ``tp``'s local heads (module docstring): ``(y,
    cache_out)``.  ``cache=None``: the chunked scan, and with ``serve``
    the prefill's caches on the reference's specs (else None); ``cache =
    (conv block, ssm (B, H, P, N))``: one decode step, both written in
    place."""
    bsz, t, d = x.shape
    d_inner, n = cfg.expand * d, cfg.ssm_state
    di, hl = d_inner // tp.size, cfg.ssm_heads // tp.size
    hp = d_inner // cfg.ssm_heads
    cols, conv = _head_columns(cfg, tp.rank, tp.size, x.device)
    heads = slice(tp.rank * hl, (tp.rank + 1) * hl)
    x = copy_to(x, tp)
    z, xbc, dt = (x @ p.in_proj.index_select(1, cols)).split(
        [di, di + 2 * n, hl], dim=-1)
    dt = softplus(dt.float() + p.dt_bias[heads])
    conv_w = p.conv_w.index_select(1, conv)
    conv_b = p.conv_b.index_select(0, conv)

    def whole_rows(rows):
        """The rows of every channel from the rank's (its ``x`` columns
        and the shared ``B``, ``C``): the ``x`` columns all-gathered."""
        xr, bc = rows.split([di, 2 * n], dim=-1)
        return torch.cat([all_gather(xr, tp, -1), bc], dim=-1)

    if cache is None:
        xbc_conv = _causal_conv(xbc, conv_w, conv_b)
        xs, b_mat, c_mat = xbc_conv.split([di, n, n], dim=-1)
        y, s_final = ssd_scan(xs.reshape(bsz, t, hl, hp), dt,
                              p.a_log[heads], b_mat, c_mat, cfg.ssm_chunk)
        cache_out = None
        if serve:
            window = nn.functional.pad(xbc, (0, 0, cfg.d_conv - 1, 0)) \
                [:, -(cfg.d_conv - 1):]
            cache_out = (_conv_block(whole_rows(window), p.conv_ax)
                         .to(x.dtype), all_gather(s_final, tp, 1))
    else:
        conv_state, ssm = cache
        if t != 1:
            raise ValueError(f"mamba2 decode takes one token, got T={t}")
        old = all_gather(conv_state, p.conv_ax, -1)          # (B,K-1,C)
        window = torch.cat([old.index_select(-1, conv).to(xbc.dtype), xbc],
                           dim=1)
        xs, b_mat, c_mat = _conv_step(window, conv_w, conv_b).split(
            [di, n, n], dim=-1)
        s_loc = ssm[:, heads].clone()
        y = _ssd_step(s_loc, xs, dt, p.a_log[heads], b_mat, c_mat)
        ssm.copy_(all_gather(s_loc, tp, 1))
        new = torch.cat([old[:, 1:], whole_rows(xbc).to(old.dtype)], dim=1)
        conv_state.copy_(_conv_block(new, p.conv_ax))
        cache_out = (conv_state, ssm)
    y = y + p.d_skip[heads][:, None] * xs.reshape(bsz, t, hl, hp).float()
    y = y.reshape(bsz, t, di).to(x.dtype) * nn.functional.silu(z)
    y = rms_norm_split(p.norm_w[tp.rank * di:(tp.rank + 1) * di], y,
                       d_inner, tp, cfg.norm_eps)
    return reduce_from(y @ p.out_proj, tp), cache_out


def apply_mamba2(p: Mamba2, x: torch.Tensor, cfg, *, cache=None,
                 train: bool = False):
    """``cache=None``: the whole sequence through the chunked scan
    (prefill), returning ``(y, (conv_state, ssm_state))`` (``(y, None)``
    with ``train`` on ``tp``).  ``cache = (conv_state (B, K-1, C),
    ssm_state (B, H, P, N))`` with ``T = 1``: one step of the recurrence,
    which writes both states **in place** (the reference returns updated
    copies) and returns them.  On a placed model the states lie on the
    reference's specs (module docstring)."""
    if p.tp is not None:
        return _tp_mamba2(p, x, cfg, p.tp, cache, serve=not train)
    bsz, t, d = x.shape
    d_inner = cfg.expand * d
    n, h = cfg.ssm_state, cfg.ssm_heads
    hp = d_inner // h
    z, xbc, dt = _split_proj(cfg, x @ p.in_proj)
    dt = softplus(dt.float() + p.dt_bias)

    if cache is None:
        xbc_conv = _causal_conv(xbc, p.conv_w, p.conv_b)
        xs, b_mat, c_mat = xbc_conv.split([d_inner, n, n], dim=-1)
        y, s_final = ssd_scan(xs.reshape(bsz, t, h, hp), dt, p.a_log,
                              b_mat, c_mat, cfg.ssm_chunk)
        # the window the next token's conv needs: the last K-1 pre-conv rows
        conv_state = nn.functional.pad(xbc, (0, 0, cfg.d_conv - 1, 0)) \
            [:, -(cfg.d_conv - 1):]
        cache_out = (_conv_block(conv_state, p.conv_ax).to(x.dtype),
                     s_final)
    else:
        conv_state, s_prev = cache
        if t != 1:
            raise ValueError(f"mamba2 decode takes one token, got T={t}")
        old = all_gather(conv_state, p.conv_ax, -1)
        window = torch.cat([old.to(xbc.dtype), xbc], dim=1)
        xs, b_mat, c_mat = _conv_step(window, p.conv_w, p.conv_b).split(
            [d_inner, n, n], dim=-1)
        y = _ssd_step(s_prev, xs, dt, p.a_log, b_mat, c_mat)
        conv_state.copy_(_conv_block(window[:, 1:], p.conv_ax))
        cache_out = (conv_state, s_prev)

    y = y + p.d_skip[:, None] * xs.reshape(bsz, t, h, hp).float()
    y = y.reshape(bsz, t, d_inner).to(x.dtype)
    y = rms_norm(p.norm_w, y * nn.functional.silu(z), cfg.norm_eps)
    return y @ p.out_proj, cache_out
