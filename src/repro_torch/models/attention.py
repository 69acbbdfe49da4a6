"""GQA/MQA attention with RoPE: train (chunked), prefill (causal,
non-causal or cross) and decode.

Counterpart of :mod:`repro.models.attention`.  Two routes serve a whole
sequence (``cache=None``):

* **prefill** goes through :func:`repro_torch.kernels.ops.flash_attention`:
  on CUDA tensors the hand-written flash kernel (which takes the place of
  the reference's chunk scan, as its docstring says the Pallas kernel
  would on hardware), on CPU tensors its plain version.  The reference
  pads keys to a chunk multiple and masks them with ``kv_len``; the kernel
  and its plain version exclude every key ``>= S``, the same function.
* **train** (``train=True``) goes through :func:`chunked_attention`, plain
  torch under autograd on every device, with the reference's key padding
  to the chunk and its ``kv_len`` mask.  The reference trains through its
  ``lax.scan`` and no TPU kernel: the Pallas flash kernel has no backward,
  and neither has the port's flash kernel, so a train forward through it
  would leave the attention projections without gradients on the card.

Decode is plain torch, as the reference's is plain ``jnp``: one new token
against the cache, softmax in f32 (:func:`_gqa_scores` /
:func:`_gqa_out`, which whisper's full cross-attention also uses).

Head counts are read off the projections, so a placed model runs the
same code on its local heads: with ``tp`` (the ``model`` axis;
:mod:`repro_torch.models.parallel`) ``wq`` / ``wo`` are this rank's heads,
``wk`` / ``wv`` its KV heads or, where the KV heads do not split over the
axis, all of them (:func:`kv_for_heads` then picks the ones its query
heads read), and ``wo``'s product is summed over the axis.  The keys and
values a prefill returns for the cache, and the decode cache, hold the
same KV heads as ``wk``: the rank's, or all of them where they do not
split (the reference's ``cache_spec``).  With ``sp`` (the batch axis, at a
batch that does not split over it) the decode cache holds the rank's
slice of the sequence: the rank owning slot ``length`` writes it, and the
softmax over the slots is combined across the axis (:func:`decode_attend`).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops, ref
from repro_torch.models.layers import init_, rope, weight
from repro_torch.models.parallel import (_reduce, all_max, copy_to,
                                         reduce_from)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_offset: int, chunk: int, causal: bool = True,
                      kv_len: int | None = None) -> torch.Tensor:
    """Online-softmax attention over KV chunks (the reference's signature).

    q: (B, T, H, hd) at absolute positions ``[q_offset, q_offset + T)``;
    k, v: (B, S, KV, hd).  S must be a multiple of ``chunk`` (the caller
    pads; ``kv_len`` masks padded key positions ``>= kv_len``).  The scan
    itself is :func:`repro_torch.kernels.ref.flash_attention`, which writes
    no tensor on the autograd graph in place, so it differentiates.
    """
    if k.shape[1] % chunk:
        raise ValueError(f"S={k.shape[1]} is not a multiple of chunk={chunk}")
    return ref.flash_attention(q, k, v, causal=causal, chunk=chunk,
                               q_offset=q_offset, kv_len=kv_len)


def _train_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cfg, *, causal: bool) -> torch.Tensor:
    """The reference's train route: keys and values padded with zeros to a
    multiple of ``chunk = min(cfg.attn_chunk, S)``, the pad masked by
    ``kv_len``, then :func:`chunked_attention` from position 0."""
    t_kv = k.shape[1]
    chunk = min(cfg.attn_chunk, t_kv)
    pad = (-t_kv) % chunk
    if pad:
        k = nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    return chunked_attention(q, k, v, q_offset=0, chunk=chunk, causal=causal,
                             kv_len=t_kv if pad else None)


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B, T, H, hd), k: (B, S, KV, hd) -> scaled scores (B, KV, H/KV,
    T, S)."""
    b, t, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, t, kvh, h // kvh, hd)
    return torch.einsum("btkgh,bskh->bkgts", qg, k) * (hd ** -0.5)


def _gqa_out(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p: (B, KV, G, T, S), v: (B, S, KV, hd) -> (B, T, H, hd)."""
    b, kvh, g, t, _ = p.shape
    o = torch.einsum("bkgts,bskh->btkgh", p, v)
    return o.reshape(b, t, kvh * g, v.shape[-1])


def kv_for_heads(k: torch.Tensor, cfg, first: int, n: int) -> torch.Tensor:
    """The KV heads (dim 2 of ``k`` (B, S, KV, hd), every KV head) that
    query heads ``[first, first + n)`` read, one a query head."""
    g = cfg.n_heads // cfg.n_kv_heads
    idx = torch.arange(first, first + n, device=k.device) // g
    return k.index_select(2, idx)


class Attention(nn.Module):
    """The projections ``wq (d, H*hd)``, ``wk``/``wv (d, KV*hd)``, ``wo
    (H*hd, d)`` in the reference's ``x @ W`` layout."""

    def __init__(self, cfg, dtype: torch.dtype, device):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.cfg = cfg
        self.tp = self.sp = None
        self.wq = weight((d, h * hd), dtype, device)
        self.wk = weight((d, kv * hd), dtype, device)
        self.wv = weight((d, kv * hd), dtype, device)
        self.wo = weight((h * hd, d), dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv):
            init_(w, generator)
        init_(self.wo, generator, scale=self.wo.shape[0] ** -0.5)

    def forward(self, x, *, positions, cache=None, kv_x=None, causal=True,
                train=False):
        return apply_attention(self, x, self.cfg, positions=positions,
                               cache=cache, kv_x=kv_x, causal=causal,
                               train=train)


def decode_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  sp=None) -> torch.Tensor:
    """One query step ``q (B, 1, H, hd)`` against every slot of ``k`` /
    ``v (B, S, KV, hd)``, softmax in f32; returns (B, 1, H, hd) f32.  Under
    ``sp`` each rank holds a slice of the sequence (maybe none of it): the
    row maxima are all-maxed over the axis, then the sums of ``exp`` and
    of the weighted values all-reduced, and their quotient is the whole
    softmax's."""
    if sp is None:
        pr = torch.softmax(_gqa_scores(q.float(), k.float()), dim=-1)
        return _gqa_out(pr, v.float())
    b, _, h, _ = q.shape
    sc = _gqa_scores(q.float(), k.float())                  # (B,KV,G,1,S)
    m = sc.amax(-1) if k.shape[1] else \
        sc.new_full(sc.shape[:-1], float("-inf"))
    e = torch.exp(sc - all_max(m, sp)[..., None])
    den = _reduce(e.sum(-1), sp)                            # (B,KV,G,1)
    num = _reduce(_gqa_out(e, v.float()), sp)               # (B,1,H,hd)
    return num / den.permute(0, 3, 1, 2).reshape(b, 1, h, 1)


def _local_kv(k, v, cfg, tp, h: int):
    """Under ``tp``, the KV heads the rank's ``h`` query heads read when
    ``wk`` / ``wv`` were gathered whole (their KV heads do not split over
    the axis, so the rank's query heads need not cover whole KV groups);
    else ``k``, ``v`` as they are."""
    if tp is None or k.shape[2] * tp.size == cfg.n_kv_heads:
        return k, v
    first = tp.rank * h
    return kv_for_heads(k, cfg, first, h), kv_for_heads(v, cfg, first, h)


def apply_attention(p: Attention, x: torch.Tensor, cfg, *,
                    positions: torch.Tensor, cache=None,
                    kv_x: torch.Tensor | None = None, causal: bool = True,
                    train: bool = False):
    """Attention of ``x`` (B, T, d).

    * prefill, ``cache=None``: self-attention over ``x`` (``causal`` or
      not), or cross-attention over ``kv_x`` (B, S, d), non-causal with q
      and k unrotated (whisper-style); returns ``(y, (k, v))``, the
      unpadded keys and values (B, S, KV, hd) for the cache; with
      ``train`` the same through :func:`_train_attention` instead of the
      flash kernel;
    * decode, ``cache=(k_cache, v_cache, length)`` with caches (B, S, KV,
      hd) and ``T = 1``: writes the new key and value at slot ``length``
      **in place** (the reference returns updated copies) and returns
      ``(y, (k_cache, v_cache, length + 1))``; under ``p.sp`` the caches
      are the rank's ``S`` slots of ``S * sp.size``.
    """
    hd = cfg.head_dim
    h, kv = p.wq.shape[-1] // hd, p.wk.shape[-1] // hd
    tp = p.tp
    b, t, _ = x.shape
    x = copy_to(x, tp)
    q = (x @ p.wq).view(b, t, h, hd)
    if kv_x is not None:
        if cache is not None:
            raise ValueError("cross-attention (kv_x) has no decode cache")
        kv_x = copy_to(kv_x, tp)
        k = (kv_x @ p.wk).view(b, kv_x.shape[1], kv, hd)
        v = (kv_x @ p.wv).view(b, kv_x.shape[1], kv, hd)
        kh, vh = _local_kv(k, v, cfg, tp, h)
        y = _train_attention(q, kh, vh, cfg, causal=False) if train else \
            ops.flash_attention(q, kh, vh, causal=False)
        return reduce_from(y.reshape(b, t, h * hd) @ p.wo, tp), (k, v)
    q = rope(q, positions, cfg.rope_theta)
    k = rope((x @ p.wk).view(b, t, kv, hd), positions, cfg.rope_theta)
    v = (x @ p.wv).view(b, t, kv, hd)

    if cache is None:
        kh, vh = _local_kv(k, v, cfg, tp, h)
        y = _train_attention(q, kh, vh, cfg, causal=causal) if train else \
            ops.flash_attention(q, kh, vh, causal=causal)
        return reduce_from(y.reshape(b, t, h * hd) @ p.wo, tp), (k, v)

    # ---- decode: one new token against the cache ------------------------ #
    k_cache, v_cache, length = cache
    sp, s_l = p.sp, k_cache.shape[1]
    first = 0 if sp is None else sp.rank * s_l       # the rank's first slot
    slots = s_l if sp is None else s_l * sp.size
    if t != 1 or not 0 <= length < slots:
        raise ValueError(f"decode takes one token and a free cache slot; got "
                         f"T={t}, length={length}, cache of {slots} slots")
    if first <= length < first + s_l:
        k_cache[:, length - first] = k[:, 0].to(k_cache.dtype)
        v_cache[:, length - first] = v[:, 0].to(v_cache.dtype)
    # slots > length are masked in the reference; leaving them out is exact
    n = max(0, min(length + 1 - first, s_l))
    kc, vc = _local_kv(k_cache[:, :n], v_cache[:, :n], cfg, tp, h)
    y = decode_attend(q, kc, vc, sp).reshape(b, 1, h * hd)
    return reduce_from(y.to(x.dtype) @ p.wo, tp), \
        (k_cache, v_cache, length + 1)
