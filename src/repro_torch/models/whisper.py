"""Whisper-style encoder-decoder (the audio family).

Counterpart of :mod:`repro.models.whisper`.  The conv frontend is a stub,
as in the reference: the encoder takes precomputed frame embeddings ``(B,
encoder_len, d)``.  Encoder: non-causal self-attention (rotary, as the
reference does) + GELU MLP, through the flash kernel's non-causal form on
the card.  Decoder: causal self-attention (cached at decode), full
cross-attention over the encoder's output with its K / V computed once
(:meth:`WhisperModel.enc_kv`) and carried in the cache, and a GELU MLP.
Norms are LayerNorm (scale + bias).

Caches: ``{"blocks": {"k", "v"}: (L, B, S, KV, hd), "enc_k", "enc_v": (L,
B, encoder_len, KV, hd), "len"}``.  Decode writes the self-attention k / v
in place; ``enc_k`` / ``enc_v`` never change and never grow.

The train mode runs the encoder and decoder self-attention through the
chunked scan under autograd, and every encoder and decoder block under
``"full"`` remat unless ``remat="none"`` (the reference's whisper
checkpoints without a policy, so ``"dots"`` is ``"full"`` here too).  A
placed model (:func:`repro_torch.train.sharding.place`) trains, prefills
and decodes, each block on its gathered weights as
:mod:`repro_torch.models.lm`'s do.  Its caches lie on the reference's
``cache_spec``: ``enc_k`` / ``enc_v`` on the ``attn`` spec, so with the
self-attention's KV heads (the rank's, or all of them where they do not
split, the rank's query heads then reading theirs), and, where the batch
does not split over the batch axes, with the encoder's frames split over
them, which a decode's cross-attention combines as its self-attention
does (:func:`repro_torch.models.attention.decode_attend`).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.attention import Attention, _local_kv, decode_attend
from repro_torch.models.layers import (MLP, REMAT, LayerNorm, init_, remat,
                                       weight)
from repro_torch.models.lm import (DTYPES, KV_LEAVES, cache_zeros,
                                   extend_cache, zero_aux)
from repro_torch.models.parallel import (all_gather, block_fn, copy_to,
                                         embed_lookup, gathered, reduce_from)

CROSS_KV = ("cross_attn.wk", "cross_attn.wv")


class EncBlock(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.ln1 = LayerNorm(cfg.d_model, dtype, device, cfg.norm_eps)
        self.attn = Attention(cfg, dtype, device)
        self.ln2 = LayerNorm(cfg.d_model, dtype, device, cfg.norm_eps)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, "gelu", dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for sub in (self.ln1, self.ln2):
            sub.reset_parameters()
        self.attn.reset_parameters(generator)
        self.mlp.reset_parameters(generator)

    def forward(self, x, *, positions, train=False):
        h, _ = self.attn(self.ln1(x), positions=positions, causal=False,
                         train=train)
        x = x + h
        return x + self.mlp(self.ln2(x))


def cross_attend(p: Attention, x: torch.Tensor, enc_k: torch.Tensor,
                 enc_v: torch.Tensor, cfg, sp=None) -> torch.Tensor:
    """Full (not chunked) cross-attention of ``x`` (B, T, d) over the
    encoder's K / V (B, S, KV, hd), unrotated, softmax in f32; under
    ``p.tp`` on the rank's heads (K / V the rank's KV heads, or all of
    them, of which its query heads read theirs); under ``sp`` (decode) K /
    V are the rank's slice of the frames."""
    hd = cfg.head_dim
    h = p.wq.shape[-1] // hd
    b, t, _ = x.shape
    q = (copy_to(x, p.tp) @ p.wq).view(b, t, h, hd)
    enc_k, enc_v = _local_kv(enc_k, enc_v, cfg, p.tp, h)
    y = decode_attend(q, enc_k, enc_v, sp).to(x.dtype)
    return reduce_from(y.reshape(b, t, h * hd) @ p.wo, p.tp)


class DecBlock(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.ln1 = LayerNorm(cfg.d_model, dtype, device, cfg.norm_eps)
        self.self_attn = Attention(cfg, dtype, device)
        self.ln_x = LayerNorm(cfg.d_model, dtype, device, cfg.norm_eps)
        self.cross_attn = Attention(cfg, dtype, device)
        self.ln2 = LayerNorm(cfg.d_model, dtype, device, cfg.norm_eps)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, "gelu", dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for sub in (self.ln1, self.ln_x, self.ln2):
            sub.reset_parameters()
        for sub in (self.self_attn, self.cross_attn, self.mlp):
            sub.reset_parameters(generator)

    def forward(self, x, enc_k, enc_v, *, positions, cache=None,
                train=False):
        h, cache_out = self.self_attn(self.ln1(x), positions=positions,
                                      cache=cache, train=train)
        x = x + h
        sp = None if cache is None else self.cross_attn.sp
        x = x + cross_attend(self.cross_attn, self.ln_x(x), enc_k, enc_v,
                             self.cfg, sp)
        return x + self.mlp(self.ln2(x)), cache_out


class WhisperModel(nn.Module):
    """Encoder-decoder of ``family="encdec"``.  Weights are allocated
    uninitialised on ``device`` in ``cfg.dtype``: fill them with
    :meth:`reset_parameters` or a state dict
    (:func:`repro_torch.models.convert.whisper_params_from_numpy`)."""

    def __init__(self, cfg, *, device):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"WhisperModel takes the encdec family, got "
                             f"{cfg.family!r}")
        self.cfg = cfg
        self.placed = None
        dtype = DTYPES[cfg.dtype]
        d = cfg.d_model
        self.embed = weight((cfg.vocab_size, d), dtype, device)
        self.unembed = weight((d, cfg.vocab_size), dtype, device)
        self.enc_norm = LayerNorm(d, dtype, device, cfg.norm_eps)
        self.final_norm = LayerNorm(d, dtype, device, cfg.norm_eps)
        self.encoder = nn.ModuleList(EncBlock(cfg, dtype, device)
                                     for _ in range(cfg.encoder_layers))
        self.decoder = nn.ModuleList(DecBlock(cfg, dtype, device)
                                     for _ in range(cfg.n_layers))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's distributions: embedding N(0, 1) cut at +-2, the
        other matrices fan-in scaled, LayerNorm scale 1 and bias 0."""
        init_(self.embed, generator, scale=1.0)
        init_(self.unembed, generator)
        self.enc_norm.reset_parameters()
        self.final_norm.reset_parameters()
        for blk in (*self.encoder, *self.decoder):
            blk.reset_parameters(generator)

    def encode(self, frames: torch.Tensor, *, train: bool = False,
               remat_policy: str = "none") -> torch.Tensor:
        """frames: (B, encoder_len, d), the stub frontend's output, cast to
        the model dtype.  ``train``: attention chunked, each block under
        ``remat_policy``."""
        b, s, _ = frames.shape
        positions = torch.arange(s, device=frames.device).expand(b, s)
        x = frames.to(self.embed.dtype)
        for i, blk in enumerate(self.encoder):
            x = remat(block_fn(self.placed, blk, f"encoder.{i}."),
                      remat_policy, x, positions=positions, train=train)
        with gathered(self.placed, self, "", ["enc_norm.scale",
                                              "enc_norm.bias"]):
            return self.enc_norm(x)

    def enc_kv(self, enc_out: torch.Tensor):
        """Per-decoder-layer cross K / V, (L, B, S, KV, hd) each, computed
        once (on a placed model: the KV heads of ``wk``, the rank's or
        all of them)."""
        b, s, _ = enc_out.shape
        hd = self.cfg.head_dim
        ks, vs = [], []
        for i, blk in enumerate(self.decoder):
            with gathered(self.placed, blk, f"decoder.{i}.", CROSS_KV):
                p = blk.cross_attn
                x = copy_to(enc_out, p.tp)
                kv = p.wk.shape[-1] // hd
                ks.append((x @ p.wk).view(b, s, kv, hd))
                vs.append((x @ p.wv).view(b, s, kv, hd))
        return torch.stack(ks), torch.stack(vs)

    extend_cache = staticmethod(extend_cache)

    def init_cache(self, batch: int, max_len: int) -> dict:
        """Empty decode caches of ``max_len`` slots, the encoder's K / V
        over ``encoder_len`` frames, in the weights' dtype."""
        cfg = self.cfg
        zeros = cache_zeros(self.embed)
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        enc = (*shape[:2], cfg.encoder_len, *shape[3:])
        return {"blocks": {name: zeros(shape) for name in KV_LEAVES},
                "enc_k": zeros(enc), "enc_v": zeros(enc), "len": 0}

    def forward(self, tokens: torch.Tensor, *, frames=None,
                mode: str = "prefill", cache: dict | None = None,
                remat: str = "full", unroll: bool = False):
        """Returns ``(hidden, cache_out)``, or ``(hidden, aux)`` in train
        mode (aux: f32 zeros, the reference's ``zero_aux()``).

        prefill: ``tokens (B, T)`` and ``frames (B, encoder_len, d)``,
        returns the cache of the T positions with the encoder's K / V;
        decode: ``tokens (B, 1)`` and a cache with a free slot; train:
        ``tokens (B, T)`` and frames, every block under ``remat``
        (``"dots"`` counts as ``"full"``, as in the reference).
        ``unroll`` changes nothing (a Python loop runs the layers).
        """
        del unroll
        if mode == "train":
            return self._train(tokens, frames, remat)
        if mode not in ("prefill", "decode"):
            raise ValueError(f"mode must be 'train', 'prefill' or 'decode', "
                             f"got {mode!r}")
        pl = self.placed
        with gathered(pl, self, "", ["embed"]):
            x = embed_lookup(tokens, self.embed, pl and pl.embed_tp)
        b, t, _ = x.shape
        run = [block_fn(pl, blk, f"decoder.{i}.", names=None if pl is None
                        else [n for n, _ in blk.named_parameters()
                              if n not in CROSS_KV])
               for i, blk in enumerate(self.decoder)]
        if mode == "decode":
            length = cache["len"]
            positions = torch.full((b, 1), length, device=x.device)
            ek, ev = cache["enc_k"], cache["enc_v"]
            kc, vc = cache["blocks"]["k"], cache["blocks"]["v"]
            for i, blk in enumerate(run):
                x, _ = blk(x, ek[i], ev[i], positions=positions,
                           cache=(kc[i], vc[i], length))
            cache_out = {**cache, "len": length + 1}
        else:
            if frames is None:
                raise ValueError("whisper prefill needs frames")
            positions = torch.arange(t, device=x.device).expand(b, t)
            ek, ev = self.enc_kv(self.encode(frames))
            ks, vs = [], []
            for i, blk in enumerate(run):
                x, (k, v) = blk(x, ek[i], ev[i], positions=positions)
                ks.append(k)
                vs.append(v)
            cache_out = {"blocks": {"k": torch.stack(ks),
                                    "v": torch.stack(vs)},
                         "enc_k": ek, "enc_v": ev, "len": t}
        with gathered(pl, self, "", ["final_norm.scale", "final_norm.bias"]):
            return self.final_norm(x), cache_out

    def _train(self, tokens, frames, policy: str):
        if frames is None:
            raise ValueError("whisper training needs frames")
        if policy not in REMAT:
            raise ValueError(f"remat must be one of {REMAT}, got {policy!r}")
        policy = "none" if policy == "none" else "full"
        pl = self.placed
        ek, ev = self.enc_kv(self.encode(frames, train=True,
                                         remat_policy=policy))
        with gathered(pl, self, "", ["embed"]):
            x = embed_lookup(tokens, self.embed, pl and pl.embed_tp)
        b, t, _ = x.shape
        positions = torch.arange(t, device=x.device).expand(b, t)
        for i, blk in enumerate(self.decoder):
            names = None if pl is None else [
                n for n, _ in blk.named_parameters() if n not in CROSS_KV]
            x, _ = remat(block_fn(pl, blk, f"decoder.{i}.", names=names),
                         policy, x, ek[i], ev[i], positions=positions,
                         train=True)
        with gathered(pl, self, "", ["final_norm.scale", "final_norm.bias"]):
            return self.final_norm(x), zero_aux(x.device)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """``hidden @ unembed``, the vocab split gathered on a placed
        model (:meth:`repro_torch.models.lm.DecoderLM.logits`)."""
        pl = self.placed
        with gathered(pl, self, "", ["unembed"]):
            out = hidden @ self.unembed
        return all_gather(out, pl and pl.unembed_tp, -1)
