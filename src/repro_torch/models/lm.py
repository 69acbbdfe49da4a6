"""Decoder-only LM: the dense, vlm, moe, ssm and hybrid families.

Counterpart of :mod:`repro.models.lm`: one model class, three block kinds.

* ``attn``  — pre-norm GQA attention + dense MLP (stablelm, minitron,
              granite, nemotron; llava's backbone, with the image's patch
              embeddings projected by ``patch_proj`` and prepended)
* ``moe``   — GQA attention + MoE FFN (+ the parallel dense MLP of
              ``dense_residual``, arctic)
* ``mamba`` — Mamba2 SSD block (mamba2-130m; zamba2's backbone)

and the hybrid (zamba2): segments of ``shared_attn_every`` mamba blocks,
with ONE ``shared`` attention + MLP block, its weights reused, after each
full segment (``n_shared_sites`` of them).

The reference scans one stacked set of block weights; here each block is
its own module in a :class:`torch.nn.ModuleList`, run by a Python loop.
Caches keep the reference's layout: ``{"blocks": {"k", "v"}: (L, B, S, KV,
hd)}`` for attention blocks, ``{"blocks": {"conv": (L, B, K-1, C), "ssm":
(L, B, H, P, N)}}`` for mamba blocks, the hybrid's ``{"shared": {"k",
"v"}: (sites, B, S, KV, hd)}`` beside them, and ``"len"``.  Prefill
returns one over the prompt (patches included); decode writes the new
token's state into the given cache in place and returns it with ``len +
1``.  The train mode returns the final hidden state and the MoE aux
losses summed over the layers, as the reference's scan sums them, each
block under the reference's per-layer remat (:func:`layers.remat`).

A model placed over a mesh (:func:`repro_torch.train.sharding.place`)
trains, prefills and decodes: each block gathers its weights (in train
mode inside its remat, so its recompute gathers them again) and frees
them after, the embedding looks up its vocab slice, and the blocks'
modules run their local shards (:mod:`repro_torch.models.parallel`).
Its prefill and decode take the rank's rows of the batch
(:meth:`repro_torch.models.parallel.Placed.serving` says whether they
are split) and caches on the reference's ``cache_spec``
(:func:`repro_torch.train.sharding.place_cache`): the rank's rows and KV
heads (mamba: its conv channels; every SSD head), the sequence whole but
where the rows are not split; :meth:`DecoderLM.logits` gathers the vocab
split.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.attention import Attention
from repro_torch.models.layers import MLP, init_, remat, rms_norm, weight
from repro_torch.models.mamba2 import Mamba2
from repro_torch.models.moe import MoE
from repro_torch.models.parallel import (all_gather, block_fn, embed_lookup,
                                         gathered)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
KINDS = {"dense": "attn", "vlm": "attn", "moe": "moe", "ssm": "mamba",
         "hybrid": "mamba"}
# cache leaves that grow with the sequence (the reference's ``pad_kv``
# pads only leaves named k / v): never ``conv``, ``ssm``, ``enc_k``/``enc_v``
KV_LEAVES = ("k", "v")
AUX = ("load_balance_loss", "router_z_loss")


def zero_aux(device) -> dict:
    """The reference's ``zero_aux()``: both MoE aux losses, f32 zeros."""
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in AUX}


def add_aux(aux: dict, more: dict | None) -> dict:
    return aux if more is None else {k: aux[k] + more[k] for k in AUX}


def cache_zeros(like: torch.Tensor):
    """``zeros(shape, dtype=None)``: plain zeros in ``like``'s dtype (or
    ``dtype``) on its device, a placed model's weights being ``DTensor``s
    whose caches are not."""
    return lambda shape, dtype=None: torch.zeros(
        shape, dtype=dtype or like.dtype, device=like.device)


def extend_cache(cache: dict, extra: int) -> dict:
    """A copy of ``cache`` with ``extra`` more empty slots in each
    attention k / v leaf (``blocks`` and ``shared``); the other leaves are
    the same tensors."""
    def grow(x):
        pad = x.new_zeros((*x.shape[:2], extra, *x.shape[3:]))
        return torch.cat([x, pad], dim=2)

    out = {}
    for key, val in cache.items():
        if isinstance(val, dict):
            val = {name: grow(x) if name in KV_LEAVES else x
                   for name, x in val.items()}
        out[key] = val
    return out


class Block(nn.Module):
    """Pre-norm GQA attention + a dense MLP or an MoE FFN (``moe``, with a
    parallel dense MLP when ``cfg.dense_residual``), each with a residual
    add."""

    def __init__(self, cfg, dtype: torch.dtype, device, *, moe: bool = False):
        super().__init__()
        self.eps = cfg.norm_eps
        self.ln1 = weight((cfg.d_model,), dtype, device)
        self.ln2 = weight((cfg.d_model,), dtype, device)
        self.attn = Attention(cfg, dtype, device)
        self.moe = MoE(cfg, dtype, device) if moe else None
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype, device) \
            if not moe or cfg.dense_residual else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.ln1.fill_(1.0)
            self.ln2.fill_(1.0)
        self.attn.reset_parameters(generator)
        for sub in (self.moe, self.mlp):
            if sub is not None:
                sub.reset_parameters(generator)

    def forward(self, x, *, positions, cache=None):
        x, cache_out, _ = self._apply(x, positions, cache, train=False)
        return x, cache_out

    def train_forward(self, x, *, positions):
        """``(x, aux)``: aux the MoE losses, None for a dense block."""
        x, _, aux = self._apply(x, positions, None, train=True)
        return x, aux

    def _apply(self, x, positions, cache, *, train: bool):
        h, cache_out = self.attn(rms_norm(self.ln1, x, self.eps),
                                 positions=positions, cache=cache,
                                 train=train)
        x = x + h
        y = rms_norm(self.ln2, x, self.eps)
        if self.moe is None:
            return x + self.mlp(y), cache_out, None
        ym, aux = self.moe(y, aux=train)
        if self.mlp is not None:
            ym = ym + self.mlp(y)
        return x + ym, cache_out, aux


class MambaBlock(nn.Module):
    """Pre-norm Mamba2 with a residual add."""

    def __init__(self, cfg, dtype: torch.dtype, device):
        super().__init__()
        self.eps = cfg.norm_eps
        self.ln1 = weight((cfg.d_model,), dtype, device)
        self.mamba = Mamba2(cfg, dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.ln1.fill_(1.0)
        self.mamba.reset_parameters(generator)

    def forward(self, x, *, positions=None, cache=None, train=False):
        h, cache_out = self.mamba(rms_norm(self.ln1, x, self.eps),
                                  cache=cache, train=train)
        return x + h, cache_out

    def train_forward(self, x, *, positions=None):
        return self(x, train=True)[0], None


class DecoderLM(nn.Module):
    """Decoder-only LM of any family but ``encdec``.  Weights are
    allocated uninitialised on ``device`` in ``cfg.dtype`` (the MoE router
    and mamba's ``a_log`` / ``dt_bias`` / ``d_skip`` in f32, as the
    reference's): fill them with :meth:`reset_parameters` or a state dict
    (:func:`repro_torch.models.convert.lm_params_from_numpy`)."""

    def __init__(self, cfg, *, device):
        super().__init__()
        if cfg.family not in KINDS:
            raise ValueError(f"DecoderLM takes the {sorted(KINDS)} families, "
                             f"got {cfg.family!r}")
        self.cfg = cfg
        self.kind = KINDS[cfg.family]
        self.placed = None
        dtype = DTYPES[cfg.dtype]
        self.embed = weight((cfg.vocab_size, cfg.d_model), dtype, device)
        if self.kind == "mamba":
            blocks = (MambaBlock(cfg, dtype, device)
                      for _ in range(cfg.n_layers))
        else:
            blocks = (Block(cfg, dtype, device, moe=self.kind == "moe")
                      for _ in range(cfg.n_layers))
        self.blocks = nn.ModuleList(blocks)
        self.shared = Block(cfg, dtype, device) \
            if cfg.family == "hybrid" else None
        self.patch_proj = weight((cfg.d_model, cfg.d_model), dtype, device) \
            if cfg.family == "vlm" else None
        self.final_norm = weight((cfg.d_model,), dtype, device)
        if not cfg.tie_embeddings:
            self.unembed = weight((cfg.d_model, cfg.vocab_size), dtype,
                                  device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random weights from ``generator`` (on the weights' device), with
        the reference's distributions: embedding N(0, 1) cut at +-2, the
        other matrices fan-in scaled (MoE and mamba: the reference's
        explicit scales and vectors), norms 1."""
        init_(self.embed, generator, scale=1.0)
        for blk in self.blocks:
            blk.reset_parameters(generator)
        if self.shared is not None:
            self.shared.reset_parameters(generator)
        if self.patch_proj is not None:
            init_(self.patch_proj, generator)
        with torch.no_grad():
            self.final_norm.fill_(1.0)
        if not self.cfg.tie_embeddings:
            init_(self.unembed, generator)

    # -------------------------------------------------------------- caches
    def n_shared_sites(self) -> int:
        cfg = self.cfg
        if cfg.family != "hybrid" or not cfg.shared_attn_every:
            return 0
        return cfg.n_layers // cfg.shared_attn_every

    def init_cache(self, batch: int, max_len: int) -> dict:
        """Empty decode caches of ``max_len`` slots in the weights' dtype
        (the SSD state in f32)."""
        cfg = self.cfg
        zeros = cache_zeros(self.embed)
        kv_shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        if self.kind != "mamba":
            return {"blocks": {name: zeros((cfg.n_layers, *kv_shape))
                               for name in KV_LEAVES}, "len": 0}
        cache = {"blocks": {
            "conv": zeros((cfg.n_layers, batch, cfg.d_conv - 1,
                           cfg.d_inner + 2 * cfg.ssm_state)),
            "ssm": zeros((cfg.n_layers, batch, cfg.ssm_heads, cfg.head_p,
                          cfg.ssm_state), torch.float32)}, "len": 0}
        sites = self.n_shared_sites()
        if sites:
            cache["shared"] = {name: zeros((sites, *kv_shape))
                               for name in KV_LEAVES}
        return cache

    extend_cache = staticmethod(extend_cache)

    # -------------------------------------------------------------- forward
    def _embed(self, tokens, patches):
        x = embed_lookup(tokens, self.embed, self.placed and
                         self.placed.embed_tp)
        if self.patch_proj is not None and patches is not None:
            pe = patches.to(x.dtype) @ self.patch_proj
            x = torch.cat([pe, x], dim=1)
        return x

    def _layers(self) -> list:
        """``(block, cache group, index in the group)`` in the order they
        run: the blocks, and the hybrid's shared block after each full
        segment of ``shared_attn_every`` (``index`` its call site)."""
        every, sites = self.cfg.shared_attn_every, self.n_shared_sites()
        out = []
        for i, blk in enumerate(self.blocks):
            out.append((blk, "blocks", i))
            if sites and (i + 1) % every == 0:
                out.append((self.shared, "shared", (i + 1) // every - 1))
        return out

    def forward(self, tokens: torch.Tensor, *, patches=None,
                mode: str = "prefill", cache: dict | None = None,
                remat: str = "full", unroll: bool = False):
        """Returns ``(hidden, cache_out)``, or ``(hidden, aux)`` in train
        mode.

        prefill: ``tokens (B, T)`` (vlm: after ``patches (B, P, d)``),
        returns the cache of the T (+ P) positions; decode: ``tokens (B,
        1)`` and a cache with a free slot; train: ``tokens (B, T)`` (and
        the vlm's patches), returns the MoE aux losses summed over the
        layers (f32 zeros for the other families), with every block
        under ``remat`` (``"full" | "dots" | "none"``; the hybrid's shared
        block ``"full"`` unless ``"none"``, as the reference's) and the
        attention through :func:`attention.chunked_attention`.  ``remat``
        and ``unroll`` are train-mode options; ``unroll`` (the reference's
        loop-free lowering) changes nothing here, where a Python loop runs
        the layers already.
        """
        del unroll
        if mode == "train":
            return self._train(tokens, patches, remat)
        if mode not in ("prefill", "decode"):
            raise ValueError(f"mode must be 'train', 'prefill' or 'decode', "
                             f"got {mode!r}")
        pl = self.placed
        decode = mode == "decode"
        patches = None if decode else patches
        top = ["embed"] + (["patch_proj"] if self.patch_proj is not None
                           and patches is not None else [])
        with gathered(pl, self, "", top):
            x = self._embed(tokens, patches)
        b, t, _ = x.shape
        if decode:
            length = cache["len"]
            positions = torch.full((b, 1), length, device=x.device)
        else:
            positions = torch.arange(t, device=x.device).expand(b, t)
        leaves = {"blocks": ("conv", "ssm") if self.kind == "mamba"
                  else KV_LEAVES, "shared": KV_LEAVES}
        new = {"blocks": [], "shared": []}
        for blk, group, i in self._layers():
            run = block_fn(pl, blk, "shared." if group == "shared"
                           else f"blocks.{i}.")
            if decode:
                c = tuple(cache[group][name][i] for name in leaves[group])
                if leaves[group] is KV_LEAVES:
                    c += (length,)        # attention writes at slot len
                x, _ = run(x, positions=positions, cache=c)
            else:
                x, c = run(x, positions=positions)
                new[group].append(c)
        if decode:
            cache_out = {**cache, "len": length + 1}
        else:
            cache_out = {group: {name: torch.stack([c[j] for c in cs])
                                 for j, name in enumerate(leaves[group])}
                         for group, cs in new.items() if cs}
            cache_out["len"] = t
        with gathered(pl, self, "", ["final_norm"]):
            return rms_norm(self.final_norm, x, self.cfg.norm_eps), cache_out

    def _train(self, tokens, patches, policy: str):
        pl = self.placed
        top = ["embed"] + (["patch_proj"] if self.patch_proj is not None
                           else [])
        with gathered(pl, self, "", top):
            x = self._embed(tokens, patches)
        b, t, _ = x.shape
        positions = torch.arange(t, device=x.device).expand(b, t)
        shared = "none" if policy == "none" else "full"
        aux = zero_aux(x.device)
        for blk, group, i in self._layers():
            prefix = "shared." if group == "shared" else f"blocks.{i}."
            x, a = remat(block_fn(pl, blk, prefix, "train_forward"),
                         shared if group == "shared" else policy, x,
                         positions=positions)
            aux = add_aux(aux, a)
        with gathered(pl, self, "", ["final_norm"]):
            return rms_norm(self.final_norm, x, self.cfg.norm_eps), aux

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """``hidden @ unembed`` (the tied embedding's transpose); on a
        placed model every rank's vocab slice gathered, so that each holds
        the logits of its rows over the whole vocab."""
        tied = self.cfg.tie_embeddings
        pl = self.placed
        with gathered(pl, self, "", ["embed" if tied else "unembed"]):
            out = hidden @ (self.embed.t() if tied else self.unembed)
        return all_gather(out, pl and pl.unembed_tp, -1)
