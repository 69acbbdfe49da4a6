"""Deterministic, restartable data pipeline.

Counterpart of :mod:`repro.data.pipeline`.  Two sources share one
interface, ``next_batch(step) -> batch dict`` of tensors on the source's
``device``:

* :class:`SyntheticSource` — tokens drawn by the reference's counter-based
  PRNG keyed on ``(seed, step)``: any step's batch, in any order, without
  state (the cursor is the step number, which makes checkpoint-restart
  exact).  Tokens and labels are the reference's bit for bit (threefry-2x32
  as :mod:`repro_torch.core.generators` runs it, ``jax.random.randint``'s
  int32 path); the stub frontends' patch or frame embeddings are
  ``jax.random.normal`` in bf16, whose ``erf_inv`` is evaluated here by
  XLA's f32 polynomial (:func:`_erfinv_f32`).
* :class:`MemmapSource` — a flat binary token file read as ``seq + 1``
  windows, the cursor derived from ``step`` the same way.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.generators import fold_in, threefry2x32
from repro_torch.device import resolve_device

_U32 = 0xFFFFFFFF


def _key(seed: int, device) -> tuple:
    """``jax.random.PRNGKey(seed)``: the words ``(seed >> 32, seed & (2^32
    - 1))`` (the two forms of jax agree for seeds below 2^31)."""
    words = (int(seed) >> 32 & _U32, int(seed) & _U32)
    return tuple(torch.tensor(w, dtype=torch.int64, device=device)
                 for w in words)


def _bits32(key: tuple, shape) -> torch.Tensor:
    """``jax.random``'s 32 random bits a value under the partitionable
    threefry: value ``i`` (row-major) is ``hi ^ lo`` of the cipher of the
    counter ``(0, i)``, as uint32 values in an int64 tensor."""
    n = math.prod(shape)
    i = torch.arange(n, dtype=torch.int64, device=key[0].device)
    hi, lo = threefry2x32(key[0], key[1], i >> 32, i & _U32)
    return (hi ^ lo).view(shape)


def randint32(key: tuple, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, jnp.int32)``: two
    draws of 32 bits from the key's split halves, ``((hi % span) *
    (2^32 % span) + lo % span) % span`` in uint32 arithmetic."""
    hi, lo = (_bits32(fold_in(key, j), shape) for j in (0, 1))
    span = max(int(maxval) - int(minval), 1)
    mult = ((1 << 16) % span) ** 2 % span
    off = (((hi % span) * mult & _U32) + lo % span) & _U32
    return (minval + off % span).to(torch.int32)


# XLA's ErfInv32 (Giles, "Approximating the erfinv function"): the
# coefficients for w < 5 and for w >= 5, highest power first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """``erf_inv`` of f32 ``x`` in (-1, 1) by XLA's polynomial: ``w =
    -log1p(-x * x)``, then ``p(w - 2.5)`` below 5, ``p(sqrt(w) - 3)``
    above, times ``x``."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.full_like(x, 0.0)
    for i, (a, b) in enumerate(zip(_ERFINV_LT5, _ERFINV_GE5)):
        c = torch.where(lt, torch.tensor(a, dtype=x.dtype, device=x.device),
                        torch.tensor(b, dtype=x.dtype, device=x.device))
        p = c if i == 0 else c + p * w
    return p * x


def normal_bf16(key: tuple, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape, jnp.bfloat16)``: a uniform of 8
    random bits (bf16 has 7 mantissa bits) on ``[nextafter(-1, 0), 1)``,
    each op rounded to bf16, then ``sqrt(2) * erf_inv(u)`` with ``erf_inv``
    in f32 (:func:`_erfinv_f32`) and rounded to bf16."""
    bf16 = torch.bfloat16
    bits = _bits32(key, shape) & 0xFF
    one = 0x3F80                      # 1.0 in bf16
    floats = ((bits >> 1) | one).to(torch.int16).view(bf16) - 1.0
    lo = -(1.0 - 2.0 ** -8)           # nextafter(-1, 0) in bf16
    u = torch.clamp(floats * (1.0 - torch.tensor(lo, dtype=bf16)) + lo,
                    min=lo)
    sqrt2 = torch.tensor(math.sqrt(2), dtype=bf16, device=bits.device)
    return sqrt2 * _erfinv_f32(u.float()).to(bf16)


@dataclasses.dataclass(frozen=True)
class SyntheticSource:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_patches: int = 0         # vlm: prepended patch embeddings
    d_model: int = 0
    encoder_len: int = 0       # audio: frame embeddings
    device: str = "cuda"

    def next_batch(self, step: int) -> dict:
        """``{"tokens" (B, T - n_patches) int32, "labels" (B, T) int32[,
        "patches" (B, n_patches | encoder_len, d) bf16]}``: the vlm's
        labels lead with zeros over the patches."""
        dev = resolve_device(self.device)
        key = fold_in(_key(self.seed, dev), step)
        b, t_text = self.global_batch, self.seq_len - self.n_patches
        tokens = randint32(key, (b, t_text + 1), 0, self.vocab_size)
        batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        if self.n_patches:
            batch["patches"] = normal_bf16(fold_in(key, 1),
                                           (b, self.n_patches, self.d_model))
            pad = torch.zeros((b, self.n_patches), dtype=torch.int32,
                              device=dev)
            batch["labels"] = torch.cat([pad, batch["labels"]], dim=1)
        if self.encoder_len:
            batch["patches"] = normal_bf16(
                fold_in(key, 2), (b, self.encoder_len, self.d_model))
        return batch


@dataclasses.dataclass(frozen=True)
class MemmapSource:
    path: str
    seq_len: int
    global_batch: int
    dtype: str = "uint16"
    device: str = "cuda"

    def next_batch(self, step: int) -> dict:
        """Windows ``step * B + j`` (mod the file's window count) of ``seq +
        1`` tokens: ``{"tokens", "labels"}`` int32, shifted by one."""
        data = np.memmap(self.path, dtype=self.dtype, mode="r")
        window = self.seq_len + 1
        n_windows = (len(data) - 1) // window
        idx = (step * self.global_batch
               + np.arange(self.global_batch)) % max(n_windows, 1)
        toks = np.stack([np.asarray(data[i * window:(i + 1) * window])
                         for i in idx]).astype(np.int32)
        toks = torch.from_numpy(toks).to(resolve_device(self.device))
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
