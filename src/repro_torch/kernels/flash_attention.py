"""GQA flash-attention forward: the CUDA kernel's wrapper.

Counterpart of :mod:`repro.kernels.flash_attention` (the Pallas TPU
kernel).  The kernel is ``csrc/flash_attention.cu``.  Both dtypes read q,
k, v in place through their strides (the KV head of query head ``h`` is
``h // (H // KV)``), skip key tiles past the causal frontier and
bounds-check ragged ``T``/``S`` tails; the online softmax keeps f32
``m``, ``l`` and accumulators.

* bf16 (the serving path) runs on Hopper's tensor cores (``wgmma``): one
  CTA of three warpgroups per (batch x head, 192-row query block), 64-key
  K/V tiles fetched by ``cp.async`` into a 3-slot shared-memory ring, QKᵀ
  exact in bf16 products with f32 sums, P kept in registers and split into
  bf16 hi + lo for the P.V product so that it carries ~16 bits (bf16 P
  alone would miss the one-bf16-ulp tolerance), ``exp`` as ``ex2.approx``.
  Its bound is the algorithm's operations (137.5 GFLOP at minitron-8b's
  prefill, 0.14 ms at the bf16 tensor-core peak); the split makes the
  tensor cores do 1.5x that.
* float32 (checks) runs on the f32 CUDA cores: 64-row query blocks,
  explicit fused multiply-adds, ``expf``.

Its plain PyTorch version is :func:`repro_torch.kernels.ref.flash_attention`;
the two sum in different orders (and bf16 rounds P to ~16 bits), so they
agree to a tolerance, not bit for bit.

One difference from the Pallas kernel, by design: with ``causal=False``
and ``S`` not a block multiple, the Pallas kernel pads with zero keys and
attends to them; this kernel excludes every key ``>= S``, which is what
``chunked_attention(..., kv_len=S)`` computes.

:func:`flash_attention` takes CUDA tensors only, checks them, allocates
the output, launches on PyTorch's current stream and raises on any launch
error.  ``launches`` counts its launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

SOURCE = "flash_attention"
MAX_HEAD_DIM = 128
BLOCK_Q = 64           # query rows per CTA of the f32 kernel (csrc kBQ;
                       # the bf16 kernel's are 192, so its grid is smaller)
MAX_Q_BLOCKS = 65535   # the grid's y extent

launches = 0


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.flash_attention_f32, lib.flash_attention_bf16):
            fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
                           ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                           i32, ptr]
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(q, k, v) -> None:
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention kernel takes CUDA tensors, got q "
                         f"on {dev}")
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q "
                             f"on {dev}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes float32 or bfloat16 q/k/v "
                         f"of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention shapes: q (B, T, H, d), k/v "
                         f"(B, S, KV, d); got {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    h, kv, d = q.shape[2], k.shape[2], q.shape[3]
    if kv < 1 or h % kv:
        raise ValueError(f"flash_attention: H={h} is not a multiple of "
                         f"KV={kv}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} outside "
                         f"[1, {MAX_HEAD_DIM}]")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name} must be contiguous in "
                             f"its head dim (stride {t.stride(3)})")
    if -(-q.shape[1] // BLOCK_Q) > MAX_Q_BLOCKS:
        raise ValueError(f"flash_attention: T={q.shape[1]} exceeds "
                         f"{MAX_Q_BLOCKS * BLOCK_Q} query rows")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, T, H, d); k, v: (B, S, KV, d) -> (B, T, H, d) in q's dtype,
    on the card.  Scale ``d ** -0.5``; causal masks key ``s > t``."""
    global launches
    _check(q, k, v)
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    o = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    strides = (ctypes.c_longlong * 12)(
        *(st for x in (q, k, v, o) for st in x.stride()[:3]))
    lib = _lib()
    fn = lib.flash_attention_bf16 if q.dtype == torch.bfloat16 \
        else lib.flash_attention_f32
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, t, s,
              h, kv, d, strides, d ** -0.5, int(causal), stream)
    build.check(code, "flash_attention launch")
    launches += 1
    return o
