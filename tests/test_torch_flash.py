"""The torch port's plain flash attention against the JAX package.

``repro_torch.kernels.ref.flash_attention`` (the plain version of the
port's CUDA flash kernel, which the CPU path runs) against the Pallas
kernel in interpret mode and against ``chunked_attention``, on the cases
of ``tests/test_flash_kernel.py`` plus ``d = 80`` (stablelm-3b's head
dim).  Tolerances are those of ``tests/test_flash_kernel.py``: 2e-5 for
f32 (the same online softmax, summed in other orders), 2e-2 for bf16
inputs held against the f32 oracle.  The CUDA kernel is held to the plain
version on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

The CUDA kernel's bf16 arithmetic (exact bf16 products summed in f32,
then ``scale``, online softmax in f32 over 64-key tiles, P split into
bf16 hi + lo for the P.V product) is emulated in plain torch by
``_kernel_precision`` below and held to the plain version and to
``chunked_attention`` under the card's bf16 tolerance: one bf16 ulp of
the larger value plus 1e-5.  Run as a script, this file prints how far
the emulation lands from the plain version at minitron-8b's per-head
shape with P split and with P in bf16 alone::

    PYTHONPATH=src python tests/test_torch_flash.py
"""

import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jflash
from repro.models.attention import chunked_attention as jchunked
from repro_torch.kernels import flash_attention as tflash_kernel
from repro_torch.kernels import ops, ref
from repro_torch.models.attention import chunked_attention

F32 = dict(atol=2e-5, rtol=2e-5)
# (H, KV, d) of the serving configs: minitron-8b, stablelm-3b, granite-34b
SERVING_HEADS = [(32, 8, 128), (32, 32, 80), (48, 1, 128)]


def _qkv(b, t, s, h, kv, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, t, h, d), (b, s, kv, d), (b, s, kv, d)))


def _t(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


@pytest.mark.parametrize("b,t,h,kv,d", [
    (1, 64, 4, 4, 32),      # MHA
    (2, 96, 4, 2, 64),      # GQA, T not a block multiple
    (1, 128, 8, 1, 16),     # MQA
    (2, 50, 4, 2, 80),      # d = 80, ragged T
])
def test_plain_flash_matches_pallas_and_scan_causal(b, t, h, kv, d):
    q, k, v = _qkv(b, t, t, h, kv, d)
    got = ref.flash_attention(*_t(q, k, v), causal=True).numpy()
    pallas = jflash(q, k, v, causal=True, block_q=32, block_k=32,
                    interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **F32)
    pad = (-t) % 32
    kp, vp = (np.pad(x, ((0, 0), (0, pad), (0, 0), (0, 0))) for x in (k, v))
    scan = jchunked(q, kp, vp, q_offset=0, chunk=32, causal=True,
                    kv_len=t if pad else None)
    np.testing.assert_allclose(got, np.asarray(scan), **F32)


def test_plain_flash_noncausal():
    q, k, v = _qkv(2, 32, 64, 4, 4, 32, seed=1)
    got = ref.flash_attention(*_t(q, k, v), causal=False).numpy()
    pallas = jflash(q, k, v, causal=False, block_q=16, block_k=32,
                    interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **F32)
    scan = jchunked(q, k, v, q_offset=0, chunk=32, causal=False)
    np.testing.assert_allclose(got, np.asarray(scan), **F32)


def test_plain_flash_noncausal_ragged_keys_excludes_the_tail():
    """S = 50 is no block multiple: the port excludes keys >= S, which is
    chunked_attention(..., kv_len=S) (the Pallas kernel would attend to
    its zero padding here, as its docstring warns)."""
    q, k, v = _qkv(1, 20, 50, 4, 2, 16, seed=2)
    got = ref.flash_attention(*_t(q, k, v), causal=False, chunk=32).numpy()
    kp, vp = (np.pad(x, ((0, 0), (0, 14), (0, 0), (0, 0))) for x in (k, v))
    scan = jchunked(q, kp, vp, q_offset=0, chunk=32, causal=False, kv_len=50)
    np.testing.assert_allclose(got, np.asarray(scan), **F32)


def test_plain_flash_bf16_inputs():
    q, k, v = _qkv(1, 64, 64, 4, 2, 32, seed=2)
    qb, kb, vb = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = ref.flash_attention(qb, kb, vb, causal=True)
    assert got.dtype == torch.bfloat16
    oracle = jchunked(*(x.float().numpy() for x in (qb, kb, vb)),
                      q_offset=0, chunk=32, causal=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(oracle),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("chunk", [8, 32, 128])
def test_plain_flash_does_not_depend_on_the_chunk(chunk):
    q, k, v = _t(*_qkv(2, 40, 40, 6, 3, 16, seed=3))
    want = ref.flash_attention(q, k, v, causal=True, chunk=40)
    got = ref.flash_attention(q, k, v, causal=True, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)


@pytest.mark.parametrize("q_offset,causal,kv_len", [
    (0, True, None), (16, True, None), (0, True, 40), (0, False, 40),
    (24, True, 33)])
def test_chunked_attention_matches_reference(q_offset, causal, kv_len):
    q, k, v = _qkv(2, 16, 48, 4, 2, 16, seed=4)
    got = chunked_attention(*_t(q, k, v), q_offset=q_offset, chunk=16,
                            causal=causal, kv_len=kv_len).numpy()
    want = jchunked(q, k, v, q_offset=q_offset, chunk=16, causal=causal,
                    kv_len=kv_len)
    np.testing.assert_allclose(got, np.asarray(want), **F32)


def test_chunked_attention_takes_padded_keys_only():
    q, k, v = _t(*_qkv(1, 8, 20, 2, 2, 16))
    with pytest.raises(ValueError, match="multiple of chunk"):
        chunked_attention(q, k, v, q_offset=0, chunk=16)


def test_cpu_dispatch_runs_the_plain_version_and_counts_nothing():
    q, k, v = _t(*_qkv(2, 33, 33, 4, 1, 16, seed=5))
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal=True)
    assert torch.equal(got, ref.flash_attention(q, k, v, causal=True))
    assert ops.launch_counts()["flash_attention"] == 0


def test_kernel_wrapper_refuses_host_tensors():
    q, k, v = _t(*_qkv(1, 8, 8, 2, 2, 16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tflash_kernel.flash_attention(q, k, v)


def _kernel_precision(q, k, v, *, causal, split=True, block_k=64):
    """The bf16 CUDA kernel's arithmetic in plain torch.  q (B, T, H, d),
    k/v (B, S, KV, d) bf16 -> (B, T, H, d) bf16.  Products of bf16 values
    are exact in f32; scores are scaled after the product; the online
    softmax runs in f32 over ``block_k``-key tiles and l sums the f32 P;
    P.V takes P as bf16 hi + lo (``split``) or as bf16 alone, V exact."""
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    n_keys = min(s, t) if causal else s
    qf = q.float().reshape(b, t, kv, h // kv, d)
    m = torch.full((b, kv, h // kv, t), ref.NEG_INF)
    l = torch.zeros((b, kv, h // kv, t))
    o = torch.zeros((b, kv, h // kv, t, d))
    qpos = torch.arange(t)
    for k0 in range(0, n_keys, block_k):
        kt, vt = k[:, k0:k0 + block_k].float(), v[:, k0:k0 + block_k].float()
        sc = torch.einsum("btkgh,bskh->bkgts", qf, kt) * d ** -0.5
        kpos = k0 + torch.arange(kt.shape[1])
        mask = (kpos < n_keys)[None, :]
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        sc = torch.where(mask, sc, torch.full_like(sc, ref.NEG_INF))
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        hi = p.bfloat16().float()
        pv = torch.einsum("bkgts,bskh->bkgth", hi, vt)
        if split:
            lo = (p - hi).bfloat16().float()
            pv = pv + torch.einsum("bkgts,bskh->bkgth", lo, vt)
        o = o * alpha[..., None] + pv
        m = m_new
    o = o / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(b, t, h, d).bfloat16()


def _bf16_tolerance_ratio(got, want):
    """Worst |got - want| over the card's bf16 tolerance (one bf16 ulp of
    the larger value, 2^-7 relative, plus 1e-5); at most 1 passes."""
    g, w = got.float(), want.float()
    tol = 2.0 ** -7 * torch.maximum(g.abs(), w.abs()) + 1e-5
    return float(((g - w).abs() / tol).max())


def _bf16_qkv(b, t, s, h, kv, d, seed):
    return tuple(torch.from_numpy(x).bfloat16()
                 for x in _qkv(b, t, s, h, kv, d, seed=seed))


@pytest.mark.parametrize("h,kv,d", SERVING_HEADS, ids=str)
def test_kernel_precision_within_bf16_tolerance(h, kv, d):
    """The emulated kernel against the plain version and the JAX scan at
    the serving head layouts, causal, T = 256 (four 64-key tiles)."""
    q, k, v = _bf16_qkv(1, 256, 256, h, kv, d, seed=h + d)
    got = _kernel_precision(q, k, v, causal=True)
    want = ref.flash_attention(q, k, v, causal=True)
    assert _bf16_tolerance_ratio(got, want) <= 1.0
    scan = jchunked(*(x.float().numpy() for x in (q, k, v)), q_offset=0,
                    chunk=64, causal=True)
    scan = torch.from_numpy(np.asarray(scan)).bfloat16()
    assert _bf16_tolerance_ratio(got, scan) <= 1.0


def test_kernel_precision_needs_the_split_p_at_minitron_head_shape():
    """One minitron-8b head at prefill length (T = S = 2048, d = 128):
    with P split into bf16 hi + lo the kernel's arithmetic stays within
    the tolerance; with P in bf16 alone it does not (its error, up to
    2^-9 of the largest |v|, outgrows 1e-5 where |o| is small)."""
    q, k, v = _bf16_qkv(1, 2048, 2048, 1, 1, 128, seed=0)
    want = ref.flash_attention(q, k, v, causal=True)
    split = _kernel_precision(q, k, v, causal=True)
    alone = _kernel_precision(q, k, v, causal=True, split=False)
    assert _bf16_tolerance_ratio(split, want) <= 1.0
    assert _bf16_tolerance_ratio(alone, want) > 1.0


if __name__ == "__main__":
    for seed in range(3):
        q, k, v = _bf16_qkv(1, 2048, 2048, 1, 1, 128, seed=seed)
        want = ref.flash_attention(q, k, v, causal=True)
        for split in (True, False):
            got = _kernel_precision(q, k, v, causal=True, split=split)
            print(f"seed {seed}, P {'hi + lo' if split else 'bf16 alone'}: "
                  f"{_bf16_tolerance_ratio(got, want):.3f}x the tolerance, "
                  f"max |diff| "
                  f"{float((got.float() - want.float()).abs().max()):.3e}")
