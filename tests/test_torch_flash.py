"""The torch port's plain flash attention against the JAX package.

``repro_torch.kernels.ref.flash_attention`` (the plain version of the
port's CUDA flash kernel, which the CPU path runs) against the Pallas
kernel in interpret mode and against ``chunked_attention``, on the cases
of ``tests/test_flash_kernel.py`` plus ``d = 80`` (stablelm-3b's head
dim).  Tolerances are those of ``tests/test_flash_kernel.py``: 2e-5 for
f32 (the same online softmax, summed in other orders), 2e-2 for bf16
inputs held against the f32 oracle.  The CUDA kernel is held to the plain
version on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
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
