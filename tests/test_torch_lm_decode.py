"""The torch port's dense LM decode, and its layers, against the JAX
package on the CPU.

Same carried weights as ``tests/test_torch_lm.py``.  Decode logits must
agree with the reference's ``make_decode_step`` within ``TOL`` (relative
to the largest |logit|: both run f32 softmax over the cache, in other
summation orders), greedy tokens exactly, and the port's decode at
position t with its own prefill over t + 1 tokens within ``TOL`` (the
check ``tests/test_models.py`` makes of the reference, there at 2e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro.train.steps import make_decode_step as jmake_decode
from repro.train.steps import make_prefill_step as jmake_prefill
from repro_torch.models import layers as tlayers
from repro_torch.train.steps import make_decode_step, make_prefill_step
from test_torch_lm import assert_close, carried

TOL = 1e-5


def _jax_pad(cache, extra):
    def pad(path, x):
        if str(getattr(path[-1], "key", "")) in ("k", "v"):
            return jnp.pad(x, ((0, 0), (0, 0), (0, extra), (0, 0), (0, 0)))
        return x
    return jax.tree_util.tree_map_with_path(pad, cache)


@pytest.mark.parametrize("arch", ["stablelm-3b", "minitron-8b",
                                  "granite-34b"])
def test_decode_steps_match_reference(arch):
    """Teacher-forced decode: the same 4 tokens into both caches."""
    jm, params, tm = carried(arch, seed=2)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, 17), dtype=np.int32)
    steps = rng.integers(0, tm.cfg.vocab_size, (4, 2, 1), dtype=np.int32)
    _, jcache = jax.jit(jmake_prefill(jm))(params, toks)
    jcache = _jax_pad(jcache, len(steps))
    _, tcache = make_prefill_step(tm)(torch.from_numpy(toks))
    tcache = tm.extend_cache(tcache, len(steps))
    jdecode, tdecode = jax.jit(jmake_decode(jm)), make_decode_step(tm)
    for step in steps:
        jtok, jlogits, jcache = jdecode(params, step, jcache)
        ttok, tlogits, tcache = tdecode(torch.from_numpy(step), tcache)
        assert_close(tlogits.numpy(), jlogits, TOL)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        assert tcache["len"] == int(jcache["len"])
    for name in ("k", "v"):
        assert_close(tcache["blocks"][name].numpy(),
                     jcache["blocks"][name], TOL)


@pytest.mark.parametrize("arch", ["nemotron-4-15b", "granite-34b"])
def test_greedy_tokens_equal_reference(arch):
    jm, params, tm = carried(arch, seed=4)
    toks = np.random.default_rng(5).integers(0, tm.cfg.vocab_size, (3, 12),
                                             dtype=np.int32)
    n_new = 6
    jlogits, jcache = jax.jit(jmake_prefill(jm))(params, toks)
    jcache = _jax_pad(jcache, n_new)
    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    jdecode = jax.jit(jmake_decode(jm))
    want = [np.asarray(jtok)]
    for _ in range(n_new - 1):
        jtok, _, jcache = jdecode(params, jtok, jcache)
        want.append(np.asarray(jtok))

    tlogits, tcache = make_prefill_step(tm)(torch.from_numpy(toks))
    tcache = tm.extend_cache(tcache, n_new)
    ttok = torch.argmax(tlogits, -1)
    tdecode = make_decode_step(tm)
    got = [ttok.numpy()]
    for _ in range(n_new - 1):
        ttok, _, tcache = tdecode(ttok, tcache)
        got.append(ttok.numpy())
    np.testing.assert_array_equal(np.concatenate(got, 1),
                                  np.concatenate(want, 1))


@pytest.mark.parametrize("arch", ["stablelm-3b", "minitron-8b",
                                  "granite-34b", "nemotron-4-15b"])
def test_decode_matches_full_forward(arch):
    """Decode at position t sees the logits of a prefill over t + 1
    tokens (the cache is right); the port alone."""
    _, _, tm = carried(arch, seed=1)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, tm.cfg.vocab_size, (2, 17), dtype=np.int64))
    t = toks.shape[1] - 1
    prefill, decode = make_prefill_step(tm), make_decode_step(tm)
    _, cache = prefill(toks[:, :t])
    cache = tm.extend_cache(cache, 1)
    _, logits_dec, cache = decode(toks[:, t:], cache)
    logits_full, _ = prefill(toks)
    assert cache["len"] == t + 1
    assert_close(logits_dec.numpy(), logits_full.numpy(), TOL)


def test_decode_from_an_empty_cache_matches_prefill():
    """init_cache + one decode per token equals one prefill."""
    _, _, tm = carried("minitron-8b", seed=7)
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, tm.cfg.vocab_size, (2, 9), dtype=np.int64))
    cache = tm.init_cache(2, 9)
    decode = make_decode_step(tm)
    for i in range(9):
        _, logits, cache = decode(toks[:, i:i + 1], cache)
    want_logits, want_cache = make_prefill_step(tm)(toks)
    assert_close(logits.numpy(), want_logits.numpy(), TOL)
    for name in ("k", "v"):
        assert_close(cache["blocks"][name].numpy(),
                     want_cache["blocks"][name].numpy(), TOL)
    with pytest.raises(ValueError, match="free cache slot"):
        decode(toks[:, :1], cache)


# --------------------------------------------------------------------------- #
# Layers                                                                      #
# --------------------------------------------------------------------------- #

def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_rms_norm_matches_reference():
    x, w = _x(3, 5, 64), _x(64, seed=1)
    got = tlayers.rms_norm(torch.from_numpy(w), torch.from_numpy(x), 1e-5)
    want = jlayers.rms_norm(w, x, 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("d", [16, 80, 128])
def test_rope_matches_reference(d):
    x = _x(2, 11, 3, d)
    pos = np.broadcast_to(np.arange(11) + 5, (2, 11)).astype(np.int32)
    got = tlayers.rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                       10000.0)
    want = jlayers.rope(x, pos, 10000.0)
    # f32 cos/sin of angles up to 15 rad, from two libraries
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mlp_type", ["swiglu", "relu2", "gelu"])
def test_mlp_matches_reference(mlp_type):
    params = jlayers.init_mlp(jax.random.PRNGKey(0), 32, 48, mlp_type,
                              jnp.float32)
    mlp = tlayers.MLP(32, 48, mlp_type, torch.float32, "cpu")
    mlp.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in params.items()})
    x = _x(4, 32, seed=2)
    np.testing.assert_allclose(
        mlp(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jlayers.apply_mlp(params, x, mlp_type)), rtol=1e-5,
        atol=1e-5)

