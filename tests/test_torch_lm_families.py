"""The torch port's MoE, SSM, hybrid, VLM and encoder-decoder families
against the JAX package, on the CPU.

Both packages run the six non-dense smoke configs (float32) with the same
weights: the reference's ``init`` pytree, carried into the port by
``repro_torch.models.convert``.  Prefill logits and every cache leaf,
decode logits and the greedy tokens must agree: floats within ``TOL``
relative to the largest |value| of the compared tensor (the same f32
arithmetic summed in other orders: matmuls, the attention scan, which
pads keys in the reference and bounds-checks them in the port, and the
SSD einsums), integers exactly (greedy tokens; MoE's dropped tokens).
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import attention as jattn
from repro.models import build_model as jbuild_model
from repro.models import layers as jlayers
from repro.models import mamba2 as jmamba
from repro.models import moe as jmoe
from repro.models import whisper as jwhisper
from repro.train.steps import make_decode_step as jmake_decode
from repro.train.steps import make_prefill_step as jmake_prefill
from repro_torch import configs as tconfigs
from repro_torch.kernels import ops
from repro_torch.launch import serve_lm
from repro_torch.models import DecoderLM, WhisperModel
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import mamba2 as tmamba
from repro_torch.models import moe as tmoe
from repro_torch.models import whisper as twhisper
from repro_torch.models.convert import (lm_params_from_numpy,
                                        whisper_params_from_numpy)
from repro_torch.train.steps import make_decode_step, make_prefill_step
from test_torch_lm import assert_close

FAMILIES = ["olmoe-1b-7b", "arctic-480b", "mamba2-130m", "zamba2-1.2b",
            "llava-next-34b", "whisper-base"]
TOL = 1e-5


def carried(arch: str, seed: int = 0):
    """(JAX model, its params, the port's model with the same weights)."""
    jm = jbuild_model(jget_smoke(arch))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    cfg = tconfigs.get_smoke_config(arch)
    if cfg.family == "encdec":
        tm = WhisperModel(cfg, device="cpu")
        tm.load_state_dict(whisper_params_from_numpy(params, cfg))
    else:
        tm = DecoderLM(cfg, device="cpu")
        tm.load_state_dict(lm_params_from_numpy(params, cfg))
    return jm, params, tm.eval()


def _extra(cfg, b: int, seed: int = 9):
    """The stub frontend's input: patches (vlm) or frames (encdec)."""
    if cfg.family not in ("vlm", "encdec"):
        return None
    n = cfg.n_patches if cfg.family == "vlm" else cfg.encoder_len
    return np.random.default_rng(seed).standard_normal(
        (b, n, cfg.d_model)).astype(np.float32)


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _leaves(cache: dict, prefix: str = ""):
    """(path, tensor) for every tensor leaf, ``len`` left out."""
    for key, val in cache.items():
        if isinstance(val, dict):
            yield from _leaves(val, f"{prefix}{key}.")
        elif key != "len":
            yield f"{prefix}{key}", val


def _assert_caches_close(got: dict, want: dict):
    got_l = dict(_leaves(got))
    want_l = {k: np.asarray(v) for k, v in _leaves(want)}
    assert sorted(got_l) == sorted(want_l)
    for name, w in want_l.items():
        assert_close(got_l[name].numpy(), w)
    assert got["len"] == int(want["len"])


def _jax_pad(cache, extra):
    """The reference's ``pad_kv``: grow every leaf named k / v."""
    def pad(path, x):
        if str(getattr(path[-1], "key", "")) in ("k", "v"):
            return jnp.pad(x, ((0, 0), (0, 0), (0, extra), (0, 0), (0, 0)))
        return x
    return jax.tree_util.tree_map_with_path(pad, cache)


# --------------------------------------------------------------------------- #
# The families end to end                                                     #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_logits_and_cache_match_reference(arch):
    jm, params, tm = carried(arch)
    cfg = tm.cfg
    # T = 21: no multiple of attn_chunk (16) nor ssm_chunk (8)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 21),
                                             dtype=np.int32)
    extra = _extra(cfg, 2)
    want_logits, want_cache = jax.jit(jmake_prefill(jm))(params, toks, extra)
    ops.reset_launch_counts()
    got_logits, got_cache = make_prefill_step(tm)(torch.from_numpy(toks),
                                                  _t(extra))
    assert ops.launch_counts()["flash_attention"] == 0   # plain on the CPU
    assert_close(got_logits.numpy(), want_logits)
    _assert_caches_close(got_cache, want_cache)


@pytest.mark.parametrize("arch", FAMILIES)
def test_greedy_decode_matches_reference(arch):
    """Prefill, then three greedy decode steps in both packages: logits
    within TOL at every step, tokens equal, every cache leaf after."""
    jm, params, tm = carried(arch, seed=2)
    cfg = tm.cfg
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 13),
                                             dtype=np.int32)
    extra = _extra(cfg, 2, seed=4)
    n_new = 3
    jlogits, jcache = jax.jit(jmake_prefill(jm))(params, toks, extra)
    jcache = _jax_pad(jcache, n_new)
    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    tlogits, tcache = make_prefill_step(tm)(torch.from_numpy(toks),
                                            _t(extra))
    tcache = tm.extend_cache(tcache, n_new)
    ttok = torch.argmax(tlogits, -1)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    jdecode, tdecode = jax.jit(jmake_decode(jm)), make_decode_step(tm)
    for _ in range(n_new):
        jtok, jlogits, jcache = jdecode(params, jtok, jcache)
        ttok, tlogits, tcache = tdecode(ttok, tcache)
        assert_close(tlogits.numpy(), jlogits)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    _assert_caches_close(tcache, jcache)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_full_forward(arch):
    """Decode at position t sees the logits of a prefill over t + 1
    tokens (the caches are right); the port alone."""
    _, _, tm = carried(arch, seed=1)
    cfg = tm.cfg
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 17), dtype=np.int64))
    extra = _t(_extra(cfg, 2, seed=7))
    t = toks.shape[1] - 1
    prefill, decode = make_prefill_step(tm), make_decode_step(tm)
    _, cache = prefill(toks[:, :t], extra)
    cache = tm.extend_cache(cache, 1)
    _, logits_dec, cache = decode(toks[:, t:], cache)
    logits_full, full_cache = prefill(toks, extra)
    assert cache["len"] == full_cache["len"]
    assert_close(logits_dec.numpy(), logits_full.numpy())


def test_capacity_bound_moe_lm_matches_reference():
    """olmoe-smoke with groups of 128 and capacity factor 0.5: capacity
    int(128 * 4 * 0.5 / 8) = 32 drops slots in prefill (the zero rows
    that pad 140 tokens to two groups take capacity too); the port drops
    the reference's slots, so prefill logits, caches and two decode steps
    agree.  A decode step stays dropless (groups of B = 2 tokens)."""
    cfg_j = dataclasses.replace(jget_smoke("olmoe-1b-7b"),
                                moe_group_size=128, capacity_factor=0.5)
    cfg_t = tconfigs.ModelConfig(**dataclasses.asdict(cfg_j))
    jm = jbuild_model(cfg_j)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(5)))
    tm = DecoderLM(cfg_t, device="cpu")
    tm.load_state_dict(lm_params_from_numpy(params, cfg_t))
    toks = np.random.default_rng(6).integers(0, cfg_t.vocab_size, (2, 70),
                                             dtype=np.int32)
    jlogits, jcache = jax.jit(jmake_prefill(jm))(params, toks)
    tlogits, tcache = make_prefill_step(tm)(torch.from_numpy(toks))
    assert_close(tlogits.numpy(), jlogits)
    _assert_caches_close(tcache, jcache)
    jcache, tcache = _jax_pad(jcache, 2), tm.extend_cache(tcache, 2)
    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    ttok = torch.argmax(tlogits, -1)
    jdecode, tdecode = jax.jit(jmake_decode(jm)), make_decode_step(tm)
    for _ in range(2):
        jtok, jlogits, jcache = jdecode(params, jtok, jcache)
        ttok, tlogits, tcache = tdecode(ttok, tcache)
        assert_close(tlogits.numpy(), jlogits)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    # 8 experts x 32 < 128 tokens x 4 slots: a full group drops at least
    # half its slots
    assert tmoe._capacity(128, cfg_t.top_k, cfg_t.n_experts,
                          cfg_t.capacity_factor) == 32


@pytest.mark.parametrize("group, dropless", [(96, False), (64, True)])
def test_moe_decode_is_a_longer_prefill_only_when_dropless(group, dropless):
    """olmoe-smoke (8 experts, top 4): a prefill over 96 tokens a row and
    one decode step against a prefill over 97.  With groups of 96
    (capacity 60) the two differ, in the reference as in the port:
    capacity is taken slot by slot, so the zero rows that pad the last
    group (and later tokens) take an expert before the last token's later
    slots, while the decode step routes it dropless; both packages give
    the same logits either way.  With groups of 64 (64 x 4 <= 256: the
    reference's dropless regime) decode equals the longer prefill."""
    cfg_j = dataclasses.replace(jget_smoke("olmoe-1b-7b"),
                                moe_group_size=group)
    cfg_t = tconfigs.ModelConfig(**dataclasses.asdict(cfg_j))
    jm = jbuild_model(cfg_j)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(7)))
    tm = DecoderLM(cfg_t, device="cpu")
    tm.load_state_dict(lm_params_from_numpy(params, cfg_t))
    toks = np.random.default_rng(8).integers(0, cfg_t.vocab_size, (2, 97),
                                             dtype=np.int32)
    _, jcache = jax.jit(jmake_prefill(jm))(params, toks[:, :96])
    _, jdec, _ = jax.jit(jmake_decode(jm))(params, toks[:, 96:],
                                           _jax_pad(jcache, 1))
    jfull = np.concatenate([np.asarray(jax.jit(jmake_prefill(jm))(
        params, toks[r:r + 1])[0]) for r in range(2)])
    _, tcache = make_prefill_step(tm)(torch.from_numpy(toks[:, :96]))
    _, tdec, _ = make_decode_step(tm)(torch.from_numpy(toks[:, 96:]),
                                      tm.extend_cache(tcache, 1))
    tfull = torch.cat([make_prefill_step(tm)(torch.from_numpy(
        toks[r:r + 1]))[0] for r in range(2)])
    assert_close(tdec.numpy(), jdec)
    assert_close(tfull.numpy(), jfull)
    apart = float(np.abs(np.asarray(jdec) - jfull).max()
                  / np.abs(jfull).max())
    if dropless:
        assert apart <= TOL
    else:
        assert apart > 100 * TOL


def test_decode_from_an_empty_cache_matches_prefill():
    """zamba2: init_cache + one decode per token equals one prefill, the
    mamba states and the shared block's k / v included."""
    _, _, tm = carried("zamba2-1.2b", seed=7)
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, tm.cfg.vocab_size, (2, 11), dtype=np.int64))
    cache = tm.init_cache(2, 11)
    decode = make_decode_step(tm)
    for i in range(11):
        _, logits, cache = decode(toks[:, i:i + 1], cache)
    want_logits, want_cache = make_prefill_step(tm)(toks)
    assert_close(logits.numpy(), want_logits.numpy())
    got_l, want_l = dict(_leaves(cache)), dict(_leaves(want_cache))
    assert sorted(got_l) == ["blocks.conv", "blocks.ssm", "shared.k",
                             "shared.v"] == sorted(want_l)
    for name in got_l:
        assert_close(got_l[name].numpy(), want_l[name].numpy())


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "whisper-base"])
def test_extend_cache_grows_attention_leaves_only(arch):
    _, _, tm = carried(arch)
    toks = torch.zeros((2, 5), dtype=torch.int64)
    _, cache = make_prefill_step(tm)(toks, _t(_extra(tm.cfg, 2)))
    grown = tm.extend_cache(cache, 3)
    for name, x in _leaves(cache):
        y = dict(_leaves(grown))[name]
        if name.split(".")[-1] in ("k", "v"):
            assert y.shape[2] == x.shape[2] + 3
            assert torch.equal(y[:, :, :x.shape[2]], x)
            assert not y[:, :, x.shape[2]:].any()
        else:      # conv, ssm, enc_k / enc_v: the same tensors
            assert y is x


@pytest.mark.parametrize("arch", list(tconfigs.ARCHS))
def test_serve_lm_smoke_on_cpu_every_arch(arch, capsys):
    rc = serve_lm.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "9", "--gen", "4"])
    out = capsys.readouterr().out
    assert rc == 0
    name = tconfigs.get_smoke_config(arch).name
    assert f"[serve_lm] arch={name} prefill=" in out
    samples = re.findall(r"\[serve_lm\] sample (\d): \[(.*)\]", out)
    assert [s[0] for s in samples] == ["0", "1"]
    assert all(len(s[1].split(",")) == 4 for s in samples)


# --------------------------------------------------------------------------- #
# MoE                                                                         #
# --------------------------------------------------------------------------- #

def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _moe_pair(cfg, seed=0):
    params = jax.tree.map(np.asarray,
                          jmoe.init_moe(jax.random.PRNGKey(seed), cfg,
                                        jnp.float32))
    tm = tmoe.MoE(tconfigs.ModelConfig(**dataclasses.asdict(cfg)),
                  torch.float32, "cpu")
    tm.load_state_dict({k: torch.from_numpy(v.copy())
                        for k, v in params.items()})
    return params, tm


def _assert_moe_matches(cfg, x, params, tm):
    jy, jaux = jmoe.apply_moe(params, x, cfg)
    ty, taux = tmoe.apply_moe(tm, torch.from_numpy(x), cfg)
    jy = np.asarray(jy)
    assert_close(ty.numpy(), jy)
    # a token none of whose slots was kept gets exactly 0 in both
    np.testing.assert_array_equal((ty.numpy() == 0).all(-1),
                                  (jy == 0).all(-1))
    for name in ("load_balance_loss", "router_z_loss"):
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]),
                                   rtol=1e-6)
    return ty


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "arctic-480b"])
def test_moe_matches_reference(arch):
    cfg = jget_smoke(arch)
    params, tm = _moe_pair(cfg)
    # 42 tokens: one full group of 32 and a zero-padded one
    _assert_moe_matches(cfg, _x(2, 21, cfg.d_model, seed=1), params, tm)


@pytest.mark.parametrize("x_shape, group", [((2, 32), 32), ((2, 48), 128)])
def test_moe_capacity_drops_the_reference_tokens(x_shape, group):
    """The reference's ``test_moe_capacity_drops_tokens`` case (capacity
    factor 0.1; its groups of 32 x top-4 stay dropless), and groups of 96
    tokens, where capacity int(96 * 4 * 0.1 / 8) = 4 drops most slots:
    the port keeps and drops the same (token, expert) slots, so y agrees,
    fully dropped tokens included."""
    cfg = dataclasses.replace(jget_smoke("olmoe-1b-7b"), capacity_factor=0.1,
                              moe_group_size=group)
    params, tm = _moe_pair(cfg)
    x = _x(*x_shape, cfg.d_model, seed=2)
    y = _assert_moe_matches(cfg, x, params, tm)
    assert np.isfinite(y.numpy()).all()
    s = min(group, x_shape[0] * x_shape[1])
    c = tmoe._capacity(s, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    if s * cfg.top_k > 256:
        assert c == 4
        assert (y.numpy() == 0).all(-1).any()    # some tokens lost every slot


def test_moe_single_expert_equals_dense_mlp():
    cfg = dataclasses.replace(jget_smoke("olmoe-1b-7b"), n_experts=1,
                              top_k=1, capacity_factor=2.0, moe_group_size=16)
    _, tm = _moe_pair(cfg)
    mlp = tlayers.MLP(cfg.d_model, cfg.d_ff, "swiglu", torch.float32, "cpu")
    mlp.load_state_dict({k: getattr(tm, k)[0] for k in
                         ("w_gate", "w_up", "w_down")})
    x = torch.from_numpy(_x(2, 16, cfg.d_model, seed=1))
    y, aux = tm(x)
    assert_close(y.detach().numpy(), mlp(x).detach().numpy())
    assert np.isfinite(float(aux["load_balance_loss"]))


def test_moe_top_k_ties_go_to_the_lower_expert():
    """Router columns 1, 2 and 5 equal: every token's probabilities tie
    across those experts, and both packages take the lower indices."""
    cfg = dataclasses.replace(jget_smoke("arctic-480b"), top_k=2)
    params, tm = _moe_pair(cfg, seed=3)
    router = params["router"].copy()
    router[:, 1] += 5.0 * np.abs(router).max()   # the top one for x > 0
    router[:, 2] = router[:, 5] = router[:, 1]   # tied three ways
    params = {**params, "router": router}
    with torch.no_grad():
        tm.router.copy_(torch.from_numpy(router))
    x = np.abs(_x(2, 9, cfg.d_model, seed=4))
    _assert_moe_matches(cfg, x, params, tm)
    probs = np.array(jax.nn.softmax(x.reshape(-1, cfg.d_model) @ router))
    _, experts = tmoe._top_k(torch.from_numpy(probs), 2)
    assert (experts.numpy() == [1, 2]).all()


def test_top_k_matches_lax_top_k_on_ties():
    vals = np.random.default_rng(5).integers(0, 4, (64, 16)).astype(
        np.float32)
    for k in (1, 3, 8):
        jv, ji = jax.lax.top_k(vals, k)
        tv, ti = tmoe._top_k(torch.from_numpy(vals), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# --------------------------------------------------------------------------- #
# Mamba2 SSD                                                                  #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("t, chunk", [(24, 8), (21, 8), (5, 8), (37, 16)])
def test_ssd_scan_matches_reference(t, chunk):
    b, h, p, n = 2, 3, 4, 5
    x, b_mat, c_mat = (_x(b, t, h, p, seed=1), _x(b, t, n, seed=2),
                       _x(b, t, n, seed=3))
    dt = np.abs(_x(b, t, h, seed=4)) * 0.5
    a_log = np.log(np.linspace(1.0, 16.0, h)).astype(np.float32)
    jy, js = jmamba.ssd_scan(x, dt, a_log, b_mat, c_mat, chunk)
    ty, ts = tmamba.ssd_scan(*map(torch.from_numpy, (x, dt, a_log, b_mat,
                                                     c_mat)), chunk)
    assert_close(ty.numpy(), jy)
    assert_close(ts.numpy(), js)


def test_ssd_scan_equals_the_decode_recurrence():
    """The state-space-duality identity: the chunked scan (ragged: 21
    steps in chunks of 8) equals S <- a S + dt B (x) x, y = C . S."""
    b, t, h, p, n = 2, 21, 3, 4, 5
    x, b_mat, c_mat = (torch.from_numpy(_x(b, t, h, p, seed=1)),
                       torch.from_numpy(_x(b, t, n, seed=2)),
                       torch.from_numpy(_x(b, t, n, seed=3)))
    dt = torch.from_numpy(np.abs(_x(b, t, h, seed=4)) * 0.5)
    a_log = torch.log(torch.linspace(1.0, 16.0, h))
    y, s_final = tmamba.ssd_scan(x, dt, a_log, b_mat, c_mat, 8)
    s = torch.zeros(b, h, p, n)
    for i in range(t):
        a = torch.exp(-torch.exp(a_log) * dt[:, i])
        s = s * a[..., None, None] + torch.einsum(
            "bh,bn,bhp->bhpn", dt[:, i], b_mat[:, i], x[:, i])
        assert_close(y[:, i].numpy(),
                     torch.einsum("bn,bhpn->bhp", c_mat[:, i], s).numpy())
    assert_close(s_final.numpy(), s.numpy())


def test_mamba2_block_prefill_and_decode_match_reference():
    cfg = jget_smoke("mamba2-130m")
    params = jax.tree.map(np.asarray, jmamba.init_mamba2(
        jax.random.PRNGKey(1), cfg, jnp.float32))
    tm = tmamba.Mamba2(cfg, torch.float32, "cpu")
    tm.load_state_dict({k: torch.from_numpy(v.copy())
                        for k, v in params.items()})
    x = _x(2, 13, cfg.d_model, seed=5)
    jy, jcache = jmamba.apply_mamba2(params, x[:, :12], cfg)
    ty, (tconv, tssm) = tmamba.apply_mamba2(tm, torch.from_numpy(x[:, :12]),
                                            cfg)
    for got, want in ((ty, jy), (tconv, jcache[0]), (tssm, jcache[1])):
        assert_close(got.detach().numpy(), want)
    jy1, (jconv, jssm) = jmamba.apply_mamba2(params, x[:, 12:], cfg,
                                             cache=jcache)
    ty1, (tconv2, tssm2) = tmamba.apply_mamba2(
        tm, torch.from_numpy(x[:, 12:]), cfg, cache=(tconv, tssm))
    assert tconv2 is tconv and tssm2 is tssm     # written in place
    for got, want in ((ty1, jy1), (tconv, jconv), (tssm, jssm)):
        assert_close(got.detach().numpy(), want)


def test_mamba2_init_mirrors_the_reference():
    cfg = tconfigs.get_smoke_config("mamba2-130m")
    m = tmamba.Mamba2(cfg, torch.float32, "cpu")
    m.reset_parameters(torch.Generator().manual_seed(0))
    h = cfg.ssm_heads
    assert torch.equal(m.a_log, torch.log(torch.linspace(1.0, 16.0, h)))
    assert torch.equal(m.d_skip, torch.ones(h))
    assert not m.conv_b.any()
    dt = torch.nn.functional.softplus(m.dt_bias)
    assert ((dt >= 1e-3 * 0.999) & (dt <= 1e-1 * 1.001)).all()
    assert float(m.conv_w.abs().max()) <= 2.0 * cfg.d_conv ** -0.5
    np.testing.assert_allclose(
        tmamba.softplus(torch.tensor([-30.0, -1.0, 0.0, 3.0, 25.0])).numpy(),
        np.asarray(jax.nn.softplus(jnp.array([-30.0, -1.0, 0.0, 3.0, 25.0],
                                             jnp.float32))), rtol=1e-7)


# --------------------------------------------------------------------------- #
# LayerNorm, non-causal and cross attention                                   #
# --------------------------------------------------------------------------- #

def test_layer_norm_matches_reference():
    x, scale, bias = _x(3, 5, 64), _x(64, seed=1), _x(64, seed=2)
    got = tlayers.layer_norm(torch.from_numpy(scale), torch.from_numpy(bias),
                             torch.from_numpy(x), 1e-5)
    want = jlayers.layer_norm({"scale": scale, "bias": bias}, x, 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _attn_pair(cfg, seed=0):
    params = jax.tree.map(np.asarray, jattn.init_attention(
        jax.random.PRNGKey(seed), cfg, jnp.float32))
    tm = tattn.Attention(cfg, torch.float32, "cpu")
    tm.load_state_dict({k: torch.from_numpy(v.copy())
                        for k, v in params.items()})
    return params, tm


@pytest.mark.parametrize("arch, s", [("whisper-base", 37),
                                     ("llava-next-34b", 23)])
def test_non_causal_attention_at_a_ragged_length_matches_reference(arch, s):
    """S = 37 / 23 keys with attn_chunk 16: the reference pads to 48 / 32
    and masks with kv_len; the port excludes keys >= S."""
    cfg = jget_smoke(arch)
    params, tm = _attn_pair(cfg)
    x = _x(2, s, cfg.d_model, seed=3)
    pos = np.broadcast_to(np.arange(s), (2, s))
    jy, (jk, jv) = jattn.apply_attention(params, x, cfg, positions=pos,
                                         causal=False)
    ty, (tk, tv) = tattn.apply_attention(tm, torch.from_numpy(x), cfg,
                                         positions=torch.from_numpy(
                                             pos.copy()), causal=False)
    for got, want in ((ty, jy), (tk, jk), (tv, jv)):
        assert_close(got.detach().numpy(), want)


def test_kv_x_cross_attention_matches_reference():
    cfg = jget_smoke("whisper-base")
    params, tm = _attn_pair(cfg, seed=1)
    x, enc = _x(2, 7, cfg.d_model, seed=4), _x(2, 19, cfg.d_model, seed=5)
    pos = np.broadcast_to(np.arange(7), (2, 7))
    jy, _ = jattn.apply_attention(params, x, cfg, positions=pos, kv_x=enc)
    ty, _ = tattn.apply_attention(tm, torch.from_numpy(x), cfg,
                                  positions=torch.from_numpy(pos.copy()),
                                  kv_x=torch.from_numpy(enc))
    assert_close(ty.detach().numpy(), jy)


def test_whisper_cross_attention_matches_reference():
    cfg = jget_smoke("whisper-base")
    params, tm = _attn_pair(cfg, seed=2)
    x = _x(2, 5, cfg.d_model, seed=6)
    ek, ev = (_x(2, 8, cfg.n_kv_heads, cfg.head_dim, seed=s) for s in (7, 8))
    want = jwhisper._cross_attend(params, x, ek, ev, cfg)
    got = twhisper.cross_attend(tm, *map(torch.from_numpy, (x, ek, ev)), cfg)
    assert_close(got.detach().numpy(), want)
