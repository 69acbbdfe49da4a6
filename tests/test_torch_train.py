"""The torch port's training path against the JAX package, on the CPU:
``softmax_xent``, remat, the chunked attention's gradient, the train mode
and the train step end to end at stablelm's smoke config (the optimizers:
``tests/test_torch_train_optimizer.py``; the other families:
``tests/test_torch_train_families.py``).

Both packages start from the same numbers: the reference's ``init``
pytree and optimizer state, carried into the port by
``repro_torch.models.convert``, and the same batches (the port's
``SyntheticSource`` is the reference's bit for bit,
``tests/test_torch_train_launch.py``).  Tolerances, each relative to the
largest magnitude of the compared tensor unless said otherwise:

* ``softmax_xent``'s value: 1e-6; its gradients 1e-5 (f32 products of
  the logits' gradient summed over V or B * T terms in another order:
  2.8e-6 at V = 1000);
* one microbatch's gradients through the train mode: 1e-5 (the same f32
  arithmetic in other orders: matmuls, the chunk scan, the SSD einsums);
* the train step (2 microbatches, bf16 accumulator): loss and aux losses
  1e-5 (elementwise relative); the grad norm 2e-4, since the jitted
  reference sums ~1e5 squares in one fused f32 loop, itself up to 1.1e-4
  off its op-by-op sum (arctic's smoke config), which the port agrees
  with to 3.3e-6; each weight's update ``w1 - w0`` against the
  reference's, in units of the step's learning rate: Adam's first step
  moves a weight by about ``lr * sign(g)``, so a gradient at rounding
  level may flip its sign (at most 2 lr apart) and a bf16 accumulator
  flip moves ``g / |g|`` a little; at least 99.9% of each tensor's
  elements within 0.1 lr and all within 2.01 lr.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.configs import get_train_config as jget_train
from repro.data.pipeline import SyntheticSource as JSource
from repro.models import attention as jattn
from repro.models import build_model as jbuild_model
from repro.train import losses as jlosses
from repro.train import optimizer as joptimizer
from repro.train.steps import _loss_fn as jloss_fn
from repro.train.steps import make_train_step as jmake_train_step
from repro_torch import configs as tconfigs
from repro_torch.data.pipeline import SyntheticSource
from repro_torch.kernels import ops
from repro_torch.models import DecoderLM, WhisperModel
from repro_torch.models import attention as tattn
from repro_torch.models.convert import (lm_params_from_numpy,
                                        opt_state_from_numpy,
                                        whisper_params_from_numpy)
from repro_torch.train import losses, optimizer
from repro_torch.train.steps import accumulate_grads, make_train_step

UPDATE_BULK, UPDATE_SHARE, UPDATE_MAX = 0.1, 0.999, 2.01


def _convert(tree, cfg):
    tree = jax.tree.map(np.asarray, tree)
    if cfg.family == "encdec":
        return whisper_params_from_numpy(tree, cfg)
    return lm_params_from_numpy(tree, cfg)


def carried(arch: str, seed: int = 0, **override):
    """(reference model, its params, the port's model with the same
    weights, the port's config) at ``arch``'s smoke config (with
    ``override``)."""
    jcfg = dataclasses.replace(jget_smoke(arch), **override)
    cfg = dataclasses.replace(tconfigs.get_smoke_config(arch), **override)
    jm = jbuild_model(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = (WhisperModel if cfg.family == "encdec" else DecoderLM)(
        cfg, device="cpu")
    tm.load_state_dict(_convert(params, cfg))
    return jm, params, tm, cfg


def batches(cfg, batch: int, seq: int, step: int = 3):
    """The same batch for both packages: the reference's source and the
    port's (bit for bit)."""
    kw = dict(n_patches=cfg.n_patches, d_model=cfg.d_model,
              encoder_len=cfg.encoder_len if cfg.family == "encdec" else 0)
    seq = seq + cfg.n_patches
    return (JSource(cfg.vocab_size, seq, batch, **kw).next_batch(step),
            SyntheticSource(cfg.vocab_size, seq, batch, device="cpu",
                            **kw).next_batch(step))


def rel_max(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def assert_rel(got, want, tol, what=""):
    err = rel_max(got, want)
    assert err <= tol, f"{what}: {err:.3e} > {tol:.1e}"


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().double().numpy()


def check_gradients(arch: str, **override):
    """One microbatch's gradients of the reference's ``_loss_fn`` and the
    port's, every parameter within 1e-5, and the loss and aux losses."""
    jm, params, tm, cfg = carried(arch, **override)
    tcfg = tconfigs.get_train_config(arch)
    jb, tb = batches(cfg, 2, 21)
    grad_fn = jax.jit(jax.grad(functools.partial(jloss_fn, jm,
                                                 jget_train(arch)),
                               has_aux=True))
    jg, jaux = grad_fn(params, jb["tokens"], jb["labels"], jb.get("patches"))
    grads, aux = accumulate_grads(tm, tcfg, tb)
    want = _convert(jg, cfg)
    assert sorted(grads) == sorted(want)
    for name, w in want.items():
        assert grads[name].dtype == w.dtype
        assert_rel(_np(grads[name]), _np(w), 1e-5, name)
    for k, v in aux.items():
        assert_rel(float(v), float(jaux[k]), 1e-5, k)
    return grads


def check_train_step(arch: str, step: int = 0):
    """The reference's jitted ``make_train_step`` and the port's, two
    microbatches, from the same weights, optimizer state and batch."""
    jm, params, tm, cfg = carried(arch)
    jtcfg, tcfg = jget_train(arch), tconfigs.get_train_config(arch)
    jb, tb = batches(cfg, 4, 21)
    jstate = joptimizer.init_opt_state(params, jtcfg)
    state = opt_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg)
    w0 = {n: _np(p) for n, p in tm.named_parameters()}
    _, jstate, jmet = jax.jit(jmake_train_step(jm, jtcfg, n_microbatches=2))(
        params, jstate, jnp.int32(step), jb)
    state, met = make_train_step(tm, tcfg, n_microbatches=2)(state, step, tb)
    assert sorted(met) == sorted(jmet)
    for k in ("loss", "load_balance_loss", "router_z_loss"):
        want = float(jmet[k])
        assert abs(float(met[k]) - want) <= 1e-5 * abs(want), k
    assert abs(float(met["grad_norm"]) - float(jmet["grad_norm"])) <= \
        2e-4 * float(jmet["grad_norm"])
    lr = float(optimizer._schedule(step, tcfg))
    want = _convert(jstate["master"], cfg)
    for n, p in tm.named_parameters():
        du = np.abs((_np(p) - w0[n]) - (_np(want[n]) - w0[n])) / lr
        assert np.mean(du <= UPDATE_BULK) >= UPDATE_SHARE, \
            (n, float(np.mean(du <= UPDATE_BULK)))
        assert du.max() <= UPDATE_MAX, (n, float(du.max()))
    return met


# --------------------------------------------------------------------------- #
# softmax_xent                                                                #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("b,t,d,v", [(2, 5, 16, 97), (1, 33, 64, 1000)])
def test_softmax_xent_value_and_gradient_match_reference(b, t, d, v):
    rng = np.random.default_rng(b * 100 + t)
    h = rng.standard_normal((b, t, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) * 2.0).astype(np.float32)
    labels = rng.integers(0, v, (b, t)).astype(np.int32)
    want, n = jlosses.softmax_xent(h, w, labels)
    gh, gw = jax.grad(lambda h_, w_: jlosses.softmax_xent(h_, w_, labels)[0],
                      argnums=(0, 1))(h, w)
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    got, got_n = losses.softmax_xent(th, tw, torch.from_numpy(labels))
    got.backward()
    assert got.dtype == torch.float32 and got_n == n == b * t
    assert abs(float(got.detach()) - float(want)) <= 1e-6 * abs(float(want))
    assert_rel(_np(th.grad), gh, 1e-5, "d hidden")
    assert_rel(_np(tw.grad), gw, 1e-5, "d unembed")


def test_softmax_xent_takes_the_tied_embedding_transposed():
    """Tied embeddings pass ``embed.T`` (a view) as the unembed matrix."""
    rng = np.random.default_rng(4)
    emb = torch.from_numpy(rng.standard_normal((50, 8)).astype(np.float32))
    h = torch.from_numpy(rng.standard_normal((2, 3, 8)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 50, (2, 3)))
    a, _ = losses.softmax_xent(h, emb.t(), labels)
    b, _ = losses.softmax_xent(h, emb.t().contiguous(), labels)
    assert torch.equal(a, b)


# --------------------------------------------------------------------------- #
# the train mode                                                              #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ["stablelm-3b", "olmoe-1b-7b",
                                  "zamba2-1.2b", "whisper-base"])
def test_remat_policies_give_the_same_gradient_bits(arch):
    cfg = tconfigs.get_smoke_config(arch)
    gen = torch.Generator().manual_seed(5)
    tm = (WhisperModel if cfg.family == "encdec" else DecoderLM)(
        cfg, device="cpu")
    tm.reset_parameters(gen)
    _, tb = batches(cfg, 2, 21)
    grads = {}
    for policy in ("none", "full", "dots"):
        tcfg = dataclasses.replace(tconfigs.get_train_config(arch),
                                   remat=policy)
        grads[policy], _ = accumulate_grads(tm, tcfg, tb, n_microbatches=2)
    for policy in ("full", "dots"):
        for n, g in grads["none"].items():
            assert torch.equal(grads[policy][n].view(torch.int16),
                               g.view(torch.int16)), (policy, n)


def test_unknown_remat_policy_raises():
    cfg = tconfigs.get_smoke_config("stablelm-3b")
    tm = DecoderLM(cfg, device="cpu")
    tm.reset_parameters(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="remat"):
        tm(torch.zeros((1, 4), dtype=torch.int64), mode="train",
           remat="offload")


@pytest.mark.parametrize("causal,t,s,chunk", [(True, 7, 8, 4),
                                              (False, 5, 6, 4)])
def test_chunked_attention_gradcheck_f64(causal, t, s, chunk):
    """The chunk scan differentiates (no in-place write on the graph),
    keys padded to the chunk and masked by ``kv_len`` as in training."""
    rng = np.random.default_rng(t)
    q = torch.from_numpy(rng.standard_normal((1, t, 4, 3))) \
        .requires_grad_(True)
    k = torch.from_numpy(rng.standard_normal((1, s, 2, 3))) \
        .requires_grad_(True)
    v = torch.from_numpy(rng.standard_normal((1, s, 2, 3))) \
        .requires_grad_(True)

    def f(q_, k_, v_):
        pad = (-s) % chunk
        kp = torch.nn.functional.pad(k_, (0, 0, 0, 0, 0, pad))
        vp = torch.nn.functional.pad(v_, (0, 0, 0, 0, 0, pad))
        return tattn.chunked_attention(q_, kp, vp, q_offset=0, chunk=chunk,
                                       causal=causal, kv_len=s)
    assert torch.autograd.gradcheck(f, (q, k, v))
    want = jattn.chunked_attention(
        q.detach().numpy(), np.pad(k.detach().numpy(),
                                   ((0, 0), (0, (-s) % chunk), (0, 0),
                                    (0, 0))),
        np.pad(v.detach().numpy(), ((0, 0), (0, (-s) % chunk), (0, 0),
                                    (0, 0))),
        q_offset=0, chunk=chunk, causal=causal, kv_len=s)
    # the reference's scan runs in f32 whatever the input dtype
    assert_rel(_np(f(q, k, v)), np.asarray(want), 1e-6, "value")


@pytest.mark.parametrize("arch", ["stablelm-3b", "olmoe-1b-7b",
                                  "mamba2-130m", "zamba2-1.2b",
                                  "llava-next-34b", "whisper-base"])
def test_train_mode_never_calls_the_flash_kernel(arch, monkeypatch):
    """The train forward takes the chunk scan: the flash kernel has no
    backward, so on the card it would leave the attention projections
    without gradients.  Here any call of ``ops.flash_attention`` fails,
    and every attention projection gets a gradient."""
    def refuse(*a, **k):
        raise AssertionError("ops.flash_attention in the train mode")
    monkeypatch.setattr(ops, "flash_attention", refuse)
    cfg = tconfigs.get_smoke_config(arch)
    tm = (WhisperModel if cfg.family == "encdec" else DecoderLM)(
        cfg, device="cpu")
    tm.reset_parameters(torch.Generator().manual_seed(1))
    _, tb = batches(cfg, 2, 9)
    grads, _ = accumulate_grads(tm, tconfigs.get_train_config(arch), tb)
    proj = [n for n in grads if n.split(".")[-1] in ("wq", "wk", "wv", "wo")]
    assert bool(proj) == (cfg.family != "ssm")
    for n in proj:
        assert bool(grads[n].abs().sum() > 0), n


def test_ssd_gradient_is_finite_where_the_reference_gives_nan():
    """mamba2-130m's chunk of 128 with its init's dt: above the chunk's
    diagonal ``cum_i - cum_j`` overflows ``exp`` to inf, and the
    reference's where-after-exp passes ``0 * inf = NaN`` back (its
    gradient is NaN at the published width).  The port masks the
    exponent first: the same forward bits, a finite gradient."""
    from repro.models import mamba2 as jmamba
    from repro_torch.models import mamba2 as tmamba
    rng = np.random.default_rng(0)
    b, t, h, p, n, chunk = 1, 128, 2, 4, 8, 128
    x = rng.standard_normal((b, t, h, p)).astype(np.float32)
    dt = np.full((b, t, h), 0.1, np.float32)
    a_log = np.log(np.array([1.0, 16.0], np.float32))
    bm = rng.standard_normal((b, t, n)).astype(np.float32)
    cm = rng.standard_normal((b, t, n)).astype(np.float32)

    def jloss(dt_):
        y, s = jmamba.ssd_scan(x, dt_, a_log, bm, cm, chunk)
        return y.sum() + s.sum()
    y_ref, s_ref = jmamba.ssd_scan(x, dt, a_log, bm, cm, chunk)
    assert not np.isfinite(np.asarray(jax.grad(jloss)(dt))).all()
    tdt = torch.from_numpy(dt).requires_grad_(True)
    y, s = tmamba.ssd_scan(torch.from_numpy(x), tdt,
                           *(torch.from_numpy(a) for a in (a_log, bm, cm)),
                           chunk)
    assert_rel(_np(y), np.asarray(y_ref), 1e-5, "y")
    assert_rel(_np(s), np.asarray(s_ref), 1e-5, "state")
    (y.sum() + s.sum()).backward()
    assert torch.isfinite(tdt.grad).all()


# --------------------------------------------------------------------------- #
# the train step end to end: stablelm (the dense family)                      #
# --------------------------------------------------------------------------- #

def test_gradients_match_reference_stablelm():
    check_gradients("stablelm-3b")


def test_train_step_matches_reference_stablelm():
    met = check_train_step("stablelm-3b")
    assert float(met["load_balance_loss"]) == 0.0


def test_train_step_at_full_lr_matches_reference_stablelm():
    check_train_step("stablelm-3b", step=150)


def test_microbatch_split_keeps_the_batch_order():
    """``n_microbatches`` cuts the batch into consecutive rows, as the
    reference's reshape; with an f32 accumulator the mean loss of two
    microbatches is the two single-microbatch losses' mean."""
    cfg = tconfigs.get_smoke_config("stablelm-3b")
    tm = DecoderLM(cfg, device="cpu")
    tm.reset_parameters(torch.Generator().manual_seed(2))
    tcfg = dataclasses.replace(tconfigs.get_train_config("stablelm-3b"),
                               grad_dtype="float32")
    _, tb = batches(cfg, 4, 9)
    _, both = accumulate_grads(tm, tcfg, tb, n_microbatches=2)
    halves = [accumulate_grads(tm, tcfg, {k: v[i:i + 2]
                                          for k, v in tb.items()})[1]
              for i in (0, 2)]
    assert float(both["loss"]) == pytest.approx(
        (float(halves[0]["loss"]) + float(halves[1]["loss"])) / 2, rel=1e-6)
    with pytest.raises(ValueError, match="microbatches"):
        accumulate_grads(tm, tcfg, tb, n_microbatches=3)
    assert all(p.grad is None for p in tm.parameters())
