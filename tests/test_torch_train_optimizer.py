"""The torch port's optimizers against the JAX package, on the CPU:
``apply_updates`` (Adam, Adafactor) from the same weights, optimizer state
and gradients, and the layer groups that stand for the reference's
stacked leaves.

Tolerances (relative to each tensor's largest magnitude): masters and
moments 1e-6 against the reference run op by op (its Adam masters and
Adafactor moments are f64 under the tests' ``jax_enable_x64``; the port's
f32) where the gradients do not clip; where they clip, 1e-5: the clip
scale is ``1 / norm``, and the reference's f32 sum of the squares is up
to 4.1e-6 off the exact norm.  The grad norm: the port's within 1e-6 of
the exact one, 1e-5 of the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_train_config as jget_train
from repro.train import optimizer as joptimizer
from repro_torch import configs as tconfigs
from repro_torch.models.convert import opt_state_from_numpy
from repro_torch.train import optimizer
from test_torch_train import _convert, _np, assert_rel, carried


# --------------------------------------------------------------------------- #
# optimizers                                                                  #
# --------------------------------------------------------------------------- #

# stablelm's smoke config (no dim reaches 128) and one whose matrices and
# embeddings are at least 128 on both trailing dims: Adafactor's factored
# branch
OPT_CONFIGS = {"smoke": {},
               "factored": dict(d_model=128, d_ff=256, vocab_size=160,
                                n_heads=4, n_kv_heads=2)}


def _random_state(jstate, rng):
    """The reference's state with random moments: m normal, v / vr / vc
    positive (a state some steps in)."""
    def one(path, x):
        key = str(getattr(path[0], "key", ""))
        x = np.asarray(x)
        if key == "master" or x.ndim == 0 and not x.any():
            return x
        r = rng.standard_normal(x.shape).astype(np.float32)
        return r * 1e-3 if key == "m" else np.abs(r) * 1e-6 + 1e-9
    return jax.tree_util.tree_map_with_path(one, jstate)


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("step", [0, 5, 150])
@pytest.mark.parametrize("opt", ["adam", "adafactor"])
@pytest.mark.parametrize("config", list(OPT_CONFIGS))
def test_apply_updates_matches_reference(config, opt, step, clip):
    jm, params, tm, cfg = carried("stablelm-3b", **OPT_CONFIGS[config])
    tcfg = dataclasses.replace(tconfigs.get_train_config("stablelm-3b"),
                               optimizer=opt)
    jtcfg = dataclasses.replace(jget_train("stablelm-3b"), optimizer=opt)
    rng = np.random.default_rng(step)
    jstate = _random_state(joptimizer.init_opt_state(params, jtcfg), rng)
    # the gradients' norm above grad_clip (1.0) or well below it
    jgrads = jax.tree.map(
        lambda p: (rng.standard_normal(p.shape)
                   * (3e-2 if clip else 1e-4)).astype(np.float32), params)
    state = opt_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg)
    grads = _convert(jgrads, cfg)
    if opt == "adafactor":
        factored = [n for n, p in tm.named_parameters()
                    if state["vr"][n].dim() < p.dim()]
        assert bool(factored) == (config == "factored"), factored
    new_params, jnew, jgnorm = joptimizer.apply_updates(
        params, jgrads, jstate, jnp.int32(step), jtcfg)
    state, gnorm = optimizer.apply_updates(tm, grads, state, step, tcfg)
    exact = np.sqrt(sum(float(np.sum(np.asarray(g, np.float64) ** 2))
                        for g in jax.tree.leaves(jgrads)))
    assert gnorm.dtype == torch.float32
    assert (exact > 1.0) == clip
    assert abs(float(gnorm) - exact) <= 1e-6 * exact
    assert abs(float(gnorm) - float(jgnorm)) <= 1e-5 * float(jgnorm)
    tol = 1e-5 if clip else 1e-6
    for key in jnew:
        # unconverted: the reference's f64 leaves as they are
        want = _convert(jnew[key], cfg)
        assert sorted(want) == sorted(state[key])
        for n, w in want.items():
            assert state[key][n].dtype == torch.float32
            assert_rel(_np(state[key][n]), _np(w), tol, f"{key} {n}")
    want_w = _convert(new_params, cfg)
    for n, p in tm.named_parameters():
        assert_rel(_np(p), _np(want_w[n]), tol, n)


def test_layer_groups_follow_the_reference_stacks():
    _, params, tm, cfg = carried("zamba2-1.2b")
    groups = optimizer.layer_groups({n: p.shape
                                     for n, p in tm.named_parameters()})
    stacked = {"/".join(str(getattr(k, "key", k)) for k in path): x.shape
               for path, x in jax.tree_util.tree_leaves_with_path(params)}
    assert {g.replace(".", "/"): s for g, (_, s) in groups.items()} == stacked
    assert optimizer.group_of("blocks.3.mamba.in_proj") == \
        ("blocks.mamba.in_proj", True)
    assert optimizer.group_of("shared.attn.wq") == ("shared.attn.wq", False)
    assert optimizer.group_of("m.decoder.1.ln1.scale") == \
        ("m.decoder.ln1.scale", True)
