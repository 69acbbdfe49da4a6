"""The torch port's dense LM against the JAX package, on the CPU.

Both packages run the same smoke configs (float32) with the same weights:
the reference's ``DecoderLM.init`` pytree, carried into the port by
``repro_torch.models.convert.lm_params_from_numpy``.  Prefill logits and
the (k, v) cache must agree within ``TOL``: the two packages run the same
f32 arithmetic, but their matmuls and the attention scan (the reference
pads keys to a chunk multiple, the port does not) sum in other orders.
Decode is in ``tests/test_torch_lm_decode.py``.
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as jget_config
from repro.configs import get_module as jget_module
from repro.configs import get_smoke_config as jget_smoke
from repro.models import build_model as jbuild_model
from repro.train.steps import make_prefill_step as jmake_prefill
from repro_torch import configs as tconfigs
from repro_torch.kernels import ops
from repro_torch.launch import serve_lm
from repro_torch.models import DecoderLM, build_model
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.train.steps import make_prefill_step

SRC = Path(__file__).resolve().parents[1] / "src"
DENSE = ["stablelm-3b", "minitron-8b", "granite-34b", "nemotron-4-15b"]
# relative to the largest |value| of the compared tensor
TOL = 1e-5


def carried(arch: str, seed: int = 0):
    """(JAX model, its params, the port's model with the same weights)."""
    jm = jbuild_model(jget_smoke(arch))
    params = jm.init(jax.random.PRNGKey(seed))
    cfg = tconfigs.get_smoke_config(arch)
    tm = DecoderLM(cfg, device="cpu")
    tm.load_state_dict(lm_params_from_numpy(
        jax.tree.map(np.asarray, params), cfg))
    return jm, params, tm.eval()


def assert_close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, tol * scale)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_logits_and_cache_match_reference(arch):
    jm, params, tm = carried(arch)
    cfg = tm.cfg
    # T = 21 is not a multiple of the smoke configs' attn_chunk (16): the
    # reference pads keys and masks them, the port bounds-checks
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 21),
                                             dtype=np.int32)
    want_logits, want_cache = jax.jit(jmake_prefill(jm))(params, toks)
    ops.reset_launch_counts()
    got_logits, got_cache = make_prefill_step(tm)(torch.from_numpy(toks))
    assert ops.launch_counts()["flash_attention"] == 0   # plain on the CPU
    assert_close(got_logits.numpy(), want_logits)
    assert got_cache["len"] == int(want_cache["len"]) == 21
    for name in ("k", "v"):
        assert_close(got_cache["blocks"][name].numpy(),
                     want_cache["blocks"][name])


@pytest.mark.parametrize("arch", list(J_ARCHS))
def test_config_registry_copies_the_reference(arch):
    mod_t = tconfigs.get_module(arch)
    mod_j = jget_module(arch)
    for name in ("CONFIG", "SMOKE"):
        assert dataclasses.asdict(getattr(mod_t, name)) == \
            dataclasses.asdict(getattr(mod_j, name))
    assert dataclasses.asdict(tconfigs.get_train_config(arch)) == \
        dataclasses.asdict(getattr(mod_j, "TRAIN"))
    assert tconfigs.get_config(arch).param_count() == \
        jget_config(arch).param_count()
    assert tconfigs.ARCHS == J_ARCHS


def test_unknown_arch_raises():
    with pytest.raises(ValueError, match="unknown arch"):
        tconfigs.get_config("gpt-5")


@pytest.mark.parametrize("arch", [a for a in J_ARCHS
                                  if jget_config(a).family != "dense"])
def test_build_model_raises_for_families_not_ported(arch):
    cfg = tconfigs.get_smoke_config(arch)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item"):
        build_model(cfg, generator=gen, device="cpu")
    with pytest.raises(NotImplementedError, match="dense family only"):
        lm_params_from_numpy({}, cfg)


def test_build_model_shapes_match_the_reference_params():
    cfg = tconfigs.get_smoke_config("granite-34b")
    tm = build_model(cfg, generator=torch.Generator().manual_seed(3),
                     device="cpu")
    shapes = jax.eval_shape(jbuild_model(jget_smoke("granite-34b")).init,
                            jax.random.PRNGKey(0))
    sd = lm_params_from_numpy(
        jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes), cfg)
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == {k: tuple(v.shape) for k, v in sd.items()}
    # the analytic count leaves out the norms' 2L + 1 vectors
    assert sum(v.numel() for v in tm.state_dict().values()) == \
        cfg.param_count() + (2 * cfg.n_layers + 1) * cfg.d_model
    # the reference's distributions: norms 1, embedding cut at +-2, the
    # fan-in scaled matrices cut at +-2 / sqrt(fan_in)
    assert torch.equal(tm.final_norm, torch.ones(cfg.d_model))
    assert float(tm.embed.abs().max()) <= 2.0
    w = tm.blocks[0].mlp.w_up
    assert float(w.abs().max()) <= 2.0 * cfg.d_model ** -0.5


def test_build_model_is_reproducible_from_its_generator():
    cfg = tconfigs.get_smoke_config("minitron-8b")
    a, b = (build_model(cfg, generator=torch.Generator().manual_seed(5),
                        device="cpu") for _ in range(2))
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k


def test_bf16_weights_carry_bit_for_bit():
    cfg = dataclasses.replace(tconfigs.get_smoke_config("minitron-8b"),
                              dtype="bfloat16")
    params = jbuild_model(dataclasses.replace(
        jget_smoke("minitron-8b"), dtype="bfloat16")).init(
        jax.random.PRNGKey(0))
    sd = lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg)
    want = np.asarray(params["blocks"]["attn"]["wq"][1].astype(jnp.float32))
    got = sd["blocks.1.attn.wq"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_serve_lm_smoke_on_cpu(capsys):
    rc = serve_lm.main(["--arch", "granite-34b", "--smoke", "--device",
                        "cpu", "--batch", "3", "--prompt-len", "19",
                        "--gen", "5"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "[serve_lm] arch=granite-smoke prefill=" in out
    assert "ms/tok" in out
    samples = re.findall(r"\[serve_lm\] sample (\d): \[(.*)\]", out)
    assert [s[0] for s in samples] == ["0", "1"]
    assert all(len(s[1].split(",")) == 5 for s in samples)


def test_serve_lm_refuses_families_not_ported():
    with pytest.raises(NotImplementedError, match="not ported"):
        serve_lm.main(["--arch", "mamba2-130m", "--smoke", "--device",
                       "cpu"])


# --------------------------------------------------------------------------- #
# The LM modules import neither JAX nor the JAX package                       #
# --------------------------------------------------------------------------- #

LM_MODULES = ["repro_torch.configs", "repro_torch.models",
              "repro_torch.models.convert", "repro_torch.train.steps",
              "repro_torch.launch.serve_lm",
              "repro_torch.kernels.flash_attention"]


def test_lm_modules_load_no_jax():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in LM_MODULES)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'repro')]\n"
              "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)


def test_no_lm_source_or_chip_smoke_line_imports_jax_or_repro():
    pattern = re.compile(r"^\s*(import\s+(jax|repro)(\.|\s|$|,)"
                         r"|from\s+(jax|repro)(\.|\s))", re.M)
    root = SRC / "repro_torch"
    files = [*sorted((root / "configs").glob("*.py")),
             *sorted((root / "models").glob("*.py")),
             *sorted((root / "train").glob("*.py")),
             root / "launch" / "serve_lm.py",
             root / "kernels" / "flash_attention.py",
             SRC.parent / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        assert not pattern.search(path.read_text()), path
