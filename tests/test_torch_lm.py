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
from repro_torch.models import DecoderLM, WhisperModel, build_model
from repro_torch.models.convert import (lm_params_from_numpy,
                                        whisper_params_from_numpy)
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


def uncounted(cfg) -> int:
    """Weights that ``ModelConfig.param_count`` leaves out: every norm
    (RMS: ln1, ln2 a layer and the final one; whisper's LayerNorms: scale
    and bias, two an encoder layer, three a decoder layer, enc_norm and
    final_norm), mamba's conv bias, and llava's patch projection."""
    d, l = cfg.d_model, cfg.n_layers
    if cfg.family == "encdec":
        return 2 * d * (2 * cfg.encoder_layers + 3 * l + 2)
    if cfg.family in ("ssm", "hybrid"):
        conv_b = cfg.d_inner + 2 * cfg.ssm_state
        shared = 2 * d if cfg.family == "hybrid" else 0
        return l * (d + conv_b) + d + shared
    return (2 * l + 1) * d + (d * d if cfg.family == "vlm" else 0)


@pytest.mark.parametrize("arch", list(J_ARCHS))
def test_build_model_shapes_match_the_reference_params(arch):
    """At the published widths (weights on the meta device, the
    reference's shapes abstract): every state-dict shape is the reference
    init's, and the count is ``param_count()`` plus what it leaves out.
    At the smoke widths, a built model's weights carry the reference's
    distributions."""
    cfg = tconfigs.get_config(arch)
    cls = WhisperModel if cfg.family == "encdec" else DecoderLM
    convert = whisper_params_from_numpy if cfg.family == "encdec" \
        else lm_params_from_numpy
    meta = cls(cfg, device="meta")
    shapes = jax.eval_shape(jbuild_model(jget_config(arch)).init,
                            jax.random.PRNGKey(0))
    want = {}
    for group, x in shapes.items():
        stack = {"blocks": cfg.n_layers, "encoder": cfg.encoder_layers,
                 "decoder": cfg.n_layers}.get(group)
        for path, leaf in (jax.tree_util.tree_flatten_with_path(x)[0]
                           if isinstance(x, dict) else [((), x)]):
            name = ".".join([group, *(str(p.key) for p in path)])
            if stack is None:
                want[name] = tuple(leaf.shape)
            else:
                for i in range(stack):
                    want[name.replace(group, f"{group}.{i}", 1)] = \
                        tuple(leaf.shape[1:])
    got = {k: tuple(v.shape) for k, v in meta.state_dict().items()}
    assert got == want
    assert sum(v.numel() for v in meta.state_dict().values()) == \
        cfg.param_count() + uncounted(cfg)

    smoke = tconfigs.get_smoke_config(arch)
    tm = build_model(smoke, generator=torch.Generator().manual_seed(3),
                     device="cpu")
    jshapes = jax.eval_shape(jbuild_model(jget_smoke(arch)).init,
                             jax.random.PRNGKey(0))
    sd = convert(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jshapes),
                 smoke)
    assert {k: (tuple(v.shape), v.dtype) for k, v in tm.state_dict().items()} \
        == {k: (tuple(v.shape), v.dtype) for k, v in sd.items()}
    # the reference's distributions: norms 1 (LayerNorm bias 0), embedding
    # cut at +-2, the matrices cut at +-2 / sqrt(fan_in), with the MoE
    # experts' fan-in d (f for w_down), not their leading E
    for name, w in tm.state_dict().items():
        if name.endswith(("ln1", "ln2", "final_norm", ".scale", "norm_w")):
            assert torch.equal(w, torch.ones_like(w)), name
        elif name.endswith(".bias"):
            assert not w.any(), name
    assert float(tm.embed.abs().max()) <= 2.0
    first = tm.decoder[0] if smoke.family == "encdec" else tm.blocks[0]
    mlp = getattr(first, "mamba", None) or getattr(first, "moe", None) \
        or first.mlp
    w_up = getattr(mlp, "w_up", getattr(mlp, "in_proj", None))
    assert float(w_up.abs().max()) <= 2.0 * smoke.d_model ** -0.5
    if smoke.family == "moe":    # tens of thousands of draws reach the cut
        assert 1.9 <= float(mlp.w_down.abs().max()) * smoke.d_ff ** 0.5 <= 2


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


# --------------------------------------------------------------------------- #
# The LM modules import neither JAX nor the JAX package                       #
# --------------------------------------------------------------------------- #

LM_MODULES = ["repro_torch.configs", "repro_torch.models",
              "repro_torch.models.convert", "repro_torch.models.moe",
              "repro_torch.models.mamba2", "repro_torch.models.whisper",
              "repro_torch.train.steps",
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
