"""Architecture registry: ``--arch <id>`` -> config module.

The port's own copy of :mod:`repro.configs` (pure Python, so the port
imports nothing of the JAX package); ``tests/test_torch_lm.py`` holds the
two registries equal.  Each module defines CONFIG (the published
dimensions), TRAIN (the reference's trainer knobs, tuned for its TPU mesh;
``repro_torch.launch.train`` takes them as they are) and SMOKE (a reduced
same-family config for CPU tests).
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig, SHAPES

ARCHS = {
    "zamba2-1.2b": "zamba2_1_2b",
    "llava-next-34b": "llava_next_34b",
    "arctic-480b": "arctic_480b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "mamba2-130m": "mamba2_130m",
    "whisper-base": "whisper_base",
    "stablelm-3b": "stablelm_3b",
    "minitron-8b": "minitron_8b",
    "granite-34b": "granite_34b",
    "nemotron-4-15b": "nemotron_4_15b",
}

# archs whose attention is sub-quadratic-capable (SSM/hybrid) -> long_500k runs
LONG_CONTEXT_OK = {"zamba2-1.2b", "mamba2-130m"}


def get_module(arch: str):
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; choose from {list(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def get_config(arch: str) -> ModelConfig:
    return get_module(arch).CONFIG


def get_train_config(arch: str) -> TrainConfig:
    return getattr(get_module(arch), "TRAIN", TrainConfig())


def get_smoke_config(arch: str) -> ModelConfig:
    return get_module(arch).SMOKE


def cells(arch: str):
    """The assigned (shape) cells for this arch, with documented skips."""
    out = []
    for name, shape in SHAPES.items():
        if name == "long_500k" and arch not in LONG_CONTEXT_OK:
            continue  # full-attention arch: skip documented in DESIGN.md §4
        out.append(shape)
    return out


def all_cells():
    return [(a, s) for a in ARCHS for s in cells(a)]
