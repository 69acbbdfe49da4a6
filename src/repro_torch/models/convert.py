"""Carry weights and optimizer state from the JAX package into the port.

:func:`lm_params_from_numpy` turns the reference's ``DecoderLM.init``
pytree, and :func:`whisper_params_from_numpy` its ``WhisperModel.init``
pytree, as numpy arrays (layer stacks on a leading ``L`` axis), into a
state dict of :class:`repro_torch.models.lm.DecoderLM` or
:class:`repro_torch.models.whisper.WhisperModel`, so that both packages
compute the same function in the tests; :func:`opt_state_from_numpy`
does the same for the reference's optimizer state.  A nested key
``a/b/c`` becomes ``a.b.c``; a stacked group's layer ``i`` becomes
``group.i.b.c``.  Nothing here imports JAX: the caller converts the
arrays with ``numpy.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(x) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(x))
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _flatten(tree: dict, prefix: str = ""):
    for name, x in tree.items():
        if isinstance(x, dict):
            yield from _flatten(x, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", x


def _state_dict(params: dict, stacks: dict[str, int]) -> dict:
    sd = {}
    for group, x in params.items():
        if group not in stacks:
            if isinstance(x, dict):
                sd.update((k, _tensor(w)) for k, w in _flatten(x, group + "."))
            else:
                sd[group] = _tensor(x)
            continue
        for path, w in _flatten(x):
            for i in range(stacks[group]):
                # a 0-d leaf of a stack (Adafactor's unfactored ``vc``) is
                # one scalar for every layer
                sd[f"{group}.{i}.{path}"] = _tensor(w if np.ndim(w) == 0
                                                    else w[i])
    return sd


def _stacks(cfg) -> dict[str, int]:
    if cfg.family == "encdec":
        return {"encoder": cfg.encoder_layers, "decoder": cfg.n_layers}
    return {"blocks": cfg.n_layers}


def lm_params_from_numpy(params: dict, cfg) -> dict[str, torch.Tensor]:
    """``{"embed", "final_norm", ["unembed"], ["patch_proj"], "blocks": {...
    stacked on L}, ["shared": {...}]}`` -> :class:`DecoderLM` state dict,
    for every family but ``encdec``."""
    if cfg.family == "encdec":
        raise ValueError("the encdec family's weights carry over with "
                         "whisper_params_from_numpy")
    return _state_dict(params, {"blocks": cfg.n_layers})


def whisper_params_from_numpy(params: dict, cfg) -> dict[str, torch.Tensor]:
    """``{"embed", "unembed", "enc_norm", "final_norm", "encoder": {...},
    "decoder": {...}}`` (LayerNorms ``{"scale", "bias"}``, the stacks on a
    leading L axis) -> :class:`WhisperModel` state dict."""
    if cfg.family != "encdec":
        raise ValueError(f"whisper_params_from_numpy takes the encdec "
                         f"family, got {cfg.family!r}")
    return _state_dict(params, {"encoder": cfg.encoder_layers,
                                "decoder": cfg.n_layers})


def opt_state_from_numpy(opt_state: dict, cfg) -> dict:
    """The reference's ``init_opt_state`` / ``apply_updates`` state
    (``{"master", "m", "v"}`` or ``{"master", "vr", "vc"}``, each a pytree
    like the params, stacked on ``L``) -> the port's state of
    :mod:`repro_torch.train.optimizer`: the same keys, each a ``{name:
    tensor}`` of the model's parameter names, every leaf f32 (the
    reference's masters are f64 under ``jax_enable_x64``)."""
    return {key: {n: t.float() for n, t in
                  _state_dict(tree, _stacks(cfg)).items()}
            for key, tree in opt_state.items()}
