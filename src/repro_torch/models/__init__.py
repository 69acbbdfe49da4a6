"""LM substrate of the port: every family's prefill and decode.

Counterpart of :mod:`repro.models`.  Modules are :class:`torch.nn.Module`
subclasses whose weights keep the reference's layouts, so weights carry
over from the JAX package (:mod:`repro_torch.models.convert`).
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.lm import DecoderLM
from repro_torch.models.whisper import WhisperModel


def build_model(cfg, *, generator: torch.Generator,
                device: str | torch.device = "cuda"):
    """The model of ``cfg`` (:class:`WhisperModel` for ``encdec``, else
    :class:`DecoderLM`) on ``device`` with random weights drawn from
    ``generator`` (which must live on that device)."""
    cls = WhisperModel if cfg.family == "encdec" else DecoderLM
    model = cls(cfg, device=resolve_device(device))
    model.reset_parameters(generator)
    return model.eval()


__all__ = ["DecoderLM", "WhisperModel", "build_model"]
