"""LM substrate of the port: the dense decoder-only family.

Counterpart of :mod:`repro.models`.  Modules are :class:`torch.nn.Module`
subclasses whose weights keep the reference's layouts, so weights carry
over from the JAX package (:mod:`repro_torch.models.convert`).
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.lm import DecoderLM


def build_model(cfg, *, generator: torch.Generator,
                device: str | torch.device = "cuda") -> DecoderLM:
    """The model of ``cfg`` on ``device`` with random weights drawn from
    ``generator`` (which must live on that device).  Only the dense family
    is ported; any other raises."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported to "
            f"repro_torch yet; see ROADMAP.md queue 1 item 15 (the rest "
            f"of the LM substrate)")
    model = DecoderLM(cfg, device=resolve_device(device))
    model.reset_parameters(generator)
    return model.eval()


__all__ = ["DecoderLM", "build_model"]
