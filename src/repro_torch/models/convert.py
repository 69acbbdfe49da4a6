"""Carry weights from the JAX package into the port.

:func:`lm_params_from_numpy` turns the reference's ``DecoderLM.init``
pytree, as numpy arrays (block weights stacked on a leading ``L`` axis),
into a state dict of :class:`repro_torch.models.lm.DecoderLM`, so that
both packages compute the same function in the tests.  Nothing here
imports JAX: the caller converts the arrays with ``numpy.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(x) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(x))
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def lm_params_from_numpy(params: dict, cfg) -> dict[str, torch.Tensor]:
    """``{"embed", "final_norm", ["unembed"], "blocks": {"ln1", "ln2",
    "attn": {"wq", "wk", "wv", "wo"}, "mlp": {...}}}`` -> state dict."""
    if cfg.family != "dense":
        raise NotImplementedError(f"lm_params_from_numpy takes the dense "
                                  f"family only, got {cfg.family!r}")
    sd = {"embed": _tensor(params["embed"]),
          "final_norm": _tensor(params["final_norm"])}
    if not cfg.tie_embeddings:
        sd["unembed"] = _tensor(params["unembed"])
    blocks = params["blocks"]
    for i in range(cfg.n_layers):
        for name in ("ln1", "ln2"):
            sd[f"blocks.{i}.{name}"] = _tensor(blocks[name][i])
        for group in ("attn", "mlp"):
            for name, w in blocks[group].items():
                sd[f"blocks.{i}.{group}.{name}"] = _tensor(w[i])
    return sd
