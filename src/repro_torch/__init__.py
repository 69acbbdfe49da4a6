"""repro_torch — the MDP solver on PyTorch, with hand-written CUDA kernels.

A port of :mod:`repro` (the JAX package, which stays the reference) to
PyTorch on an NVIDIA H100.  Module names mirror the reference's so each
counterpart is easy to find:

* :mod:`repro_torch.core` — containers, generators, Bellman operators,
  inner solvers, the outer iPI loop and the host driver;
* :mod:`repro_torch.kernels` — the kernels (fused ELL and dense backups,
  policy SpMV, the ELL Q table, GQA flash attention) as CUDA C++ for
  ``sm_90a`` beside their plain PyTorch versions, dispatched by the
  device of the tensors they are given;
* :mod:`repro_torch.api` — options database, ``MDP`` builder, ``Session``;
* :mod:`repro_torch.launch.solve` — the solve CLI;
* :mod:`repro_torch.configs`, :mod:`repro_torch.models`,
  :mod:`repro_torch.train.steps`, :mod:`repro_torch.launch.serve_lm` —
  the LM substrate's dense family, served by batched prefill and greedy
  decode.

The port covers the solve of one materialized ELL or dense MDP, on one
device, as a fleet on one device, or sharded over the ranks of a
``torch.distributed`` world (:mod:`repro_torch.launch.mesh`), and the
serving path of the dense LMs.  Every entry point takes a
``device`` (default ``"cuda"``); asking for ``cuda`` without a visible GPU
raises instead of running on the host.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
