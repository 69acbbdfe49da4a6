"""GARNET ELL instances and their cost draws, made on the device.

The recipe of ``repro_torch.core.generators.garnet`` (Archibald, McKinnon
and Thomas 1995): each (state, action) row has ``k`` successors drawn
uniformly from the ``n`` states, with uniform weights (plus ``1e-6``)
normalised to sum to one, and a uniform stage cost in ``[0, 1)``.  The
tables are stored as the port stores them: ``idx`` int32, ``val`` and
``cost`` float32.  Each table is one call of a ``torch.Generator`` on the
device, seeded by :func:`derive` from the instance's lane and the draw,
so the host never holds a table.  The weights are normalised in float32
here, where the port's generator normalises in float64 and rounds after:
rows sum to one within float32 rounding.

The harness asks an inputs module for three things, and passes what it
gets on without looking inside:

* :func:`instance`: the part of lane ``lane``'s instance that stays fixed
  for the run (here the transition tables), made once in set-up;
* :func:`problem`: the plain data of one solve, the instance with draw
  ``draw``'s part (here the costs), which the reference also reads;
* :func:`program_mdp`: the program's MDP object for that data.
"""

from __future__ import annotations

import hashlib

import torch


def derive(*parts) -> int:
    """A 63-bit generator seed from any whole numbers and words."""
    text = "/".join(str(p) for p in parts).encode()
    return int.from_bytes(hashlib.blake2b(text, digest_size=8).digest(),
                          "little") >> 1


def _gen(device: torch.device, *parts) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derive(*parts))
    return g


def instance(cfg: dict, lane: int, device: torch.device) -> dict:
    """``idx (n, m, k) int32`` and ``val (n, m, k) float32`` of lane
    ``lane``'s instance."""
    n, m, k = cfg["n"], cfg["m"], cfg["k"]
    idx = torch.randint(0, n, (n, m, k), dtype=torch.int32, device=device,
                        generator=_gen(device, "garnet-idx", lane))
    val = torch.rand((n, m, k), dtype=torch.float32, device=device,
                     generator=_gen(device, "garnet-val", lane))
    val += 1e-6
    val /= val.sum(-1, keepdim=True)
    return {"idx": idx, "val": val}


def problem(cfg: dict, inst: dict, lane: int, draw: int,
            device: torch.device) -> dict:
    """One solve's data: the instance's tables, the ``(n, m)`` float32
    stage costs of draw ``draw`` (the warm-up call's is ``-1``) and the
    discount."""
    cost = torch.rand((cfg["n"], cfg["m"]), dtype=torch.float32,
                      device=device,
                      generator=_gen(device, "garnet-cost", lane, draw))
    return {**inst, "cost": cost, "gamma": float(cfg["gamma"])}


def program_mdp(cfg: dict, data: dict):
    """The port's ``EllMDP`` over the data's device tensors (no copy)."""
    from repro_torch.core.mdp import EllMDP

    return EllMDP(idx=data["idx"], val=data["val"], cost=data["cost"],
                  gamma=data["gamma"], n_global=cfg["n"],
                  m_global=cfg["m"])
