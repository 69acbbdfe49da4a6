"""Process groups and device meshes for sharded solves.

Counterpart of :mod:`repro.launch.mesh`.  JAX builds a mesh over the
devices of one process; the port runs one process per device, as
madupite runs one MPI rank per core, and builds a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks:

    torchrun --nproc-per-node 4 -m repro_torch.launch.solve ... --layout 1d

:func:`init_distributed` brings the process group up (from torchrun's
``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``, or from an explicit store, as
tests do) on NCCL for the card's tensors and gloo for the host's, after
putting the rank on its own card; :func:`make_host_mesh` lays a named mesh
over the world, :func:`make_fleet_mesh` the fleet layouts' mesh with a
leading ``fleet`` axis.  A rank without a card, or a process group that
fails to come up, raises.

``make_production_mesh`` and ``mesh_kwargs`` of the reference shape XLA's
TPU pod meshes and stay reference-only.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.device import resolve_device

# one collective or rendezvous may wait this long before the rank raises
TIMEOUT = datetime.timedelta(minutes=10)


def init_distributed(device: str = "cuda", *, store=None,
                     rank: int | None = None, world_size: int | None = None,
                     timeout: datetime.timedelta = TIMEOUT) -> torch.device:
    """Bring up the default process group (once) and return this rank's
    device.

    Rank and world size come from the arguments, else from torchrun's
    environment, else a world of one.  ``store`` (a
    ``torch.distributed.Store``) rendezvous without an address; without one
    torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` are used, and a world of
    one needs none.  On ``cuda`` the rank first takes card ``LOCAL_RANK``
    (default: its rank), then the group runs NCCL for the card's tensors
    and gloo for the host's; on ``cpu`` gloo alone."""
    dev = resolve_device(device)
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank} wants card {local}, but this host shows "
                f"{torch.cuda.device_count()}: start at most one rank per "
                f"card (NCCL refuses two ranks on one card)")
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    if dist.is_initialized():
        if dist.get_world_size() != world_size or dist.get_rank() != rank:
            raise RuntimeError(
                f"a process group of world {dist.get_world_size()} (rank "
                f"{dist.get_rank()}) is already up; asked for rank {rank} "
                f"of {world_size}")
        return dev
    if store is None and world_size == 1 and "MASTER_ADDR" not in os.environ:
        store = dist.HashStore()
    kw = dict(backend="cuda:nccl,cpu:gloo" if dev.type == "cuda" else "gloo",
              rank=rank, world_size=world_size, timeout=timeout)
    if dev.type == "cuda":
        # bind the communicator to the card now: a failed NCCL init raises
        # here, not at the first collective
        kw["device_id"] = dev
    if store is not None:
        dist.init_process_group(store=store, **kw)
    else:
        dist.init_process_group(init_method="env://", **kw)
    return dev


def make_host_mesh(shape=None, axes=("data", "model"),
                   device: str = "cuda"):
    """A mesh over every rank of the process group, named ``axes``
    (default shape ``(world, 1)``): the ``1d`` layout shards states over
    all of it, ``2d`` states over the leading and actions over the last
    axis."""
    if not dist.is_initialized():
        raise RuntimeError("no torch.distributed process group is up; call "
                           "repro_torch.launch.mesh.init_distributed() (or "
                           "launch under torchrun) first")
    if shape is None:
        shape = (dist.get_world_size(), 1)
    return init_device_mesh(resolve_device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_fleet_mesh(fleet: int, *, layout: str = "fleet",
                    device: str = "cuda", world: int | None = None):
    """A mesh over every rank with a leading ``fleet`` axis, for
    fleet-sharded ``solve_many``.

    ``fleet`` ranks shard the instance dim; the remaining ``world //
    fleet`` shard states within each fleet slice (``layout="fleet"``:
    names ``("fleet", "data")``), or states x actions (``"fleet2d"``:
    ``("fleet", "data", "model")``, the trailing axis 2 — or 1 when the
    rest is odd — shards actions).  ``world`` (default: the process
    group's) only sizes the mesh; the reference's errors."""
    if world is None:
        if not dist.is_initialized():
            raise RuntimeError("no torch.distributed process group is up; "
                               "call repro_torch.launch.mesh."
                               "init_distributed() (or launch under "
                               "torchrun) first")
        world = dist.get_world_size()
    if fleet < 1 or world % fleet:
        raise ValueError(f"fleet-axis size {fleet} must divide the device "
                         f"count {world}")
    rest = world // fleet
    if layout == "fleet":
        shape, names = (fleet, rest), ("fleet", "data")
    elif layout == "fleet2d":
        am = 2 if rest % 2 == 0 and rest >= 2 else 1
        shape, names = (fleet, rest // am, am), ("fleet", "data", "model")
    else:
        raise ValueError(f"make_fleet_mesh serves the fleet layouts, "
                         f"got {layout!r}")
    return make_host_mesh(shape, names, device=device)


def all_ranks(flag: bool) -> bool:
    """``flag`` on every rank of the world (a MIN all-reduce of a host
    tensor, which the process group's gloo side carries); ``flag`` itself
    when no process group is up."""
    if not dist.is_initialized():
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


def shutdown(*, barrier: bool = True) -> None:
    """Tear the process group down (every rank, at exit).

    The ranks first meet at a barrier, so none destroys its groups and
    exits while a peer is still working: a gloo rank that exited early
    could abort at interpreter exit ("terminate called without an active
    exception") on a loaded host, failing the whole launch.  A rank that
    is leaving on an error passes ``barrier=False``: its peers may never
    arrive."""
    if dist.is_initialized():
        if barrier:
            dist.barrier()
        dist.destroy_process_group()
