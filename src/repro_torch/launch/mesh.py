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
over the world.  A rank without a card, or a process group that fails to
come up, raises.

``make_production_mesh`` and ``mesh_kwargs`` of the reference shape XLA's
TPU pod meshes and stay reference-only; ``make_fleet_mesh`` waits for the
fleet layouts (ROADMAP queue 1 item 10).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.core.comm import FLEET_ITEM
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


def make_fleet_mesh(fleet: int, *, layout: str = "fleet", devices=None):
    """The mesh of the fleet layouts: not yet ported."""
    raise NotImplementedError(
        f"make_fleet_mesh: the fleet layouts are not yet ported to "
        f"repro_torch (ROADMAP queue 1 item {FLEET_ITEM})")


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
