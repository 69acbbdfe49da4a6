"""End-to-end LM training driver, on one device or under ``torchrun``.

Counterpart of :mod:`repro.launch.train`, with the same flags plus
``--device`` (default ``cuda``; ``cpu`` trains on the host):

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \\
        --steps 4 --batch 4 --seq 2048 --microbatches 2

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \\
        --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir run1 --device cpu

    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
        -m repro_torch.launch.train -- --arch stablelm-3b --smoke \\
        --steps 50 --batch 8 --seq 128 --ckpt-dir run1 --device cpu

Config -> weights drawn on the device from a generator seeded with 0 ->
optimizer state -> checkpointed, microbatched, remat'd train steps ->
metrics.  ``--smoke`` selects the reduced config.  Restart-safe:
re-launching with the same ``--ckpt-dir`` resumes from the newest
complete checkpoint (the weights, then the optimizer state, in a fixed
leaf order), and the data cursor is the step counter, so no batch is
skipped or repeated.

Under ``torchrun`` (``WORLD_SIZE`` set) every rank takes a card (gloo
ranks on the host with ``--device cpu``), the mesh is ``(world, 1)`` over
``(data, model)`` as the reference's ``make_host_mesh``, and the weights
lie on the reference's specs (:func:`repro_torch.train.sharding.
infer_param_specs`, :func:`~repro_torch.train.sharding.place`): every
rank draws the same weights and keeps its block, builds the same global
batch and keeps its rows.  Checkpoints hold whole leaves in the
one-device format, gathered leaf by leaf and written by rank 0; a resume
reads the whole leaves and keeps its blocks, so a checkpoint written at
one world size resumes at any other.  Rank 0 logs the steps; every rank
prints its last line.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config, get_train_config
from repro_torch.data.pipeline import SyntheticSource
from repro_torch.device import DEVICES, resolve_device
from repro_torch.launch import mesh as lm
from repro_torch.models import build_model
from repro_torch.train import sharding as shd
from repro_torch.train.optimizer import init_opt_state, local
from repro_torch.train.steps import make_train_step
from repro_torch.utils import checkpoint as ckpt


def state_leaves(model, opt_state: dict) -> list[torch.Tensor]:
    """The checkpoint's leaves in their fixed order: every weight in
    ``named_parameters`` order, then the optimizer state, key by key."""
    return [p for _, p in model.named_parameters()] + \
        [t for d in opt_state.values() for t in d.values()]


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    # numpy has no bf16: its bits travel as int16
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A leaf whole: a ``DTensor`` gathered (every rank takes part)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


@torch.no_grad()
def _load(leaves: list[torch.Tensor], arrays) -> None:
    """Whole checkpoint leaves into ``leaves``; a ``DTensor`` takes its
    rank's block."""
    for dst, a in zip(leaves, arrays):
        src = torch.from_numpy(np.asarray(a))
        if dst.dtype == torch.bfloat16:
            src = src.view(torch.bfloat16)
        if src.shape != dst.shape or src.dtype != dst.dtype:
            raise ValueError(f"checkpoint leaf {tuple(src.shape)} "
                             f"{src.dtype} does not fit {tuple(dst.shape)} "
                             f"{dst.dtype}")
        if hasattr(dst, "placements"):
            src = shd.local_block(src, dst.device_mesh, dst.placements)
        local(dst).copy_(src)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=DEVICES)
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--"]:
        # torchrun ... -m repro_torch.launch.train -- --arch ...: the
        # launcher hands on the separator that keeps its own options apart
        argv = argv[1:]
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tcfg = get_train_config(args.arch)
    if "WORLD_SIZE" not in os.environ:
        return _train(args, cfg, tcfg, resolve_device(args.device), None)
    world = int(os.environ["WORLD_SIZE"])
    if args.batch % (args.microbatches * world):
        raise ValueError(f"--batch {args.batch} does not split into "
                         f"{args.microbatches} microbatches over {world} "
                         f"ranks")
    dev = lm.init_distributed(args.device)
    try:
        rc = _train(args, cfg, tcfg, dev,
                    lm.make_host_mesh(device=args.device))
    except BaseException:
        lm.shutdown(barrier=False)
        raise
    lm.shutdown()
    return rc


def _train(args, cfg, tcfg, dev, mesh) -> int:
    rank = 0 if mesh is None else mesh.get_rank()
    say = print if rank == 0 else (lambda *a, **k: None)
    where = "devices=1" if mesh is None else (
        f"devices={mesh.size()} mesh="
        f"{dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape)))}")
    say(f"[train] arch={cfg.name} {where} device={dev}", flush=True)

    model = build_model(cfg, generator=torch.Generator(device=dev)
                        .manual_seed(0), device=dev)
    if mesh is not None:
        shd.place(model, mesh, shd.infer_param_specs(model, mesh))
    opt_state = init_opt_state(model, tcfg)
    start_step = 0
    if args.ckpt_dir:
        leaves = state_leaves(model, opt_state)
        restored = ckpt.restore(args.ckpt_dir, len(leaves))
        if restored is not None:
            arrays, start_step, _ = restored
            _load(leaves, arrays)
            say(f"[train] resumed from step {start_step}")

    def save(step: int) -> None:
        arrays = []
        for t in state_leaves(model, opt_state):    # leaf by leaf
            whole = _whole(t)
            if rank == 0:
                arrays.append(_host(whole))
            del whole
        if rank == 0:
            ckpt.save(args.ckpt_dir, step, arrays, meta=dict(arch=cfg.name))

    src = SyntheticSource(
        cfg.vocab_size, args.seq, args.batch,
        n_patches=cfg.n_patches, d_model=cfg.d_model,
        encoder_len=cfg.encoder_len if cfg.family == "encdec" else 0,
        device=str(dev))
    step_fn = make_train_step(model, tcfg, n_microbatches=args.microbatches,
                              mesh=mesh)

    losses = []
    t0 = time.time()
    for step in range(start_step, args.steps):
        opt_state, metrics = step_fn(opt_state, step, src.next_batch(step))
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = (time.time() - t0) / max(len(losses), 1)
            say(f"[train] step={step} loss={losses[-1]:.4f} "
                f"gnorm={float(metrics['grad_norm']):.3f} "
                f"{dt*1e3:.0f}ms/step", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save(step + 1)
    if args.ckpt_dir:
        save(args.steps)
    if mesh is not None:
        print(f"[train] rank {rank} of {mesh.size()}: losses "
              f"{[float.hex(x) for x in losses]}", flush=True)
    if not losses:
        say(f"[train] done. nothing to run: the checkpoint is at step "
            f"{start_step}")
        return 0
    first = np.mean(losses[:5]) if len(losses) >= 5 else losses[0]
    last = np.mean(losses[-5:])
    say(f"[train] done. loss {first:.4f} -> {last:.4f} "
        f"({'improved' if last < first else 'NOT improved'})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
