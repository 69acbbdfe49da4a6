"""Elastic restart: survive a change of world size mid-solve.

Counterpart of :mod:`repro.launch.elastic`.  Checkpoints are mesh-agnostic
(the driver writes the unpadded, unsharded state), so a job that loses
ranks restarts on a smaller world and continues from the same iterate.
This driver runs it for real: it launches one ``torchrun`` world that
solves a garnet for 3 outer steps with a checkpoint after each, then a
smaller world (or, ``0``, this process without a mesh) that resumes from
the checkpoint and solves to ``1e-9``, and holds the result to the
single-device solve (``|v - v_ref|_inf < 1e-9``):

    PYTHONPATH=src python -m repro_torch.launch.elastic    # on the card(s)
    PYTHONPATH=src python -m repro_torch.launch.elastic --device cpu  # gloo, 4 -> 2

``--batch B`` runs a seed ensemble of ``B`` garnets under the ``fleet``
layout instead (the fleet axis as large as the world: a 4-way fleet axis
checkpointed, resumed on a 2-way one).  It runs on the card unless given
``--device cpu``, and without a GPU it raises rather than run on the
host.  On the card the worlds default to every card and half of them, or
on one card to one rank and no mesh; on the host to 4 and 2 gloo ranks.
Every process takes the kernel tuner's ``-kernel_tune`` and
``-kernel_tune_cache`` from ``MADUPITE_OPTIONS``, as the solve CLI does.
Each world runs under a time limit; every process started is stopped.
"""

from __future__ import annotations

import argparse
import os
import shutil
import signal
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from repro_torch.device import DEVICES, resolve_device

SRC = Path(__file__).resolve().parents[2]


def _instances(args):
    from repro_torch.core import generators
    seeds = range(5, 5 + max(args.batch, 1))
    return [generators.garnet(args.n, 12, 6, gamma=args.gamma, seed=s)
            for s in seeds]


def _opts(max_outer: int = 500):
    from repro_torch.core.ipi import IPIOptions
    return IPIOptions(method="ipi_gmres", atol=1e-9, dtype="float64",
                      max_outer=max_outer)


def _solve(args, max_outer: int, chunk: int, *, mesh_world: int):
    """One phase's solve: on a mesh over the world (``mesh_world`` > 0)
    or on this process's device; a list of results (one a lane)."""
    from repro_torch.api import Options
    from repro_torch.core import driver
    from repro_torch.kernels import tuning
    from repro_torch.launch import mesh as lm
    env = Options.from_sources()
    tuning.configure(enabled=env.get("-kernel_tune") != "off",
                     cache_path=env.get("-kernel_tune_cache"))
    mdps = _instances(args)
    kw = dict(checkpoint_dir=args.ckpt, chunk=chunk, device=args.device)
    if mesh_world:
        if args.batch > 1:
            kw.update(mesh=lm.make_fleet_mesh(mesh_world, device=args.device),
                      layout="fleet")
        else:
            kw.update(mesh=lm.make_host_mesh((mesh_world, 1),
                                             device=args.device),
                      layout="1d")
    if args.batch > 1:
        return driver.solve_many(mdps, _opts(max_outer), **kw)
    return [driver.solve(mdps[0], _opts(max_outer), **kw)]


def worker(args) -> int:
    """One rank of a phase, under torchrun: phase 1 stops after 3 outer
    steps (a checkpoint after each), phase 2 resumes to convergence and
    rank 0 writes the values to ``--out``."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as lm
    lm.init_distributed(args.device)
    world, rank = dist.get_world_size(), dist.get_rank()
    try:
        if args.worker == 1:
            rs = _solve(args, 3, 1, mesh_world=world)
        else:
            rs = _solve(args, 500, 16, mesh_world=world)
            if rank == 0:
                np.save(args.out, np.stack([r.v for r in rs]))
        if rank == 0:
            print(f"[elastic] phase {args.worker} on {world} ranks: "
                  + "; ".join(r.summary() for r in rs), flush=True)
    except BaseException:
        lm.shutdown(barrier=False)
        raise
    lm.shutdown()
    return 0 if args.worker == 1 or all(r.converged for r in rs) else 1


def _world(args, phase: int, world: int, extra: list) -> str:
    """Run phase ``phase`` on ``world`` ranks under torchrun; its output.
    The launch runs in a session of its own, so a timeout stops its whole
    process tree."""
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", str(world), "-m",
            "repro_torch.launch.elastic", "--", "--worker", str(phase),
            *extra]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=args.timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise SystemExit(f"[elastic] phase {phase} on {world} ranks timed "
                         f"out after {args.timeout} s")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    lines = [ln for ln in out.splitlines() if ln.startswith("[elastic]")]
    if proc.returncode != 0:
        raise SystemExit(f"[elastic] phase {phase} on {world} ranks exited "
                         f"{proc.returncode}:\n{err[-3000:]}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--gamma", type=float, default=0.995)
    ap.add_argument("--device", default="cuda", choices=list(DEVICES),
                    help="cuda (default) or cpu (gloo ranks on the host)")
    ap.add_argument("--batch", type=int, default=1,
                    help="a seed ensemble of B garnets under the fleet "
                         "layout (default: one garnet under 1d)")
    ap.add_argument("--worlds", type=int, nargs=2, default=None,
                    metavar=("FIRST", "SECOND"),
                    help="ranks of the interrupted and the resuming world "
                         "(SECOND 0: this process, no mesh); default 4 2 "
                         "on the host, on the card every card and half")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds each world may take")
    ap.add_argument("--worker", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--ckpt", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--"]:
        argv = argv[1:]
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args)

    resolve_device(args.device)   # no GPU for cuda: raise, never the host
    if args.worlds is None:
        cards = torch.cuda.device_count() if args.device == "cuda" else 4
        args.worlds = (cards, cards // 2) if cards >= 2 else (1, 0)
    first, second = args.worlds
    if not (first > second >= 0):
        raise SystemExit(f"--worlds {first} {second}: the resuming world "
                         f"must be smaller (0: no mesh)")
    tmp = tempfile.mkdtemp(prefix="elastic_")
    args.ckpt, args.out = os.path.join(tmp, "ckpt"), os.path.join(tmp,
                                                                  "v.npy")
    shared = ["--n", str(args.n), "--gamma", str(args.gamma), "--device",
              args.device, "--batch", str(args.batch), "--ckpt", args.ckpt,
              "--out", args.out]
    try:
        print(_world(args, 1, first, shared) + " (simulated failure)",
              flush=True)
        if second:
            print(_world(args, 2, second, shared), flush=True)
            v = np.load(args.out)
        else:
            rs = _solve(args, 500, 16, mesh_world=0)
            print(f"[elastic] phase 2 on one device, no mesh: "
                  + "; ".join(r.summary() for r in rs), flush=True)
            v = np.stack([r.v for r in rs])
        args.ckpt = None
        ref = _solve(args, 500, 64, mesh_world=0)
        dv = float(np.abs(v - np.stack([r.v for r in ref])).max())
        print(f"[elastic] |v - v_ref|_inf = {dv:.2e}")
        if not (all(r.converged for r in ref) and dv < 1e-9):
            print("[elastic] FAILED: the resumed solve left the "
                  "uninterrupted one", flush=True)
            return 1
        print("[elastic] OK: elastic restart preserved the solve exactly")
        return 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    raise SystemExit(main())
