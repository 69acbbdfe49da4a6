"""End-to-end sharded solve with fault tolerance on the port.

Solves a 250x250 slippery-maze MDP (62,500 states) over 4 ranks on the
``2d`` layout (2 state shards x 2 action shards) with checkpointing, and
demonstrates the restart path by solving in two phases: a budget-limited
run that checkpoints after every outer step ("preempted"), then a run
that resumes from the newest checkpoint and finishes.

    # a card a rank, NCCL
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
        examples/torch/solve_maze_distributed.py
    # gloo ranks on the host
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
        examples/torch/solve_maze_distributed.py -- --device cpu --size 30

Runs on the cards unless given ``--device cpu``; ``--size`` is the maze's
side (250).  Rank 0 prints; the exit code is 0 iff the resumed solve
converged with the start cell moving toward the goal, on every rank.
"""
import argparse
import hashlib
import shutil
import sys
import tempfile

import numpy as np
import torch.distributed as dist

from repro_torch.core import IPIOptions, generators
from repro_torch.core.driver import solve
from repro_torch.launch import mesh as lm


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--size", type=int, default=250, help="maze side")
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--"]:
        argv = argv[1:]     # the separator that keeps torchrun off our flags
    args = ap.parse_args(argv)

    lm.init_distributed(args.device)
    rank, world = dist.get_rank(), dist.get_world_size()
    say = print if rank == 0 else (lambda *a, **k: None)
    ok = False
    try:
        mdp = generators.maze2d(size=args.size, gamma=0.999, slip=0.15)
        actions = 2 if world % 2 == 0 else 1
        mesh = lm.make_host_mesh((world // actions, actions),
                                 device=args.device)
        say(f"maze {args.size}x{args.size}: {mdp.n_global:,} states on "
            f"{world} ranks, 2d mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}")
        # one checkpoint directory for every rank: rank 0 makes it
        box = [tempfile.mkdtemp(prefix="maze_") if rank == 0 else None]
        dist.broadcast_object_list(box, src=0)
        ckpt = box[0]
        kw = dict(mesh=mesh, layout="2d", checkpoint_dir=ckpt,
                  verbose=rank == 0, device=args.device)
        try:
            # phase 1: budget-limited run, checkpointing every outer step
            r1 = solve(mdp, IPIOptions(method="ipi_gmres", atol=1e-8,
                                       max_outer=3, dtype="float64"),
                       chunk=1, **kw)
            say(f"preempted at outer={r1.outer_iterations}, "
                f"res={r1.residual:.2e}")

            # phase 2: restart from the checkpoint and finish
            r2 = solve(mdp, IPIOptions(method="ipi_gmres", atol=1e-8,
                                       dtype="float64"), **kw)
            say("finished:", r2.summary())

            # the greedy policy at the start cell should move toward the
            # goal (goal = last cell; actions: 0 stay, 1 N, 2 S, 3 E, 4 W)
            say("policy at cell (0,0):", r2.policy[0], "(expect 2=S or 3=E)")
            say("policy digest:", hashlib.sha1(np.asarray(
                r2.policy, np.int32).tobytes()).hexdigest()[:16])
            ok = bool(r2.converged and r2.policy[0] in (2, 3))
        finally:
            dist.barrier()
            if rank == 0:
                shutil.rmtree(ckpt, ignore_errors=True)
        ok = lm.all_ranks(ok)
    except BaseException:
        lm.shutdown(barrier=False)
        raise
    lm.shutdown()
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
