"""MDP solve CLI of the torch port — a thin shell over the options database
and the session layer.

The reference's single-instance flags, plus ``--device`` (default
``cuda``; ``cpu`` runs the plain PyTorch kernels on the host).  Every
setting is an options-database key; ``--option key=value`` (repeatable)
reaches the whole registry and ``MADUPITE_OPTIONS`` is ingested first:

    PYTHONPATH=src python -m repro_torch.launch.solve --instance garnet \\
        --n 1000000 --m 16 --k 8 --method ipi_gmres --atol 1e-8

    PYTHONPATH=src python -m repro_torch.launch.solve --instance maze2d \\
        --size 64 --device cpu --option mode=maxreward

    PYTHONPATH=src python -m repro_torch.launch.solve --load DIR \\
        --method ipi_bicgstab --option pc_type=jacobi --monitor \\
        --ckpt-dir CKPT

``--method auto`` probes the instance with a few VI backups and picks the
method by the adaptive rule table (the profile, the choice and its reason
are printed); ``--option adapt_on_stagnation=true`` watches a fixed
method and hot-swaps it on stagnation or divergence (each swap printed):

    PYTHONPATH=src python -m repro_torch.launch.solve --instance garnet \
        --n 1000000 --m 16 --k 8 --method auto --atol 1e-8

Kernel options reach the CLI through ``--option`` or
``MADUPITE_OPTIONS`` like every other key: ``kernel_impl=auto|torch|
blocked|cuda`` (``xla`` / ``pallas`` accepted), ``kernel_tune=off`` (the
kernels' fixed launch shapes, nothing timed or written) and
``kernel_tune_cache=PATH`` (the tuner's JSON file, by default
``~/.cache/madupite/autotune.json``).  On the card the CLI prints the
kernel launches, the tuner's timing launches and the launch shapes it
resolved:

    PYTHONPATH=src python -m repro_torch.launch.solve --instance garnet \
        --n 1000000 --m 16 --k 8 --option kernel_tune_cache=tune.json

``--load`` reads the block-manifest format of :mod:`repro_torch.core.io`
(either package's files); ``--ckpt-dir`` checkpoints between chunks and
resumes from the newest step there; ``--monitor`` prints one line per
outer iteration.

Fleet mode: ``--batch N`` solves N instances in one batched lockstep loop
(``Session.solve_fleet``): a seed ensemble (seeds ``seed .. seed+N-1``),
or with ``--sweep-gamma LO HI`` a gamma sweep over one instance,
``gamma = 1 - geomspace(1-LO, 1-HI, N)``:

    PYTHONPATH=src python -m repro_torch.launch.solve --instance garnet \
        --n 1000000 --m 16 --k 8 --batch 4 --method ipi_gmres --atol 1e-8

    PYTHONPATH=src python -m repro_torch.launch.solve --instance garnet \
        --n 2000 --batch 8 --sweep-gamma 0.9 0.999 --device cpu

Sharded (``--layout 1d|2d``), one process a card under ``torchrun``, or
gloo ranks on the host with ``--device cpu``:

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.solve \
        -- --instance garnet --n 1000000 --m 16 --k 8 --layout 1d

(the ``--`` keeps torchrun from reading ``--n`` / ``--m`` as abbreviations
of its own options; the CLI drops it).  A fleet under torchrun shards its
instances (``--layout fleet|fleet2d``, the default for ``--batch`` over
more than one rank; ``--fleet F`` sizes the fleet axis):

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.solve \
        -- --instance garnet --n 2000 --batch 8 --layout fleet --fleet 4 \
        --device cpu

Every rank builds the instances, keeps its block and prints one ``[solve]
rank`` line naming its device; rank 0 prints the rest.  Under torchrun the
layout defaults to ``1d`` over the world (a fleet: ``fleet``; ``-layout
auto``).  Exit code 0 iff every instance converged, on every rank.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.api import MDP, Options, Session
from repro_torch.core import generators
from repro_torch.device import DEVICES
from repro_torch.kernels import ops, tuning
from repro_torch.launch import mesh as launch_mesh


def _gen_kwargs(args) -> dict:
    if args.instance == "garnet":
        return dict(n=args.n, m=args.m, k=args.k, gamma=args.gamma,
                    seed=args.seed)
    if args.instance == "maze2d":
        return dict(size=args.size, gamma=args.gamma, seed=args.seed)
    if args.instance == "sis":
        return dict(pop=args.n, n_actions=args.m, gamma=args.gamma,
                    seed=args.seed)
    if args.instance == "chain_walk":
        return dict(n=args.n, gamma=args.gamma)
    raise ValueError(args.instance)


def build_instance(args) -> MDP:
    if args.load:
        return MDP.from_file(args.load)
    return MDP.from_generator(args.instance, **_gen_kwargs(args))


def build_fleet(args) -> list:
    """``--batch N`` fleet: seed ensemble, or a gamma sweep with
    ``--sweep-gamma``."""
    kw = _gen_kwargs(args)
    sweep = None
    if args.sweep_gamma is not None:
        lo, hi = args.sweep_gamma
        # log-spaced in (1 - gamma): resolves the conditioning ~ 1/(1-gamma)
        sweep = {"gamma": list(1.0 - np.geomspace(1 - lo, 1 - hi,
                                                  args.batch))}
    return generators.generate_many(args.instance, args.batch, sweep=sweep,
                                    **kw)


def build_options(args) -> Options:
    """Flags -> options database (env < flags/--option; flags the user did
    not pass fall back to the CLI's soft defaults, which still lose to
    ``MADUPITE_OPTIONS``)."""
    opts = Options.from_sources()                    # env ingested here
    flag_map = {"method": "-method", "ksp_type": "-ksp_type",
                "atol": "-atol", "stop_criterion": "-stop_criterion",
                "max_outer": "-max_outer", "dtype": "-dtype",
                "ckpt_dir": "-checkpoint_dir", "mode": "-mode",
                "device": "-device", "layout": "-layout", "fleet": "-fleet"}
    for flag, key in flag_map.items():
        val = getattr(args, flag)
        if val is not None:
            opts.set(key, val, source="cli")
    if args.monitor:
        opts.set("-monitor", True, source="cli")
    opts.ingest_cli(args.option)
    # the CLI defaults to PETSc-style f64 and a deep outer cap, as the
    # reference's does; the environment may override
    if not opts.is_set("-dtype"):
        opts.set("-dtype", "float64", source="default")
    if not opts.is_set("-max_outer"):
        opts.set("-max_outer", 2000, source="default")
    if not opts.is_set("-verbose"):
        opts.set("-verbose", True, source="default")
    return opts


def _start_ranks(args, opts: Options) -> tuple[bool, bool]:
    """Bring the process group up under torchrun (``WORLD_SIZE`` set) or
    for a forced ``1d`` / ``2d`` layout, unless one is up already:
    ``(lead, started)``, lead when this process is rank 0 (or alone).
    Each rank names its device."""
    if dist.is_initialized():
        return dist.get_rank() == 0, False
    if "WORLD_SIZE" not in os.environ \
            and args.layout not in ("1d", "2d", "fleet", "fleet2d"):
        return True, False
    dev = launch_mesh.init_distributed(opts.get("-device"))
    rank, world = dist.get_rank(), dist.get_world_size()
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "host"
    print(f"[solve] rank {rank} of {world} on {dev} ({name})", flush=True)
    return rank == 0, True


def _launch_line(opts: Options, say=print) -> None:
    if opts.get("-device") == "cuda":
        counts = " ".join(f"{k}={v}" for k, v in ops.launch_counts().items())
        say(f"[solve] kernel launches: {counts}")
        tuned = " ".join(f"{k}={v}"
                         for k, v in ops.tune_launch_counts().items())
        say(f"[solve] tune launches: {tuned} (tuning "
            f"{'on' if tuning.enabled() else 'off'})")
        say(f"[solve] launch shapes: "
            f"{json.dumps(ops.launch_shapes(), sort_keys=True)}")


def _run(args, session: Session, opts: Options, say) -> int:
    """One single solve, or one fleet with ``--batch``, through
    ``session``; the exit code."""
    if args.batch > 1:
        fleet = build_fleet(args)
        mesh, layout = session.placement(fleet_size=args.batch)
        where = "single" if mesh is None else \
            f"{layout} over mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}"
        say(f"[solve] fleet B={args.batch} instance={args.instance} "
            f"n={fleet[0].n_global} m={fleet[0].m_global} "
            f"gammas={[round(float(m.gamma), 6) for m in fleet]} "
            f"device={opts.get('-device')} layout={where}")
        t0 = time.time()
        results = session.solve_fleet(fleet)
        wall = time.time() - t0
        for b, r in enumerate(results):
            say(f"[solve] [{b}] {r.summary()}")
        say(f"[solve] fleet wall={wall:.2f}s "
            f"({wall / args.batch:.2f}s/instance amortized)")
        _launch_line(opts, say)
        ok = launch_mesh.all_ranks(all(r.converged for r in results))
        return 0 if ok else 1

    mdp = build_instance(args)
    mesh, layout = session.placement()
    where = "single" if mesh is None else \
        f"{layout} over {dist.get_world_size()} ranks"
    say(f"[solve] instance={args.instance} n={mdp.n} m={mdp.m} "
        f"gamma={mdp.gamma} mode={mdp.mode} "
        f"device={opts.get('-device')} layout={where}")
    t0 = time.time()
    r = session.solve(mdp)
    say(f"[solve] {r.summary()}  wall={time.time()-t0:.2f}s")
    adaptive = session.stats[-1].get("adaptive")
    if adaptive is not None:
        # what -method auto / -adapt_on_stagnation actually ran
        if adaptive["profile"] is not None:
            p = adaptive["profile"]
            say(f"[solve] probe: {p['iters']} iterations, "
                f"contraction={p['contraction']:.6f} "
                f"span_ratio={p['span_ratio']:.3e} "
                f"res={p['res']:.3e}")
        choice = adaptive.get("choice")
        if choice is not None:
            say(f"[solve] auto-selected {choice['method']} "
                f"(stop={choice['stop_criterion']} "
                f"pc={choice['pc_type']}): {choice['reason']}")
        for sw in adaptive["swaps"]:
            say(f"[solve] hot-swap at k={sw['k']}: "
                f"{sw['from_method']} -> {sw['to_method']} "
                f"(pc={sw['pc_type']}) — {sw['reason']}")
        if adaptive["methods"]:
            say(f"[solve] methods run: "
                f"{' -> '.join(adaptive['methods'])}")
    _launch_line(opts, say)
    say(f"[solve] ||v - v*||_inf <= {r.gap_bound:.3e} (certificate)")
    ok = launch_mesh.all_ranks(bool(r.converged))
    return 0 if ok else 1


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--instance", default="garnet",
                    choices=["garnet", "maze2d", "sis", "chain_walk"])
    ap.add_argument("--load", default=None,
                    help="load an MDP saved by repro_torch.core.io (or "
                         "repro.core.io)")
    ap.add_argument("--n", type=int, default=10000)
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--gamma", type=float, default=0.99)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--method", default=None,
                    help="option -method (any live-registry name; auto "
                         "probes the instance and picks one)")
    ap.add_argument("--ksp-type", default=None,
                    help="option -ksp_type (inner solver sugar)")
    ap.add_argument("--mode", default=None,
                    choices=["mincost", "maxreward"], help="option -mode")
    ap.add_argument("--atol", type=float, default=None, help="option -atol")
    ap.add_argument("--stop-criterion", default=None,
                    help="option -stop_criterion (atol|rtol|span)")
    ap.add_argument("--monitor", action="store_true",
                    help="option -monitor (per-outer-iteration records)")
    ap.add_argument("--max-outer", type=int, default=None,
                    help="option -max_outer")
    ap.add_argument("--layout", default=None,
                    choices=["auto", "single", "1d", "2d", "fleet",
                             "fleet2d"],
                    help="option -layout (1d/2d shard one MDP over the "
                         "torch.distributed world; fleet/fleet2d shard a "
                         "--batch fleet's instances)")
    ap.add_argument("--fleet", type=int, default=None,
                    help="option -fleet (fleet-axis size)")
    ap.add_argument("--dtype", default=None, help="option -dtype")
    ap.add_argument("--device", default=None, choices=list(DEVICES),
                    help="option -device (default cuda)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="option -checkpoint_dir")
    ap.add_argument("--single-device", action="store_true",
                    help="option -layout single")
    ap.add_argument("--option", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="set any options-database key (repeatable; the "
                         "leading dash is optional)")
    ap.add_argument("--batch", type=int, default=1,
                    help="solve a fleet of N instances in one batched loop "
                         "(seed ensemble unless --sweep-gamma)")
    ap.add_argument("--sweep-gamma", type=float, nargs=2, default=None,
                    metavar=("LO", "HI"),
                    help="with --batch: gamma sweep over [LO, HI] instead "
                         "of a seed ensemble")
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--"]:
        # torchrun ... -m repro_torch.launch.solve -- --n ...: the launcher
        # hands on the separator that keeps it from reading --n / --m as
        # abbreviations of its own options
        argv = argv[1:]
    args = ap.parse_args(argv)

    if args.sweep_gamma is not None and args.batch <= 1:
        raise SystemExit("--sweep-gamma needs --batch N (the sweep IS the "
                         "fleet); e.g. --batch 8 --sweep-gamma 0.9 0.9999")
    if args.batch > 1 and args.load:
        raise SystemExit("--batch does not combine with --load")
    if args.single_device:
        args.layout = "single"
    opts = build_options(args)
    if opts.get("-layout") in ("fleet", "fleet2d") and args.batch <= 1:
        raise SystemExit(f"-layout {opts.get('-layout')} shards the fleet "
                         "dim; it needs a fleet (--batch N)")
    lead, started = _start_ranks(args, opts)
    say = print if lead else (lambda *a, **k: None)
    completed = False
    try:
        with Session(opts) as session:
            rc = _run(args, session, opts, say)
        completed = True
        return rc
    finally:
        if started:
            # the ranks meet before tearing down, unless this one failed:
            # a peer might then never arrive
            launch_mesh.shutdown(barrier=completed)


if __name__ == "__main__":
    raise SystemExit(main())
