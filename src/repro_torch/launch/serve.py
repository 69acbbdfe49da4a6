"""MDP serving CLI of the torch port — drive a
:class:`repro_torch.serve.Server` with a workload.

Counterpart of :mod:`repro.launch.serve`, with the same flags plus
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch kernels on
the host), ``--clients`` and ``--prebuild``.  It stands up the in-process
batched solve server and replays a request stream into it with Poisson
arrivals:

    # generated: 32 garnet requests, ragged state counts, ~50 req/s
    PYTHONPATH=src python -m repro_torch.launch.serve --requests 32 \\
        --instance garnet --n-choices 256,384 --m 8 --rate 50 --device cpu

    # on the card: 24 garnets of 500,000 / 1,000,000 states, 4 clients
    PYTHONPATH=src python -m repro_torch.launch.serve --requests 24 \\
        --n-choices 500000,1000000 --m 16 --k 8 --gamma 0.99 --rate 20 \\
        --clients 4 --prebuild --option method=auto \\
        --option serve_max_batch=4 --window 0.05

    # file-driven: one JSON object per line
    PYTHONPATH=src python -m repro_torch.launch.serve --workload reqs.jsonl

A workload-file line is ``{"instance": "garnet", "n": 256, "m": 8,
"seed": 3, "gamma": 0.95, "overrides": {"-atol": 1e-6},
"monitor": false}`` — generator keyword arguments at the top level
(``"deferred": true`` makes a function-backed request, ``"dense": true``
its ``as_dense()``), per-request solver-option overrides under
``"overrides"``.

Arrivals: one Poisson clock (exponential gaps at ``--rate`` requests a
second; 0 submits all at once) whose arrivals are dealt round-robin to
``--clients`` threads (default: a thread a request, as the reference
runs them).  A client builds its request's MDP at its arrival time and
submits it, or with ``--prebuild`` every MDP is built before the clock
starts, so that the serving window holds only serving.  Latency is the
server's: from submit to completion.

Server knobs are options-database keys (``-serve_batch_window``,
``-serve_max_queue``, ``-serve_max_states``, ``-serve_max_batch``,
``-serve_program_cache``, ``-serve_slot_policy``,
``-serve_deadline_ms``) reachable through ``--option key=value`` or
``MADUPITE_OPTIONS``; ``--window`` is sugar for the batching window.
Prints one line a request (its dispatch, padded state count, slot and
latency), one a dispatch (its requests and, on the card, its kernel
launches), then throughput, latency quantiles and the program-cache
counters.  Exits non-zero when any request fails or is rejected.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from repro_torch.api import MDP, Options
from repro_torch.device import DEVICES
from repro_torch.serve import AdmissionError, Server
from repro_torch.serve.stats import percentile


def _parse_workload_file(path: str) -> list[dict]:
    specs = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            try:
                spec = json.loads(line)
            except json.JSONDecodeError as e:
                raise SystemExit(f"{path}:{lineno}: bad JSON: {e}")
            if "instance" not in spec:
                raise SystemExit(f"{path}:{lineno}: missing 'instance'")
            specs.append(spec)
    return specs


def _generate_workload(args) -> list[dict]:
    """Ragged synthetic workload: state counts drawn from --n-choices."""
    rng = random.Random(args.seed)
    choices = [int(x) for x in args.n_choices.split(",")]
    specs = []
    for i in range(args.requests):
        n = rng.choice(choices)
        spec = {"instance": args.instance, "gamma": args.gamma}
        if args.instance == "garnet":
            spec.update(n=n, m=args.m, k=args.k, seed=args.seed + i)
        elif args.instance == "maze2d":
            spec.update(size=max(2, round(n ** 0.5)), seed=args.seed + i)
        elif args.instance == "sis":
            spec.update(pop=n, n_actions=args.m, seed=args.seed + i)
        else:  # chain_walk
            spec.update(n=n)
        specs.append(spec)
    return specs


def build_mdp(spec: dict) -> MDP:
    """A workload line's MDP: the generator's keyword arguments;
    ``"dense": true`` wraps its ``as_dense()``."""
    kw = {k: v for k, v in spec.items()
          if k not in ("instance", "overrides", "monitor", "dense")}
    mdp = MDP.from_generator(spec["instance"], **kw)
    if spec.get("dense"):
        mdp = MDP(mdp.core.as_dense(), mode=mdp.mode)
    return mdp


def build_options(args) -> Options:
    opts = Options.from_sources()                    # env ingested here
    if args.window is not None:
        opts.set("-serve_batch_window", args.window, source="cli")
    if args.monitor:
        opts.set("-monitor", True, source="cli")
    if args.device is not None:
        opts.set("-device", args.device, source="cli")
    opts.ingest_cli(args.option)
    if not opts.is_set("-dtype"):
        opts.set("-dtype", "float64", source="default")
    if not opts.is_set("-max_outer"):
        opts.set("-max_outer", 2000, source="default")
    return opts


def _arrivals(n: int, rate: float, seed: int) -> list[float]:
    """Offsets (s) of ``n`` Poisson arrivals at ``rate`` per second from
    the clock's start (all 0 when ``rate`` is 0)."""
    rng = random.Random(seed)
    t, out = 0.0, []
    for i in range(n):
        out.append(t)
        if rate > 0 and i + 1 < n:
            t += rng.expovariate(rate)
    return out


def submit_clients(server: Server, specs: list[dict], rate: float,
                   seed: int, monitor: bool, clients: int | None = None,
                   mdps: list | None = None) -> list[dict]:
    """Replay ``specs`` into ``server`` on a Poisson clock from
    ``clients`` threads (None: a thread a request), each waiting for its
    own results after its last submit; ``mdps`` are the prebuilt MDPs
    (else each is built at its arrival).  One outcome dict per request,
    in input order."""
    at = _arrivals(len(specs), rate, seed)
    n_threads = len(specs) if clients is None else max(1, int(clients))
    outcomes: list[dict | None] = [None] * len(specs)
    t0 = time.monotonic()

    def client(mine: list[int]) -> None:
        reqs = []
        for i in mine:
            spec = specs[i]
            delay = t0 + at[i] - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            try:
                mdp = mdps[i] if mdps is not None else build_mdp(spec)
                req = server.submit(mdp,
                                    monitor=bool(spec.get("monitor",
                                                          monitor)),
                                    **spec.get("overrides", {}))
                reqs.append((i, req))
            except AdmissionError as e:
                outcomes[i] = {"ok": False, "rejected": e.reason,
                               "error": str(e)}
            except Exception as e:  # noqa: BLE001 — report, don't hang
                outcomes[i] = {"ok": False,
                               "error": f"{type(e).__name__}: {e}"}
        for i, req in reqs:
            try:
                n_records = sum(1 for _ in server.stream(req)) \
                    if req.monitor else 0
                res = req.result()
                outcomes[i] = {
                    "ok": True, "request": req.id,
                    "converged": bool(res.converged),
                    "outer": int(res.outer_iterations),
                    "latency": req.latency, "dispatch": req.dispatch,
                    "records": n_records, "result": res}
            except Exception as e:  # noqa: BLE001
                outcomes[i] = {"ok": False,
                               "error": f"{type(e).__name__}: {e}"}

    threads = [threading.Thread(target=client,
                                args=(list(range(c, len(specs),
                                                 n_threads)),),
                                daemon=True)
               for c in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return outcomes


def main(argv=None, *, keep: dict | None = None,
         window=contextlib.nullcontext, mdps: list | None = None):
    """The CLI.  For callers that drive it in-process: ``window`` is a
    context-manager factory entered around the serving window (the
    arrival clock, the requests' solves and the drain), e.g. a profiler;
    ``mdps`` are the workload's MDPs already built (as ``--prebuild``
    builds them); ``keep`` (a dict) receives the run's ``outcomes``,
    ``mdps`` (prebuilt, else None), server ``stats``, dispatch ``log``
    and serving ``wall``."""
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", default=None,
                    help="JSONL request file (one spec per line); "
                         "otherwise a synthetic workload is generated")
    ap.add_argument("--requests", type=int, default=16,
                    help="generated workload size")
    ap.add_argument("--instance", default="garnet",
                    choices=["garnet", "maze2d", "sis", "chain_walk"])
    ap.add_argument("--n-choices", default="256,384",
                    help="comma-separated state counts the generated "
                         "workload samples from (ragged shape buckets)")
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--gamma", type=float, default=0.95)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rate", type=float, default=50.0,
                    help="Poisson arrival rate in requests/second "
                         "(0 = submit all at once)")
    ap.add_argument("--clients", type=int, default=None,
                    help="client threads the arrivals are dealt to "
                         "(default: one a request)")
    ap.add_argument("--prebuild", action="store_true",
                    help="build every request's MDP before the arrival "
                         "clock starts")
    ap.add_argument("--window", type=float, default=None,
                    help="option -serve_batch_window (batching linger, s)")
    ap.add_argument("--monitor", action="store_true",
                    help="stream per-iteration records for every request")
    ap.add_argument("--device", default=None, choices=list(DEVICES),
                    help="option -device (default cuda)")
    ap.add_argument("--option", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="set any options-database key (repeatable; the "
                         "leading dash is optional), e.g. "
                         "--option serve_max_batch=16")
    args = ap.parse_args(argv)

    specs = (_parse_workload_file(args.workload) if args.workload
             else _generate_workload(args))
    if not specs:
        raise SystemExit("empty workload")
    opts = build_options(args)
    if mdps is None and args.prebuild:
        t0 = time.monotonic()
        with ThreadPoolExecutor(max_workers=args.clients or 4) as pool:
            mdps = list(pool.map(build_mdp, specs))
        print(f"[serve] built {len(mdps)} MDPs in "
              f"{time.monotonic() - t0:.2f}s (before the clock)")

    with Server(opts) as server:
        print(f"[serve] {len(specs)} requests, Poisson rate="
              f"{args.rate}/s, clients="
              f"{args.clients or len(specs)}, window="
              f"{opts.get('-serve_batch_window')}s, device="
              f"{server.session.device}")
        with window():
            t0 = time.monotonic()
            outcomes = submit_clients(server, specs, args.rate, args.seed,
                                      args.monitor, args.clients, mdps)
            server.drain()
            wall = time.monotonic() - t0
        st = server.stats()
        log = server.dispatch_log()
    if keep is not None:
        keep.update(outcomes=outcomes, mdps=mdps, stats=st, log=log,
                    wall=wall)

    ok = [o for o in outcomes if o and o.get("ok")]
    bad = [o for o in outcomes if not (o and o.get("ok"))]
    by_dispatch = {d["dispatch"]: d for d in log}
    for i, o in enumerate(outcomes):
        if o and o.get("ok"):
            d = by_dispatch[o["dispatch"]]
            print(f"[serve] request {i} id={o['request']}: dispatch="
                  f"{o['dispatch']} n_pad={d['n_pad']} slot={d['slot']} "
                  f"latency={o['latency'] * 1e3:.1f}ms outer={o['outer']} "
                  f"converged={o['converged']}")
    for d in log:
        launches = "" if d["launches"] is None else \
            " launches " + " ".join(f"{k}={v}" for k, v in
                                    d["launches"].items() if v)
        print(f"[serve] dispatch {d['dispatch']}: n_pad={d['n_pad']} "
              f"slot={d['slot']} requests={d['requests']} "
              f"method={d['method']} solve={d['seconds']:.3f}s{launches}")
    lats = sorted(o["latency"] for o in ok)
    print(f"[serve] completed={len(ok)}/{len(specs)} wall={wall:.2f}s "
          f"throughput={len(ok) / wall:.2f} req/s")
    if lats:
        print(f"[serve] latency p50={percentile(lats, 50) * 1e3:.1f}ms "
              f"p95={percentile(lats, 95) * 1e3:.1f}ms")
    pc = st["program_cache"]
    print(f"[serve] dispatches={st['dispatches']} "
          f"mean_batch={st['batch']['mean_size']:.1f} "
          f"padded_lanes={st['padded_lanes']}")
    print(f"[serve] program_cache hit_rate={pc['hit_rate']:.2f} "
          f"(hits={pc['hits']} misses={pc['misses']} "
          f"evictions={pc['evictions']})")
    for o in bad:
        print(f"[serve] FAILED: "
              f"{ {k: v for k, v in (o or {}).items() if k != 'result'} }")
    return 0 if not bad else 1


if __name__ == "__main__":
    raise SystemExit(main())
