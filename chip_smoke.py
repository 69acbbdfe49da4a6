"""End-to-end check of the torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root; it needs one CUDA device, ``nvcc`` and the
repository's ``src/`` next to this file, and exits non-zero (printing no
result) without them.  Phases, each of which raises on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build the three CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all at once) and hold both ELL kernels against
   their plain PyTorch versions on garnet tables ``n=10^6, m=16, K=8`` in
   float32 and float64: max |diff| must be 0 and the argmin identical.
   Kernel, plain version and (SpMV only) ``torch.sparse_csr_tensor @ x``
   are timed with CUDA events (median of 25 after warm-up);
3. the main path at full width, ``garnet n=10^6, m=16, k=8, gamma=0.99``:
   (a) the CLI ``repro_torch.launch.solve ... --method ipi_gmres --atol
   1e-8`` (float64) must exit 0; (b) ``madupite_session({-method mpi,
   -dtype float32, -atol 1e-4}).solve(...)`` must converge.  The launch
   counters are set to 0 just before each of (a) and (b) and read just
   after it, and both kernels must have launched in each; the CLI's value
   vector is checked independently by one plain-version backup on the
   CPU;
   then the same ipi_gmres solve once plain and once under torch.profiler
   (device time by kernel, idle share);
4. GPU vs CPU parity at n=20,000 for vi / mpi / ipi_gmres x mincost /
   maxreward in float64: same policy and counts, values within
   max(1e-10 |v|_inf, gap bound);
5. the dense path, on ``as_dense()`` of garnet ``n=16,384, m=16, k=8,
   gamma=0.99`` built on the card (P is 17.2 GB of float32):
   (2d) ``dense_backup`` against its plain version in float32 and float64,
   bitwise, timed as in phase 2, beside ``torch.mv(P.view(n*m, n), v)``
   (the cuBLAS product alone, float32 only); (3d) a Session ipi_gmres
   float64 solve to ``1e-8`` and a ``driver.solve`` mpi float32 solve to
   ``1e-4``, each with its own launch counts (``dense_backup`` >= 1, the
   ELL kernels 0), the first certified by one plain-version backup of its
   value vector and held against the ELL solve of the same garnet; (3e)
   the ipi_gmres solve profiled as in phase 3b; (4d) GPU vs CPU parity on
   a fully dense random MDP at n=2,048, m=8 for mpi / ipi_gmres x
   mincost / maxreward in float64;
6. one JSON ``kernels`` line, then the ``ok`` line last.  An ELL kernel's
   ``launches`` is its count in the CLI's ipi_gmres solve (a), the
   default method; ``dense_backup``'s is its count in the dense ipi_gmres
   solve (3d).  ``launches_by_path`` gives each path's counts.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "chip_smoke"

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and non-tensor-core peaks
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}

N, M, K, GAMMA = 1_000_000, 16, 8, 0.99
DN, DM, DK = 16_384, 16, 8          # the dense phases' garnet
REPS, WARMUP = 25, 3
PLAIN_DENSE_REPS = 5                # the dense plain version is slow
ELL_KERNELS = ("ell_backup", "ell_matvec")


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = REPS) -> float:
    """Median device time of one call, by CUDA events around each call."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: int, flops: int, dtype: torch.dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    ia = {4: torch.int32, 8: torch.int64}[a.element_size()]
    return a.dtype == b.dtype and a.shape == b.shape and \
        torch.equal(a.view(ia), b.view(ia))


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.max(torch.abs(a.double() - b.double())))


def kernel_checks(mdp, gen: np.random.Generator) -> dict:
    """Phase 2: each kernel against its plain version, timed."""
    from repro_torch.core import bellman
    from repro_torch.core.comm import Axes
    from repro_torch.kernels import bellman_ell, ref, spmv_ell

    idx, val, cost = mdp.idx, mdp.val, mdp.cost
    n, m, k = idx.shape
    out = {"ell_backup": {}, "ell_matvec": {}}
    for dt in (torch.float32, torch.float64):
        name = str(dt).replace("torch.", "")
        v = torch.from_numpy(gen.random(n) * 50.0).to("cuda", dt)
        got_v, got_pi = bellman_ell.ell_backup(idx, val, cost, GAMMA, v)
        want_v, want_pi = ref.ell_backup(idx, val, cost, GAMMA, v)
        torch.cuda.synchronize()
        if not (bits_equal(got_v, want_v) and torch.equal(got_pi, want_pi)):
            raise AssertionError(
                f"ell_backup {name}: kernel != plain version (max |diff| "
                f"{max_abs_diff(got_v, want_v)}, argmin mismatches "
                f"{int((got_pi != want_pi).sum())})")
        nbytes = (idx.nbytes + val.nbytes + cost.nbytes + v.nbytes
                  + got_v.nbytes + got_pi.nbytes)
        flops = n * m * (2 * k + 3)
        b_ms, b_by = bound_ms(nbytes, flops, dt)
        out["ell_backup"][name] = dict(
            max_abs_err=max_abs_diff(got_v, want_v),
            ms=time_ms(lambda: bellman_ell.ell_backup(idx, val, cost,
                                                      GAMMA, v)),
            plain_ms=time_ms(lambda: ref.ell_backup(idx, val, cost, GAMMA,
                                                    v)),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            bytes=nbytes, flops=flops)

        rows = bellman.policy_rows(mdp, got_pi, Axes())
        x = torch.from_numpy(gen.random(n) * 50.0).to("cuda", dt)
        got_y = spmv_ell.ell_matvec(rows.idx, rows.val, x)
        want_y = ref.ell_matvec(rows.idx, rows.val, x)
        torch.cuda.synchronize()
        if not bits_equal(got_y, want_y):
            raise AssertionError(f"ell_matvec {name}: kernel != plain "
                                 f"version (max |diff| "
                                 f"{max_abs_diff(got_y, want_y)})")
        crow = torch.arange(0, n * k + 1, k, dtype=torch.int32,
                            device="cuda")
        csr = torch.sparse_csr_tensor(crow, rows.idx.reshape(-1),
                                      rows.val.reshape(-1).to(dt),
                                      size=(n, n), check_invariants=False)
        lib_y = csr @ x
        nbytes = rows.idx.nbytes + rows.val.nbytes + x.nbytes + got_y.nbytes
        flops = 2 * n * k
        b_ms, b_by = bound_ms(nbytes, flops, dt)
        out["ell_matvec"][name] = dict(
            max_abs_err=max_abs_diff(got_y, want_y),
            ms=time_ms(lambda: spmv_ell.ell_matvec(rows.idx, rows.val, x)),
            plain_ms=time_ms(lambda: ref.ell_matvec(rows.idx, rows.val, x)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: csr @ x),
            library_max_abs_diff=max_abs_diff(lib_y, want_y),
            bytes=nbytes, flops=flops)
        log(f"[phase2] {name}: backup {out['ell_backup'][name]['ms']:.4f} "
            f"ms (plain {out['ell_backup'][name]['plain_ms']:.4f}, bound "
            f"{out['ell_backup'][name]['bound_ms']:.4f}); spmv "
            f"{out['ell_matvec'][name]['ms']:.4f} ms (plain "
            f"{out['ell_matvec'][name]['plain_ms']:.4f}, csr "
            f"{out['ell_matvec'][name]['library_ms']:.4f}, bound "
            f"{out['ell_matvec'][name]['bound_ms']:.4f}); bitwise equal")
    return out


def require_launched(path: str, launches: dict, names) -> None:
    """Every kernel in ``names`` launched on ``path``, and no other."""
    if any(launches[k] < 1 for k in names) or \
            any(c for k, c in launches.items() if k not in names):
        raise AssertionError(f"{path}: expected launches of exactly "
                             f"{sorted(names)}, got {launches}")


def main_path(mdp) -> dict:
    """Phase 3: the CLI (f64 ipi_gmres) and a Session (f32 mpi) at full
    width, each with its own launch counts, then an independent CPU check
    of the CLI's value vector."""
    from repro_torch.api import MDP, madupite_session
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import solve as cli

    OUT.mkdir(parents=True, exist_ok=True)
    v_path, pi_path = OUT / "cli_v.npy", OUT / "cli_pi.npy"
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main(["--instance", "garnet", "--n", str(N), "--m", str(M),
                   "--k", str(K), "--gamma", str(GAMMA),
                   "--method", "ipi_gmres", "--atol", "1e-8",
                   "--option", f"file_cost={v_path}",
                   "--option", f"file_policy={pi_path}"])
    t_cli = time.perf_counter() - t0
    cli_launches = ops.launch_counts()
    if rc != 0:
        raise AssertionError(f"CLI ipi_gmres exited {rc}")
    require_launched("CLI ipi_gmres", cli_launches, ELL_KERNELS)

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with madupite_session({"-method": "mpi", "-dtype": "float32",
                           "-atol": 1e-4}) as s:
        r = s.solve(MDP(mdp))
    torch.cuda.synchronize()
    t_sess = time.perf_counter() - t0
    sess_launches = ops.launch_counts()
    if not r.converged:
        raise AssertionError(f"Session mpi float32 did not converge: "
                             f"{r.summary()}")
    require_launched("Session mpi", sess_launches, ELL_KERNELS)
    log(f"[phase3] session mpi f32: {r.summary()} wall={t_sess:.2f}s; "
        f"launches {sess_launches}")

    v = np.load(v_path)
    pi = np.load(pi_path)
    if v.shape != (N,) or v.dtype != np.float64 or not np.isfinite(v).all():
        raise AssertionError(f"CLI value vector: shape {v.shape} dtype "
                             f"{v.dtype}, finite={np.isfinite(v).all()}")
    host = mdp.to("cpu")
    tv, tpi = ref.ell_backup(host.idx, host.val, host.cost, GAMMA,
                             torch.from_numpy(v))
    res = float(torch.max(torch.abs(tv - torch.from_numpy(v))))
    slack = 16 * np.finfo(np.float64).eps * float(np.abs(v).max())
    if not res <= 1e-8 + slack:
        raise AssertionError(f"independent CPU backup: ||Tv - v||_inf = "
                             f"{res} > 1e-8")
    if not np.array_equal(tpi.numpy(), pi):
        raise AssertionError("independent CPU backup: greedy policy "
                             "differs from the CLI's")
    log(f"[phase3] CLI wall={t_cli:.2f}s; independent CPU residual "
        f"{res:.3e} <= 1e-8; launches {cli_launches}")
    launches = {"cli_ipi_gmres": cli_launches, "session_mpi": sess_launches}
    return dict(launches=launches, cli_wall_s=t_cli, session_wall_s=t_sess,
                session_outer=r.outer_iterations,
                session_inner=r.inner_iterations, cpu_residual=res)


def where_time_goes(mdp, phase: str) -> dict:
    """Phase 3b (and 3e, on the dense path): the ipi_gmres float64 solve
    of the path's instance again, once plain for its wall time and once
    under torch.profiler for device time by kernel.  The idle share is
    1 - busy / wall against the plain run's wall, and against the profiled
    run's (profiling adds host time, so that one is an upper bound)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import driver
    from repro_torch.core.ipi import IPIOptions

    opts = IPIOptions(method="ipi_gmres", dtype="float64", atol=1e-8,
                      max_outer=2000)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = driver.solve(mdp, opts, device="cuda")
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        driver.solve(mdp, opts, device="cuda")
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        # device-side entries only (kernels, copies): host ops report the
        # device time of the kernels they launch, which would count twice
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(ms for ms, _, _ in rows)
    out = dict(outer=r.outer_iterations, inner=r.inner_iterations,
               wall_ms=wall_ms, profiled_wall_ms=prof_wall_ms,
               device_busy_ms=busy_ms, device_entries=len(rows),
               idle_share=(1.0 - busy_ms / wall_ms) if rows else None,
               idle_share_profiled=(1.0 - busy_ms / prof_wall_ms)
               if rows else None,
               top=[dict(ms=ms, count=c, kernel=k[:90])
                    for ms, c, k in rows[:8]])
    log(f"[{phase}] {json.dumps(out)}")
    return out


def parity() -> list:
    """Phase 4: the same solves on the GPU and on the CPU."""
    from repro_torch.core import driver, generators
    from repro_torch.core.ipi import IPIOptions

    mdp = generators.garnet(n=20_000, m=8, k=4, gamma=GAMMA, seed=3)
    rows = []
    for method in ("vi", "mpi", "ipi_gmres"):
        for mode in ("mincost", "maxreward"):
            opts = IPIOptions(method=method, mode=mode, dtype="float64",
                              atol=1e-6, max_outer=2000)
            rg = driver.solve(mdp, opts, device="cuda")
            rc = driver.solve(mdp, opts, device="cpu")
            dv = float(np.abs(rg.v - rc.v).max())
            tol = max(1e-10 * float(np.abs(rc.v).max()), rc.gap_bound)
            row = dict(method=method, mode=mode,
                       outer=(rg.outer_iterations, rc.outer_iterations),
                       inner=(rg.inner_iterations, rc.inner_iterations),
                       policy_equal=bool(np.array_equal(rg.policy,
                                                         rc.policy)),
                       max_abs_dv=dv, tol=tol)
            log(f"[phase4] {json.dumps(row)}")
            if not (rg.converged and rc.converged and row["policy_equal"]
                    and rg.outer_iterations == rc.outer_iterations
                    and rg.inner_iterations == rc.inner_iterations
                    and dv <= tol):
                raise AssertionError(f"GPU vs CPU parity failed: {row}")
            rows.append(row)
    return rows


def dense_kernel_checks(dmdp, gen: np.random.Generator) -> dict:
    """Phase 2d: ``dense_backup`` against its plain version at full width,
    timed, beside ``torch.mv`` over the same P (the product alone)."""
    from repro_torch.kernels import dense_backup, ref

    p, cost = dmdp.p, dmdp.cost
    n, m, n_cols = p.shape
    out = {}
    for dt in (torch.float32, torch.float64):
        name = str(dt).replace("torch.", "")
        v = torch.from_numpy(gen.random(n_cols) * 50.0).to("cuda", dt)
        got_v, got_pi = dense_backup.dense_backup(p, cost, GAMMA, v)
        want_v, want_pi = ref.dense_backup(p, cost, GAMMA, v)
        torch.cuda.synchronize()
        if not (bits_equal(got_v, want_v) and torch.equal(got_pi, want_pi)):
            raise AssertionError(
                f"dense_backup {name}: kernel != plain version (max |diff| "
                f"{max_abs_diff(got_v, want_v)}, argmin mismatches "
                f"{int((got_pi != want_pi).sum())})")
        nbytes = (p.nbytes + cost.nbytes + v.nbytes + got_v.nbytes
                  + got_pi.nbytes)
        flops = n * m * (2 * n_cols + 3)
        b_ms, b_by = bound_ms(nbytes, flops, dt)
        row = dict(
            max_abs_err=max_abs_diff(got_v, want_v),
            ms=time_ms(lambda: dense_backup.dense_backup(p, cost, GAMMA, v)),
            plain_ms=time_ms(lambda: ref.dense_backup(p, cost, GAMMA, v),
                             reps=PLAIN_DENSE_REPS),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            bytes=nbytes, flops=flops)
        if dt == torch.float32:
            # torch.mv takes one dtype: in float32 it is cuBLAS's gemv over
            # the same P, the product without the epilogue and min/argmin
            p2 = p.view(n * m, n_cols)
            row["library_ms"] = time_ms(lambda: torch.mv(p2, v))
            row["library"] = "torch.mv(P.view(n*m, n_cols), v), product only"
        out[name] = row
        log(f"[phase2d] dense_backup {name}: {row['ms']:.4f} ms (plain "
            f"{row['plain_ms']:.4f}, torch.mv {row['library_ms']}, bound "
            f"{row['bound_ms']:.4f} by {b_by}); bitwise equal")
    return out


def dense_main_path(ell, dmdp) -> dict:
    """Phase 3d: the dense path through a Session (ipi_gmres, float64) and
    through ``driver.solve`` (mpi, float32), each with its own launch
    counts; an independent plain-version certificate of the first; the
    ELL solve of the same garnet as a cross-check."""
    from repro_torch.api import MDP, madupite_session
    from repro_torch.core import driver
    from repro_torch.core.ipi import IPIOptions
    from repro_torch.kernels import ops, ref

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with madupite_session({"-method": "ipi_gmres", "-dtype": "float64",
                           "-atol": 1e-8}) as s:
        r = s.solve(MDP(dmdp))
    torch.cuda.synchronize()
    t_gmres = time.perf_counter() - t0
    gmres_launches = ops.launch_counts()
    if not r.converged:
        raise AssertionError(f"dense Session ipi_gmres did not converge: "
                             f"{r.summary()}")
    require_launched("dense Session ipi_gmres", gmres_launches,
                     ("dense_backup",))
    log(f"[phase3d] dense Session ipi_gmres f64: {r.summary()} "
        f"wall={t_gmres:.3f}s; launches {gmres_launches}")

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rm = driver.solve(dmdp, IPIOptions(method="mpi", dtype="float32",
                                       atol=1e-4, max_outer=2000),
                      device="cuda")
    torch.cuda.synchronize()
    t_mpi = time.perf_counter() - t0
    mpi_launches = ops.launch_counts()
    if not rm.converged:
        raise AssertionError(f"dense driver mpi float32 did not converge: "
                             f"{rm.summary()}")
    require_launched("dense driver mpi", mpi_launches, ("dense_backup",))
    log(f"[phase3d] dense driver mpi f32: {rm.summary()} "
        f"wall={t_mpi:.3f}s; launches {mpi_launches}")

    v = torch.from_numpy(r.v).to("cuda")
    tv, tpi = ref.dense_backup(dmdp.p, dmdp.cost, GAMMA, v)
    res = float(torch.max(torch.abs(tv - v)))
    slack = 16 * np.finfo(np.float64).eps * float(np.abs(r.v).max())
    if not res <= 1e-8 + slack:
        raise AssertionError(f"plain-version certificate: ||Tv - v||_inf = "
                             f"{res} > 1e-8")
    if not np.array_equal(tpi.cpu().numpy(), r.policy):
        raise AssertionError("plain-version certificate: greedy policy "
                             "differs from the solve's")
    re_ = driver.solve(ell, IPIOptions(method="ipi_gmres", dtype="float64",
                                       atol=1e-8), device="cuda")
    dv = float(np.abs(re_.v - r.v).max())
    tol = 1e-5 * float(np.abs(re_.v).max())
    if not (re_.converged and dv <= tol):
        raise AssertionError(f"dense vs ELL solve of one garnet: max |dv| "
                             f"{dv} > {tol} ({re_.summary()})")
    log(f"[phase3d] plain-version residual {res:.3e} <= 1e-8, same policy; "
        f"dense vs ELL max |dv| {dv:.3e} <= {tol:.3e} (policies equal: "
        f"{bool(np.array_equal(re_.policy, r.policy))})")
    launches = {"session_ipi_gmres": gmres_launches,
                "driver_mpi": mpi_launches}
    return dict(launches=launches, gmres_wall_s=t_gmres,
                gmres_outer=r.outer_iterations,
                gmres_inner=r.inner_iterations, mpi_wall_s=t_mpi,
                mpi_outer=rm.outer_iterations,
                mpi_inner=rm.inner_iterations, plain_residual=res,
                ell_max_abs_dv=dv)


def dense_parity() -> list:
    """Phase 4d: dense solves on the GPU and on the CPU, a fully dense
    random MDP at n=2,048, m=8."""
    from repro_torch.core import driver
    from repro_torch.core.ipi import IPIOptions
    from repro_torch.core.mdp import DenseMDP

    rng = np.random.default_rng(4)
    n, m = 2048, 8
    p = rng.random((n, m, n)) ** 4
    p /= p.sum(-1, keepdims=True)
    mdp = DenseMDP.from_numpy(p, rng.random((n, m)), GAMMA, n, m)
    rows = []
    for method in ("mpi", "ipi_gmres"):
        for mode in ("mincost", "maxreward"):
            opts = IPIOptions(method=method, mode=mode, dtype="float64",
                              atol=1e-6, max_outer=2000)
            rg = driver.solve(mdp, opts, device="cuda")
            rc = driver.solve(mdp, opts, device="cpu")
            dv = float(np.abs(rg.v - rc.v).max())
            tol = max(1e-10 * float(np.abs(rc.v).max()), rc.gap_bound)
            row = dict(method=method, mode=mode,
                       outer=(rg.outer_iterations, rc.outer_iterations),
                       inner=(rg.inner_iterations, rc.inner_iterations),
                       policy_equal=bool(np.array_equal(rg.policy,
                                                         rc.policy)),
                       max_abs_dv=dv, tol=tol)
            log(f"[phase4d] {json.dumps(row)}")
            if not (rg.converged and rc.converged and row["policy_equal"]
                    and rg.outer_iterations == rc.outer_iterations
                    and rg.inner_iterations == rc.inner_iterations
                    and dv <= tol):
                raise AssertionError(f"dense GPU vs CPU parity failed: {row}")
            rows.append(row)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import generators
    from repro_torch.kernels import bellman_ell, build, dense_backup, spmv_ell

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[phase1] {torch.cuda.get_device_name(0)} torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    build.build_all([bellman_ell.SOURCE, spmv_ell.SOURCE,
                     dense_backup.SOURCE])
    log(f"[phase2] kernels built in {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    mdp = generators.garnet(n=N, m=M, k=K, gamma=GAMMA, seed=0).to("cuda")
    log(f"[phase2] garnet n={N} m={M} k={K} on the card in "
        f"{time.perf_counter() - t0:.1f}s")
    checks = kernel_checks(mdp, np.random.default_rng(1))
    path = main_path(mdp)
    where_time_goes(mdp, "phase3b")
    parity()
    del mdp
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ell = generators.garnet(n=DN, m=DM, k=DK, gamma=GAMMA, seed=0).to("cuda")
    dmdp = ell.as_dense()
    dmdp.validate()
    torch.cuda.synchronize()
    log(f"[phase2d] as_dense() of garnet n={DN} m={DM} k={DK} on the card "
        f"({dmdp.p.nbytes / 1e9:.1f} GB) in {time.perf_counter() - t0:.1f}s")
    dchecks = dense_kernel_checks(dmdp, np.random.default_rng(2))
    dpath = dense_main_path(ell, dmdp)
    where_time_goes(dmdp, "phase3e")
    del ell, dmdp
    torch.cuda.empty_cache()
    dense_parity()

    sources = {"ell_backup": ("src/repro_torch/kernels/csrc/ell_backup.cu",
                              "src/repro/kernels/bellman_ell.py:109"),
               "ell_matvec": ("src/repro_torch/kernels/csrc/ell_spmv.cu",
                              "src/repro/kernels/spmv_ell.py:53")}
    kernels = []
    for name, (src, replaces) in sources.items():
        f64, f32 = checks[name]["float64"], checks[name]["float32"]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=path["launches"]["cli_ipi_gmres"][name],
            launches_by_path={p: c[name]
                              for p, c in path["launches"].items()},
            max_abs_err=max(f64["max_abs_err"], f32["max_abs_err"]),
            max_abs_diff=max(f64["max_abs_err"], f32["max_abs_err"]),
            ms=f64["ms"], plain_ms=f64["plain_ms"],
            bound_ms=f64["bound_ms"], bound_by=f64["bound_by"],
            library_ms=f64["library_ms"], dtype="float64", float32=f32,
            shape=dict(n=N, m=M, k=K)))
    f32, f64 = dchecks["float32"], dchecks["float64"]
    kernels.append(dict(
        name="dense_backup", route="cuda",
        source="src/repro_torch/kernels/csrc/dense_backup.cu",
        replaces="src/repro/kernels/dense_backup.py:52",
        launches=dpath["launches"]["session_ipi_gmres"]["dense_backup"],
        launches_by_path={p: c["dense_backup"]
                          for p, c in dpath["launches"].items()},
        max_abs_err=max(f64["max_abs_err"], f32["max_abs_err"]),
        max_abs_diff=max(f64["max_abs_err"], f32["max_abs_err"]),
        ms=f32["ms"], plain_ms=f32["plain_ms"], bound_ms=f32["bound_ms"],
        bound_by=f32["bound_by"], library_ms=f32["library_ms"],
        library=f32["library"], dtype="float32", float64=f64,
        shape=dict(n=DN, m=DM, n_cols=DN)))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
