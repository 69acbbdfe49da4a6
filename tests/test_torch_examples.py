"""The port's examples (``examples/torch/``) at a small size on the CPU,
each held to the JAX package's same computation at the same size.

Each example runs as a user runs it — ``main(argv)`` with ``--device cpu``
and its size flag, the maze under ``torchrun`` on 4 gloo ranks — and the
test reads what it prints: the solves' outer / inner counts and a policy
digest (sha1 of the int32 policy).  The reference side is the same
computation through ``repro.api`` / ``repro.core`` (``-kernel_impl xla``,
tuning off, one device).  The rules are ``tests/test_torch_ksp.py``'s:
garnet and maze2d in float64 give exact policies and counts for every
method, VI everywhere (the backup is bit for bit); sis and chain_walk
Krylov solves give exact policies here, outer counts within 1 and inner
counts within 25% of the larger.
"""

import hashlib
import importlib.util
import os
import re
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import api as japi
from repro.core import IPIOptions as JOpts
from repro.core import generators as jgen
from repro.core import methods as jmethods
from repro.core.driver import solve as jsolve
from repro.core.solvers import richardson as jrichardson
from repro_torch.core import methods as tmethods

jax.config.update("jax_enable_x64", True)

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples" / "torch"
JBASE = {"-layout": "single", "-kernel_impl": "xla", "-kernel_tune": "off",
         "-dtype": "float64"}
INNER_DRIFT = 0.25
TIMEOUT = 300          # seconds, the torchrun launch


def _digest(policy) -> str:
    return hashlib.sha1(np.asarray(policy, np.int32).tobytes()).hexdigest()[:16]


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(name: str, argv, capsys) -> str:
    mod = _load(name)
    capsys.readouterr()
    assert mod.main(["--device", "cpu", *argv]) == 0
    return capsys.readouterr().out


def _counts(line: str) -> tuple[int, int]:
    m = re.search(r"converged=True outer=(\d+) inner=(\d+)", line)
    assert m, line
    return int(m.group(1)), int(m.group(2))


def _line(out: str, prefix: str) -> str:
    [line] = [ln for ln in out.splitlines() if ln.startswith(prefix)]
    return line


def _near(got: tuple, want: tuple) -> None:
    assert abs(got[0] - want[0]) <= 1, (got, want)
    assert abs(got[1] - want[1]) <= INNER_DRIFT * max(got[1], want[1]), \
        (got, want)


@pytest.fixture
def registries_restored():
    """Drop what a run registers (ad-hoc stop criteria, user KSPs) from
    both packages' registries."""
    before = [(mod, set(mod.stop_names()), set(mod.ksp_names()))
              for mod in (jmethods, tmethods)]
    yield
    for mod, stops, ksps in before:
        for name in set(mod.stop_names()) - stops:
            mod.unregister_stop_criterion(name)
        for name in set(mod.ksp_names()) - ksps:
            mod.unregister_ksp(name)


def test_quickstart(capsys):
    n = 300
    out = _run("quickstart", ["--n", str(n)], capsys)
    mdp = japi.MDP.from_generator("garnet", n=n, m=16, k=8, gamma=0.99,
                                  seed=0)
    reward = japi.MDP.from_generator("garnet", n=n, m=8, k=6, gamma=0.99,
                                     seed=1, mode="maxreward")
    with japi.madupite_session({**JBASE, "-atol": 1e-8}) as s:
        r_vi = s.solve(mdp, method="vi", max_outer=10_000)
        r_ipi = s.solve(mdp, method="ipi_gmres")
        r_max = s.solve(reward, method="vi", max_outer=10_000)
    assert _counts(_line(out, "VI ")) == \
        (r_vi.outer_iterations, r_vi.inner_iterations)
    assert _counts(_line(out, "iPI-GMRES")) == \
        (r_ipi.outer_iterations, r_ipi.inner_iterations)
    assert _line(out, "policy digest:").split()[-1] == _digest(r_ipi.policy)
    assert _counts(_line(out, "maxreward :")) == \
        (r_max.outer_iterations, r_max.inner_iterations)
    assert _line(out, "maxreward policy digest:").split()[-1] == \
        _digest(r_max.policy)
    assert "stats JSONL: 2 solves recorded" in out


def _jax_damped(matvec, b, x0, *, tol, maxiter, axes):
    return jrichardson(matvec, b, x0, tol=tol, maxiter=maxiter, axes=axes,
                       omega=0.9)


def test_custom_solver(capsys, registries_restored):
    n, chain, gamma = 300, 100, 0.99
    out = _run("custom_solver", ["--n", str(n), "--chain", str(chain),
                                 "--chain-gamma", str(gamma)], capsys)
    assert "damped" not in tmethods.ksp_names()     # unregistered again
    japi.register_ksp("damped", _jax_damped)
    mdp = japi.MDP.from_generator("garnet", n=n, m=8, k=6, gamma=0.99,
                                  seed=0)
    chain_mdp = japi.MDP.from_generator("chain_walk", n=chain, gamma=gamma)
    with japi.madupite_session({**JBASE, "-atol": 1e-8}) as s:
        r_user = s.solve(mdp, ksp_type="damped")
        r_ref = s.solve(mdp, method="ipi_gmres")
    with japi.madupite_session({**JBASE, "-atol": 1e-8,
                                "-max_outer": 100_000}) as s:
        r_span = s.solve(chain_mdp, method="vi", stop_criterion="span")
        r_atol = s.solve(chain_mdp, method="vi")
    with japi.madupite_session(JBASE) as s:
        r_gap = s.solve(mdp, method="ipi_gmres",
                        stop_criterion=lambda m: m.res / (1 - m.gamma)
                        <= 1e-4)
    assert _counts(_line(out, "user ksp 'damped':")) == \
        (r_user.outer_iterations, r_user.inner_iterations)
    assert _counts(_line(out, "reference (gmres):")) == \
        (r_ref.outer_iterations, r_ref.inner_iterations)
    assert _line(out, "policy digest:").split()[2:5:2] == \
        [_digest(r_user.policy), _digest(r_ref.policy)]
    assert f"span stop: {r_span.outer_iterations} outers (vs " \
           f"{r_atol.outer_iterations} with atol" in out
    assert f"monitored {r_span.outer_iterations + 1} records" in out
    assert _counts(_line(out, "custom gap criterion:")) == \
        (r_gap.outer_iterations, r_gap.inner_iterations)


def _jax_sis(pop: int, sis):
    """The reference example's SIS constructors in jax.numpy, on the port
    example's constants (``sis``), the stage cost summed in float64 as x64
    promotes the reference's."""
    BETA, ACT_COST, MU = sis.BETA, sis.ACT_COST, sis.MU

    def transitions(rows, a: int):
        i = rows.astype(jnp.float32)
        up = jnp.clip(float(BETA[a]) * i * (pop - i) / pop**2, 0, 0.49)
        down = jnp.clip(MU * i / pop, 0, 0.49)
        up = jnp.where(rows == 0, 0.0, up)
        down = jnp.where(rows == 0, 0.0, down)
        ids = jnp.stack([jnp.clip(rows + 1, 0, pop),
                         jnp.clip(rows - 1, 0, pop), rows], axis=-1)
        probs = jnp.stack([up, down, 1.0 - up - down], axis=-1)
        return ids.astype(jnp.int32), probs.astype(jnp.float32)

    def stage_cost(rows, a: int):
        return (jnp.where(rows == 0, 0.0, 2.0 * rows.astype(jnp.float64)
                          / pop) + float(ACT_COST[a])).astype(jnp.float32)

    return transitions, stage_cost


def test_epidemic_control(capsys):
    pop = 100
    out = _run("epidemic_control", ["--pop", str(pop)], capsys)
    assert "built by the device pipeline" in out
    sis = _load("epidemic_control")
    P_fn, g_fn = _jax_sis(pop, sis)
    mdp = japi.MDP.from_functions(P_fn, g_fn, n=pop + 1, m=sis.N_ACT,
                                  nnz=3, gamma=0.999, vectorized=True)
    with japi.madupite_session({**JBASE, "-method": "ipi_bicgstab",
                                "-atol": 1e-8}) as s:
        r = s.solve(mdp)
    lines = out.splitlines()
    solve_line = lines[lines.index(next(ln for ln in lines
                                        if ln.startswith("SIS MDP"))) + 1]
    _near(_counts(solve_line), (r.outer_iterations, r.inner_iterations))
    assert _line(out, "policy digest:").split()[-1] == _digest(r.policy)


def test_ipi_vs_vi(capsys):
    n, gammas = 100, (0.9, 0.99)
    out = _run("ipi_vs_vi", ["--n", str(n), "--gammas",
                             *map(str, gammas)], capsys)
    rows = [ln.split("|") for ln in out.splitlines()
            if re.match(r"\s+0\.\d+ \|", ln)]
    assert len(rows) == len(gammas)
    for gamma, row in zip(gammas, rows):
        mdp = jgen.chain_walk(n=n, gamma=gamma)
        r_vi = jsolve(mdp, JOpts(method="vi", atol=1e-8, dtype="float64",
                                 max_outer=1_000_000, impl="xla"),
                      chunk=8192)
        r_ip = jsolve(mdp, JOpts(method="ipi_gmres", atol=1e-8,
                                 max_inner=3000, dtype="float64",
                                 impl="xla"))
        got = [float(row[0])] + [int(c) for c in row[1:]]
        assert got[0] == gamma
        assert got[1] == r_vi.outer_iterations
        _near(tuple(got[2:]), (r_ip.outer_iterations,
                               r_ip.inner_iterations))


def test_solve_maze_distributed_under_torchrun():
    """4 gloo ranks on the 2d layout, stopped after 3 outer steps and
    resumed: the finished solve's policy is the reference's uninterrupted
    one-device solve's; its counts are held to the Krylov rules (the
    sharded dots sum in another order)."""
    size = 30
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    for key in ("WORLD_SIZE", "MADUPITE_OPTIONS"):
        env.pop(key, None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4",
         str(EXAMPLES / "solve_maze_distributed.py"), "--", "--device",
         "cpu", "--size", str(size)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise AssertionError(f"maze example timed out:\n{err[-3000:]}")
    assert proc.returncode == 0, out[-2000:] + "\n" + err[-3000:]
    assert "preempted at outer=3" in out
    assert "[driver] resumed at outer k=3" in out
    r = jsolve(jgen.maze2d(size=size, gamma=0.999, slip=0.15),
               JOpts(method="ipi_gmres", atol=1e-8, dtype="float64",
                     impl="xla"))
    _near(_counts(_line(out, "finished:")),
          (r.outer_iterations, r.inner_iterations))
    assert _line(out, "policy digest:").split()[-1] == _digest(r.policy)
    assert f"policy at cell (0,0): {r.policy[0]}" in out
