"""The torch port's user surface: options, Session, CLI, device rule, and
the rule that the port never imports JAX or the JAX package."""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.api import options as jopts
from repro.core import ipi as jipi
from repro_torch.api import MDP, Options, Session, madupite_session
from repro_torch.api import options as topts
from repro_torch.core import driver as tdriver
from repro_torch.core import generators as tgen
from repro_torch.core import ipi as tipi
from repro_torch.launch import solve as tcli

jax.config.update("jax_enable_x64", True)

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: cuda is a legal device here")


# --------------------------------------------------------------------------- #
# Options database                                                            #
# --------------------------------------------------------------------------- #

BAD_VALUES = [
    ("-atol", -1.0), ("-atol", "abc"), ("-rtol", 1.5), ("-max_outer", 0),
    ("-max_inner", -1), ("-inner_forcing", 1.0), ("-restart", 0),
    ("-mpi_sweeps", 0), ("-divtol", 0.5), ("-dtype", "float16"),
    ("-mode", "minreward"), ("-safeguard", "maybe"), ("-max_outer", 2.5),
    ("-chunk", 0), ("-verbose", "sometimes"),
]


@pytest.mark.parametrize("key,value", BAD_VALUES,
                         ids=[f"{k}={v}" for k, v in BAD_VALUES])
def test_validation_messages_match_reference(key, value):
    with pytest.raises(jopts.OptionTypeError) as want:
        jopts.Options({key: value})
    with pytest.raises(topts.OptionTypeError) as got:
        Options({key: value})
    assert str(got.value) == str(want.value)


FIELD_ERRORS = [dict(atol=0.0), dict(rtol=0.0), dict(max_outer=0),
                dict(max_inner=-1), dict(forcing_eta=1.0),
                dict(restart=0), dict(mpi_sweeps=0), dict(divtol=1.0),
                dict(dtype="float16"), dict(mode="minreward")]


@pytest.mark.parametrize("kw", FIELD_ERRORS, ids=[next(iter(k))
                                                  for k in FIELD_ERRORS])
def test_ipi_options_errors_match_reference(kw):
    with pytest.raises(ValueError) as want:
        jipi.IPIOptions(**kw)
    with pytest.raises(ValueError) as got:
        tipi.IPIOptions(**kw)
    assert str(got.value) == str(want.value)


def test_precedence_matches_reference():
    env = {"MADUPITE_OPTIONS": "-method vi -atol 1e-6 -max_outer 77 "
                               "-inner_forcing=0.1"}
    cli = ["method=mpi", "mpi_sweeps=7", "max_outer=88"]
    explicit = {"-max_outer": 99, "dtype": "float64"}
    ref = jopts.Options.from_sources(explicit, cli=cli, env=env).to_ipi()
    got = Options.from_sources(explicit, cli=cli, env=env).to_ipi()
    for field in ("method", "atol", "max_outer", "forcing_eta",
                  "mpi_sweeps", "dtype", "mode", "restart"):
        assert getattr(got, field) == getattr(ref, field), field
    assert (got.method, got.atol, got.max_outer) == ("mpi", 1e-6, 99)


def test_ksp_sugar_and_round_trip():
    assert Options({"-ksp_type": "gmres"}).to_ipi().method == "ipi_gmres"
    assert Options({"-ksp_type": "none"}).to_ipi().method == "vi"
    assert Options({"-ksp_type": "gmres",
                    "-method": "mpi"}).to_ipi().method == "mpi"
    o = Options({"-method": "mpi", "-atol": 1e-5, "-mpi_sweeps": 9,
                 "-dtype": "float64", "-safeguard": False})
    again = Options(o.as_dict(explicit_only=True))
    assert again.to_ipi() == o.to_ipi()
    assert again.to_ipi() == tipi.IPIOptions(
        method="mpi", atol=1e-5, mpi_sweeps=9, dtype="float64",
        safeguard=False)


def test_unknown_keys_and_devices_raise():
    with pytest.raises(topts.UnknownOptionError, match="did you mean"):
        Options({"-atoll": 1e-6})
    with pytest.raises(topts.OptionTypeError, match="'-device' must be"):
        Options({"-device": "tpu"})
    with pytest.raises(topts.OptionTypeError, match="'-method'"):
        Options({"-method": "autoo"})
    assert Options({"-method": "auto"}).get("-method") == "auto"
    assert Options().get("-device") == "cuda"


# --------------------------------------------------------------------------- #
# Session, driver and CLI on the CPU; cuda without a GPU raises               #
# --------------------------------------------------------------------------- #

def test_session_on_cpu_matches_reference_session(tmp_path):
    from repro.api import MDP as JMDP
    from repro.api import Session as JSession

    kw = dict(n=120, m=4, k=3, gamma=0.95, seed=2)
    common = {"-method": "vi", "-dtype": "float64", "-atol": 1e-7,
              "-mode": "maxreward"}
    with JSession({**common, "-layout": "single", "-kernel_impl": "xla",
                   "-kernel_tune": "off"}) as js:
        rj = js.solve(JMDP.from_generator("garnet", **kw))
    files = {"-file_policy": str(tmp_path / "out" / "pi.npy"),
             "-file_cost": str(tmp_path / "out" / "v.npy")}
    with madupite_session({**common, "-device": "cpu", **files}) as s:
        rt = s.solve(MDP.from_generator("garnet", **kw))
        stats = s.stats
    np.testing.assert_array_equal(rt.v, rj.v)
    np.testing.assert_array_equal(rt.policy, rj.policy)
    assert rt.outer_iterations == rj.outer_iterations
    assert stats[0]["device"] == "cpu" and stats[0]["mode"] == "maxreward"
    assert stats[0]["solves"][0]["outer_iterations"] == rt.outer_iterations
    np.testing.assert_array_equal(np.load(files["-file_cost"]), rt.v)
    np.testing.assert_array_equal(np.load(files["-file_policy"]),
                                  rt.policy)


def test_session_overrides_mode_and_close():
    mdp = MDP.from_generator("chain_walk", n=40, gamma=0.9, mode="maxreward")
    s = Session({"-device": "cpu", "-method": "mpi", "-dtype": "float64"})
    r = s.solve(mdp, atol=1e-6)
    assert r.converged and s.stats[-1]["mode"] == "maxreward"
    r2 = s.solve(mdp, mode="mincost")
    assert s.stats[-1]["mode"] == "mincost"
    assert not np.array_equal(r.v, r2.v)
    s.close()
    with pytest.raises(RuntimeError, match="closed"):
        s.solve(mdp)


def test_from_arrays_builds_and_validates():
    m = tgen.garnet(n=30, m=3, k=2, seed=4)
    mdp = MDP.from_arrays(idx=m.idx.numpy(), val=m.val.numpy(),
                          cost=m.cost.numpy(), gamma=0.9)
    core = mdp.build("cpu")
    assert torch.equal(core.idx, m.idx) and (mdp.n, mdp.m) == (30, 3)
    assert mdp.build("cpu") is core
    with pytest.raises(ValueError, match="sums to"):
        MDP.from_arrays(idx=m.idx.numpy(), val=m.val.numpy() * 2,
                        cost=m.cost.numpy())
    dense = MDP.from_arrays(p=np.ones((2, 1, 2)) / 2, cost=np.zeros((2, 1)))
    assert torch.equal(dense.build("cpu").p, torch.full((2, 1, 2), 0.5))
    with pytest.raises(ValueError, match="not both"):
        MDP.from_arrays(p=np.ones((2, 1, 2)) / 2, cost=np.zeros((2, 1)),
                        idx=np.zeros((2, 1, 1), np.int32))


def test_cuda_without_gpu_raises_everywhere(no_gpu):
    m = tgen.chain_walk(n=20)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        tdriver.solve(m, tipi.IPIOptions(method="vi"))
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        Session({"-method": "vi"})
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        tcli.main(["--instance", "chain_walk", "--n", "20"])


def test_cli_on_cpu(capsys):
    rc = tcli.main(["--instance", "maze2d", "--size", "6", "--device", "cpu",
                    "--method", "ipi_gmres", "--atol", "1e-9",
                    "--option", "mode=maxreward"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "converged=True" in out and "device=cpu" in out
    assert "(certificate)" in out and "kernel launches" not in out


@pytest.mark.parametrize("flags", [["--batch", "2", "--layout", "fleet"],
                                   ["--layout", "fleet2d"],
                                   ["--batch", "3", "--fleet", "3"],
                                   ["--layout", "fleet", "--monitor"],
                                   ["--sweep-gamma", "0.9", "0.99",
                                    "--layout", "fleet2d"],
                                   ["--fleet", "2"],
                                   ["--fleet", "4", "--ckpt-dir", "d"]])
def test_cli_unported_flags_raise(flags, tmp_path, capsys):
    # the fleet-mesh flags are ported: a fleet layout without a fleet
    # (--batch) and a sweep without --batch still exit with the
    # reference's messages; the rest solve (a forced fleet layout on a
    # world of one rank, here in-process; --fleet sizes a fleet axis that
    # only a fleet layout has)
    flags = [str(tmp_path / f) if f == "d" else f for f in flags]
    argv = ["--device", "cpu", "--instance", "garnet", "--n", "60", "--m",
            "4", "--k", "3", "--method", "vi", "--atol", "1e-6", *flags]
    if "--sweep-gamma" in flags:
        with pytest.raises(SystemExit, match="needs --batch N"):
            tcli.main(argv)
    elif "--layout" in flags and "--batch" not in flags:
        with pytest.raises(SystemExit, match="needs a fleet"):
            tcli.main(argv)
    else:
        assert tcli.main(argv) == 0
        out = capsys.readouterr().out
        assert "converged=True" in out and "converged=False" not in out
        if "--layout" in flags:
            assert "layout=fleet over mesh {'fleet': 1, 'data': 1}" in out


# --------------------------------------------------------------------------- #
# The port imports neither JAX nor the JAX package                            #
# --------------------------------------------------------------------------- #

def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.api, repro_torch.launch.solve\n"
        "import repro_torch.core.driver, repro_torch.kernels.ops\n"
        "import repro_torch.kernels.build\n"
        "import repro_torch.core.io, repro_torch.utils.checkpoint\n"
        "import repro_torch.core.solvers.precond\n"
        "import repro_torch.core.solvers.bicgstab\n"
        "import repro_torch.core.solvers.chebyshev\n"
        "import repro_torch.core.solvers.anderson\n"
        "import repro_torch.api.methods\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)


def test_no_source_file_imports_jax_or_repro():
    pattern = re.compile(r"^\s*(import\s+(jax|repro)(\.|\s|$|,)"
                         r"|from\s+(jax|repro)(\.|\s))", re.M)
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    assert len(files) > 10
    for path in files:
        assert not pattern.search(path.read_text()), path
