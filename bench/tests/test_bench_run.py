"""``bench/run.py`` as a process: it refuses to run without a card, and
nothing it loads is JAX or the JAX package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.pop("JAX_PLATFORMS", None)
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_no_card_exits_nonzero_without_a_result():
    if torch.cuda.is_available():
        # on a machine with a card this is the run itself, not a refusal
        return
    p = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "garnet1e6.gmres.fleet8", "--seed", "4294967311", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=_env(), capture_output=True,
        text=True, timeout=120)
    assert p.returncode != 0
    assert "no CUDA device" in p.stderr
    assert p.stdout.strip() == ""


def test_unknown_cell_exits_nonzero():
    p = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "no.such.cell",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        env=_env(), capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_run_loads_no_jax_and_no_jax_package():
    """A whole run on the CPU at a small size, traced, in a fresh process:
    the top-level names of every loaded module, compared whole."""
    script = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        "from bench.harness import run_cell, forbidden_modules\n"
        "out = run_cell('garnet1e6.gmres.fleet8', 2**35 + 1, 0.1, True,\n"
        "               device='cpu', config_overrides={'n': 300},\n"
        "               traffic_overrides={'batch': 2,\n"
        "                                  'traced_calls': 1})\n"
        "assert out['correct'], out\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    p = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    loaded = set(__import__("json").loads(p.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and "bench" in loaded
    assert not loaded & FORBIDDEN


def test_sources_import_no_jax_and_read_no_jax_harness():
    for path in (ROOT / "bench").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)
