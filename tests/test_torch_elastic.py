"""Elastic restarts of the torch port: ``repro_torch.launch.elastic`` on
gloo ranks.

Each case runs the script as a user would: it launches a ``torchrun``
world of 4 gloo ranks that solves for 3 outer steps with a checkpoint
after each, resumes on a smaller world (2 ranks, or no mesh in the
script's own process), and holds the result to the one-device solve
(``|v - v_ref|_inf < 1e-9``, the reference's ``launch/elastic.py``
check).  The single garnet has ``n = 501``, which pads to 504 states on
4 shards and to 502 on 2, so the checkpoint must hold the unpadded ``n``.
The fleet cases checkpoint a seed ensemble of 5 garnets on a 4-way fleet
axis (3 dummy lanes) and resume it on a 2-way one (1 dummy lane) and on
no mesh, as ``tests/test_fleet.py`` resumes the reference's.  The
launcher runs on the card unless given ``--device cpu``, which every
launch here passes.
"""

import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest
import torch

SRC = Path(__file__).resolve().parent.parent / "src"
TIMEOUT = 240           # seconds, each launch


def _elastic(*args) -> str:
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    for key in ("WORLD_SIZE", "MADUPITE_OPTIONS"):
        env.pop(key, None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.elastic", *args,
         "--device", "cpu", "--timeout", str(TIMEOUT)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=TIMEOUT + 30)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise AssertionError(f"elastic {args} timed out:\n{err[-3000:]}")
    assert proc.returncode == 0, out[-2000:] + "\n" + err[-3000:]
    return out


def test_elastic_restart_world4_to_world2():
    out = _elastic("--n", "501", "--worlds", "4", "2")
    assert "[elastic] phase 1 on 4 ranks: converged=False outer=3" in out
    assert "(simulated failure)" in out
    assert "[elastic] phase 2 on 2 ranks: converged=True" in out
    assert "elastic restart preserved the solve exactly" in out


@pytest.mark.parametrize("second", ["2", "0"])
def test_fleet_checkpoint_resumes_on_a_smaller_fleet_axis(second):
    """A 4-way fleet axis checkpointed after 3 outer steps resumes on a
    2-way fleet axis and on no mesh, every lane within 1e-9 of the
    uninterrupted one-device fleet."""
    out = _elastic("--n", "301", "--batch", "5", "--worlds", "4", second)
    first = [ln for ln in out.splitlines()
             if ln.startswith("[elastic] phase 1 on 4 ranks")]
    assert len(first) == 1 and first[0].count("converged=False") == 5
    where = "on 2 ranks" if second == "2" else "on one device, no mesh"
    resumed = [ln for ln in out.splitlines()
               if ln.startswith(f"[elastic] phase 2 {where}")]
    assert len(resumed) == 1 and resumed[0].count("converged=True") == 5
    assert "elastic restart preserved the solve exactly" in out


def test_default_device_is_the_card_and_never_falls_back(monkeypatch):
    """Without ``--device`` the launcher asks for ``cuda``: with no GPU
    visible it raises ``resolve_device``'s error before it starts any
    world, rather than run on the host."""
    sys.path.insert(0, str(SRC))
    from repro_torch.launch import elastic

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    started = []
    monkeypatch.setattr(elastic, "_world",
                        lambda *a, **k: started.append(a) or "")
    monkeypatch.setattr(elastic, "_solve",
                        lambda *a, **k: started.append(a) or [])
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        elastic.main(["--n", "101"])
    assert not started
