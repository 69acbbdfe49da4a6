"""The correctness check has to fail a broken program: the control (the
program's float32 value path, one precision below the configuration's
float64) and each fault a cell can have, planted in the program under a
whole run.  On the CPU at a small size; the harness's look for a card is
what ``bench/run.py`` adds and is skipped here."""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from bench.harness import run_cell  # noqa: E402

FLEET = "garnet1e6.gmres.fleet8"
CELLS = [FLEET, "garnet1e7.gmres.single", "garnet1e6.mpi.fleet8"]


def small_run(cell, **kw):
    batch = 1 if cell.endswith("single") else 4
    return run_cell(cell, 2**33 + 5, 0.05, False, device="cpu",
                    config_overrides={"n": 300},
                    traffic_overrides={"batch": batch}, **kw)


@pytest.fixture(autouse=True)
def one_thread():
    """Small CPU solves run fastest, and steadiest beside other test
    workers, on one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_is_correct(cell):
    out = small_run(cell)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_float32_fails(cell):
    out = small_run(cell, dtype="float32", extra_options={"-max_outer": 20})
    assert not out["correct"]
    assert out["checks"]["residual_max"]["value"] > \
        out["checks"]["residual_max"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_step_that_returns_its_state_unchanged_fails(cell, monkeypatch):
    from repro_torch.core import ipi

    def unchanged(mdp, state, opts, axes, gamma_t, act, act_h):
        import torch
        inner = torch.zeros(mdp.batch, dtype=torch.int32,
                            device=state.v.device)
        return (state.v, state.tv, state.pi, state.res, state.span, inner,
                state.win)

    monkeypatch.setattr(ipi, "_outer_core", unchanged)
    out = small_run(cell, extra_options={"-max_outer": 30})
    assert not out["correct"] and out["failed"] > 0


@pytest.mark.parametrize("how", ["left_out", "copied"])
def test_half_the_fleet_left_out_fails(how, monkeypatch):
    from repro_torch.api import Session

    real = Session.solve_fleet

    def half(self, mdps, **kw):
        got = real(self, list(mdps)[:len(mdps) // 2], **kw)
        return got if how == "left_out" else got + got

    monkeypatch.setattr(Session, "solve_fleet", half)
    out = small_run(FLEET)
    assert not out["correct"] and out["failed"] >= 2
    if how == "left_out":
        assert out["checks"]["missing"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("field", ["v", "policy"])
def test_answer_altered_where_produced_fails(cell, field, monkeypatch):
    from repro_torch.core import driver

    real = driver._result

    def altered(state, b, *a, **kw):
        r = real(state, b, *a, **kw)
        if b != 0:
            return r
        if field == "v":
            v = r.v.copy()
            v[len(v) // 2] += 1e-6
            return dataclasses.replace(r, v=v)
        pi = r.policy.copy()
        pi[len(pi) // 2] = (pi[len(pi) // 2] + 1) % 6
        return dataclasses.replace(r, policy=pi)

    monkeypatch.setattr(driver, "_result", altered)
    out = small_run(cell)
    assert not out["correct"] and out["failed"] > 0


def test_one_late_answer_altered_fails(monkeypatch):
    """Every answer of the window is checked, not a sample: one value
    altered in the last lane of the window's second call is enough."""
    from repro_torch.core import driver

    real = driver._result
    made = []

    def altered(state, b, *a, **kw):
        r = real(state, b, *a, **kw)
        made.append(b)
        if len(made) != 6:
            return r
        v = r.v.copy()
        v[0] += 1e-6
        return dataclasses.replace(r, v=v)

    monkeypatch.setattr(driver, "_result", altered)
    out = run_cell(FLEET, 2**33 + 5, 1.0, False, device="cpu",
                   config_overrides={"n": 300},
                   traffic_overrides={"batch": 2})
    assert len(made) >= 6, "the window made too few calls to reach it"
    assert not out["correct"] and out["failed"] == 1
