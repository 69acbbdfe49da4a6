"""The readers of the program's own spans and counters
(``host_reads_per_instance``, ``surface_ms_per_call``,
``arnoldi_roofline_pct``): a traced run on the CPU at a small size reads
the first two and, with no CUDA events to time, not the third; and each
reads nothing from a program that lacks ``repro_torch.utils.trace``."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from bench import manifest as mf  # noqa: E402
from bench.devtrace import TraceSummary  # noqa: E402
from bench.generator import Traffic  # noqa: E402
from bench.harness import CallRecord, LaneRecord, RunRecord, run_cell  # noqa: E402,E501

NEW = ("host_reads_per_instance", "surface_ms_per_call",
       "arnoldi_roofline_pct")
CELLS = ["garnet1e6.gmres.fleet8", "garnet1e7.gmres.single",
         "garnet1e6.mpi.fleet8"]


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_programs_counters(cell):
    batch = 1 if cell.endswith("single") else 2
    # few outer steps: every operation is a host record under the CPU
    # profile
    out = run_cell(cell, 2**35 + 7, 0.05, True, device="cpu",
                   config_overrides={"n": 300, "gamma": 0.9},
                   traffic_overrides={"batch": batch, "traced_calls": 1})
    assert out["correct"], out["checks"]
    metrics = out["metrics"]
    reads = metrics["host_reads_per_instance"]["value"]
    # at least the flags of every step and eight reads of each result
    assert reads >= 8 + metrics["outer_per_instance"]["value"]
    assert metrics["host_reads_per_instance"]["unit"] == "count"
    assert metrics["surface_ms_per_call"]["value"] > 0
    assert "arnoldi_roofline_pct" not in metrics


def _run(trace=True) -> RunRecord:
    man = mf.load()
    traffic = Traffic.from_dict(mf.traffic("gmres_fleet8"))
    cfg = mf.config(man, "garnet-ell-1e6")
    lanes = [LaneRecord(6, 66, [11] * 6, True)] * traffic.batch
    return RunRecord(
        cfg=cfg, traffic=traffic,
        options={**cfg["options"], **traffic.options}, setup_s=1.0,
        window_s=1.0, calls=[CallRecord(0, 0, 0.0, 1.0, lanes)],
        peak_window_bytes=None,
        trace=TraceSummary(1.0, 0.5, {}, {}) if trace else None)


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_nothing_without_the_module(name, monkeypatch):
    import repro_torch.utils
    monkeypatch.delattr(repro_torch.utils, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.utils.trace", None)
    assert mf.reader(name)(_run()) is None


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_nothing_without_records(name):
    from repro_torch.utils import trace
    trace.clear()
    assert mf.reader(name)(_run()) is None
    assert mf.reader(name)(_run(trace=False)) is None
