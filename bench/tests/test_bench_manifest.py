"""BENCHMARK.json against its format rules, and every name it
holds against the file it leads to."""

import json
import math
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from bench import manifest as mf  # noqa: E402
from bench.generator import Traffic  # noqa: E402

MAN = mf.load()
CELLS = [w["name"] for w in MAN["workloads"]]
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_command_and_paths():
    assert MAN["command"] == ["python3", "bench/run.py"]
    assert MAN["paths"] == ["bench"]
    assert all((ROOT / p).is_dir() for p in MAN["paths"])
    assert (ROOT / MAN["command"][1]).is_file()


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names(entry):
    assert mf.NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert mf.NAME.match(entry[key])
    if "unit" in entry:
        assert mf.UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]


def test_names_unique():
    for group in (MAN["configs"], MAN["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda e: e["name"])
def test_config_files(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"].startswith("bench/configs/")
    cfg = mf.config(MAN, entry["name"])
    assert cfg["name"] == entry["name"]
    assert cfg["reduced"] == entry["reduced"] == []
    assert (mf.BENCH / "inputs" / f"{cfg['inputs']}.py").is_file()
    assert (mf.BENCH / "reference" / f"{cfg['reference']}.py").is_file()
    assert cfg["limits"]["residual"] == cfg["options"]["-atol"]
    assert any(w["config"] == entry["name"] for w in MAN["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files(cell):
    spec = mf.cell(MAN, cell)
    assert set(spec) == {"name", "config", "traffic", "chips", "why"}
    assert spec["chips"] in (1, 4)
    mf.config(MAN, spec["config"])
    t = Traffic.from_dict(mf.traffic(spec["traffic"]))
    assert sorted(t.order(2**40)) == list(range(t.pool))


@pytest.mark.parametrize("cell", CELLS)
def test_every_seed_makes_the_same_problems(cell):
    """The seed orders the traffic's pool and changes nothing else: over
    whole cycles every seed makes each problem equally often."""
    t = Traffic.from_dict(mf.traffic(mf.cell(MAN, cell)["traffic"]))
    seeds = [0, 1, 2**31 + 11, 2**40 + 3]
    runs = [[t.problem(s, i) for i in range(3 * t.pool)] for s in seeds]
    for got in runs:
        assert sorted(got) == sorted(list(range(t.pool)) * 3)
    assert len({tuple(r) for r in runs}) > 1 or t.pool == 1
    assert t.problem(seeds[0], -1) == -1


@pytest.mark.parametrize("cell", CELLS)
def test_cell_metrics_have_readers(cell):
    e2e = mf.metrics_of(MAN, cell, "end_to_end")
    per_layer = mf.metrics_of(MAN, cell, "per_layer")
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert per_layer
    for m in e2e + per_layer:
        assert callable(mf.reader(m["name"]))
    for m in per_layer:
        assert m["moves"] in names


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entries(metric):
    allowed = {"name", "unit", "better", "source"}
    if "bound" in metric:
        allowed |= {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        allowed |= {"layer", "moves"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
    assert set(metric) - {"workloads"} == allowed
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    if metric["name"].endswith("_roofline_pct") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_one_layer_name_per_layer():
    by_layer = {}
    for m in MAN["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert 1 <= MAN["run_seconds"] <= 51 and total <= 43200


def test_four_chip_cells_at_most_a_quarter():
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, math.floor(len(CELLS) / 4))


def test_traffic_files_are_data():
    for path in (mf.BENCH / "traffic").iterdir():
        assert path.suffix == ".json"
        json.loads(path.read_text())
