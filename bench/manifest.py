"""``BENCHMARK.json`` and the files its names lead to.

A cell (``workloads`` entry) names a configuration and a traffic mix.  The
configuration's JSON file is the manifest's ``file``; the traffic mix is
``bench/traffic/<traffic>.json``; a metric's reader is
``bench/metrics/<metric>.py``.  The inputs and the plain reference a
configuration uses are named in its file (``inputs``, ``reference``) and
live in ``bench/inputs/<name>.py`` and ``bench/reference/<name>.py``.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
MANIFEST = ROOT / "BENCHMARK.json"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    known = ", ".join(w["name"] for w in manifest["workloads"])
    raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: {known})")


def config(manifest: dict, name: str) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            with open(ROOT / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    with open(BENCH / "traffic" / f"{name}.json") as f:
        return json.load(f)


def metrics_of(manifest: dict, cell_name: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    without a ``workloads`` key, and those whose key names the cell."""
    return [m for m in manifest[kind]
            if cell_name in m.get("workloads", [cell_name])]


def module(kind: str, name: str):
    """``bench/<kind>/<name>.py`` as a fresh module object (names may hold
    dots and dashes, so it is loaded from its path, not imported)."""
    path = BENCH / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"{kind} {name!r} has no file {path}")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """The ``read(run) -> float | None`` of metric ``name``."""
    return module("metrics", name).read
