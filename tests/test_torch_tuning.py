"""The port's launch-shape autotuner: its cache lifecycle, held to the
reference's tuner tests (``tests/test_tuning.py``) case by case.

The tuner is plain Python called at dispatch time: the answer must be
stable across processes (persisted JSON), survive a corrupted cache
file, be fully inert under ``-kernel_tune off`` and inside a trace, and
key its entries as the reference does (apart from the backend field,
which names PyTorch and the card).
"""

import json
import os
import threading
import warnings

import pytest
import torch

from repro.kernels import tuning as jtuning
from repro_torch.kernels import tuning


@pytest.fixture(autouse=True)
def _isolated_tuner(tmp_path):
    """Every test runs against its own cache file and leaves the
    process-wide tuner state as it found it."""
    prev_enabled, prev_path = tuning.enabled(), tuning.cache_path()
    tuning.reset(cache_path=str(tmp_path / "autotune.json"))
    yield
    tuning.reset(cache_path=prev_path)
    tuning.configure(enabled=prev_enabled)


# A shape comfortably above MIN_TUNE_ELEMS so tune() actually measures.
BIG = dict(n=1 << 20, m=4, k=4)


def _tune(bench, *, candidates=(8, 16, 32), default=16, **over):
    kw = dict(BIG, **over)
    return tuning.tune("ell_backup_blocked", "torch-cpu", kw["n"], kw["m"],
                       kw["k"], "float32", candidates, default, bench)


def test_round_trip_persists_and_reloads():
    calls = []

    def bench(cand):
        calls.append(cand)
        return {8: 3.0, 16: 1.0, 32: 2.0}[cand]

    assert _tune(bench) == 16
    assert calls, "bench was never invoked"
    assert len(calls) == 3 * tuning._TIMING_REPS
    # same key again: served from memory, no re-measurement
    calls.clear()
    assert _tune(bench) == 16
    assert not calls
    # a fresh process (reset) with the same cache file: served from disk
    path = tuning.cache_path()
    assert os.path.exists(path)
    tuning.reset(cache_path=path)
    assert _tune(bench) == 16
    assert not calls
    blob = json.load(open(path))
    assert blob["version"] == 1
    [entry] = blob["entries"].values()
    assert entry["choice"] == 16
    assert set(entry["timings_s"]) == {"8", "16", "32"}
    # no temporary file is left beside the cache
    assert os.listdir(os.path.dirname(path)) == ["autotune.json"]


def test_n_bucket_shares_entries_across_close_sizes():
    assert tuning.n_bucket(1) == 1
    assert tuning.n_bucket(1000) == 1024
    assert tuning.n_bucket(1024) == 1024
    assert tuning.n_bucket(1025) == 2048
    k1 = tuning.cache_key("k", "torch-cpu", 900_000, 4, 4, "float32")
    k2 = tuning.cache_key("k", "torch-cpu", 1_000_000, 4, 4, "float32")
    assert k1 == k2
    assert k1 != tuning.cache_key("k", "torch-cpu", 2_000_000, 4, 4,
                                  "float32")


@pytest.mark.parametrize("n", [1, 1000, 1024, 1025, 10 ** 6, 3 * 10 ** 7])
def test_cache_key_is_the_reference_layout_but_the_backend(n):
    """Field for field the reference's key, the backend apart: PyTorch's
    names cannot collide with a JAX backend's in a shared cache file."""
    got = tuning.cache_key("ell_backup", "torch-cpu", n, 16, 8, "float64")
    want = jtuning.cache_key("ell_backup", "cpu", n, 16, 8, "float64")
    got_f, want_f = got.split("|"), want.split("|")
    assert len(got_f) == len(want_f) == 6
    assert got_f[0] == want_f[0] and got_f[2:] == want_f[2:]
    assert got_f[1] == "torch-cpu" != want_f[1]
    assert tuning.n_bucket(n) == jtuning.n_bucket(n)
    assert tuning.DEFAULT_CACHE_PATH == jtuning.DEFAULT_CACHE_PATH
    assert (tuning.MIN_TUNE_ELEMS, tuning._TIMING_REPS) == \
        (jtuning.MIN_TUNE_ELEMS, jtuning._TIMING_REPS)


def test_backend_names_the_device_kind():
    import jax

    assert tuning.backend(torch.device("cpu")) == "torch-cpu"
    assert tuning.backend(torch.device("cpu")) != jax.default_backend()


def test_corrupt_cache_file_recovers(tmp_path):
    path = tuning.cache_path()
    with open(path, "w") as f:
        f.write("{not json")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert tuning.lookup("whatever") is None
        assert tuning.lookup("whatever") is None  # warns only once
    assert sum("unreadable" in str(x.message) for x in w) == 1
    # the next successful tune overwrites the corrupt file
    assert _tune(lambda c: float(c)) == 8
    assert json.load(open(path))["entries"]


def test_disabled_returns_default_and_writes_nothing():
    tuning.configure(enabled=False)
    calls = []
    assert _tune(lambda c: calls.append(c) or 1.0, default=42) == 42
    assert not calls
    assert not os.path.exists(tuning.cache_path())


def test_disabled_ignores_a_cached_winner():
    """The port's ``-kernel_tune off`` launches the fixed shapes whatever
    the cache holds (the reference would serve the cached winner)."""
    assert _tune(lambda c: {8: 3.0, 16: 2.0, 32: 1.0}[c]) == 32
    tuning.configure(enabled=False)
    assert _tune(lambda c: 1.0, default=16) == 16
    tuning.configure(enabled=True)
    assert _tune(lambda c: 1.0, default=16) == 32


def test_small_problem_skips_measurement():
    calls = []
    got = _tune(lambda c: calls.append(c) or 1.0, n=128, m=4, k=4,
                default=99)
    assert got == 99 and not calls


def test_tune_inside_trace_falls_back_to_default():
    """When the dispatch is traced by ``torch.compile``, the tuner must not
    time candidates (they would be traced) — it returns the default and
    records nothing, so a later eager call can still tune the shape."""
    calls = []

    def traced(x):
        got = _tune(lambda c: calls.append(c) or 1.0, default=16)
        return x * got

    out = torch.compile(traced, backend="eager")(torch.tensor(2.0))
    assert float(out) == 32.0
    assert not calls
    assert not os.path.exists(tuning.cache_path())
    # eager call afterwards tunes for real
    assert _tune(lambda c: {8: 3.0, 16: 2.0, 32: 1.0}[c]) == 32
    assert os.path.exists(tuning.cache_path())


def test_failing_candidate_is_skipped():
    def bench(cand):
        if cand == 8:
            raise RuntimeError("boom")
        return {16: 2.0, 32: 1.0}[cand]

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert _tune(bench) == 32
    entry = json.load(open(tuning.cache_path()))["entries"]
    assert set(next(iter(entry.values()))["timings_s"]) == {"16", "32"}


def test_threads_tune_a_shape_once():
    """Two threads asking for one shape at once: the lock serialises them,
    so one times the candidates and the other is served its winner."""
    calls, out = [], []
    barrier = threading.Barrier(2)

    def bench(cand):
        calls.append(cand)
        return {8: 3.0, 16: 2.0, 32: 1.0}[cand]

    def worker():
        barrier.wait()
        out.append(_tune(bench))

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert out == [32, 32]
    assert len(calls) == 3 * tuning._TIMING_REPS


def test_measure_times_host_calls_once_after_a_warm_up():
    calls = []
    t = tuning.measure(lambda: calls.append(1) or torch.zeros(3))
    assert t >= 0 and len(calls) == 2


def test_session_options_drive_tuner(tmp_path):
    from repro_torch.api import Session

    path = str(tmp_path / "elsewhere.json")
    with Session({"-kernel_tune": "off", "-kernel_tune_cache": path,
                  "-device": "cpu"}):
        assert tuning.enabled() is False
        assert tuning.cache_path() == path
    with Session({"-kernel_tune": "on", "-device": "cpu"}):
        assert tuning.enabled() is True
