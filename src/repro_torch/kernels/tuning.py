"""Launch-shape autotuner for the kernels, with a persisted JSON cache.

Counterpart of :mod:`repro.kernels.tuning`.  The dispatch layer
(:mod:`repro_torch.kernels.ops`) asks it for a choice among candidates
that leave the result unchanged (a CUDA kernel's CTA size and a fleet's
grid order, or the plain blocked versions' rows a chunk) when it is
called.  On a cache miss the tuner times each candidate and persists the
winner, keyed by

    (kernel, backend, n-bucket, m, K, dtype)

where the n-bucket is the next power of two — close shapes share an entry
so a solver sweeping problem sizes does not retune per size.  The JSON
cache (``{"version": 1, "entries": {key: {"choice", "timings_s"}}}``)
lives at ``~/.cache/madupite/autotune.json`` by default; override with
the ``-kernel_tune_cache`` option or :func:`configure`.  ``-kernel_tune
off`` disables measurement (defaults are used and nothing is written).

A corrupt or unreadable cache file is treated as empty (warned once) and
is overwritten on the next successful tune.

Where the port differs from the reference:

* **Inside a trace.**  The reference falls back to the default inside an
  enclosing ``jit``.  Here a trace is ``torch.compile`` tracing
  (``torch.compiler.is_compiling()``) or a CUDA-graph capture on the
  current stream: timing launches in a capture would record them into
  the graph.  In either case :func:`tune` returns the default and records
  nothing; under ``torch.compile`` it returns before it reads the cache,
  so the traced call holds no file access.
* **Off means today's shapes.**  With tuning off :func:`tune` returns the
  default without reading the cache, so ``-kernel_tune off`` launches
  exactly the fixed shapes, whatever a cache file holds.
* **Measuring synchronises the device.**  :func:`measure` times a CUDA
  call with CUDA events, queued behind a spin on the card so that the
  host's launch time falls outside them, never with a host clock around
  an enqueue.
* **Keys cannot collide with the reference's** in a shared cache file,
  nor across cards: the backend field is ``torch-cpu`` or ``torch-cuda:``
  followed by the card's name (:func:`backend`), and the kernel field
  names the lane form (``ops`` appends ``[fleet]`` for a fleet with its
  own tables a lane, ``[shared]`` for one whose lanes share the tables),
  so a fleet's grid order never serves a single solve.  The rest of the
  key is the reference's, taken on the per-lane shape.
* **Writes are safe across processes and threads.**  The temporary file
  has a per-process, per-thread name before the ``os.replace`` (torchrun
  ranks tune at once), and a lock guards the in-memory state and a tune
  (the solve server's scheduler thread launches kernels too).
"""

from __future__ import annotations

import functools
import json
import os
import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import torch

DEFAULT_CACHE_PATH = os.path.join(
    os.path.expanduser("~"), ".cache", "madupite", "autotune.json")

_CACHE_VERSION = 1

# Below this element count (n * m * K) tuning costs more than it can ever
# save; callers get the default candidate and nothing is cached.
MIN_TUNE_ELEMS = 1 << 21

_TIMING_REPS = 3

# device cycles of the spin queued ahead of a timed call (about 0.5 ms on
# the H100): the launches are enqueued while it runs
SPIN_CYCLES = 1_000_000


@dataclass
class _State:
    enabled: bool = True
    cache_path: str = DEFAULT_CACHE_PATH
    entries: dict[str, dict[str, Any]] = field(default_factory=dict)
    loaded_from: str | None = None
    warned_corrupt: bool = False
    tuned_seconds: float = 0.0   # host time spent timing candidates


_state = _State()
_lock = threading.RLock()


def configure(*, enabled: bool | None = None,
              cache_path: str | None = None) -> None:
    """Set tuner behaviour (called by Session from the options DB)."""
    with _lock:
        if enabled is not None:
            _state.enabled = bool(enabled)
        if cache_path is not None and cache_path != _state.cache_path:
            _state.cache_path = cache_path
            _state.entries = {}
            _state.loaded_from = None
            _state.warned_corrupt = False


def reset(*, cache_path: str | None = None) -> None:
    """Forget all in-memory state (tests)."""
    global _state
    with _lock:
        _state = _State()
        if cache_path is not None:
            _state.cache_path = cache_path


def enabled() -> bool:
    return _state.enabled


def cache_path() -> str:
    return _state.cache_path


def tuned_seconds() -> float:
    """Host seconds this process has spent timing candidates."""
    return _state.tuned_seconds


def n_bucket(n: int) -> int:
    """Next power of two >= n: close sizes share a tuning entry."""
    return 1 << max(0, int(n - 1).bit_length())


def cache_key(kernel: str, backend: str, n: int, m: int, k: int,
              dtype: Any) -> str:
    return f"{kernel}|{backend}|n{n_bucket(n)}|m{m}|k{k}|{dtype}"


@functools.lru_cache(maxsize=None)
def _cuda_backend(index: int) -> str:
    return f"torch-cuda:{torch.cuda.get_device_name(index)}"


def backend(device: torch.device) -> str:
    """The key's backend field for tensors on ``device``."""
    if device.type == "cuda":
        return _cuda_backend(device.index if device.index is not None
                             else torch.cuda.current_device())
    return f"torch-{device.type}"


def _capturing() -> bool:
    """A CUDA-graph capture on the current stream."""
    return torch.cuda.is_available() \
        and torch.cuda.is_current_stream_capturing()


def _load() -> None:
    if _state.loaded_from == _state.cache_path:
        return
    _state.loaded_from = _state.cache_path
    path = _state.cache_path
    if not os.path.exists(path):
        return
    try:
        with open(path) as f:
            blob = json.load(f)
        entries = blob["entries"]
        if not isinstance(entries, dict):
            raise ValueError("entries is not a dict")
    except (OSError, ValueError, KeyError, TypeError,
            json.JSONDecodeError) as e:
        if not _state.warned_corrupt:
            warnings.warn(
                f"madupite autotune cache {path!r} is unreadable ({e}); "
                "starting from an empty cache", stacklevel=3)
            _state.warned_corrupt = True
        return
    # merge under whatever was recorded in-memory this process
    for key, entry in entries.items():
        _state.entries.setdefault(key, entry)


def _persist() -> None:
    path = _state.cache_path
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            json.dump({"version": _CACHE_VERSION, "entries": _state.entries},
                      f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError as e:
        warnings.warn(f"could not persist autotune cache to {path!r}: {e}",
                      stacklevel=3)
        try:
            os.unlink(tmp)
        except OSError:
            pass


def lookup(key: str) -> dict[str, Any] | None:
    with _lock:
        _load()
        return _state.entries.get(key)


def record(key: str, entry: dict[str, Any]) -> None:
    with _lock:
        _load()
        _state.entries[key] = entry
        _persist()


def tune(kernel: str, backend: str, n: int, m: int, k: int, dtype: Any,
         candidates: Sequence[Any], default: Any,
         bench: Callable[[Any], float] | None,
         ) -> Any:
    """Resolve the launch choice for one kernel shape.

    With tuning off, inside a trace (module docstring) or below
    :data:`MIN_TUNE_ELEMS`, returns ``default`` (a capture is still served
    a cached winner).  Otherwise returns the cached winner if present; or,
    given a ``bench`` callable, times each candidate (``bench(candidate)
    -> seconds``, the least of :data:`_TIMING_REPS` calls), records the
    winner and returns it.  A candidate whose bench raises is skipped with
    a warning.
    """
    if torch.compiler.is_compiling():
        return default
    if not _state.enabled or n * m * k < MIN_TUNE_ELEMS:
        return default
    key = cache_key(kernel, backend, n, m, k, dtype)
    with _lock:
        hit = lookup(key)
        if hit is not None:
            return hit["choice"]
        if bench is None or len(candidates) <= 1 or _capturing():
            return default
        t_start = time.perf_counter()
        timings: dict[str, float] = {}
        best, best_t = default, float("inf")
        for cand in candidates:
            try:
                t = min(bench(cand) for _ in range(_TIMING_REPS))
            except Exception as e:  # noqa: BLE001 - a failing candidate is skipped
                warnings.warn(f"autotune candidate {cand!r} failed: {e}",
                              stacklevel=2)
                continue
            timings[str(cand)] = t
            if t < best_t:
                best, best_t = cand, t
        if timings:
            record(key, {"choice": best, "timings_s": timings})
        _state.tuned_seconds += time.perf_counter() - t_start
        return best


def _cuda_device(out) -> torch.device | None:
    """The CUDA device of the first CUDA tensor in ``out`` (a tensor or a
    tuple / list of them), or ``None``."""
    items = out if isinstance(out, (tuple, list)) else (out,)
    for t in items:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            return t.device
    return None


def measure(fn: Callable[[], Any]) -> float:
    """One timed run of ``fn`` (seconds) after one untimed run, with the
    device synchronised: CUDA events around it on the card (queued behind
    a spin, so the host's launch time falls outside them), the host clock
    otherwise."""
    out = fn()
    dev = _cuda_device(out)
    if dev is None:
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    with torch.cuda.device(dev):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
