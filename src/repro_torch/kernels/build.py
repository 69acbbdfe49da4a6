"""Build the CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \\
         -Xptxas -v -shared -Xcompiler -fPIC \\
         -o build/kernels/<name>-<hash>.so <name>.cu

The library lands in ``build/kernels/`` at the repository root, named by a
hash of its source, the headers beside it (``csrc/*.cuh``) and the flags,
so an edited source or header rebuilds and an unchanged one loads at once.
nvcc's output, ptxas's per-kernel registers, spills and advisories among
it, is kept beside it as ``<name>-<hash>.log``
(:func:`build_log`).  :func:`build_all` starts one ``nvcc`` per
source at the same time.  No PyTorch headers are involved, so a build
takes seconds.  Every C entry point returns ``cudaGetLastError()`` after
its launch; :func:`check` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise KernelBuildError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are built "
        "from source at first use and need the CUDA toolkit")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all(names) -> dict[str, Path]:
    """Build every named source that has no current library, all ``nvcc``
    processes at once; returns ``{name: library path}``."""
    targets = {name: _target(name) for name in names}
    todo = [name for name, t in targets.items() if not t.exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmps = {name: targets[name].with_suffix(f".{os.getpid()}.tmp")
            for name in todo}
    procs = {name: subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmps[name]),
         str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in todo}
    try:
        for name, proc in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise KernelBuildError(f"nvcc failed on {name}.cu "
                                       f"(exit {proc.returncode}):\n{out}")
            build_log(targets[name]).write_text(out)
            os.replace(tmps[name], targets[name])   # atomic publish
    finally:
        for name, proc in procs.items():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmps[name].unlink(missing_ok=True)
    return targets


def build_log(target: Path) -> Path:
    """nvcc's output for the library ``target``, written by its build."""
    return target.with_suffix(".log")


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            _LIBS[name] = lib
        return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        raise KernelLaunchError(f"{what}: CUDA error {code}")
