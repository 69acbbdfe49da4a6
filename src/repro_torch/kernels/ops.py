"""Kernel dispatch: the implementation by option and device, the launch
shapes by the tuner.

Counterpart of :mod:`repro.kernels.ops`.  Every entry point takes
``impl=`` (``-kernel_impl``, :class:`repro_torch.core.ipi.IPIOptions`
``impl``), which picks the implementation:

* ``"auto"`` (the default) — CUDA tensors launch the hand-written kernels
  (:mod:`.bellman_ell`, :mod:`.spmv_ell`, :mod:`.dense_backup`,
  :mod:`.flash_attention`) at tuned launch shapes; CPU tensors run the
  plain PyTorch versions (:mod:`.ref`).
* ``"torch"`` (the reference's ``"xla"``) — the plain versions, wherever
  the tensors are: on the card only as the caller's explicit choice.
* ``"blocked"`` — the plain blocked versions (``ref.*_blocked``, bit for
  bit the plain ones), their rows a chunk tuned; the dense backup has no
  blocked form and runs its plain version, as in the reference.
* ``"cuda"`` (the reference's ``"pallas"``) — the hand-written kernels;
  on CPU tensors it raises.

The reference's ``"pallas_interpret"`` raises: the port has no
interpreter (``"torch"`` runs the plain versions).  Where the reference's
``auto`` is its blocked version on a host, the port's ``auto`` on the CPU
stays the plain version: tuning, on by default, would otherwise make CPU
runs time candidates and write the cache.

Nothing falls back: ``cuda`` on CPU tensors raises, and a kernel that
fails to build or launch raises.

**Launch shapes.**  The hand kernels' CTA size (128, 256 or 512 threads
for the ELL kernels, 4, 8 or 16 warps for the dense one) and, for a fleet
of ``B > 1`` lanes, the ELL kernels' grid order are resolved at each call
as the reference resolves its tiles: explicit keyword, then the tuner's
cache (:mod:`.tuning`), then the default, which is the kernels' fixed
shape before the tuner (256 threads, 8 warps, ``lanes.LANE_ORDER``).
None of these choices changes a bit of a result.  On a cache miss the
tuner times the candidates on the call's own operands (the kernels are
pure; the outputs are dropped): those launches count under each
wrapper's ``tune_launches``, never under ``launches``.  The key is the
per-lane shape, the kernel field naming the lane form (``ell_backup``,
``ell_backup[fleet]`` for per-lane tables, ``ell_backup[shared]`` for a
matrix-free fleet's shared chunk), the dtype the accumulation dtype.
``ell_qvalues`` runs the SpMV kernel over the ``(n*m, K)`` rows and takes
``ell_matvec``'s shape for them.  ``flash_attention`` is not tuned, as in
the reference.  ``blocked`` tunes ``block_rows`` by the reference's
synthetic bench (:data:`BLOCK_ROWS_CANDIDATES`).

Every MDP entry point also takes a fleet: a leading lane axis ``B`` on
``val`` / ``cost`` / ``p``, ``idx`` ``(B, ...)`` or shared, ``v`` / ``x``
``(B, n)`` or shared ``(n,)``, ``gamma`` a float or a ``(B,)`` tensor.
On the card that is one launch of the kernel's lane axis, never a loop
over lanes.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import bellman_ell, dense_backup as dense_kernel
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.kernels import lanes, ref, spmv_ell, tuning

# kernel name -> (wrapper module, its launch counter)
KERNELS = {"ell_backup": (bellman_ell, "launches"),
           "ell_matvec": (spmv_ell, "launches"),
           "dense_backup": (dense_kernel, "launches"),
           "ell_qvalues": (bellman_ell, "qvalues_launches"),
           "flash_attention": (flash_kernel, "launches")}

# the wrappers whose launches the tuner times
TUNED = {"ell_backup": bellman_ell, "ell_matvec": spmv_ell,
         "dense_backup": dense_kernel}

IMPLS = ("auto", "torch", "blocked", "cuda")
# the reference's names, accepted so that its options files run here
ALIASES = {"xla": "torch", "pallas": "cuda"}

# Scan-chunk candidates for the blocked implementation (rows per chunk).
BLOCK_ROWS_CANDIDATES = (31_250, 62_500, 125_000, 250_000, 500_000)

# Cap on synthetic tuning data (elements), so tuning a huge solve does not
# allocate a huge benchmark table; block_rows choices transfer downward.
_MAX_BENCH_ELEMS = 1 << 26

# the launch shapes resolved in this process, by tuning key
_shapes: dict[str, object] = {}


def check_impl(impl: str | None) -> str | None:
    """The error for a ``-kernel_impl`` value, or ``None`` if it is one."""
    if impl is None or impl in IMPLS or impl in ALIASES:
        return None
    if impl == "pallas_interpret":
        return ("kernel_impl 'pallas_interpret' runs the JAX package's "
                "Pallas interpreter; the port has no interpreter: use "
                "'torch' for the plain PyTorch versions")
    return (f"kernel_impl must be one of {IMPLS} (or the JAX package's "
            f"{tuple(ALIASES)}), got {impl!r}")


def resolve(impl: str | None, device: torch.device) -> str:
    """The implementation that runs for ``impl`` on tensors on ``device``:
    ``"cuda"``, ``"torch"`` or ``"blocked"``."""
    impl = impl or "auto"
    err = check_impl(impl)
    if err:
        raise ValueError(err)
    impl = ALIASES.get(impl, impl)
    if impl == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if impl == "cuda" and device.type != "cuda":
        raise ValueError(f"kernel_impl 'cuda' launches the hand-written "
                         f"kernels, which take CUDA tensors; got tensors "
                         f"on {device}")
    return impl


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _form(batch: int | None, shared: bool = False) -> str:
    """The key's lane form: unbatched (a fleet of one included), per-lane
    tables, or tables shared by every lane."""
    if batch is None or batch == 1:
        return ""
    return "[shared]" if shared else "[fleet]"


def _tune(kernel: str, device, n: int, m: int, k: int, dtype,
          candidates, default, bench):
    backend, name = tuning.backend(device), _dtype_name(dtype)
    choice = tuning.tune(kernel, backend, n, m, k, name, candidates,
                         default, bench)
    _shapes[tuning.cache_key(kernel, backend, n, m, k, name)] = choice
    return choice


def _ell_launch(kernel: str, form: str, device, n: int, m: int, k: int,
                dtype, launch) -> tuple[int, str | None]:
    """The ELL kernels' ``(threads, lane_order)``: unbatched, the CTA size
    alone (candidates ints); a fleet, the CTA size and the grid order
    (candidates ``"threads/order"``).  ``launch(threads, lane_order)``
    runs the kernel once as a tune launch."""
    if form:
        cands = tuple(f"{t}/{o}" for t in lanes.THREADS
                      for o in lanes.LANE_ORDERS)
        default = f"{lanes.DEFAULT_THREADS}/{lanes.LANE_ORDER}"
    else:
        cands, default = lanes.THREADS, lanes.DEFAULT_THREADS
    choice = _tune(kernel + form, device, n, m, k, dtype, cands, default,
                   lambda c: tuning.measure(lambda: launch(*_parse(c))))
    return _parse(choice)


def _parse(choice) -> tuple[int, str | None]:
    if isinstance(choice, str):
        t, order = choice.split("/")
        return int(t), order
    return int(choice), None


def launch_shapes() -> dict[str, object]:
    """The launch shapes (and blocked rows a chunk) resolved in this
    process so far, by tuning key."""
    return dict(_shapes)


# ---------------------------------------------------------------------------
# The blocked versions' rows a chunk
# ---------------------------------------------------------------------------


def _bench_shape(n: int, m: int, k: int) -> int:
    """Benchmark row count: the real n, capped so synthetic data stays
    small."""
    per_row = max(1, m * k)
    return max(1, min(n, _MAX_BENCH_ELEMS // per_row))


def _block_rows_default(n: int) -> int:
    return min(ref.DEFAULT_BLOCK_ROWS, max(1, n))


def _tuned_block_rows(kernel: str, n: int, m: int, k: int, n_cols: int,
                      dtype, device, bench_builder) -> int:
    """Resolve the blocked version's rows a chunk: autotuner cache, else a
    timed search over BLOCK_ROWS_CANDIDATES on synthetic data, else the
    default."""
    n_bench = _bench_shape(n, m, k)
    cands = sorted({c for c in BLOCK_ROWS_CANDIDATES if c <= n_bench}
                   | {_block_rows_default(n_bench)})
    bench = bench_builder(n_bench, m, k, min(n_cols, n_bench), dtype,
                          device)
    choice = _tune(kernel, device, n, m, k, dtype, cands,
                   _block_rows_default(n), bench)
    return int(min(choice, n)) if n else 1


def _synthetic(shape_fn):
    """A bench over synthetic operands built at its first call (a cache
    hit builds none)."""
    data = []

    def bench(block_rows):
        if not data:
            data.append(shape_fn())
        fn, args = data[0]
        return tuning.measure(lambda: fn(*args, block_rows=int(block_rows)))

    return bench


def _make_backup_bench(n, m, k, n_cols, dtype, device):
    def build():
        rng = np.random.default_rng(0)
        idx = torch.from_numpy(rng.integers(0, n_cols, (n, m, k))
                               .astype(np.int32)).to(device)
        val = torch.from_numpy(rng.random((n, m, k), np.float32)).to(device)
        cost = torch.from_numpy(rng.random((n, m), np.float32)).to(device)
        v = torch.from_numpy(rng.random(n_cols)).to(device, dtype)
        return ref.ell_backup_blocked, (idx, val, cost, 0.99, v)

    return _synthetic(build)


def _make_matvec_bench(n, _m, k, n_cols, dtype, device):
    def build():
        rng = np.random.default_rng(0)
        idx = torch.from_numpy(rng.integers(0, n_cols, (n, k))
                               .astype(np.int32)).to(device)
        val = torch.from_numpy(rng.random((n, k), np.float32)).to(device)
        x = torch.from_numpy(rng.random(n_cols)).to(device, dtype)
        return ref.ell_matvec_blocked, (idx, val, x)

    return _synthetic(build)


def backup_block_rows(n: int, m: int, k: int, n_cols: int, dtype,
                      device=torch.device("cpu")) -> int:
    """Rows a chunk for the blocked fused backup (and Q table)."""
    return _tuned_block_rows("ell_backup_blocked", n, m, k, n_cols, dtype,
                             device, _make_backup_bench)


def matvec_block_rows(n: int, k: int, n_cols: int, dtype,
                      device=torch.device("cpu")) -> int:
    """Rows a chunk for the blocked policy SpMV."""
    return _tuned_block_rows("ell_matvec_blocked", n, 1, k, n_cols, dtype,
                             device, _make_matvec_bench)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def ell_backup(idx: torch.Tensor, val: torch.Tensor, cost: torch.Tensor,
               gamma, v: torch.Tensor, *, impl: str | None = None,
               threads: int | None = None, lane_order: str | None = None,
               block_rows: int | None = None) \
        -> tuple[torch.Tensor, torch.Tensor]:
    """Fused Bellman backup on an ELL block -> (v_new ([B,] n), argmin
    ([B,] n) int32)."""
    impl = resolve(impl, v.device)
    if impl == "torch":
        return ref.ell_backup(idx, val, cost, gamma, v)
    n, m, k = val.shape[-3:]
    if impl == "blocked":
        bn = block_rows or backup_block_rows(n, m, k, v.shape[-1], v.dtype,
                                             v.device)
        return ref.ell_backup_blocked(idx, val, cost, gamma, v,
                                      block_rows=bn)
    if threads is None and lane_order is None:
        shared = val.dim() == 3 and v.dim() == 2
        batch = val.shape[0] if val.dim() == 4 else \
            (v.shape[0] if shared else None)
        threads, lane_order = _ell_launch(
            "ell_backup", _form(batch, shared), v.device, n, m, k, v.dtype,
            lambda t, o: bellman_ell.ell_backup(
                idx, val, cost, gamma, v, threads=t, lane_order=o,
                tuning=True))
    return bellman_ell.ell_backup(idx, val, cost, gamma, v, threads=threads,
                                  lane_order=lane_order)


def ell_backup_chunk(idx: torch.Tensor, val: torch.Tensor,
                     cost: torch.Tensor, gamma, v: torch.Tensor, *,
                     impl: str | None = None) \
        -> tuple[torch.Tensor, torch.Tensor]:
    """The fused backup on ONE rebuilt row chunk ``(bn, m, K)`` against the
    whole value window ``v`` — the matrix-free operator's tile body
    (:mod:`repro_torch.kernels.matrix_free`), whose caller owns the row
    tiling.  It is :func:`ell_backup` (the hand-written kernel at a tuned
    shape on the card, the plain version on the CPU), except that
    ``blocked`` runs the plain version on the chunk unblocked, as the
    reference's does; the math is row-independent, so any chunking gives
    the bits of one call over every row.  A matrix-free fleet passes the
    chunk once for all its lanes: tables unbatched, ``v`` ``(B, n_v)``,
    ``gamma`` a float or ``(B,)``."""
    if resolve(impl, v.device) == "blocked":
        return ref.ell_backup(idx, val, cost, gamma, v)
    return ell_backup(idx, val, cost, gamma, v, impl=impl)


def ell_qvalues(idx: torch.Tensor, val: torch.Tensor, cost: torch.Tensor,
                gamma, v: torch.Tensor, *, impl: str | None = None,
                threads: int | None = None, lane_order: str | None = None,
                block_rows: int | None = None) -> torch.Tensor:
    """Q table ``cost + gamma * P v`` ([B,] n, m) on an ELL block."""
    impl = resolve(impl, v.device)
    if impl == "torch":
        return ref.ell_qvalues(idx, val, cost, gamma, v)
    n, m, k = val.shape[-3:]
    if impl == "blocked":
        bn = block_rows or backup_block_rows(n, m, k, v.shape[-1], v.dtype,
                                             v.device)
        return ref.ell_qvalues_blocked(idx, val, cost, gamma, v,
                                       block_rows=bn)
    if threads is None and lane_order is None:
        rows = lambda t: t.view(*t.shape[:-3], n * m, k)
        batch = val.shape[0] if val.dim() == 4 else None
        threads, lane_order = _ell_launch(
            "ell_matvec", _form(batch), v.device, n * m, 1, k, v.dtype,
            lambda t, o: spmv_ell.ell_matvec(
                rows(idx), rows(val), v, threads=t, lane_order=o,
                tuning=True))
    return bellman_ell.ell_qvalues(idx, val, cost, gamma, v,
                                   threads=threads, lane_order=lane_order)


def ell_matvec(idx: torch.Tensor, val: torch.Tensor, x: torch.Tensor, *,
               impl: str | None = None, threads: int | None = None,
               lane_order: str | None = None,
               block_rows: int | None = None) -> torch.Tensor:
    """Policy-restricted SpMV y = P_pi @ x on ([B,] n, K) ELL rows."""
    impl = resolve(impl, x.device)
    if impl == "torch":
        return ref.ell_matvec(idx, val, x)
    n, k = val.shape[-2:]
    if impl == "blocked":
        bn = block_rows or matvec_block_rows(n, k, x.shape[-1], x.dtype,
                                             x.device)
        return ref.ell_matvec_blocked(idx, val, x, block_rows=bn)
    if threads is None and lane_order is None:
        batch = val.shape[0] if val.dim() == 3 else None
        threads, lane_order = _ell_launch(
            "ell_matvec", _form(batch), x.device, n, 1, k, x.dtype,
            lambda t, o: spmv_ell.ell_matvec(idx, val, x, threads=t,
                                             lane_order=o, tuning=True))
    return spmv_ell.ell_matvec(idx, val, x, threads=threads,
                               lane_order=lane_order)


def dense_backup(p: torch.Tensor, cost: torch.Tensor, gamma,
                 v: torch.Tensor, *, impl: str | None = None,
                 warps: int | None = None) \
        -> tuple[torch.Tensor, torch.Tensor]:
    """Fused Bellman backup on a dense block -> (v_new ([B,] n), argmin
    ([B,] n) int32)."""
    impl = resolve(impl, v.device)
    if impl in ("torch", "blocked"):
        return ref.dense_backup(p, cost, gamma, v)
    if warps is None:
        n, m, n_cols = p.shape[-3:]
        warps = int(_tune(
            "dense_backup" + _form(p.shape[0] if p.dim() == 4 else None),
            v.device, n, m, n_cols, v.dtype, dense_kernel.WARPS,
            dense_kernel.DEFAULT_WARPS,
            lambda w: tuning.measure(lambda: dense_kernel.dense_backup(
                p, cost, gamma, v, warps=int(w), tuning=True))))
    return dense_kernel.dense_backup(p, cost, gamma, v, warps=warps)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    impl: str | None = None) -> torch.Tensor:
    """GQA attention forward: q (B, T, H, d), k/v (B, S, KV, d) -> (B, T, H,
    d) in q's dtype, scale ``d ** -0.5``, keys ``>= S`` excluded.  Not
    tuned; ``blocked`` is the plain version."""
    if resolve(impl, q.device) != "cuda":
        return ref.flash_attention(q, k, v, causal=causal)
    return flash_kernel.flash_attention(q, k, v, causal=causal)


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {name: getattr(mod, attr) for name, (mod, attr) in KERNELS.items()}


def tune_launch_counts() -> dict[str, int]:
    """Launches that timed a tuning candidate so far, by kernel name
    (``ell_qvalues``' count under ``ell_matvec``, whose kernel it runs)."""
    return {name: mod.tune_launches for name, mod in TUNED.items()}


def reset_launch_counts() -> None:
    """Set every launch count, the tune launches' too, to 0."""
    for mod, attr in KERNELS.values():
        setattr(mod, attr, 0)
    for mod in TUNED.values():
        mod.tune_launches = 0
