"""PETSc-style options database, the subset this slice honours.

Counterpart of :mod:`repro.api.options`: a typed registry of ``-key``
options with the reference's types, defaults, validators and error
messages; ingestion from ``MADUPITE_OPTIONS`` and ``--option key=value``
with the reference's precedence (explicit > CLI > environment > default);
and the mapping onto :class:`repro_torch.core.ipi.IPIOptions`.

Ported keys: the solver keys of ``IPIOptions`` (``-method``, ``-mode``,
``-ksp_type``, ``-atol``, ``-stop_criterion``, ``-rtol``, ``-max_outer``,
``-max_inner``, ``-inner_forcing``, ``-restart``, ``-omega``,
``-mpi_sweeps``, ``-anderson_window``, ``-monitor``, ``-monitor_mode``,
``-safeguard``, ``-deterministic_dots``, ``-pc_type``, ``-pc_block``,
``-divtol``, ``-dtype``, ``-halo``, ``-gather_dtype``, ``-comm_overlap``,
``-async_sweeps``, ``-kernel_impl`` with its alias ``-impl``), the
kernel tuner's ``-kernel_tune`` and ``-kernel_tune_cache``, the adaptive
layer's ``-probe_iters`` and
``-adapt_on_stagnation``, the solve loop's ``-chunk``, ``-checkpoint_dir``
and ``-verbose``, the placement's ``-layout``
(``auto|single|1d|2d|fleet|fleet2d``), ``-fleet``, ``-pad_fleet`` and
``-fleet_bucketing``, function-backed MDPs' ``-mdp_materialize``, the
solve server's ``-serve_*`` keys, the outputs ``-file_stats`` /
``-file_stats_format`` / ``-file_policy`` / ``-file_cost``, and the
port's own ``-device``.  ``-kernel_impl`` takes the port's names (``auto``,
``torch``, ``blocked``, ``cuda``) and the JAX package's ``xla`` /
``pallas`` for ``torch`` / ``cuda``, so that an options file written for
the JAX package runs here.  The JAX package's ``-xla_flag_bundle`` has no
counterpart (PyTorch reads no ``XLA_FLAGS``): it raises
:class:`UnknownOptionError` saying so.
:func:`option_table` renders the registry as the README's table.
"""

from __future__ import annotations

import dataclasses
import os
import shlex
from typing import Any, Callable, Mapping

from repro_torch.core import methods as _methods
from repro_torch.core.ipi import IPIOptions, MODES
from repro_torch.core.solvers import PC_TYPES
from repro_torch.device import DEVICES
from repro_torch.kernels import ops as _ops

__all__ = ["OptionSpec", "OPTION_SPECS", "Options", "UnknownOptionError",
           "OptionTypeError", "option_table"]

ENV_VAR = "MADUPITE_OPTIONS"

# precedence levels (higher wins); `set()` without a source is "user"
_SOURCES = {"default": 0, "env": 1, "cli": 2, "user": 3}

_LAYOUT_CHOICES = ("auto", "single", "1d", "2d", "fleet", "fleet2d")


def _gather_dtype(v) -> str | None:
    if v is None:
        return None
    try:
        IPIOptions(gather_dtype=v, dtype="float64")
    except ValueError as e:
        return str(e)
    return None



class UnknownOptionError(KeyError):
    """Raised for a key absent from the registry; names the key and the
    closest registered spellings."""


class OptionTypeError(ValueError):
    """Raised when a value cannot be coerced to the key's declared type (or
    violates its choices/validator); names the key."""


@dataclasses.dataclass(frozen=True)
class OptionSpec:
    """One registered option: its type, default and constraints."""

    name: str                    # "-atol"
    type: type                   # float / int / bool / str
    default: Any
    doc: str
    choices: tuple | None = None
    choices_fn: Callable[[], tuple] | None = None   # live registry view
    choices_doc: str | None = None                  # table rendering
    nullable: bool = False       # None is a legal value ("unset")
    validate: Callable[[Any], str | None] | None = None  # -> error or None

    def _choices(self) -> tuple | None:
        if self.choices_fn is not None:
            return tuple(self.choices_fn())
        return self.choices

    def coerce(self, value: Any) -> Any:
        """Coerce (possibly a string from env/CLI) to the declared type."""
        choices = self._choices()
        if value is None:
            if self.nullable:
                return None
            raise OptionTypeError(
                f"option {self.name!r} does not accept None "
                f"(expected {self.type.__name__})")
        if self.nullable and isinstance(value, str) \
                and value.lower() in ("none", "") \
                and not (choices and value.lower() in choices):
            return None
        try:
            if self.type is bool:
                out = _coerce_bool(self.name, value)
            elif isinstance(value, str) and self.type is not str:
                out = self.type(value)
            elif self.type is float and isinstance(value, int) \
                    and not isinstance(value, bool):
                out = float(value)
            elif not isinstance(value, self.type) \
                    or isinstance(value, bool) is not (self.type is bool):
                raise TypeError(
                    f"got {type(value).__name__} {value!r}")
            else:
                out = value
        except OptionTypeError:
            raise
        except (TypeError, ValueError) as e:
            raise OptionTypeError(
                f"option {self.name!r} expects {self.type.__name__}, "
                f"{e}") from None
        if choices is not None and out not in choices:
            raise OptionTypeError(
                f"option {self.name!r} must be one of {choices}, "
                f"got {out!r}{_methods.suggest(out, choices)}")
        if self.validate is not None:
            err = self.validate(out)
            if err:
                raise OptionTypeError(f"option {self.name!r}: {err}")
        return out


def _coerce_bool(name: str, value: Any) -> bool:
    if isinstance(value, bool):
        return value
    if isinstance(value, int) and value in (0, 1):
        return bool(value)
    if isinstance(value, str):
        low = value.lower()
        if low in ("1", "true", "yes", "on"):
            return True
        if low in ("0", "false", "no", "off"):
            return False
    raise OptionTypeError(f"option {name!r} expects a bool "
                          f"(true/false/1/0), got {value!r}")


def _positive(v) -> str | None:
    return None if v > 0 else f"must be > 0, got {v}"


def _non_negative(v) -> str | None:
    return None if v >= 0 else f"must be >= 0, got {v}"


def _open_unit(v) -> str | None:
    return None if 0.0 < v < 1.0 else f"must lie in (0, 1), got {v}"


def _live_choices_doc(names: tuple, register_fn: str) -> str:
    shown = " \\| ".join(f"`{n}`" for n in names)
    return f"{shown} \\| user-registered (`{register_fn}`)"


_SPECS = [
    # ---- solver (maps onto IPIOptions) -------------------------------------
    OptionSpec("-method", str, "ipi_gmres",
               "outer/inner method (validates against the live registry: "
               "repro_torch.api.register_method)",
               choices_fn=lambda: _methods.method_names(),
               validate=_methods.check_method,
               choices_doc=_live_choices_doc(
                   _methods.method_names(builtin_only=True),
                   "register_method")),
    OptionSpec("-mode", str, "mincost",
               "argmin (mincost) vs argmax (maxreward) Bellman backup",
               choices=MODES),
    OptionSpec("-ksp_type", str, None,
               "inner linear solver (PETSc-style sugar: picks -method "
               "ipi_<ksp> unless -method is set explicitly; live registry: "
               "repro_torch.api.register_ksp)",
               choices_fn=lambda: ("none",) + _methods.ksp_names(),
               choices_doc=_live_choices_doc(
                   ("none",) + _methods.ksp_names(builtin_only=True),
                   "register_ksp"),
               nullable=True),
    OptionSpec("-atol", float, 1e-8, "stop when ||T v - v||_inf <= atol",
               validate=_positive),
    OptionSpec("-stop_criterion", str, "atol",
               "outer stopping predicate; span certifies long-mixing VI "
               "far earlier than sup-norm residuals (live registry: "
               "repro_torch.api.register_stop_criterion)",
               choices_fn=lambda: _methods.stop_names(),
               choices_doc=_live_choices_doc(
                   _methods.stop_names(builtin_only=True),
                   "register_stop_criterion")),
    OptionSpec("-rtol", float, 1e-4,
               "threshold for -stop_criterion rtol (relative to the "
               "initial residual)", validate=_open_unit),
    OptionSpec("-max_outer", int, 500, "outer-iteration cap",
               validate=_positive),
    OptionSpec("-max_inner", int, 500, "inner-iteration cap per outer step",
               validate=_non_negative),
    OptionSpec("-inner_forcing", float, 0.05,
               "forcing factor eta: inner tol = eta * ||T v - v||_inf",
               validate=_open_unit),
    OptionSpec("-restart", int, 32, "GMRES restart length",
               validate=_positive),
    OptionSpec("-omega", float, 1.0,
               "Richardson damping factor (also the Anderson mixing "
               "parameter for ksp anderson)"),
    OptionSpec("-mpi_sweeps", int, 50, "Richardson sweeps for method=mpi",
               validate=_positive),
    OptionSpec("-anderson_window", int, 5,
               "Anderson-acceleration window for the anderson inner solver",
               validate=_positive),
    OptionSpec("-monitor", bool, False,
               "emit per-outer-iteration records (residual, inner iters, "
               "elapsed)"),
    OptionSpec("-monitor_mode", str, "stream",
               "monitor delivery: stream (a record from the host loop "
               "after each outer step) or chunk (records rebuilt from the "
               "residual trace once per run chunk)",
               choices=("stream", "chunk")),
    OptionSpec("-safeguard", bool, True,
               "monotone (VI-fallback) safeguard for Krylov steps"),
    OptionSpec("-deterministic_dots", bool, False,
               "pin the Krylov projection and combination orders (loops "
               "over basis lanes, explicit back-substitution)"),
    OptionSpec("-pc_type", str, "none",
               "right preconditioner for Krylov inner solvers: jacobi "
               "(diagonal of I - gamma P_pi) or bjacobi (dense blocks, "
               "PETSc-style)", choices=PC_TYPES),
    OptionSpec("-pc_block", int, 32,
               "bjacobi block size (states per dense block)",
               validate=_positive),
    OptionSpec("-divtol", float, 1e4,
               "declare divergence (sticky flag, loop bail-out) when the "
               "residual exceeds divtol x the initial residual",
               validate=lambda v: None if v > 1.0
               else f"must be > 1, got {v}"),
    OptionSpec("-probe_iters", int, 8,
               "-method auto: probe iterations (plain VI backups) used to "
               "estimate contraction / residual decay before picking the "
               "method", validate=_positive),
    OptionSpec("-adapt_on_stagnation", bool, False,
               "watch any solve (fixed -method too) for stagnation or "
               "divergence between chunks and hot-swap to the next method "
               "in the escalation chain, resuming from the current state"),
    OptionSpec("-kernel_impl", str, None,
               "kernel implementation (auto = the hand-written CUDA "
               "kernels on the card at tuned launch shapes, the plain "
               "PyTorch versions on the CPU; torch = the plain versions; "
               "blocked = the plain blocked versions, tuned rows a chunk; "
               "cuda = the hand-written kernels, raises on the CPU; the "
               "JAX package's xla / pallas name torch / cuda); '-impl' is "
               "accepted as an alias",
               choices_doc=" \\| ".join(
                   f"`{c}`" for c in _ops.IMPLS + tuple(_ops.ALIASES)),
               nullable=True, validate=_ops.check_impl),
    OptionSpec("-kernel_tune", str, "on",
               "launch-shape autotuner: time the hand-written kernels' "
               "CTA sizes and grid orders (blocked: rows a chunk) per "
               "(card, shape, dtype) and persist the winners",
               choices=("on", "off")),
    OptionSpec("-kernel_tune_cache", str, None,
               "autotune cache path (default ~/.cache/madupite/"
               "autotune.json)", nullable=True),
    OptionSpec("-dtype", str, "float32", "value-vector dtype",
               choices=("float32", "float64")),
    OptionSpec("-halo", int, 0,
               "banded layout: exchange only +-halo boundary entries",
               validate=_non_negative),
    OptionSpec("-gather_dtype", str, None,
               "compressed (inexact) gather wire dtype for inner matvecs",
               nullable=True, validate=_gather_dtype),
    OptionSpec("-comm_overlap", str, "auto",
               "overlap the value-window gather with interior-row backup "
               "compute and shrink the collective to the frontier reach "
               "when -halo is 0 (bitwise-identical to the synchronous "
               "path); auto enables it when the interior covers >= half "
               "the shard",
               choices=("auto", "on", "off")),
    OptionSpec("-async_sweeps", int, 1,
               "method=async_vi: local Bellman sweeps per value exchange "
               "(1 = synchronous VI)",
               validate=_positive),
    # ---- placement and driver ----------------------------------------------
    OptionSpec("-device", str, "cuda",
               "device the solve runs on; cuda raises when no GPU is "
               "visible (nothing falls back to the CPU)", choices=DEVICES),
    OptionSpec("-layout", str, "auto",
               "mesh layout; 'auto' picks 1d (a fleet: fleet) over the "
               "torch.distributed world when it has more than one rank, "
               "'single' forces single-device",
               choices=_LAYOUT_CHOICES),
    OptionSpec("-fleet", int, None,
               "fleet-axis size for the fleet layouts (default: largest "
               "world-size divisor <= B)", nullable=True,
               validate=_positive),
    OptionSpec("-chunk", int, 64,
               "outer iterations per chunk between progress reports",
               validate=_positive),
    OptionSpec("-checkpoint_dir", str, None,
               "persist solver state between chunks (and resume from it)",
               nullable=True),
    OptionSpec("-verbose", bool, False, "per-chunk progress lines"),
    OptionSpec("-pad_fleet", bool, True,
               "pad B up to the fleet-axis size with dummy instances"),
    OptionSpec("-fleet_bucketing", str, "auto",
               "group ragged fleets by state count into pad-efficient "
               "buckets (one batched loop per bucket)",
               choices=("auto", "off")),
    OptionSpec("-mdp_materialize", str, "auto",
               "function-backed MDP materialization: device (run the torch "
               "row constructors on the solve's device), host (numpy "
               "callbacks), matrix_free (never store the table — rebuild "
               "row chunks inside every Bellman backup; O(n) per shard), "
               "or auto (device when the constructors are torch "
               "functions; never matrix_free)",
               choices=("auto", "host", "device", "matrix_free")),
    # ---- serving (repro_torch.serve.Server) ---------------------------------
    OptionSpec("-serve_batch_window", float, 0.02,
               "serving: seconds the scheduler waits after the oldest "
               "queued request to coalesce compatible arrivals into one "
               "batched dispatch (0 = dispatch whatever is queued "
               "immediately)", validate=_non_negative),
    OptionSpec("-serve_max_queue", int, 256,
               "serving: admission-control queue depth; submits beyond it "
               "are rejected with AdmissionError('queue_full')",
               validate=_positive),
    OptionSpec("-serve_max_states", int, None,
               "serving: per-request state-count limit; larger MDPs are "
               "rejected with AdmissionError('too_large'). The limit names "
               "a materialized-table byte budget, so matrix-free requests "
               "(O(n) footprint) are admitted up to the same bytes — far "
               "more states (default: unlimited)", nullable=True,
               validate=_positive),
    OptionSpec("-serve_max_batch", int, 32,
               "serving: max requests per dispatched bucket (also caps the "
               "padded fleet-slot size)", validate=_positive),
    OptionSpec("-serve_program_cache", int, 16,
               "serving: LRU capacity of the warm program-slot cache keyed "
               "by shape bucket (hit/miss/eviction counters in "
               "Server.stats())", validate=_positive),
    OptionSpec("-serve_deadline_ms", float, None,
               "serving: per-request latency budget; the scheduler cuts "
               "its coalescing linger short so the request dispatches "
               "before its deadline (default: no deadline)",
               nullable=True, validate=_positive),
    OptionSpec("-serve_slot_policy", str, "mid2",
               "serving: fleet-slot sizing — mid2 pads each bucket's "
               "request count up on the pow2-with-midpoints grid "
               "(1,2,3,4,6,8,12,16,24,...; waste <= 1/3 of the slot), "
               "pow2 on the classic power-of-two grid, exact dispatches "
               "the raw count", choices=("mid2", "pow2", "exact")),
    # ---- output -------------------------------------------------------------
    OptionSpec("-file_stats", str, None,
               "write run statistics here after each solve",
               nullable=True),
    OptionSpec("-file_stats_format", str, "jsonl",
               "run-statistics format: jsonl (one line per solve, "
               "appended) or json (single array, rewritten per solve)",
               choices=("jsonl", "json")),
    OptionSpec("-file_policy", str, None,
               "write the optimal policy (.npy) here", nullable=True),
    OptionSpec("-file_cost", str, None,
               "write the optimal value vector (.npy) here", nullable=True),
]

OPTION_SPECS: dict[str, OptionSpec] = {s.name: s for s in _SPECS}

# the IPIOptions field each solver option maps onto
_IPI_FIELDS = {
    "-method": "method", "-mode": "mode", "-atol": "atol",
    "-stop_criterion": "stop_criterion", "-rtol": "rtol",
    "-max_outer": "max_outer", "-max_inner": "max_inner",
    "-inner_forcing": "forcing_eta", "-restart": "restart",
    "-omega": "omega", "-mpi_sweeps": "mpi_sweeps",
    "-anderson_window": "anderson_window", "-monitor": "monitor",
    "-safeguard": "safeguard", "-deterministic_dots": "deterministic_dots",
    "-kernel_impl": "impl", "-dtype": "dtype", "-monitor_mode": "monitor_mode",
    "-pc_type": "pc_type", "-pc_block": "pc_block", "-divtol": "divtol",
    "-halo": "halo", "-gather_dtype": "gather_dtype",
    "-comm_overlap": "comm_overlap", "-async_sweeps": "async_sweeps",
}


# retired spellings accepted for compatibility
_ALIASES = {"-impl": "-kernel_impl"}

# the JAX package's keys that have no counterpart here, and why
_REFERENCE_ONLY = {
    "-xla_flag_bundle": "is the JAX package's XLA option (a named "
                        "XLA_FLAGS bundle) and has no counterpart in the "
                        "port: PyTorch reads no XLA flags"}


def _normalize(key: Any) -> str:
    if not isinstance(key, str) or not key:
        raise UnknownOptionError(f"option keys are strings like '-atol', "
                                 f"got {key!r}")
    name = key if key.startswith("-") else "-" + key
    name = _ALIASES.get(name, name)
    if name in _REFERENCE_ONLY:
        raise UnknownOptionError(f"option {key!r} {_REFERENCE_ONLY[name]}")
    if name not in OPTION_SPECS:
        raise UnknownOptionError(
            f"unknown option {key!r}{_methods.suggest(name, OPTION_SPECS)} "
            f"(see repro_torch.api.OPTION_SPECS for the full registry)")
    return name


class Options:
    """The options database: a validated, precedence-aware flat key store.

    Construct empty, from a mapping, from the environment and/or CLI
    (:meth:`from_sources`), or from an :class:`IPIOptions`
    (:meth:`from_ipi`).  Keys may be given with or without the leading
    dash.  Reads return the registry default for unset keys.
    """

    def __init__(self, values: Mapping[str, Any] | None = None):
        # name -> (coerced value, source priority)
        self._values: dict[str, tuple[Any, int]] = {}
        for k, v in (values or {}).items():
            self.set(k, v)

    # ---- core accessors ----------------------------------------------------
    def set(self, key: str, value: Any, *, source: str = "user") -> "Options":
        """Set (and validate) one option.  A lower-precedence ``source``
        never overrides a higher-precedence value already present."""
        name = _normalize(key)
        prio = _SOURCES[source]
        coerced = OPTION_SPECS[name].coerce(value)
        if name in self._values and self._values[name][1] > prio:
            return self
        self._values[name] = (coerced, prio)
        return self

    def get(self, key: str) -> Any:
        name = _normalize(key)
        if name in self._values:
            return self._values[name][0]
        return OPTION_SPECS[name].default

    def is_set(self, key: str) -> bool:
        """True when the key was explicitly provided (any source)."""
        return _normalize(key) in self._values

    def unset(self, key: str) -> None:
        """Forget an explicitly set key: reads give its default again."""
        self._values.pop(_normalize(key), None)

    def __repr__(self) -> str:
        kv = ", ".join(f"{k}={v[0]!r}"
                       for k, v in sorted(self._values.items()))
        return f"Options({kv})"

    def copy(self) -> "Options":
        out = Options()
        out._values = dict(self._values)
        return out

    def as_dict(self, *, explicit_only: bool = False) -> dict[str, Any]:
        """Flat ``{name: value}`` view (all keys, or only explicitly-set)."""
        if explicit_only:
            return {k: v for k, (v, _) in sorted(self._values.items())}
        return {name: self.get(name) for name in OPTION_SPECS}

    # ---- ingestion ---------------------------------------------------------
    def ingest_env(self, env: Mapping[str, str] | None = None) -> "Options":
        """Parse ``MADUPITE_OPTIONS`` (shell-style ``-key value`` pairs, or
        ``-key=value`` tokens) at "env" precedence."""
        raw = (env if env is not None else os.environ).get(ENV_VAR, "")
        for key, value in _parse_pairs(shlex.split(raw), where=ENV_VAR):
            self.set(key, value, source="env")
        return self

    def ingest_cli(self, pairs) -> "Options":
        """Ingest ``--option key=value`` arguments at "cli" precedence."""
        for item in pairs or ():
            if "=" not in item:
                raise OptionTypeError(
                    f"--option expects key=value, got {item!r}")
            key, value = item.split("=", 1)
            self.set(key.strip(), value.strip(), source="cli")
        return self

    @classmethod
    def from_sources(cls, values: Mapping[str, Any] | None = None, *,
                     cli=None, env: Mapping[str, str] | None = None) -> \
            "Options":
        """Build a database from every source at once.  Precedence (low to
        high): registry defaults, environment, CLI, explicit ``values``."""
        out = cls()
        out.ingest_env(env)
        out.ingest_cli(cli)
        for k, v in (values or {}).items():
            out.set(k, v)
        return out

    # ---- IPIOptions mapping ------------------------------------------------
    def to_ipi(self) -> IPIOptions:
        """The solver-core view of this database.  ``-ksp_type`` picks the
        method when ``-method`` is unset."""
        kw = {field: self.get(name) for name, field in _IPI_FIELDS.items()}
        ksp = self.get("-ksp_type")
        if ksp is not None and not self.is_set("-method"):
            try:
                kw["method"] = _methods.method_for_ksp(ksp)
            except ValueError as e:
                raise OptionTypeError(
                    f"option '-ksp_type': {e}") from None
        try:
            return IPIOptions(**kw)
        except ValueError as e:
            raise OptionTypeError(str(e)) from None

    @classmethod
    def from_ipi(cls, ipi: IPIOptions) -> "Options":
        """Database holding exactly ``ipi``'s settings, over the fields
        :meth:`to_ipi` reads (round-trips: ``Options.from_ipi(o).to_ipi()
        == o``)."""
        out = cls()
        for name, field in _IPI_FIELDS.items():
            out.set(name, getattr(ipi, field))
        return out

    def with_overrides(self, overrides: Mapping[str, Any]) -> "Options":
        """Copy with ``overrides`` applied at user precedence."""
        out = self.copy()
        for k, v in overrides.items():
            out.set(k, v)
        return out


def _parse_pairs(tokens, where: str):
    """``["-method", "vi", "-atol=1e-6"]`` -> ``[("-method", "vi"), ...]``."""
    out = []
    it = iter(tokens)
    for tok in it:
        if "=" in tok:
            key, value = tok.split("=", 1)
            out.append((key, value))
            continue
        try:
            out.append((tok, next(it)))
        except StopIteration:
            raise OptionTypeError(
                f"{where}: option {tok!r} is missing a value") from None
    return out


def option_table() -> str:
    """The full registry rendered as a markdown table (README / docs).

    Registry-backed options render their stable builtin choice set
    (``choices_doc``), so the table does not drift when a user registers
    extra solvers at runtime."""
    lines = ["| option | type | default | description |",
             "|--------|------|---------|-------------|"]
    for spec in OPTION_SPECS.values():
        typ = spec.type.__name__
        if spec.choices_doc:
            typ = spec.choices_doc
        elif spec.choices:
            typ = " \\| ".join(f"`{c}`" for c in spec.choices)
        default = "—" if spec.default is None else f"`{spec.default}`"
        doc = spec.doc.replace("|", "\\|")
        lines.append(f"| `{spec.name}` | {typ} | {default} | {doc} |")
    return "\n".join(lines)
