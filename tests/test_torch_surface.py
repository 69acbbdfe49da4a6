"""The torch port's public surface against the JAX package's, by name.

Both packages are parsed with ``ast`` and neither is imported, so the
check takes well under a second.  For every module of ``src/repro/``,
each public top-level function and class, each public method of a public
class, and each name in a package's ``__all__`` must have a counterpart
of the same name in the same module path under ``src/repro_torch/``: a
top-level binding (``def``, ``class``, assignment or import), a member
of the class of that name, and a name in the port package's ``__all__``.

The only exceptions are :data:`REFERENCE_ONLY`, each with its reason.  A
new reference name needs a port counterpart, or an entry there with a
reason; an entry whose name the port now has, or the reference no longer
has, fails as stale.
"""

import ast
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"

# "module" (a whole module) or "module::name" -> why the port has none
REFERENCE_ONLY = {
    "utils/jax_compat.py": "shims over jax versions; the port runs on "
                           "PyTorch",
    "utils/xla_flags.py": "XLA_FLAGS bundles; PyTorch reads no XLA flags "
                          "(the options refuse -xla_flag_bundle)",
    "launch/mesh.py::make_production_mesh": "XLA's TPU pod meshes",
    "launch/mesh.py::mesh_kwargs": "jax.make_mesh's axis types",
    "launch/dryrun.py::analyze": "reads the compiled HLO text",
    "launch/dryrun.py::collective_bytes": "counts collectives in HLO text",
    "launch/dryrun.py::run_mdp_cell": "the MDP cells, closed: the solver "
                                      "reads host values between steps, "
                                      "so nothing is traced ahead",
    "core/ipi.py::init_state_jit": "a jit wrapper of init_state",
    "core/driver.py::clear_run_cache": "the jit cache; eager torch "
                                       "compiles nothing",
    "core/methods.py::emit_monitor": "a device callback; the port's "
                                     "record rides the step's read "
                                     "through emit_host",
    "core/partition.py::mdp_pspecs": "jax PartitionSpecs",
    "kernels/ops.py::set_default_impl": "a process-wide knob; the port "
                                        "picks the kernels per call, by "
                                        "-kernel_impl / impl=",
    "kernels/ops.py::get_default_impl": "reads set_default_impl's knob, "
                                        "which the port has not",
    "kernels/ref.py::pin_rounding": "an XLA FMA barrier; the port pins "
                                    "rounding by -fmad=false and "
                                    "explicit ops",
    "models/attention.py::init_attention": "Flax-style init; the port's "
                                           "nn.Module constructors and "
                                           "models/convert.py",
    "models/layers.py::init_mlp": "Flax-style init; MLP's constructor",
    "models/mamba2.py::init_mamba2": "Flax-style init; Mamba2's "
                                     "constructor",
    "models/moe.py::init_moe": "Flax-style init; MoE's constructor",
    "models/lm.py::DecoderLM.init": "Flax-style init; DecoderLM's "
                                    "constructor",
    "models/whisper.py::WhisperModel.init": "Flax-style init; "
                                            "WhisperModel's constructor",
}


def _literal_all(tree: ast.Module) -> list[str]:
    for node in tree.body:
        targets = node.targets if isinstance(node, ast.Assign) else \
            [node.target] if isinstance(node, ast.AnnAssign) else []
        if any(isinstance(t, ast.Name) and t.id == "__all__"
               for t in targets):
            return list(ast.literal_eval(node.value))
    return []


def _public(name: str) -> bool:
    return not name.startswith("_")


def reference_names(tree: ast.Module, package: bool) -> set[str]:
    """Public defs and classes, public methods as ``Class.method``, and a
    package's ``__all__`` as ``__all__:name``."""
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and _public(node.name):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{f.name}" for f in node.body
                        if isinstance(f, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                        and _public(f.name)}
    if package:
        out |= {f"__all__:{n}" for n in _literal_all(tree)}
    return out


def _bound(body) -> set[str]:
    """Every name a module or class body binds."""
    out = set()
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                out |= {n.id for n in ast.walk(t) if isinstance(n, ast.Name)}
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return out


def port_names(tree: ast.Module) -> set[str]:
    """What the port module offers, in :func:`reference_names`' terms."""
    out = _bound(tree.body)
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            out |= {f"{node.name}.{n}" for n in _bound(node.body)}
    out |= {f"__all__:{n}" for n in _literal_all(tree)}
    return out


def _parse(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


MODULES = sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py"))


def missing_in_port(module: str) -> list[str]:
    """The reference names of ``module`` the port lacks, less the
    exceptions."""
    if module in REFERENCE_ONLY:
        return []
    ref = reference_names(_parse(REF / module),
                          module.endswith("__init__.py"))
    port_path = PORT / module
    have = port_names(_parse(port_path)) if port_path.exists() else set()
    return sorted(n for n in ref - have
                  if f"{module}::{n}" not in REFERENCE_ONLY)


@pytest.mark.parametrize("module", MODULES)
def test_every_reference_name_has_a_port_counterpart(module):
    if module not in REFERENCE_ONLY:
        assert (PORT / module).exists(), \
            f"src/repro_torch/{module} is missing"
    missing = missing_in_port(module)
    assert not missing, (
        f"src/repro/{module} has {missing} with no counterpart in "
        f"src/repro_torch/{module}: port them, or add each to "
        f"REFERENCE_ONLY with its reason")


@pytest.mark.parametrize("entry", sorted(REFERENCE_ONLY))
def test_reference_only_entries_are_not_stale(entry):
    assert REFERENCE_ONLY[entry].strip(), f"{entry} gives no reason"
    module, _, name = entry.partition("::")
    assert (REF / module).exists(), \
        f"stale REFERENCE_ONLY entry {entry}: src/repro/{module} is gone"
    if not name:
        assert not (PORT / module).exists(), (
            f"stale REFERENCE_ONLY entry {entry}: the port has "
            f"src/repro_torch/{module}")
        return
    ref = reference_names(_parse(REF / module),
                          module.endswith("__init__.py"))
    assert name in ref, (f"stale REFERENCE_ONLY entry {entry}: the "
                         f"reference has no public {name} there")
    port_path = PORT / module
    assert not (port_path.exists() and name in port_names(
        _parse(port_path))), (f"stale REFERENCE_ONLY entry {entry}: the "
                              f"port has {name} now")
