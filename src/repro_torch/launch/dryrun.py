"""Dry run of the LM cells: every (arch x shape) step at 256 and 512 ranks,
in one host process, with no memory and no data.

Counterpart of the LM half of :mod:`repro.launch.dryrun` (``run_lm_cell``,
``analyze``, ``main``).  Where the reference lowers and compiles each
cell's jitted step for a ``(16, 16)`` or ``(2, 16, 16)`` device mesh and
reads XLA's analyses, the port runs the step itself, once, as one rank of
that mesh:

* the process joins the ``fake`` process-group backend at world 256 or
  512 (every collective returns at once, moving nothing) and builds a
  ``DeviceMesh`` of ``("data", "model")`` or ``("pod", "data", "model")``
  on it (:func:`production_mesh`; the reference's ``make_production_mesh``
  is reference-only);
* the model, its optimizer state, the batch and the decode cache are
  ``FakeTensor`` objects (shapes and dtypes, no storage) placed on the
  specs of :func:`repro_torch.launch.specs.input_specs`, each rank's
  local block;
* the step is the port's own: ``make_train_step(..., mesh=)`` with the
  cell's microbatches, or the placed prefill or decode step.  A decode
  step runs at the cache's last free slot, so that attention reads every
  slot, as the reference's masked step does.

Each cell records, as rank 0 of the mesh (the reference's keys where they
carry over):

* ``flops``: per rank, each op's FLOPs by the formulas of
  :mod:`torch.utils.flop_counter` (``FlopCounterMode``'s registry),
  counted in :class:`StepMeter` (``FlopCounterMode`` itself keeps tensors
  alive through its module tracker, which would spoil the peak below),
  plus the flash kernel's (``flash_flops``): on the card a prefill's
  attention is the hand-written kernel, which the dry run stands in for by
  its output's shape and its FLOPs, ``4 hd`` a query-key pair that the
  kernel's mask keeps (:func:`flash_stand_in`);
* ``collectives`` / ``collective_counts``: bytes and counts by kind
  (``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute``), from a dispatch mode over the ``c10d`` and
  ``_c10d_functional`` ops (:class:`StepMeter`; the bytes are each op's
  result's, as the reference's ``collective_bytes`` counts them);
* ``argument_size_in_bytes``: the rank's inputs (its weight blocks, its
  optimizer state, its rows of the batch, its cache blocks), and for a
  train cell ``rank_bytes`` (:func:`repro_torch.launch.specs.rank_bytes`)
  beside it; ``temp_size_in_bytes``: the peak of the bytes the step's ops
  allocate, live at once (:class:`StepMeter`);
* ``status`` and ``wall_s``; a cell that fails records ``FAIL``, the error
  and the traceback's tail, and the exit code is 1.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --suite lm --mesh both \\
      --out results.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-34b \\
      --shape train_4k --mesh multipod

The MDP cells (``--suite mdp``) are reference-only (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# the c10d / _c10d_functional ops the port issues -> the reference's
# collective kinds (any other op is recorded as "other:<op>")
KIND = {"allreduce_": "all-reduce", "all_reduce": "all-reduce",
        "_allgather_base_": "all-gather",
        "all_gather_into_tensor": "all-gather",
        "reduce_scatter_tensor": "reduce-scatter"}
_NOT_COLLECTIVE = {"wait_tensor", "_wrap_tensor_autograd"}
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class StepMeter(TorchDispatchMode):
    """A dispatch mode that counts the collectives a step issues and the
    bytes its ops allocate.

    ``calls`` / ``bytes``: by op name, every ``c10d`` op
    (``torch.distributed``'s calls, e.g. ``allreduce_``) and
    ``_c10d_functional`` op (``DTensor``'s redistributions, e.g.
    ``all_gather_into_tensor``, ``reduce_scatter_tensor``) that reaches
    the dispatcher, the autograd backward's included, with its result's
    bytes; ``wait_tensor`` and the wrappers are no collectives.

    ``flops``: the ops' FLOPs by :mod:`torch.utils.flop_counter`'s
    formulas.  With ``memory``: ``peak`` is the most bytes live at once
    among the storages the ops returned new (an output aliasing no input),
    each counted from its first tensor until its last is collected
    (``weakref.finalize``)."""

    def __init__(self, memory: bool = False):
        super().__init__()
        self.calls = collections.Counter()
        self.bytes = collections.Counter()
        self.flops = 0
        self.memory = memory
        self.live: dict = {}
        self.now = self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        name = func.__name__.split(".")[0]
        if func.namespace in ("c10d", "_c10d_functional") and \
                name not in _NOT_COLLECTIVE:
            self.calls[name] += 1
            self.bytes[name] += _nbytes(out)
        if self.memory:
            self._track(args, kwargs, out)
        return out

    def _track(self, args, kwargs, out) -> None:
        ins = {t.untyped_storage()._cdata for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)}
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self.live:
                self.live[key][1] += 1
            elif key in ins:
                continue
            else:
                self.live[key] = [st.nbytes(), 1]
                self.now += st.nbytes()
                self.peak = max(self.peak, self.now)
            weakref.finalize(t, self._drop, key)

    def _drop(self, key) -> None:
        entry = self.live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.now -= entry[0]
            del self.live[key]

    def by_kind(self) -> tuple:
        """``(bytes, counts)`` by the reference's kinds (``other:<op>``
        for an op of none)."""
        nbytes = dict.fromkeys(COLLECTIVES, 0)
        counts = dict.fromkeys(COLLECTIVES, 0)
        for name, n in self.calls.items():
            kind = KIND.get(name, f"other:{name}")
            nbytes[kind] = nbytes.get(kind, 0) + self.bytes[name]
            counts[kind] = counts.get(kind, 0) + n
        return nbytes, counts


def count_dispatched_collectives(fn) -> tuple:
    """``fn()`` with the collectives it issues counted by op name
    (:class:`StepMeter`): ``(result, {op: count})``."""
    with StepMeter() as meter:
        result = fn()
    return result, dict(sorted(meter.calls.items()))


# ------------------------------------------------------------------------- #
# the fake world                                                             #
# ------------------------------------------------------------------------- #

def join_fake_world(world: int) -> None:
    """This process as rank 0 of a ``fake`` process group of ``world``
    ranks (a group it was in before is left)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def production_mesh(name: str):
    """The ``pod`` ``(16, 16)`` ``("data", "model")`` or ``multipod`` ``(2,
    16, 16)`` ``("pod", "data", "model")`` mesh on a fake world of its
    size, joined here."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = MESHES[name]
    join_fake_world(math.prod(shape))
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode

    # the mesh's own bookkeeping runs real tensors
    return FakeTensorMode(allow_non_fake_inputs=True)


@contextlib.contextmanager
def flash_stand_in(count: dict):
    """``ops.flash_attention`` replaced, for the block's duration, by the
    kernel's contract without its work: an output of ``q``'s shape, and
    ``4 hd`` FLOPs (``q . k`` and ``p v``) for each query-key pair its
    mask keeps (every pair, or ``sum min(i + 1, S)`` over the queries
    where causal) added to ``count["flops"]``."""
    from repro_torch.kernels import ops

    real = ops.flash_attention

    def stand_in(q, k, v, *, causal=True, impl=None):
        b, t, h, hd = q.shape
        s = k.shape[1]
        pairs = t * s
        if causal:
            m = min(t, s)
            pairs = m * (m + 1) // 2 + (t - m) * s
        count["flops"] = count.get("flops", 0) + 4 * b * h * hd * pairs
        return torch.empty_like(q)

    ops.flash_attention = stand_in
    try:
        yield count
    finally:
        ops.flash_attention = real


# ------------------------------------------------------------------------- #
# LM cells                                                                   #
# ------------------------------------------------------------------------- #

def place_cell(arch: str, shape_name: str, mesh, mode=None) -> dict:
    """The cell's inputs as fake tensors on ``mesh`` (its local blocks),
    from :func:`repro_torch.launch.specs.input_specs`: ``model`` placed
    on the specs, and by kind ``opt`` / ``batch`` (global, as the steps
    take it) / ``cache`` (its blocks on ``cache_spec``, at its last free
    slot) / ``token`` (global), with ``local``: ``{kind: {leaf: local
    shape}}`` (batch and token: the rank's rows) and ``argument_bytes``."""
    from repro_torch.configs import get_config, get_train_config
    from repro_torch.launch import specs
    from repro_torch.models import DecoderLM, WhisperModel
    from repro_torch.train import sharding as shd
    from repro_torch.train.optimizer import init_opt_state, local

    mode = mode or fake_mode()
    si = specs.input_specs(arch, shape_name, mesh)
    cfg, shape = get_config(arch), si["shape"]
    with mode:
        model = (WhisperModel if cfg.family == "encdec" else DecoderLM)(
            cfg, device="cpu")
        cache = model.init_cache(shape.global_batch, shape.seq_len) \
            if shape.kind == "decode" else None
    shd.place(model, mesh, si["param_specs"])
    out = dict(model=model, cfg=cfg, shape=shape, si=si, mode=mode,
               local={"params": {n: tuple(local(p).shape)
                                 for n, p in model.named_parameters()}})
    args = sum(local(p).numel() * local(p).element_size()
               for p in model.parameters())
    with mode:
        if shape.kind == "train":
            opt = init_opt_state(model, get_train_config(arch),
                                 {k: v for k, v in si["opt_specs"].items()
                                  if k != "master"})
            out["opt"] = opt
            out["local"]["opt"] = {f"{k}.{n}": tuple(local(t).shape)
                                   for k, d in opt.items()
                                   for n, t in d.items()}
            args += sum(local(t).numel() * local(t).element_size()
                        for d in opt.values() for t in d.values())
        if shape.kind in ("train", "prefill"):
            batch = {n: torch.empty(t.shape, dtype=t.dtype)
                     for n, t in si["batch"].items()}
            if shape.kind == "prefill":
                batch.pop("labels")
            out["batch"] = batch
            rows = shd.batch_rows(batch, mesh) if shd.batch_split(
                mesh, shape.global_batch) else batch
            out["local"]["batch"] = {n: tuple(t.shape)
                                     for n, t in rows.items()}
            args += _nbytes(rows)
        else:
            cache = shd.place_cache(cache, mesh, cfg, shape.global_batch)
            cache["len"] = shape.seq_len - 1
            token = torch.empty(si["token"].shape, dtype=si["token"].dtype)
            rows = shd.batch_rows({"token": token}, mesh)["token"] \
                if shd.batch_split(mesh, shape.global_batch) else token
            out["cache"], out["token"] = cache, token
            out["local"]["cache"] = {
                f"{k}.{n}" if isinstance(v, dict) else k: tuple(x.shape)
                for k, v in cache.items() if k != "len"
                for n, x in (v.items() if isinstance(v, dict) else
                             [(None, v)])}
            out["local"]["token"] = {"token": tuple(rows.shape)}
            args += _nbytes([v for k, v in cache.items() if k != "len"]) + \
                _nbytes(rows)
    out["argument_bytes"] = args
    return out


def run_lm_cell(arch: str, shape_name: str, mesh) -> dict:
    """One cell's step on ``mesh`` (a ``DeviceMesh`` on a fake world), its
    record (module docstring)."""
    from repro_torch.configs import get_train_config
    from repro_torch.launch import specs
    from repro_torch.train.steps import (make_decode_step, make_prefill_step,
                                         make_train_step)

    t0 = time.time()
    cell = place_cell(arch, shape_name, mesh)
    model, shape, si = cell["model"], cell["shape"], cell["si"]
    tcfg = get_train_config(arch)
    rec = {}
    if shape.kind == "train":
        fn = make_train_step(model, tcfg, n_microbatches=si["n_micro"],
                             mesh=mesh)
        run = lambda: fn(cell["opt"], 0, cell["batch"])
        rec["n_micro"] = si["n_micro"]
        rec["rank_bytes"] = specs.rank_bytes(
            si["model"], si["opt"], tcfg, mesh, si["param_specs"],
            si["opt_specs"])
    elif shape.kind == "prefill":
        fn = make_prefill_step(model)
        run = lambda: fn(cell["batch"]["tokens"], cell["batch"].get(
            "patches"))
    else:
        fn = make_decode_step(model)
        run = lambda: fn(cell["token"], cell["cache"])
    setup = time.time() - t0
    flash = {}
    with cell["mode"], flash_stand_in(flash), \
            StepMeter(memory=True) as meter:
        run()
    nbytes, counts = meter.by_kind()
    rec.update(
        flops=float(meter.flops + flash.get("flops", 0)),
        flash_flops=float(flash.get("flops", 0)),
        collectives=nbytes, collective_counts=counts,
        collective_ops=dict(sorted(meter.calls.items())),
        argument_size_in_bytes=cell["argument_bytes"],
        temp_size_in_bytes=meter.peak,
        setup_s=round(setup, 2), step_s=round(time.time() - t0 - setup, 2),
        mesh=dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)))
    return rec


# ------------------------------------------------------------------------- #
# CLI                                                                        #
# ------------------------------------------------------------------------- #

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--suite", choices=("lm", "mdp", "all"), default=None)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("pod", "multipod", "both"),
                    default="both")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.suite in ("mdp", "all"):
        ap.error("the MDP cells are reference-only (ROADMAP.md, "
                 "\"Reference-only\": src/repro/launch/dryrun.py's "
                 "run_mdp_cell); run --suite lm")

    from repro_torch.configs import ARCHS, cells

    mesh_names = [args.mesh] if args.mesh != "both" else ["pod", "multipod"]
    jobs = []
    if args.arch:
        shapes = [args.shape] if args.shape else \
            [s.name for s in cells(args.arch)]
        jobs += [(args.arch, s) for s in shapes]
    if args.suite == "lm":
        jobs += [(a, s.name) for a in ARCHS for s in cells(a)]
    if not jobs:
        ap.error("nothing to run: give --suite lm or --arch")

    results = {}
    t_all = time.time()
    for mesh_name in mesh_names:
        mesh = production_mesh(mesh_name)
        for a, s in jobs:
            key = f"{a}/{s}/{mesh_name}"
            t0 = time.time()
            try:
                rec = run_lm_cell(a, s, mesh)
                rec["status"] = "ok"
            except Exception as e:  # noqa: BLE001 — record and continue
                rec = {"status": "FAIL", "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
            rec["wall_s"] = round(time.time() - t0, 2)
            results[key] = rec
            print(f"[{rec['status']}] {key}  wall={rec['wall_s']}s "
                  f"flops={rec.get('flops', 0):.3e} "
                  f"coll={sum(rec.get('collectives', {}).values()):.3e}B "
                  f"args={rec.get('argument_size_in_bytes', 0):.3e}B "
                  f"temp={rec.get('temp_size_in_bytes', 0):.3e}B",
                  flush=True)
            if args.out:
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    n_fail = sum(1 for r in results.values() if r["status"] != "ok")
    print(f"done: {len(results) - n_fail}/{len(results)} ok in "
          f"{time.time() - t_all:.1f}s", flush=True)
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
