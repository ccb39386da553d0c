"""Dry run: trace every (arch x shape) cell on the ``meta`` device (port
of ``repro/launch/dryrun.py``), on one card or on the reference's
production meshes.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --cell train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all     # every cell, one card
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both   # (16, 16) and (2, 16, 16)
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mace --cell ogb_products --variant nodes=306128

The reference lowers and compiles each cell for its 256- and 512-chip
TPU meshes and reads XLA's memory and cost analyses and the collectives
of its HLO.  Here each cell's program is built on ``meta``, its arguments
made by ``CellProgram.meta_args`` (no storage, no data drawn), and ``fn``
run once:

* ``--mesh card`` (the default): on a one-card ``Mesh((1, 1))`` under
  ``torch.utils.flop_counter.FlopCounterMode``, which counts the matrix
  products every executed op does, loops and the backward included.
* ``--mesh single`` / ``multipod`` (``both`` runs the two): on the
  production ``DeviceMesh`` (data=16, model=16) or (pod=2, data=16,
  model=16) over PyTorch's fake process group, this process rank 0 of
  256 / 512 (``launch/mesh.make_fake_production_mesh``): the arguments are
  split as the program's ``placements`` say (``shard_args``), so rank 0
  holds its shards on ``meta``, at the reference's shapes with no one-card
  cut.  ``RankCounter`` counts what rank 0 runs: the FLOPs of the ops on
  its local shards (a mode that steps aside for DTensor dispatch and skips
  the fake tensors of its propagation, which carry global shapes; over
  DTensors ``FlopCounterMode`` would count the global product), each
  collective by kind as the reference's ``collective_bytes`` does (the
  bytes of its result on this rank, and a count), and the peak of the
  storage its ops hold live, the counterpart of the temporaries in XLA's
  memory analysis.  Collectives move no data on the fake group.

A kernel wrapper reached on a meta tensor runs its plain version.
Nothing needs a GPU.

Each cell writes ``artifacts/dryrun_torch/<arch>__<cell>__<mesh>
[__<variant>].json``: the seconds to build and to trace, ``n_devices``,
``memory.argument_bytes`` and ``memory.output_bytes`` (the ``nbytes`` of
the arguments' and the outputs' tensors, a rank's shards on a mesh), on
a mesh ``memory.peak_bytes`` (the arguments and the most storage the
rank's ops made that was live at once: activations, saved tensors,
gradients, collectives' buffers; the card would add its allocator's
rounding and its libraries' workspaces, so it is a lower bound of the
card's peak),
``cost.flops`` and ``cost.flops_by_op`` (a rank's), ``collectives``
(``bytes`` and ``counts`` by kind, ``total_bytes``; none on one card), the
cell's ``kind`` and ``compute_dtype``, and the program's ``meta``.
``repro_torch/roofline.py`` reads them.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Optional

import collections
import weakref

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.configs import ASSIGNED, get_arch
from repro_torch.core.sharded_index import Mesh
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps
from repro_torch.tree import leaves

ARTIFACT_DIR = os.path.abspath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "../../../artifacts/dryrun_torch"))
MESH_NAME = "card"
MESHES = ("card", "single", "multipod")
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# c10d ops by kind: the functional ops DTensor issues, and the in-place
# ones behind the ``torch.distributed`` calls of ``models/collectives`` and
# ``models/moe`` (their first argument holds the result)
_FUNCTIONAL = {"all_gather_into_tensor": "all-gather",
               "all_reduce": "all-reduce",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all"}
_INPLACE = {"_allgather_base_": "all-gather", "allreduce_": "all-reduce",
            "_reduce_scatter_base_": "reduce-scatter",
            "alltoall_base_": "all-to-all"}


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t


def _tensor_bytes(tree) -> int:
    """The ``nbytes`` of the tree's tensors (of this rank's shard of a
    DTensor)."""
    return int(sum(_local(t).nbytes for t in leaves(tree)
                   if isinstance(t, torch.Tensor)))


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.nbytes
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(y) for y in x)
    return 0


class RankCounter(TorchDispatchMode):
    """What this rank runs: FLOPs by op (``flop_counter``'s formulas) of
    the ops on plain tensors (its local shards), the collectives by kind
    (bytes of the result, count), and the most bytes of storage that its
    ops made and that were live at once (``peak``: each storage an op
    returns that aliases none of its inputs is counted until it is freed,
    a weakref finalizer on it; a storage outlives its Python tensors while
    autograd saves it).  DTensor dispatch steps aside (``NotImplemented``),
    its local ops coming back here; the ops of its sharding propagation,
    on global shapes under a ``FakeTensorMode``, run uncounted."""

    def __init__(self):
        super().__init__()
        self.flops = collections.Counter()
        self.coll_bytes = dict.fromkeys(COLLECTIVES, 0)
        self.coll_counts = dict.fromkeys(COLLECTIVES, 0)
        self.live = self.peak = 0
        self._held: set[int] = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        # DTensor's propagation: fake tensors, and the factories that make
        # its global-shape inputs under its ``FakeTensorMode``
        if any(issubclass(t, FakeTensor) for t in types) or any(
                isinstance(m, FakeTensorMode)
                for m in _get_current_dispatch_mode_stack()):
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops[str(packet)] += int(flop_registry[packet](
                *args, **kwargs, out_val=out))
        name = func._schema.name.split("::")[-1]
        if func.namespace in ("_c10d_functional", "c10d_functional") \
                and name in _FUNCTIONAL:
            self._collective(_FUNCTIONAL[name], _nbytes(out))
        elif func.namespace == "c10d" and name in _INPLACE:
            self._collective(_INPLACE[name], _nbytes(args[0]))
        self._hold(out, func._schema.returns)
        return out

    def _hold(self, out, returns):
        """Count the new storages of ``out`` as live until they are
        freed."""
        outs = out if isinstance(out, (list, tuple)) else (out,)
        for i, o in enumerate(outs):
            # a list return is one schema entry
            if not isinstance(o, torch.Tensor) or \
                    returns[min(i, len(returns) - 1)].alias_info is not None:
                continue
            storage = o.untyped_storage()
            key, n = id(storage), storage.nbytes()
            if key in self._held:
                continue
            self._held.add(key)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(storage, self._release, key, n)

    def _release(self, key: int, n: int):
        self._held.discard(key)
        self.live -= n

    def _collective(self, kind: str, nbytes: int):
        self.coll_bytes[kind] += int(nbytes)
        self.coll_counts[kind] += 1

    def collectives(self) -> dict:
        return {"bytes": dict(self.coll_bytes),
                "counts": dict(self.coll_counts),
                "total_bytes": int(sum(self.coll_bytes.values()))}


def artifact_path(arch_id: str, cell_name: str, variant: str = "base",
                  directory: str = ARTIFACT_DIR,
                  mesh: str = MESH_NAME) -> str:
    suffix = "" if variant == "base" else f"__{variant}"
    return os.path.join(directory,
                        f"{arch_id}__{cell_name}__{mesh}{suffix}.json")


def run_cell(arch_id: str, cell_name: str, variant: str = "base",
             save: bool = True, directory: str = ARTIFACT_DIR,
             mesh: str = MESH_NAME, device_mesh=None) -> dict:
    """Trace one cell on ``meta`` on ``mesh`` ("card", "single" or
    "multipod") and return (and, with ``save``, write) its record.
    ``device_mesh`` (a fake-group ``DeviceMesh``, ``launch/mesh.
    make_fake_mesh``) replaces the production mesh of "single" /
    "multipod", the latter's dp axes ("pod", "data")."""
    if mesh not in MESHES:
        raise ValueError(f"mesh must be one of {MESHES}, got {mesh!r}")
    if mesh != MESH_NAME:
        return _run_cell_on_mesh(arch_id, cell_name, variant, save,
                                 directory, mesh, device_mesh)
    t0 = time.perf_counter()
    card = Mesh((1, 1), ("data", "model"), device="meta")
    prog = steps.build_cell(arch_id, cell_name, card, False, variant=variant)
    args = prog.meta_args()
    t_build = time.perf_counter() - t0
    with FlopCounterMode(display=False) as counter:
        out = prog.fn(*args)
    t_trace = time.perf_counter() - t0 - t_build
    by_op = {str(op): int(n) for op, n in
             counter.get_flop_counts().get("Global", {}).items()}
    spec = get_arch(arch_id)
    cell = {c.name: c for c in spec.cells}[cell_name]
    result = {
        "arch": arch_id,
        "cell": cell_name,
        "mesh": MESH_NAME,
        "variant": variant,
        "n_devices": 1,
        "kind": cell.kind,
        "compute_dtype": spec.config.compute_dtype,
        "build_s": round(t_build, 2),
        "trace_s": round(t_trace, 2),
        "memory": {
            "argument_bytes": _tensor_bytes(args),
            "output_bytes": _tensor_bytes(out),
        },
        "cost": {
            "flops": int(counter.get_total_flops()),
            "flops_by_op": by_op,
        },
        "collectives": {"bytes": {}, "counts": {}, "total_bytes": 0},
        "meta": dict(prog.meta),
    }
    if save:
        _save(result, directory)
    return result


def _save(result: dict, directory: str):
    os.makedirs(directory, exist_ok=True)
    with open(artifact_path(result["arch"], result["cell"],
                            result["variant"], directory, result["mesh"]),
              "w") as f:
        json.dump(result, f, indent=1)


def _run_cell_on_mesh(arch_id: str, cell_name: str, variant: str,
                      save: bool, directory: str, mesh: str,
                      dm=None) -> dict:
    multi_pod = mesh == "multipod"
    t0 = time.perf_counter()
    if dm is None:
        dm = mesh_mod.make_fake_production_mesh(multi_pod=multi_pod)
    prog = steps.build_cell(arch_id, cell_name, dm, multi_pod,
                            variant=variant)
    args = prog.shard_args(prog.meta_args())
    t_build = time.perf_counter() - t0
    with RankCounter() as counter:
        out = prog.fn(*args)
    t_trace = time.perf_counter() - t0 - t_build
    spec = get_arch(arch_id)
    cell = {c.name: c for c in spec.cells}[cell_name]
    result = {
        "arch": arch_id,
        "cell": cell_name,
        "mesh": mesh,
        "variant": variant,
        "n_devices": dm.size(),
        "kind": cell.kind,
        "compute_dtype": spec.config.compute_dtype,
        "build_s": round(t_build, 2),
        "trace_s": round(t_trace, 2),
        "memory": {
            "argument_bytes": _tensor_bytes(args),
            "output_bytes": _tensor_bytes(out),
            "peak_bytes": _tensor_bytes(args) + counter.peak,
        },
        "cost": {
            "flops": int(sum(counter.flops.values())),
            "flops_by_op": dict(counter.flops),
        },
        "collectives": counter.collectives(),
        "meta": dict(prog.meta),
    }
    if save:
        _save(result, directory)
    return result


def all_cells() -> list[tuple[str, str]]:
    out = []
    for arch_id in ASSIGNED:
        for cell in get_arch(arch_id).cells:
            if not cell.skip:
                out.append((arch_id, cell.name))
    return out


def main(argv: Optional[list[str]] = None) -> list[dict]:
    p = argparse.ArgumentParser()
    p.add_argument("--arch")
    p.add_argument("--cell")
    p.add_argument("--mesh", choices=MESHES + ("both",), default=MESH_NAME,
                   help="card: one card; single / multipod: the "
                        "production (16, 16) / (2, 16, 16) meshes over "
                        "the fake process group; both: the two")
    p.add_argument("--variant", default="base")
    p.add_argument("--all", action="store_true")
    p.add_argument("--skip-existing", action="store_true")
    p.add_argument("--out", default=ARTIFACT_DIR,
                   help="the records' directory")
    args = p.parse_args(argv)
    if not args.all and not (args.arch and args.cell):
        p.error("give --arch and --cell, or --all")

    meshes = ("single", "multipod") if args.mesh == "both" else (args.mesh,)
    cells = all_cells() if args.all else [(args.arch, args.cell)]
    records, failures = [], []
    for mesh in meshes:
        for arch_id, cell_name in cells:
            name = f"{arch_id}/{cell_name}/{mesh}"
            if args.skip_existing and os.path.exists(artifact_path(
                    arch_id, cell_name, args.variant, args.out, mesh)):
                print(f"[skip] {name}")
                continue
            try:
                r = run_cell(arch_id, cell_name, variant=args.variant,
                             directory=args.out, mesh=mesh)
                records.append(r)
                coll = r["collectives"]["total_bytes"]
                print(f"[ok] {name} trace={r['trace_s']}s "
                      f"flops={r['cost']['flops']:.3e} "
                      f"args={r['memory']['argument_bytes'] / 2**30:.2f}GiB "
                      f"out={r['memory']['output_bytes'] / 2**30:.2f}GiB"
                      + (f" coll={coll / 2**30:.2f}GiB"
                         if mesh != MESH_NAME else ""), flush=True)
            except Exception as e:  # noqa: BLE001 — report, then fail
                failures.append((arch_id, cell_name, mesh, repr(e)))
                print(f"[FAIL] {name}: {e!r}", flush=True)
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} failures:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nall dry-run cells traced OK")
    return records


if __name__ == "__main__":
    main()
