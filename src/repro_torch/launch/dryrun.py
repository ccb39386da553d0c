"""One-card dry run: trace every (arch x shape) cell on the ``meta`` device
(port of ``repro/launch/dryrun.py``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --cell train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all     # every cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mace --cell ogb_products --variant nodes=306128

The reference lowers and compiles each cell for a 256-chip TPU mesh and
reads XLA's memory and cost analyses.  Here each cell's program is built on
a one-card mesh (``Mesh((1, 1))``) on ``meta``, its arguments made by
``CellProgram.meta_args`` (no storage, no data drawn), and ``fn`` run once
under ``torch.utils.flop_counter.FlopCounterMode``, which counts the matrix
products every executed op does, loops and the backward included.  A
kernel wrapper reached on a meta tensor runs its plain version.  Nothing
needs a GPU.

Each cell writes ``artifacts/dryrun_torch/<arch>__<cell>__card[__<variant>]
.json``: the seconds to build and to trace, ``memory.argument_bytes`` and
``memory.output_bytes`` (the ``nbytes`` of the arguments' and the outputs'
tensors), ``cost.flops`` and ``cost.flops_by_op``, ``collectives`` (none
on one card), the cell's ``kind`` and ``compute_dtype``, and the program's
``meta``.  ``repro_torch/roofline.py`` reads them.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ASSIGNED, get_arch
from repro_torch.core.sharded_index import Mesh
from repro_torch.launch import steps
from repro_torch.tree import leaves

ARTIFACT_DIR = os.path.abspath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "../../../artifacts/dryrun_torch"))
MESH_NAME = "card"


def _tensor_bytes(tree) -> int:
    return int(sum(t.nbytes for t in leaves(tree)
                   if isinstance(t, torch.Tensor)))


def artifact_path(arch_id: str, cell_name: str, variant: str = "base",
                  directory: str = ARTIFACT_DIR) -> str:
    suffix = "" if variant == "base" else f"__{variant}"
    return os.path.join(directory,
                        f"{arch_id}__{cell_name}__{MESH_NAME}{suffix}.json")


def run_cell(arch_id: str, cell_name: str, variant: str = "base",
             save: bool = True, directory: str = ARTIFACT_DIR) -> dict:
    """Trace one cell on ``meta`` and return (and, with ``save``, write)
    its record."""
    t0 = time.perf_counter()
    mesh = Mesh((1, 1), ("data", "model"), device="meta")
    prog = steps.build_cell(arch_id, cell_name, mesh, False, variant=variant)
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
        os.makedirs(directory, exist_ok=True)
        with open(artifact_path(arch_id, cell_name, variant, directory),
                  "w") as f:
            json.dump(result, f, indent=1)
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
    p.add_argument("--mesh", choices=[MESH_NAME], default=MESH_NAME,
                   help="one card: the reference's TPU meshes have no "
                        "counterpart")
    p.add_argument("--variant", default="base")
    p.add_argument("--all", action="store_true")
    p.add_argument("--skip-existing", action="store_true")
    p.add_argument("--out", default=ARTIFACT_DIR,
                   help="the records' directory")
    args = p.parse_args(argv)
    if not args.all and not (args.arch and args.cell):
        p.error("give --arch and --cell, or --all")

    cells = all_cells() if args.all else [(args.arch, args.cell)]
    records, failures = [], []
    for arch_id, cell_name in cells:
        name = f"{arch_id}/{cell_name}/{MESH_NAME}"
        if args.skip_existing and os.path.exists(artifact_path(
                arch_id, cell_name, args.variant, args.out)):
            print(f"[skip] {name}")
            continue
        try:
            r = run_cell(arch_id, cell_name, variant=args.variant,
                         directory=args.out)
            records.append(r)
            print(f"[ok] {name} trace={r['trace_s']}s "
                  f"flops={r['cost']['flops']:.3e} "
                  f"args={r['memory']['argument_bytes'] / 2**30:.2f}GiB "
                  f"out={r['memory']['output_bytes'] / 2**30:.2f}GiB",
                  flush=True)
        except Exception as e:  # noqa: BLE001 — report, then fail the run
            failures.append((arch_id, cell_name, MESH_NAME, repr(e)))
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
