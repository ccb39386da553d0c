"""The readings a limit is set from: the compared numbers of the program
and of the control over many seeds, in one process (set-up paid once).

    python3 bench/calibrate.py --workload <cell> --seeds 11,12,13 \
        --seconds 3 --system program|control-rerank|control-build

Each seed is a whole run of the cell (its data, its build, a window of
``--seconds`` at the cell's own load, the judge) with the program or the
control (``reference/control.py``) as the system under test.  One JSON line
a seed: the seed, the system, ``correct`` and every compared number.  The
benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys

import run as entry  # bench/run.py, beside this file


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--system", default="program",
                   choices=("program", "control-rerank", "control-build"))
    args = p.parse_args(argv)
    entry.setup_environment()
    import torch

    from bench import harness, manifest
    from bench.reference.control import Control

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    man = manifest.load(entry.ROOT)
    cell = man.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        system = None
        if args.system != "program":
            system = Control(man.config(cell["config"]),
                             man.traffic(cell["traffic"]),
                             args.system.split("-")[1])
        t0 = harness.now()
        r = harness.run_cell(man, args.workload, seed, args.seconds, False,
                             "cuda", t0, system=system)
        print(json.dumps({"seed": seed, "system": args.system,
                          "correct": r["correct"],
                          "attempted": r["attempted"],
                          "seconds": harness.now() - t0,
                          "numbers": {k: v["value"]
                                      for k, v in r["checks"].items()}}),
              flush=True)
        del r, system
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
