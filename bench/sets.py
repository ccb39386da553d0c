"""Sets of runs of one cell, each run its own process as the check runs
them, and the spread of every metric: what a bound is set from.

    python3 bench/sets.py --workload <cell> --seeds 21,22,23,24,25,26 \
        --sets 2 --seconds 30 --trace 0 --out <dir>

Each set runs ``bench/run.py`` once per seed, in order; every set uses the
same seeds.  Each run's standard output and error go to ``<dir>``.  Then one
JSON line a metric: each set's median and spread (the distance between the
first and third quartile of ``statistics.quantiles(values, n=4)`` over the
median), the spread with each set's run farthest from its median left out,
the spread of all runs together, and whether every run was correct.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent


def spread(values: list[float]) -> float:
    if len(values) < 2:
        return 0.0
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed(values: list[float]) -> list[float]:
    """The values less the one farthest from their median."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return [v for i, v in enumerate(values) if i != far]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    runs: list[list[dict]] = []
    for k in range(args.sets):
        runs.append([])
        for seed in seeds:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, str(HERE / "run.py"), "--workload",
                 args.workload, "--seed", str(seed), "--seconds",
                 str(args.seconds), "--trace", str(args.trace)],
                capture_output=True, text=True, cwd=HERE.parent)
            tag = f"{args.workload}.t{args.trace}.s{k}.{seed}"
            (out / f"{tag}.out").write_text(proc.stdout)
            (out / f"{tag}.err").write_text(proc.stderr)
            line = (json.loads(proc.stdout.strip().splitlines()[-1])
                    if proc.returncode == 0 and proc.stdout.strip() else {})
            runs[-1].append(line)
            print(json.dumps({"set": k, "seed": seed, "rc": proc.returncode,
                              "wall_s": time.perf_counter() - t0,
                              "correct": line.get("correct"),
                              "metrics": {m: v["value"] for m, v in
                                          line.get("metrics", {}).items()},
                              "checks": {c: v["value"] for c, v in
                                         line.get("checks", {}).items()}}),
                  flush=True)
    names = sorted({m for s in runs for r in s for m in r.get("metrics", {})})
    for name in names:
        sets = [[r["metrics"][name]["value"] for r in s
                 if name in r.get("metrics", {})] for s in runs]
        print(json.dumps({
            "metric": name,
            "medians": [statistics.median(v) if v else None for v in sets],
            "spreads": [spread(v) for v in sets],
            "spreads_trimmed": [spread(trimmed(v)) if len(v) > 2 else None
                                for v in sets],
            "spread_all": spread([x for v in sets for x in v]),
            "all_correct": all(r.get("correct") for s in runs for r in s)}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
