"""Serving launcher: tuned index -> capacity plan -> open-loop SLO check
(port of ``repro/launch/serve.py``).

The end-to-end entry point of the serving runtime (DESIGN.md §12), on the GPU
unless ``--device cpu``:

  # build + tune + plan + serve a load test at the plan's rated QPS
  PYTHONPATH=src python -m repro_torch.launch.serve --dataset mnist784 \
      --n-db 20000 --target-recall 0.9 --slo-p99-ms 25

  # persist everything (manifest v5), then serve from the manifest later
  PYTHONPATH=src python -m repro_torch.launch.serve --n-db 20000 \
      --save /ckpt/idx
  PYTHONPATH=src python -m repro_torch.launch.serve --load /ckpt/idx \
      --qps 500

A LOADED manifest's tuned operating point (and per-shard params / capacity
plan, when present) is the serving default.  ``--no-tuned`` is the escape
hatch back to
``SearchParams()`` defaults.  Traffic is open-loop Poisson
(serve/loadgen.py), so the reported p50/p99/p999 are coordinated-omission
free; ``--sweep`` walks a QPS ladder past saturation to locate the knee
and exercise the overload-degradation ladder.

``--config fleet.yml`` switches to the config-driven stand-up
(DESIGN.md §15): the file names the manifest, serving knobs, an optional
mesh and an optional autoscaling loop; the launcher builds the fleet with
``serve.config.build_fleet`` and load-tests the FLEET (not a single
runtime), printing any autoscaler decisions the traffic provoked:

  PYTHONPATH=src python -m repro_torch.launch.serve --config fleet.yml \
      --qps 800

``main(argv)`` returns the load test's report (the sweep's rows with
``--sweep``), so a caller can drive the launcher in-process.  The recall
oracle is ``core.knn.exact_knn`` in fp32: the launcher turns TF32 off.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.forest import ForestConfig
from repro_torch.core.knn import exact_knn
from repro_torch.index import (IndexSpec, SearchParams, build_index,
                               load_index, tune)
from repro_torch.serve import loadgen, planner
from repro_torch.serve.runtime import ServingRuntime


def _fmt_params(p: SearchParams) -> str:
    return (f"k={p.k} metric={p.metric} n_probes={p.n_probes} "
            f"n_trees={p.n_trees or 'all'} adaptive_wave={p.adaptive_wave}")


def _true_ids(queries: np.ndarray, gids: np.ndarray, rows: np.ndarray,
              k: int, metric: str, device) -> np.ndarray:
    """The exact top-k gids of ``queries`` over the live ``rows``."""
    _, pos = exact_knn(torch.as_tensor(queries, device=device),
                       torch.as_tensor(rows, device=device), k=k,
                       metric=metric)
    return np.asarray(gids)[pos.cpu().numpy()]


def _serve_fleet(args) -> dict:
    """--config path: fleet.yml -> build_fleet -> open-loop load test."""
    from repro_torch.serve.config import build_fleet
    handle = build_fleet(args.config, device=args.device)
    index = handle.index
    auto = handle.autoscaler
    print(f"[serve] fleet from {args.config}: "
          f"{handle.fleet.n_replicas} replica(s)"
          + (f"; plan batch {handle.plan.batch}, rated "
             f"{handle.plan.rated_qps_per_replica:.0f} qps/replica"
             if handle.plan else "")
          + ("; autoscaler ON" if auto else ""))
    try:
        # query near the index's own rows — the loaded manifest fixes the
        # dimensionality, so synthetic queries must be drawn at ITS dim
        gids, rows = index.live_points()
        rng = np.random.default_rng(0)
        pick = rng.integers(0, rows.shape[0], size=args.n_queries)
        queries = (np.asarray(rows)[pick]
                   + 0.01 * rng.standard_normal(
                       (args.n_queries, rows.shape[1]))).astype(np.float32)
        true_ids = _true_ids(queries, gids, rows, min(args.k, rows.shape[0]),
                             "l2", index.device)
        qps = args.qps or float(
            (handle.plan.rated_qps_per_replica * handle.plan.n_replicas)
            if handle.plan else 100.0)
        r = loadgen.run_open_loop(handle.fleet, np.asarray(queries), qps,
                                  n_requests=args.requests,
                                  true_ids=true_ids)
        print(f"[serve] {r['n_ok']}/{r['n_requests']} ok at "
              f"{r['achieved_qps']:.0f} qps; p50 {r['p50_ms']:.1f}ms "
              f"p99 {r['p99_ms']:.1f}ms p999 {r['p999_ms']:.1f}ms; "
              f"shed {r['shed_fraction']:.1%}; recall "
              f"{r.get('recall_vs_oracle', float('nan')):.3f}")
        print(f"[serve] fleet stats: {handle.fleet.stats()}")
        if auto is not None:
            acted = [d for d in auto.history if d["action"] != "hold"]
            print(f"[serve] autoscaler: {auto.stats()}")
            for d in acted:
                print(f"[serve]   {d['action']} -> {d['n_replicas']} "
                      f"({d['reason']}, demand {d['demand_qps']:.0f} qps)")
    finally:
        handle.stop()
    return r


def main(argv: list[str] | None = None) -> dict | list[dict]:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", choices=["mnist784", "iss595"],
                   default="mnist784")
    p.add_argument("--n-db", type=int, default=20000)
    p.add_argument("--n-queries", type=int, default=256)
    p.add_argument("--trees", type=int, default=40)
    p.add_argument("--capacity", type=int, default=12)
    p.add_argument("--k", type=int, default=5)
    p.add_argument("--load", default="",
                   help="serve an existing index manifest instead of "
                        "building one (tuned params + plan apply)")
    p.add_argument("--save", default="",
                   help="persist the index (+ tuned params, traffic model, "
                        "capacity plan) as a format-5 manifest")
    p.add_argument("--no-tuned", action="store_true",
                   help="ignore the manifest's tuned operating point and "
                        "serve SearchParams() defaults")
    p.add_argument("--target-recall", type=float, default=0.9,
                   help="tune() target when building (skipped with --load)")
    p.add_argument("--slo-p99-ms", type=float, default=25.0)
    p.add_argument("--qps", type=float, default=0.0,
                   help="offered load for the load test (0 = the planner's "
                        "rated QPS)")
    p.add_argument("--requests", type=int, default=1000)
    p.add_argument("--max-batch", type=int, default=64)
    p.add_argument("--sweep", default="",
                   help="comma QPS list to sweep past saturation instead "
                        "of the single-rate run (e.g. 250,500,1000,2000)")
    p.add_argument("--no-degrade", action="store_true",
                   help="disable the overload degradation ladder (serve "
                        "rung 0 only — for A/B-ing the ladder)")
    p.add_argument("--config", default="",
                   help="fleet.yml: config-driven stand-up (index manifest "
                        "+ serving + optional autoscale section); "
                        "load-tests the whole fleet")
    p.add_argument("--device", default="cuda",
                   help="where the index lives and searches run (cuda, or "
                        "cpu for the kernels' plain versions)")
    args = p.parse_args(argv)
    # the recall oracle is an fp32 product (core.knn.exact_knn refuses TF32)
    torch.backends.cuda.matmul.allow_tf32 = False

    if args.config:
        return _serve_fleet(args)

    from repro_torch.data.synthetic import iss_like, mnist_like
    if args.dataset == "mnist784":
        _, _, queries, _ = mnist_like(n=2, n_test=args.n_queries)
        metric = "l2"
    else:
        _, _, queries, _ = iss_like(n=2, n_test=args.n_queries)
        metric = "chi2"

    # ----------------------------------------------------------- index
    if args.load:
        index = load_index(args.load, device=args.device)
        print(f"[serve] loaded {args.load}: {index.stats()}")
        tuned = index.tuned_params
        print(f"[serve] manifest tuned_params: "
              f"{_fmt_params(tuned) if tuned else None}"
              + (f"; {len(index.shard_params)} per-shard points"
                 if index.shard_params else ""))
    else:
        if args.dataset == "mnist784":
            db, _, queries, _ = mnist_like(n=args.n_db,
                                           n_test=args.n_queries)
        else:
            db, _, queries, _ = iss_like(n=args.n_db, n_test=args.n_queries)
        spec = IndexSpec(backend="rpf",
                         forest=ForestConfig(n_trees=args.trees,
                                             capacity=args.capacity,
                                             split_ratio=0.3))
        t0 = time.perf_counter()
        index = build_index(db, spec, device=args.device)
        print(f"[serve] built over {args.n_db} x {db.shape[1]} in "
              f"{time.perf_counter() - t0:.1f}s; {index.stats()}")
        t0 = time.perf_counter()
        tuned = tune(index, queries[:64], target_recall=args.target_recall,
                     k=args.k, metric=metric)
        print(f"[serve] tuned to recall>={args.target_recall} in "
              f"{time.perf_counter() - t0:.1f}s: {_fmt_params(tuned)}")

    # ----------------------------------------------------------- runtime
    runtime = ServingRuntime(index, use_tuned=not args.no_tuned,
                             slo_p99_ms=args.slo_p99_ms,
                             max_batch=args.max_batch,
                             degrade=not args.no_degrade)
    try:
        return _plan_and_serve(args, index, runtime, queries, metric)
    finally:
        runtime.stop()


def _plan_and_serve(args, index, runtime: ServingRuntime,
                    queries: np.ndarray, metric: str) -> dict | list[dict]:
    src = ("explicit-default" if args.no_tuned else
           "per-shard tuned" if index.shard_params else
           "tuned" if index.tuned_params is not None else "default")
    print(f"[serve] operating point ({src}): {_fmt_params(runtime.params)}; "
          f"ladder of {len(runtime.ladder)} rung(s), "
          f"shed depth {runtime.shed_depth}")

    # ------------------------------------------------------------- plan
    model = ServingRuntime.manifest_traffic_model(index)
    if model is None:
        model = runtime.calibrate(np.asarray(queries[:32]))
        print(f"[serve] calibrated: t(b) = {model.c0_s * 1e3:.2f}ms + "
              f"{model.c1_s * 1e3:.4f}ms*b")
    else:
        print("[serve] traffic model from manifest")
    rated = planner.rated_qps(model, args.slo_p99_ms, args.max_batch)
    qps = args.qps or max(rated, 1.0)
    plan = planner.plan(model, qps=qps, slo_p99_ms=args.slo_p99_ms,
                        recall_target=args.target_recall)
    print(f"[serve] plan for {qps:.0f} qps @ p99<={args.slo_p99_ms}ms: "
          f"{plan.n_shards} shard(s) x {plan.n_replicas} replica(s), "
          f"batch {plan.batch}, rated {plan.rated_qps_per_replica:.0f} "
          f"qps/replica, predicted p99 {plan.predicted_p99_ms:.1f}ms")

    if args.save:
        index.serving_plan = {"plan": plan.to_dict(),
                              "traffic_model": model.to_dict()}
        path = index.save(args.save)
        print(f"[serve] manifest -> {path}")

    # ------------------------------------------------- open-loop traffic
    gids, rows = index.live_points()
    true_ids = _true_ids(queries, gids, rows, min(args.k, rows.shape[0]),
                         metric, index.device)

    if args.sweep:
        rates = [float(x) for x in args.sweep.split(",")]
        out = loadgen.sweep(runtime, np.asarray(queries), rates,
                            n_requests=args.requests, true_ids=true_ids)
        for r in out:
            print(f"[sweep] offered {r['offered_qps']:>8.0f} qps -> "
                  f"achieved {r['achieved_qps']:>8.0f}; p50 "
                  f"{r['p50_ms']:.1f}ms p99 {r['p99_ms']:.1f}ms p999 "
                  f"{r['p999_ms']:.1f}ms; shed {r['shed_fraction']:.1%}; "
                  f"recall {r.get('recall_vs_oracle', float('nan')):.3f}")
    else:
        out = r = loadgen.run_open_loop(runtime, np.asarray(queries), qps,
                                        n_requests=args.requests,
                                        true_ids=true_ids)
        ok = r["p99_ms"] <= args.slo_p99_ms
        print(f"[serve] {r['n_ok']}/{r['n_requests']} ok at "
              f"{r['achieved_qps']:.0f} qps; p50 {r['p50_ms']:.1f}ms "
              f"p99 {r['p99_ms']:.1f}ms p999 {r['p999_ms']:.1f}ms "
              f"[{'IN' if ok else 'OUT OF'} SLO]; shed "
              f"{r['shed_fraction']:.1%}; recall "
              f"{r.get('recall_vs_oracle', float('nan')):.3f}")
    stats = {k: v for k, v in runtime.stats().items() if k != "batcher"}
    print(f"[serve] runtime stats: {stats}")

    # the paper's incremental-update path (§5) stays live under serving
    new_id = index.add(np.asarray(queries[0]))
    d, i = index.search(np.asarray(queries[0])[None],
                        SearchParams(k=1, metric=metric))
    print(f"[serve] inserted id {new_id}; self-query -> id "
          f"{int(i[0, 0])} dist {float(d[0, 0]):.2e}")
    return out


if __name__ == "__main__":
    main()
