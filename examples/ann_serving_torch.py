"""Serving on the PyTorch port: a unified-API index behind a batched service
(the port of ``examples/ann_serving.py``).

  PYTHONPATH=src python examples/ann_serving_torch.py [--device cpu] [--tiny]

Builds the index from an ``IndexSpec``, stands up the dynamic batcher,
fires concurrent requests, then exercises the incremental-update path: an
added point is queryable at once, and a delete with a background
compaction runs while the batcher keeps answering.  ``--tiny`` shrinks the
corpus.  It runs on the GPU unless ``--device cpu``, and raises without
one.
"""
import argparse
import threading
import time

import numpy as np
import torch

from repro_torch.core.forest import ForestConfig
from repro_torch.data.synthetic import mnist_like
from repro_torch.index import IndexSpec, SearchParams
from repro_torch.serve.ann_serve import make_ann_server


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu for the plain PyTorch versions")
    ap.add_argument("--tiny", action="store_true",
                    help="a small corpus (seconds, not minutes)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the "
                           "plain PyTorch versions")

    n, n_clients = (2_000, 32) if args.tiny else (10_000, 128)
    db, _, queries, _ = mnist_like(n=n, n_test=max(n_clients, 32))
    spec = IndexSpec(backend="rpf", seed=0,
                     forest=ForestConfig(n_trees=20 if args.tiny else 40,
                                         capacity=12, split_ratio=0.3))
    index, batcher = make_ann_server(db, spec, k=5, max_batch=64,
                                     max_wait_s=0.01, device=dev)
    print("index:", index.stats())

    # concurrent clients
    results = {}

    def client(j):
        results[j] = batcher(queries[j])

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(j,))
               for j in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    assert len(results) == n_clients, (len(results), n_clients)
    stats = dict(batcher.stats)
    print(f"{n_clients} concurrent requests in {dt * 1e3:.0f} ms; "
          f"batcher: {stats}")

    # incremental update: a novel point becomes queryable at once
    novel = queries[0] * 0.9 + 0.1 * queries[1]
    novel /= np.linalg.norm(novel)
    new_id = index.add(novel)
    d, i = index.search(novel[None], SearchParams(k=1))
    assert int(i[0, 0]) == new_id, (int(i[0, 0]), new_id)
    print(f"inserted point {new_id}: self-query hits it at dist "
          f"{float(d[0, 0]):.2e}")

    # mutate WHILE serving: delete + background compaction; the batcher's
    # thread keeps answering from the published immutable view
    index.delete(new_id)
    t = index.compact(block=False)
    d, i = batcher(novel)                       # served mid-rebuild
    assert int(i[0]) != new_id, "tombstoned id surfaced while compacting"
    t.join()
    st = index.stats()
    print(f"deleted {new_id} + compacted in the background while serving: "
          f"{st['n_live']} live rows, {st['n_segments']} segment(s), "
          f"{st['n_compactions']} compaction(s)")
    batcher.stop()
    return {"clients": n_clients, "wall_ms": dt * 1e3, "batcher": stats,
            "new_id": new_id, "stats": st}


if __name__ == "__main__":
    main()
