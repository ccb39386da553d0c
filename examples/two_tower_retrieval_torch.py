"""Train a two-tower retrieval model on the PyTorch port, index the item
tower with the paper's RPF, and serve retrieval -- the train -> index ->
serve pipeline (the port of ``examples/two_tower_retrieval.py``).

  PYTHONPATH=src python examples/two_tower_retrieval_torch.py [--device cpu] [--users N] [--items N] [--steps N]

Steps:
  1. train a two-tower model with in-batch softmax on synthetic
     interactions (users like items of their taste cluster),
  2. encode the item catalog, build the RPF index over the unit item
     embeddings,
  3. serve user queries through the index with ``metric="ip"`` (maximum
     inner product, the two-tower score) and ASSERT recall@20 >= 0.8
     against the exact-MIPS brute force, so this example is a checked
     workload.
The sizes default to the reference's: 2,000 users, 20,000 items, 200
steps.  It runs on the GPU unless ``--device cpu``, and raises without one.
"""
import argparse

import numpy as np
import torch

from repro_torch.core.forest import ForestConfig
from repro_torch.core.knn import exact_knn
from repro_torch.index import IndexSpec, SearchParams, build_index
from repro_torch.models import recsys as rs
from repro_torch.train.optimizer import adamw, cosine_schedule
from repro_torch.train.train_loop import LoopConfig, train
from repro_torch.train.train_state import init_train_state, make_train_step

D = 64
N_TASTES = 32


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu for the plain PyTorch versions")
    ap.add_argument("--users", type=int, default=2000)
    ap.add_argument("--items", type=int, default=20_000)
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the "
                           "plain PyTorch versions")
    torch.backends.cuda.matmul.allow_tf32 = False   # exact_knn's fp32
    n_users, n_items = args.users, args.items

    rng = np.random.default_rng(0)
    # planted taste structure: users like items in their cluster
    user_taste = rng.integers(0, N_TASTES, n_users)
    item_taste = rng.integers(0, N_TASTES, n_items)
    taste_items = [np.where(item_taste == t)[0] for t in range(N_TASTES)]

    def batches(bs=256):
        while True:
            u = rng.integers(0, n_users, bs)
            i = np.array([rng.choice(taste_items[user_taste[uu]])
                          for uu in u])
            yield (torch.from_numpy(u).to(dev), torch.from_numpy(i).to(dev))

    params = rs.init_two_tower(torch.Generator(device=dev).manual_seed(0),
                               n_users, n_items, d=D, device=dev)
    opt = adamw(cosine_schedule(3e-3, 20, 300), weight_decay=1e-4)
    state = init_train_state(params, opt)

    def lf(p, b):
        return rs.two_tower_loss(p, b[0], b[1]), {}

    step = make_train_step(lf, opt)
    state, hist = train(state, step, batches(),
                        LoopConfig(total_steps=args.steps, log_every=50))
    print(f"two-tower loss {hist['loss'][0]:.3f} -> {hist['loss'][-1]:.3f}")

    # ---- encode catalog + build the paper's index (unified API) ----------
    with torch.no_grad():
        item_emb = rs.two_tower_item(state.params,
                                     torch.arange(n_items, device=dev))
        item_emb = item_emb / torch.linalg.norm(item_emb, dim=1,
                                                keepdim=True)
        users = torch.arange(64, device=dev)
        u_emb = rs.two_tower_user(state.params, users)
        u_emb = u_emb / torch.linalg.norm(u_emb, dim=1, keepdim=True)
    cfg = ForestConfig(n_trees=60, capacity=16, split_ratio=0.3)
    index = build_index(item_emb, IndexSpec(backend="rpf", forest=cfg,
                                            seed=1), device=dev)

    # ---- retrieve for a user batch (MIPS: the model scores by u . i) -----
    _, rpf_ids = index.search(u_emb, SearchParams(k=20, metric="ip",
                                                  n_probes=8))
    _, bf_ids = exact_knn(u_emb, item_emb, k=20, metric="ip")
    rpf_ids, bf_ids = rpf_ids.cpu().numpy(), bf_ids.cpu().numpy()
    recall = float((rpf_ids[:, :, None] == bf_ids[:, None, :]).any(1).mean())
    touched = 8 * cfg.n_trees * cfg.resolved(n_items).leaf_pad
    print(f"RPF retrieval recall@20 vs exact MIPS: {recall:.3f} "
          f"(touching <= {touched}/{n_items} items/query)")
    assert recall >= 0.8, f"ip retrieval recall regressed: {recall:.3f} < 0.8"
    # taste-consistency: retrieved items should share the user's taste
    taste_hit = float((item_taste[rpf_ids[:, 0]]
                       == user_taste[:64]).mean())
    print(f"top-1 item matches user taste for {taste_hit * 100:.0f}% of users")
    return {"loss": hist["loss"], "recall": recall, "taste_hit": taste_hit,
            "touched": touched}


if __name__ == "__main__":
    main()
