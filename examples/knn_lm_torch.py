"""kNN-LM on the PyTorch port: augment a small LM's next-token prediction
with the paper's index (the port of ``examples/knn_lm.py``).

  PYTHONPATH=src python examples/knn_lm_torch.py [--device cpu] [--steps 300]

Train a SmolLM-family reduced config on a Markov corpus, memorize (hidden
state -> next token) pairs into an RPF index (``repro_torch.index``), then
interpolate LM logits with the kNN distribution (Khandelwal et al. 2020
applied through Zhong's index).  Neighbor lookup runs under
``metric="cosine"`` and the retrieval is recall-asserted (>= 0.8) against
the exact cosine brute force, so the example is a checked workload.  It
runs on the GPU unless ``--device cpu``.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.base import LMConfig
from repro_torch.core.forest import ForestConfig
from repro_torch.core.knn import exact_knn
from repro_torch.data.lm_data import MarkovTokens
from repro_torch.index import IndexSpec, SearchParams, build_index
from repro_torch.models import transformer as tr
from repro_torch.train.optimizer import adamw, cosine_schedule
from repro_torch.train.train_loop import LoopConfig, train
from repro_torch.train.train_state import init_train_state, make_train_step

CFG = LMConfig(name="smol-smoke", n_layers=4, d_model=96, n_heads=4,
               n_kv_heads=2, head_dim=24, d_ff=256, vocab_size=512,
               tie_embeddings=True, remat=False,
               param_dtype="float32", compute_dtype="float32")


def unit_rows(h: torch.Tensor) -> torch.Tensor:
    """(B, S, D) hidden states -> (B * S, D) f32 rows of unit norm."""
    rows = h.float().reshape(-1, h.shape[-1])
    return rows / (torch.linalg.norm(rows, dim=1, keepdim=True) + 1e-9)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu for the plain PyTorch versions")
    ap.add_argument("--steps", type=int, default=300)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False   # exact_knn's fp32

    data = MarkovTokens(CFG.vocab_size, branch=8, seed=0)
    params = tr.init_lm(torch.Generator(device=dev).manual_seed(0), CFG, dev)
    opt = adamw(cosine_schedule(3e-3, 20, 400))
    state = init_train_state(params, opt)
    step = make_train_step(lambda p, b: tr.loss_fn(p, b, CFG), opt)

    def batches():
        for b in data.batches(16, 64):
            yield {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    state, hist = train(state, step, batches(),
                        LoopConfig(total_steps=args.steps, log_every=100))
    print(f"LM loss {hist['loss'][0]:.3f} -> {hist['loss'][-1]:.3f}")

    # ---- memorize: hidden states -> next tokens --------------------------
    mem = data.sample(64, 64)
    mem_tok, mem_next = mem[:, :-1], mem[:, 1:]
    with torch.no_grad():
        hidden, _ = tr.forward_hidden(state.params,
                                      torch.from_numpy(mem_tok).to(dev), CFG)
    keys = unit_rows(hidden)
    vals = mem_next.reshape(-1)
    index = build_index(keys, IndexSpec(backend="rpf",
                                        forest=ForestConfig(n_trees=40,
                                                            capacity=12),
                                        seed=2), device=dev)

    # ---- evaluate interpolated next-token accuracy ------------------------
    test = data.sample(32, 64)
    t_tok = torch.from_numpy(test[:, :-1]).to(dev)
    t_next = test[:, 1:]
    with torch.no_grad():
        h, _ = tr.forward_hidden(state.params, t_tok, CFG)
        logits, _ = tr.forward(state.params, t_tok, CFG)
    q = unit_rows(h)

    k = 8
    d, ids = index.search(q, SearchParams(k=k, metric="cosine"))
    # retrieval quality gate: the kNN distribution is only as good as the
    # neighbor set, so assert recall vs the exact cosine oracle
    _, bf_ids = exact_knn(q, keys, k, metric="cosine")
    d, ids, bf_ids = (t.cpu().numpy() for t in (d, ids, bf_ids))
    recall = float((ids[:, :, None] == bf_ids[:, None, :]).any(1).mean())
    print(f"kNN recall@{k} vs exact cosine: {recall:.3f}")
    assert recall >= 0.8, f"cosine kNN recall regressed: {recall:.3f} < 0.8"
    knn_next = vals[np.clip(ids, 0, len(vals) - 1)]          # (Q, k)
    w = np.exp(-d * 10.0) * (ids >= 0)
    knn_probs = np.zeros((q.shape[0], CFG.padded_vocab), np.float32)
    for j in range(k):
        np.add.at(knn_probs, (np.arange(q.shape[0]), knn_next[:, j]),
                  w[:, j])
    knn_probs /= knn_probs.sum(1, keepdims=True) + 1e-9

    lm_probs = torch.softmax(logits, dim=-1).cpu().numpy().reshape(
        -1, CFG.padded_vocab)
    truth = t_next.reshape(-1)
    acc = {}
    for lam in (0.0, 0.3, 0.6):
        mix = (1 - lam) * lm_probs + lam * knn_probs
        acc[lam] = float((mix.argmax(1) == truth).mean())
        print(f"lambda={lam:.1f}: next-token acc {acc[lam]:.3f}"
              + ("  (pure LM)" if lam == 0 else ""))
    return {"loss": hist["loss"], "recall": recall, "acc": acc}


if __name__ == "__main__":
    main()
