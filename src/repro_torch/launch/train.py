"""End-to-end training driver (port of ``repro/launch/train.py``), on the
GPU unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch mind \\
      --preset smoke --steps 50

``--preset smoke`` shrinks the arch to a small config of the same
structure (``smoke_lm``, ``smoke_recsys``); ``--preset full`` uses the
registered production config.  Every model trains through
``train/train_loop.train`` with AdamW on a cosine schedule (weight decay
0.01): checkpoint cadence and resume (``--ckpt-every``, ``--ckpt-dir``;
either package's checkpoints), the preemption check and the straggler
watchdog.  The language models (``smollm-135m``, ``gemma3-4b``,
``stablelm-12b``, and the MoE ``granite-moe-1b-a400m`` and
``llama4-maverick-400b-a17b``) train ``models/transformer.loss_fn`` (its
aux term included) on ``MarkovTokens(vocab, seed=0)`` batches of
``--batch`` x ``--seq``; the recommenders (``mind``, ``dlrm-mlperf``,
``autoint``, ``wide-deep``) the reference's BCE, ignoring ``--seq`` as
the reference does; ``mace`` (``d_hidden`` 32 under ``--preset smoke``)
the energy MSE of ``models/mace.mace_fwd`` on the local path over
``batched_molecules(--batch, 12, 32, seed=0)`` with the target
``sin(arange(batch))``, as the reference's.  ``main(argv)`` returns the
loop's history.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import LMConfig, RecsysConfig
from repro_torch.data.graph_data import batched_molecules
from repro_torch.data.lm_data import MarkovTokens
from repro_torch.data.recsys_data import BehaviorStream, CTRStream
from repro_torch.device import resolve_device
from repro_torch.launch.steps import recsys_loss
from repro_torch.models import mace as mace_mod
from repro_torch.models import recsys as rs
from repro_torch.models import transformer as tr
from repro_torch.train.optimizer import adamw, cosine_schedule
from repro_torch.train.train_loop import LoopConfig, train
from repro_torch.train.train_state import init_train_state, make_train_step
from repro_torch.tree import leaves


def smoke_lm(cfg: LMConfig) -> LMConfig:
    """Reduced config of the same family (structure preserved)."""
    return dataclasses.replace(
        cfg, n_layers=max(2, min(4, cfg.n_layers)), d_model=64,
        n_heads=min(cfg.n_heads, 4),
        n_kv_heads=min(cfg.n_kv_heads, 2), head_dim=16, d_ff=128,
        vocab_size=512, n_experts=min(cfg.n_experts, 8) if cfg.moe else 0,
        sliding_window=min(cfg.sliding_window, 8) if cfg.sliding_window else 0,
        global_every=min(cfg.global_every, 2) if cfg.global_every else 0,
        param_dtype="float32", compute_dtype="float32", fsdp=False,
        remat=False)


def smoke_recsys(cfg: RecsysConfig) -> RecsysConfig:
    return dataclasses.replace(
        cfg, table_sizes=tuple(min(s, 1000) for s in cfg.table_sizes),
        item_vocab=min(cfg.item_vocab, 5000) if cfg.item_vocab else 0,
        row_pad_to=8)


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--preset", choices=["smoke", "full"], default="smoke")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--ckpt-every", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="where the model trains (cuda, or cpu for the "
                        "plain PyTorch versions)")
    args = p.parse_args(argv)

    spec = get_arch(args.arch)
    dev = resolve_device(None if args.device == "cuda" else args.device)
    # fp32 products are IEEE fp32, as the reference's
    torch.backends.cuda.matmul.allow_tf32 = False
    opt = adamw(cosine_schedule(args.lr, 10, args.steps), weight_decay=0.01)
    lcfg = LoopConfig(total_steps=args.steps, log_every=10,
                      ckpt_every=args.ckpt_every,
                      ckpt_dir=args.ckpt_dir or os.path.join(
                          tempfile.gettempdir(), f"repro_{args.arch}"))

    generator = torch.Generator(device=dev).manual_seed(0)
    if spec.family == "lm":
        cfg = smoke_lm(spec.config) if args.preset == "smoke" \
            else spec.config
        model = tr.init_lm(generator, cfg, dev)

        def loss_fn(p_, b_):
            return tr.loss_fn(p_, b_, cfg)
        data = MarkovTokens(cfg.vocab_size, seed=0)

        def batches():
            for b in data.batches(args.batch, args.seq):
                yield {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    elif spec.family == "gnn":
        cfg = spec.config if args.preset == "full" else dataclasses.replace(
            spec.config, d_hidden=32)
        model = mace_mod.init_mace(generator, cfg, device=dev)
        mol = batched_molecules(args.batch, 12, 32, seed=0)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in mol.items()
                 if k != "n_graphs"}
        # synthetic energies
        batch["energy"] = torch.from_numpy(np.asarray(
            np.sin(np.arange(args.batch)), np.float32)).to(dev)

        def loss_fn(p_, b_):
            out = mace_mod.mace_fwd(p_, cfg, b_["species"], b_["positions"],
                                    b_["senders"], b_["receivers"],
                                    graph_ids=b_["graph_ids"],
                                    n_graphs=args.batch)
            return torch.mean((out["energy"] - b_["energy"]) ** 2), {}

        def batches():
            while True:
                yield batch
    else:
        cfg = smoke_recsys(spec.config) if args.preset == "smoke" \
            else spec.config
        model = rs.INITS[cfg.model](generator, cfg, dev)
        loss_fn = recsys_loss(cfg)
        if cfg.model == "mind":
            stream = BehaviorStream(cfg.item_vocab, cfg.hist_len, seed=0)
        else:
            stream = CTRStream(cfg.table_sizes, cfg.n_dense, seed=0)

        def batches():
            while True:
                yield {k: torch.from_numpy(v).to(dev)
                       for k, v in stream.batch(args.batch).items()}
    print(f"[train] {args.arch}: "
          f"{sum(x.numel() for x in leaves(model)):,} params on {dev}")
    state = init_train_state(model, opt)
    step = make_train_step(loss_fn, opt)

    state, hist = train(state, step, batches(), lcfg)
    if hist["loss"]:
        print(f"[train] done: loss {hist['loss'][0]:.4f} -> "
              f"{hist['loss'][-1]:.4f} over {len(hist['loss'])} steps; "
              f"stragglers={len(hist['straggler_events'])}")
    return hist


if __name__ == "__main__":
    main()
