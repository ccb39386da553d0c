"""Config schema for every architecture family + input-shape cells (a copy
of ``repro/configs/base.py``: plain dataclasses, field for field)."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (input-shape) cell of the dry-run matrix."""

    name: str                    # e.g. "train_4k"
    kind: str                    # train | prefill | decode | serve | retrieval
    # LM shapes
    seq_len: int = 0
    global_batch: int = 0
    # GNN shapes
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    batch_nodes: int = 0
    fanout: tuple[int, ...] = ()
    n_graphs: int = 0
    # RecSys shapes
    batch: int = 0
    n_candidates: int = 0
    skip: bool = False           # inapplicable cell (documented in DESIGN.md)
    skip_reason: str = ""


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1           # 1 = every layer is MoE; 2 = alternate dense/MoE
    shared_expert: bool = False
    capacity_factor: float = 1.25
    # attention pattern
    sliding_window: int = 0      # 0 = all-global
    global_every: int = 0        # gemma3: every 6th layer is global
    attn_shard: str = "heads"    # "heads" | "sequence" (DESIGN.md §3.2)
    attn_impl: str = "dense"     # "dense" | "blockwise" (flash-style)
    kv_block: int = 1024         # blockwise KV tile
    rope_base: float = 10000.0
    norm_eps: float = 1e-6
    logit_softcap: float = 0.0
    tie_embeddings: bool = False
    # numerics / memory
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    fsdp: bool = False           # shard params+opt over dp too (ZeRO-3 analogue)
    expert_fsdp: int = -1        # -1: follow fsdp; 0/1 override for MoE experts
    # (hillclimb: expert weights NOT dp-sharded kill the per-layer weight
    # all-gathers; feasible when paired with factored optimizer states)
    opt: str = "adamw"           # "adamw" | "adafactor"
    moe_gather_quant: bool = False  # int8-compress FSDP expert-weight gathers
    moe_a2a: bool = False        # top-1 all_to_all dispatch (vs gather+psum)
    vocab_pad_to: int = 128
    split_cache: bool = False    # per-window KV cache sizes (hillclimb variant)
    unroll: bool = False         # python-loop layers instead of lax.scan —
    # identical math; used by the roofline dry-run because XLA cost_analysis
    # counts a while-loop body ONCE regardless of trip count

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def layer_windows(self) -> tuple[int, ...]:
        """Per-layer sliding window (0 = global)."""
        if self.sliding_window and self.global_every:
            return tuple(0 if (l + 1) % self.global_every == 0
                         else self.sliding_window
                         for l in range(self.n_layers))
        if self.sliding_window:
            return (self.sliding_window,) * self.n_layers
        return (0,) * self.n_layers

    def param_count(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        attn = d * self.n_heads * self.head_dim * 2 \
            + d * self.n_kv_heads * self.head_dim * 2
        dense_ffn = 3 * d * f
        moe_ffn = self.n_experts * 3 * d * f + d * self.n_experts
        if self.shared_expert:
            moe_ffn += 3 * d * f
        n_moe = self.n_layers // self.moe_every if self.moe else 0
        n_dense = self.n_layers - n_moe
        total = self.n_layers * (attn + 2 * d) \
            + n_dense * dense_ffn + n_moe * moe_ffn + d
        total += v * d * (1 if self.tie_embeddings else 2)
        return total


@dataclasses.dataclass(frozen=True)
class MACEConfig:
    name: str = "mace"
    n_layers: int = 2
    d_hidden: int = 128
    l_max: int = 2
    correlation_order: int = 3
    n_rbf: int = 8
    r_cut: float = 5.0
    n_species: int = 16
    d_feat_in: int = 0           # raw node-attribute dim (projected to species emb)
    param_dtype: str = "float32"
    compute_dtype: str = "float32"  # equivariance is precision-sensitive
    exchange_dtype: str = "float32"  # node-feature all-gather wire dtype
    # ("bfloat16" halves the dominant collective + h_full transient — §Perf)


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str = ""
    model: str = ""              # dlrm | autoint | widedeep | mind
    n_dense: int = 0
    n_sparse: int = 0
    embed_dim: int = 0
    table_sizes: tuple[int, ...] = ()
    multi_hot: int = 1           # ids per sparse field (bag size)
    bot_mlp: tuple[int, ...] = ()
    top_mlp: tuple[int, ...] = ()
    mlp: tuple[int, ...] = ()
    # autoint
    n_attn_layers: int = 0
    n_attn_heads: int = 0
    d_attn: int = 0
    # mind
    n_interests: int = 0
    capsule_iters: int = 0
    hist_len: int = 50
    item_vocab: int = 1_000_000
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    row_pad_to: int = 256        # pad table rows for even tp sharding


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """A registered architecture: config + its shape cells + metadata."""

    arch_id: str
    family: str                  # lm | gnn | recsys
    config: object
    cells: tuple[ShapeCell, ...]
    notes: str = ""
