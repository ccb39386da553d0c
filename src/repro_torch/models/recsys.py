"""RecSys models (port of ``repro/models/recsys.py``): DLRM, AutoInt,
Wide&Deep, MIND (+ two-tower retrieval).

Each model is an ``nn.Module`` built from the reference's params tree: its
parameters carry the tree's names (``tables.3``, ``bot_mlp.0.w``,
``item_embed``), ``param_tree`` gives the nested dicts and lists back, and
``convert.recsys_from_numpy`` builds a module from the reference's arrays.
The reference's functions keep their names and arguments, with the module
in the place of the params dict: ``init_*`` draw from an explicit
``torch.Generator`` on ``device`` (the GPU unless ``device="cpu"``; on
``"meta"`` they allocate nothing), ``*_fwd`` are the forward passes, and
each module's ``forward`` calls its function.  Every product stays in f32.

Gathers follow the reference's rule (``take_rows``): an id below 0 wraps
once by the table's rows, then every id is clamped into the table, as
``table[ids]`` under jit reads; its gradient drops every id the forward
clamped, as the reference's scatter does.  ``embedding_bag`` is kernel H
(``kernels/ops.embedding_bag``); H reads id -1 as "no row", so ids pass
through the same rule first, and its backward is plain PyTorch.

The reference's ``*_specs`` and ``table_specs`` give the spec trees
(``models/layers.P``) that place the models over a mesh: tables of 16,384
rows or more row-split over tp, the widest MLP layers' columns over tp.
On a DTensor table (a cell on a ``DeviceMesh``) ``take_rows`` and
``embedding_bag`` are vocab-parallel, written by hand since DTensor has
no rule for the port's own ops (``_sharded_rows``): the ids are gathered
over the mesh axes the table's rows are split over, each rank takes the
ids in its rows through kernel H over its shard with the ids rebased (an
id outside the shard is H's "no row", -1, and adds nothing; a gather is a
bag of one row at weight 1), and the partial rows are summed over those
axes; the backward is the transpose, each rank scattering the cotangent
into its own rows.  Ids clamp as ``take_rows``'s rule says, on the
table's global row count.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import RecsysConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.layers import (P, dense_init, is_dtensor, normal,
                                       row_split_gather)
from repro_torch.tree import module_tree

F32 = torch.float32


def _pad_rows(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def _device(device) -> torch.device:
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


# ---------------------------------------------------------------------------
# parameters as the reference's tree
# ---------------------------------------------------------------------------


class Leaves(nn.Module):
    """A dict of tensors as named parameters (``{"w": ..., "b": ...}``)."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            setattr(self, name, nn.Parameter(value))


class MLP(nn.ModuleList):
    """The reference's ``[{"w", "b"}, ...]`` layers: ``x @ w + b``, ReLU
    between layers (and after the last with ``final_act``)."""

    def __init__(self, layers: list):
        super().__init__(Leaves(layer) for layer in layers)

    def forward(self, x: torch.Tensor, final_act: bool = False
                ) -> torch.Tensor:
        for i, layer in enumerate(self):
            x = x @ layer.w + layer.b
            if i < len(self) - 1 or final_act:
                x = torch.relu(x)
        return x


def param_tree(model: nn.Module) -> dict:
    """The reference's params tree of ``model``: nested dicts (and lists
    where the names are 0, 1, ...) of its parameters."""
    return module_tree(model)


def _mlp_specs(dims: tuple[int, ...], shard_wide: Optional[str]) -> list:
    """Shard the widest layers' columns (512 or more) over ``shard_wide``;
    keep small ones replicated."""
    out = []
    for i in range(len(dims) - 1):
        big = shard_wide is not None and dims[i + 1] >= 512
        out.append({"w": P(None, shard_wide if big else None), "b": P(None)})
    return out


def _mlp_init(generator, dims: tuple[int, ...], device: torch.device) -> list:
    return [{"w": dense_init(generator, dims[i], dims[i + 1], F32,
                             device=device),
             "b": torch.zeros((dims[i + 1],), dtype=F32, device=device)}
            for i in range(len(dims) - 1)]


# ---------------------------------------------------------------------------
# gathers and the bag
# ---------------------------------------------------------------------------


def gather_index(ids: torch.Tensor, n_rows: int) -> torch.Tensor:
    """int64 row indices of ``ids`` under the reference's gather rule: a
    negative id wraps once by ``n_rows``, then all clamp to [0, n_rows)."""
    ids = ids.long()
    return torch.where(ids < 0, ids + n_rows, ids).clamp_(0, n_rows - 1)


def gather_kept(ids: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Whether each id's gradient reaches its row: the reference's gather
    transposes to a scatter that drops every id the forward clamped (past
    the table, or below ``-n_rows``); an id that wrapped into range keeps
    it."""
    return (ids >= -n_rows) & (ids < n_rows)


def _scatter_rows(n_rows: int, idx: torch.Tensor, kept: torch.Tensor,
                  g: torch.Tensor) -> torch.Tensor:
    """(n_rows, D) sum of the rows ``g`` (idx.shape + (D,)) into ``idx``
    where ``kept`` (elsewhere a zero is added, which leaves the sum's bits
    alone).  The sum is ``nn.Embedding``'s backward: it sorts the ids and
    sums each id's run in parallel pieces, where ``index_put_``'s
    accumulate walks a run one row at a time, which serializes on the
    skewed ids of ``CTRStream`` (a quarter of a field's ids are its row 0)."""
    g = torch.where(kept[..., None], g, 0)
    return torch.ops.aten.embedding_dense_backward(g, idx, n_rows, -1, False)


class _TakeRows(torch.autograd.Function):
    """``table[idx]``, whose backward drops the ids the forward clamped."""

    @staticmethod
    def forward(ctx, table, idx, kept):
        ctx.save_for_backward(idx, kept)
        ctx.n_rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        idx, kept = ctx.saved_tensors
        return _scatter_rows(ctx.n_rows, idx, kept, g), None, None


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` as the reference reads it (``gather_index``) and
    differentiates it: the table's gradient takes no part from an id the
    forward clamped (``gather_kept``).  A DTensor table takes the
    vocab-parallel path (``_sharded_rows``)."""
    if is_dtensor(table):
        return _sharded_rows(table, ids, None)
    n = table.shape[0]
    if not (table.requires_grad and torch.is_grad_enabled()):
        return table[gather_index(ids, n)]
    return _TakeRows.apply(table, gather_index(ids, n), gather_kept(ids, n))


class _Bag(torch.autograd.Function):
    """Kernel H's forward (its plain version on the CPU) with the backward
    of the reference's take + weighted sum, which has no Pallas backward:
    XLA differentiates it.  So the backward is plain PyTorch on every
    device: the table's gradient adds ``w[b, h] g[b]`` into row
    ``idx[b, h]`` where the id is kept, the weights' is ``<g[b],
    table[idx[b, h]]>``."""

    @staticmethod
    def forward(ctx, table, idx, kept, weights):
        ctx.save_for_backward(table, idx, kept, weights)
        return ops.embedding_bag(idx.int(), weights.contiguous(),
                                 table.contiguous())

    @staticmethod
    def backward(ctx, g):
        table, idx, kept, weights = ctx.saved_tensors
        d_table = d_w = None
        if ctx.needs_input_grad[0]:
            d_table = _scatter_rows(table.shape[0], idx, kept,
                                    weights[..., None] * g[:, None, :])
        if ctx.needs_input_grad[3]:
            d_w = torch.einsum("bhd,bd->bh", table[idx], g)
        return d_table, None, None, d_w


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """take + weighted segment-sum bag. ids (B, H) -> (B, D), kernel H
    (weights of 1 where none are given), differentiable in the table and
    the weights under ``take_rows``'s rule."""
    if is_dtensor(table):
        return _sharded_rows(table, ids, weights, bag=True)
    n = table.shape[0]
    if weights is None:
        weights = torch.ones(ids.shape, dtype=F32, device=ids.device)
    return _Bag.apply(table.float(), gather_index(ids, n),
                      gather_kept(ids, n), weights.float())


class _ShardRows(torch.autograd.Function):
    """Kernel H over this rank's rows of a row-split table: ``idx`` (B,
    H) local rows, -1 where an id is not in the shard (H's "no row");
    ``weights`` (B, H); out (B, D).  Backward: the cotangent times the
    weights scattered into the rows where ``kept`` (in the shard and not
    clamped)."""

    @staticmethod
    def forward(ctx, table, idx, kept, weights):
        ctx.save_for_backward(idx.clamp(min=0), kept, weights)
        ctx.n_rows = table.shape[0]
        return ops.embedding_bag(idx.int(), weights.contiguous(),
                                 table.contiguous())

    @staticmethod
    def backward(ctx, g):
        idx, kept, weights = ctx.saved_tensors
        d_table = _scatter_rows(ctx.n_rows, idx, kept,
                                weights[..., None] * g[:, None, :])
        return d_table, None, None, None


def _sharded_rows(table, ids, weights, bag: bool = False):
    """The vocab-parallel ``take_rows`` (``bag`` False: (*ids.shape, D))
    or ``embedding_bag`` ((B, D)) of the DTensor ``table``: kernel H over
    this rank's rows (``row_split_gather``)."""
    if weights is not None and weights.requires_grad:
        raise NotImplementedError("the sharded bag takes no gradient in "
                                  "its weights")
    n = table.shape[0]

    def local(tab, lo, ids_loc, w_loc):
        idx = gather_index(ids_loc, n)
        mine = (idx >= lo) & (idx < lo + tab.shape[0])
        kept = gather_kept(ids_loc, n) & mine
        local_idx = torch.where(mine, idx - lo, -1)
        w = mine.to(F32) if w_loc is None else w_loc.float() * mine
        if bag:
            return _ShardRows.apply(tab.float(), local_idx, kept, w)
        flat = _ShardRows.apply(tab.float(), local_idx.reshape(-1, 1),
                                kept.reshape(-1, 1), w.reshape(-1, 1))
        return flat.reshape(tuple(ids_loc.shape) + (flat.shape[-1],))

    return row_split_gather(table, ids, local, weights, bag)


def table_specs(cfg: RecsysConfig, axes) -> list:
    """Row-shard big tables over tp; replicate small ones (< 16k rows)."""
    return [P(axes.tp, None) if v >= 16384 else P(None, None)
            for v in cfg.table_sizes]


def dlrm_specs(cfg: RecsysConfig, axes) -> dict:
    return {
        "tables": table_specs(cfg, axes),
        "bot_mlp": _mlp_specs((cfg.n_dense,) + cfg.bot_mlp, axes.tp),
        "top_mlp": _mlp_specs((_dlrm_top_in(cfg),) + cfg.top_mlp, axes.tp),
    }


def autoint_specs(cfg: RecsysConfig, axes) -> dict:
    layer = {"wq": P(None, None), "wk": P(None, None), "wv": P(None, None),
             "wo": P(None, None), "res": P(None, None)}
    return {"tables": table_specs(cfg, axes),
            "attn": [dict(layer) for _ in range(cfg.n_attn_layers)],
            "out_w": P(None, None)}


def widedeep_specs(cfg: RecsysConfig, axes) -> dict:
    return {
        "tables": table_specs(cfg, axes),
        "wide_tables": table_specs(cfg, axes),
        "deep_mlp": _mlp_specs((cfg.n_sparse * cfg.embed_dim,) + cfg.mlp
                               + (1,), axes.tp),
    }


def mind_specs(cfg: RecsysConfig, axes) -> dict:
    return {"item_embed": P(axes.tp, None), "bilinear": P(None, None),
            "out_mlp": _mlp_specs((cfg.embed_dim, 4 * cfg.embed_dim,
                                   cfg.embed_dim), None)}


def init_tables(generator, cfg: RecsysConfig, device=None) -> list:
    dev = _device(device)
    out = []
    for v in cfg.table_sizes:
        t = normal(generator, (_pad_rows(v, cfg.row_pad_to), cfg.embed_dim),
                   dev)
        out.append(t.div_(math.sqrt(cfg.embed_dim)))
    return out


# ---------------------------------------------------------------------------
# DLRM (arXiv:1906.00091, MLPerf config)
# ---------------------------------------------------------------------------


class DLRM(nn.Module):
    def __init__(self, cfg: RecsysConfig, tree: dict):
        super().__init__()
        self.cfg = cfg
        self.tables = nn.ParameterList(tree["tables"])
        self.bot_mlp = MLP(tree["bot_mlp"])
        self.top_mlp = MLP(tree["top_mlp"])

    def forward(self, dense, sparse_ids):
        return dlrm_fwd(self, dense, sparse_ids)


def _dlrm_top_in(cfg: RecsysConfig) -> int:
    f = cfg.n_sparse + 1
    return f * (f - 1) // 2 + cfg.embed_dim


def init_dlrm(generator, cfg: RecsysConfig, device=None) -> DLRM:
    dev = _device(device)
    return DLRM(cfg, {
        "tables": init_tables(generator, cfg, dev),
        "bot_mlp": _mlp_init(generator, (cfg.n_dense,) + cfg.bot_mlp, dev),
        "top_mlp": _mlp_init(generator, (_dlrm_top_in(cfg),) + cfg.top_mlp,
                             dev),
    })


def dlrm_fwd(params: DLRM, dense: torch.Tensor, sparse_ids: torch.Tensor
             ) -> torch.Tensor:
    """dense (B, n_dense), sparse_ids (B, n_sparse) -> logits (B,)."""
    x0 = params.bot_mlp(dense, final_act=True)                 # (B, D)
    embs = [take_rows(t, sparse_ids[:, i])
            for i, t in enumerate(params.tables)]
    z = torch.stack([x0] + embs, dim=1)                        # (B, F, D)
    g = torch.einsum("bfd,bgd->bfg", z, z)                     # pairwise dots
    f = z.shape[1]
    iu, ju = torch.triu_indices(f, f, 1, device=z.device)      # row-major
    inter = g[:, iu, ju]                                       # (B, F(F-1)/2)
    top_in = torch.cat([x0, inter], dim=1)
    return params.top_mlp(top_in)[:, 0]


# ---------------------------------------------------------------------------
# AutoInt (arXiv:1810.11921)
# ---------------------------------------------------------------------------


class AutoInt(nn.Module):
    def __init__(self, cfg: RecsysConfig, tree: dict):
        super().__init__()
        self.cfg = cfg
        self.tables = nn.ParameterList(tree["tables"])
        self.attn = nn.ModuleList(Leaves(layer) for layer in tree["attn"])
        self.out_w = nn.Parameter(tree["out_w"])

    def forward(self, sparse_ids):
        return autoint_fwd(self, sparse_ids)


def init_autoint(generator, cfg: RecsysConfig, device=None) -> AutoInt:
    dev = _device(device)
    d_attn, heads = cfg.d_attn, cfg.n_attn_heads
    layers = []
    for i in range(cfg.n_attn_layers):
        d_in = cfg.embed_dim if i == 0 else d_attn
        layers.append({
            "wq": dense_init(generator, d_in, heads * d_attn, F32, device=dev),
            "wk": dense_init(generator, d_in, heads * d_attn, F32, device=dev),
            "wv": dense_init(generator, d_in, heads * d_attn, F32, device=dev),
            "wo": dense_init(generator, heads * d_attn, d_attn, F32,
                             device=dev),
            "res": dense_init(generator, d_in, d_attn, F32, device=dev),
        })
    return AutoInt(cfg, {
        "tables": init_tables(generator, cfg, dev),
        "attn": layers,
        "out_w": dense_init(generator, cfg.n_sparse * d_attn, 1, F32,
                            device=dev),
    })


def autoint_fwd(params: AutoInt, sparse_ids: torch.Tensor) -> torch.Tensor:
    """sparse_ids (B, F) -> logits (B,)."""
    x = torch.stack([take_rows(t, sparse_ids[:, i])
                     for i, t in enumerate(params.tables)], dim=1)  # (B,F,D)
    for h in params.attn:
        b, f, _ = x.shape
        d_attn = h.wo.shape[1]
        heads = h.wq.shape[1] // d_attn
        q = (x @ h.wq).reshape(b, f, heads, d_attn)
        k = (x @ h.wk).reshape(b, f, heads, d_attn)
        v = (x @ h.wv).reshape(b, f, heads, d_attn)
        scores = torch.einsum("bfhd,bghd->bhfg", q, k) / math.sqrt(d_attn)
        probs = torch.softmax(scores, dim=-1)
        o = torch.einsum("bhfg,bghd->bfhd", probs, v).reshape(b, f, -1)
        x = torch.relu(o @ h.wo + x @ h.res)
    return (x.reshape(x.shape[0], -1) @ params.out_w)[:, 0]


# ---------------------------------------------------------------------------
# Wide & Deep (arXiv:1606.07792)
# ---------------------------------------------------------------------------


class WideDeep(nn.Module):
    def __init__(self, cfg: RecsysConfig, tree: dict):
        super().__init__()
        self.cfg = cfg
        self.tables = nn.ParameterList(tree["tables"])
        self.wide_tables = nn.ParameterList(tree["wide_tables"])
        self.deep_mlp = MLP(tree["deep_mlp"])

    def forward(self, sparse_ids):
        return widedeep_fwd(self, sparse_ids)


def init_widedeep(generator, cfg: RecsysConfig, device=None) -> WideDeep:
    dev = _device(device)
    wide_cfg = RecsysConfig(**{**cfg.__dict__, "embed_dim": 1})
    return WideDeep(cfg, {
        "tables": init_tables(generator, cfg, dev),
        "wide_tables": init_tables(generator, wide_cfg, dev),
        "deep_mlp": _mlp_init(generator, (cfg.n_sparse * cfg.embed_dim,)
                              + cfg.mlp + (1,), dev),
    })


def widedeep_fwd(params: WideDeep, sparse_ids: torch.Tensor) -> torch.Tensor:
    embs = torch.cat([take_rows(t, sparse_ids[:, i])
                      for i, t in enumerate(params.tables)], dim=1)
    deep = params.deep_mlp(embs)[:, 0]
    wide = sum(take_rows(t, sparse_ids[:, i])[:, 0]
               for i, t in enumerate(params.wide_tables))
    return deep + wide


# ---------------------------------------------------------------------------
# MIND: multi-interest capsule routing (arXiv:1904.08030)
# ---------------------------------------------------------------------------


class MIND(nn.Module):
    def __init__(self, cfg: RecsysConfig, tree: dict):
        super().__init__()
        self.cfg = cfg
        self.item_embed = nn.Parameter(tree["item_embed"])
        self.bilinear = nn.Parameter(tree["bilinear"])
        self.out_mlp = MLP(tree["out_mlp"])

    def forward(self, hist_ids, target_ids, hist_mask=None):
        return mind_train_logits(self, self.cfg, hist_ids, target_ids,
                                 hist_mask)


def init_mind(generator, cfg: RecsysConfig, device=None) -> MIND:
    dev = _device(device)
    d = cfg.embed_dim
    item = normal(generator, (_pad_rows(cfg.item_vocab, cfg.row_pad_to), d),
                  dev)
    return MIND(cfg, {
        "item_embed": item.div_(math.sqrt(d)),
        "bilinear": dense_init(generator, d, d, F32, device=dev),  # B2I S
        "out_mlp": _mlp_init(generator, (d, 4 * d, d), dev),
    })


def _squash(s: torch.Tensor) -> torch.Tensor:
    n2 = torch.sum(s * s, dim=-1, keepdim=True)
    return (n2 / (1.0 + n2)) * s / torch.sqrt(n2 + 1e-9)


def mind_user_fwd(params: MIND, cfg: RecsysConfig, hist_ids: torch.Tensor,
                  hist_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Behavior-to-Interest dynamic routing. hist_ids (B, H) -> (B, K, D)."""
    u = take_rows(params.item_embed, hist_ids) @ params.bilinear  # (B, H, D)
    if hist_mask is None:
        hist_mask = torch.ones(hist_ids.shape, dtype=u.dtype, device=u.device)
    b, h, _ = u.shape
    # fixed (shared) routing-logit init, as in the paper's shared-B variant
    blog = torch.zeros((b, cfg.n_interests, h), dtype=u.dtype,
                       device=u.device)
    v = None
    for _ in range(cfg.capsule_iters):
        c = torch.softmax(blog, dim=1) * hist_mask[:, None, :]
        s = torch.einsum("bkh,bhd->bkd", c, u)
        v = _squash(s)
        blog = blog + torch.einsum("bkd,bhd->bkh", v, u)
    # H-layer MLP with residual (paper: one ReLU layer per interest)
    return v + params.out_mlp(v)


def mind_train_logits(params: MIND, cfg: RecsysConfig,
                      hist_ids: torch.Tensor, target_ids: torch.Tensor,
                      hist_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Label-aware attention (pow=2) over interests -> logit vs target item."""
    interests = mind_user_fwd(params, cfg, hist_ids, hist_mask)  # (B, K, D)
    tgt = take_rows(params.item_embed, target_ids)               # (B, D)
    att = torch.softmax(
        torch.einsum("bkd,bd->bk", interests, tgt) ** 2, dim=-1)
    user = torch.einsum("bk,bkd->bd", att, interests)
    return torch.sum(user * tgt, dim=-1)


def mind_score_candidates(params: MIND, cfg: RecsysConfig,
                          hist_ids: torch.Tensor, cand: torch.Tensor,
                          hist_mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Retrieval scoring: max over interests of interest . candidate.

    cand (N, D) -> scores (B, N). The brute-force path; the index's version
    is ``launch/steps.py``'s ``rpf=1`` retrieval.
    """
    interests = mind_user_fwd(params, cfg, hist_ids, hist_mask)  # (B, K, D)
    scores = torch.einsum("bkd,nd->bkn", interests, cand)
    return torch.amax(scores, dim=1)


# ---------------------------------------------------------------------------
# two-tower retrieval (substrate for the paper-integration example)
# ---------------------------------------------------------------------------


class TwoTower(nn.Module):
    def __init__(self, tree: dict):
        super().__init__()
        self.user_embed = nn.Parameter(tree["user_embed"])
        self.item_embed = nn.Parameter(tree["item_embed"])
        self.user_mlp = MLP(tree["user_mlp"])
        self.item_mlp = MLP(tree["item_mlp"])

    def forward(self, user_ids, item_ids):
        return two_tower_loss(self, user_ids, item_ids)


def init_two_tower(generator, n_users: int, n_items: int, d: int = 64,
                   hidden: int = 256, device=None) -> TwoTower:
    dev = _device(device)
    return TwoTower({
        "user_embed": normal(generator, (n_users, d), dev).div_(math.sqrt(d)),
        "item_embed": normal(generator, (n_items, d), dev).div_(math.sqrt(d)),
        "user_mlp": _mlp_init(generator, (d, hidden, d), dev),
        "item_mlp": _mlp_init(generator, (d, hidden, d), dev),
    })


def two_tower_user(params: TwoTower, user_ids: torch.Tensor) -> torch.Tensor:
    return params.user_mlp(take_rows(params.user_embed, user_ids))


def two_tower_item(params: TwoTower, item_ids: torch.Tensor) -> torch.Tensor:
    return params.item_mlp(take_rows(params.item_embed, item_ids))


def two_tower_loss(params: TwoTower, user_ids: torch.Tensor,
                   item_ids: torch.Tensor) -> torch.Tensor:
    """In-batch sampled softmax (the standard two-tower objective)."""
    u = two_tower_user(params, user_ids)
    v = two_tower_item(params, item_ids)
    logits = u @ v.T
    labels = torch.arange(u.shape[0], device=u.device)
    return torch.mean(-torch.log_softmax(logits, dim=-1)[labels, labels])


MODELS = {"dlrm": DLRM, "autoint": AutoInt, "widedeep": WideDeep,
          "mind": MIND}
INITS = {"dlrm": init_dlrm, "autoint": init_autoint,
         "widedeep": init_widedeep, "mind": init_mind}
