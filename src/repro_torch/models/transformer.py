"""Decoder-only transformer LM: dense / MoE / interleaved (port of
``repro/models/transformer.py``).

Structure modes (static, derived from the config), as the reference's:
  * "dense"     -- n_layers of (attn + SwiGLU FFN);
  * "moe"       -- n_layers of (attn + MoE FFN)              (granite);
  * "dense_moe" -- n_layers / 2 groups of [dense, moe]       (llama4).

The model is an ``nn.Module`` (``LM``) built from the reference's params
tree, whose parameters carry the tree's names (``embed``,
``layers.attn.wq``, ``final_norm``, ``unembed``): ``repro_torch.tree``
reads it as that tree, so weights, train states and checkpoints cross
packages by name, and ``convert.lm_from_numpy`` builds one from the
reference's arrays.  Every layer leaf is stacked along axis 0, as
``(n_layers, ...)``, as the reference's scan over layers stacks it; a pass
splits each stacked leaf once (``torch.unbind``, whose backward is one
stack) and runs the layers in a Python loop, the reference's ``unroll``
branch; a ``dense_moe`` group's leaves are stacked as ``(n_layers // 2,
...)`` under ``layers/dense`` and ``layers/moe``.  The functions keep the
reference's names and arguments, with the model (or its params tree) in
the place of the params dict.  ``lm_param_specs`` and ``cache_specs`` are
the reference's spec trees (``models/layers.P``); ``axes`` constrains the
residual stream (``_act_spec``, degrading where B or S does not divide)
and the logits where the reference does, which on DTensors (a
``DeviceMesh`` in ``axes``) redistributes them and on plain tensors does
nothing.  An ``axes`` with a mesh routes an MoE block's tokens as the
reference's does: ``models/moe.moe_fwd_a2a`` under ``cfg.moe_a2a`` at
top-1 when the tokens divide dp x tp, else ``moe_fwd_sharded`` when they
divide dp, else the local ``moe_fwd``; the LM cells pass their mesh on a
``DeviceMesh`` and none on the one-card ``Mesh((1, 1))``, where they run
``moe_fwd``.

Numerics follow the reference: each block's parameters are cast to the
compute dtype (``_cast``), norms compute in f32, attention scores are f32
(``models/attention``), the logits are the compute dtype's product upcast
to f32.  ``cfg.remat`` checkpoints each block (and ``chunked_cross_entropy``
each chunk) with ``torch.utils.checkpoint`` when a gradient is taken; an
MoE block's checkpoint returns its aux loss too, so the loss's aux term
keeps its gradient.  ``forward_hidden`` returns the sum of the MoE
layers' aux losses (0 for the dense structure).  A decode or prefill
writes the KV cache in place and returns it; a ``dense_moe`` group ``g``
writes layer ``2g`` (dense) and ``2g + 1`` (MoE) of the ``(n_layers,
...)`` cache.  An MoE layer's capacity depends on the tokens of the call,
so a prefill, a decode step and ``forward`` agree only at a capacity that
drops no token, as the reference's do.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import (Axes, P, constrain, dtype_of,
                                       grad_whole, is_dtensor, label_logits,
                                       logsumexp_last, mesh_sizes,
                                       normal, rms_norm, row_split_gather,
                                       softmax_cross_entropy, upcast,
                                       whole)
from repro_torch.tree import flatten_with_names, module_tree, tree_map, unflatten

F32 = torch.float32


def structure(cfg: LMConfig) -> str:
    if cfg.moe and cfg.moe_every == 2:
        return "dense_moe"
    if cfg.moe:
        return "moe"
    return "dense"


def _constrain(x, axes: Optional[Axes], spec: P):
    if axes is None:
        return x
    return constrain(x, spec)


def _device(device) -> torch.device:
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


# ---------------------------------------------------------------------------
# the model: the reference's params tree as named parameters
# ---------------------------------------------------------------------------


class _Node(nn.Module):
    """A dict of tensors and dicts as nested modules and parameters."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                setattr(self, name, _Node(value))
            else:
                setattr(self, name, nn.Parameter(value))


class LM(_Node):
    """The LM's parameters: ``embed`` (Vpad, D), ``layers`` (each leaf
    (n_layers, ...); for ``dense_moe`` ``layers/dense`` and ``layers/moe``,
    each (n_layers // 2, ...)), ``final_norm`` (D,) and, untied,
    ``unembed`` (D, Vpad).  ``forward(tokens)`` is ``forward(self, tokens,
    cfg)``."""

    def __init__(self, cfg: LMConfig, tree: dict):
        super().__init__(tree)
        self.cfg = cfg

    def forward(self, tokens: torch.Tensor):
        return forward(self, tokens, self.cfg)


def _tree(params) -> dict:
    return module_tree(params) if isinstance(params, nn.Module) else params


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_dense_block(generator, cfg: LMConfig, dtype, device,
                      lead: tuple[int, ...] = ()) -> dict:
    def dense(d_in, d_out):
        return normal(generator, lead + (d_in, d_out), device).mul_(
            1.0 / math.sqrt(d_in)).to(dtype)

    return {
        "ln1": torch.zeros(lead + (cfg.d_model,), dtype=dtype, device=device),
        "attn": attn_mod.init_attention(generator, cfg.d_model, cfg.n_heads,
                                        cfg.n_kv_heads, cfg.head_dim, dtype,
                                        device, lead),
        "ln2": torch.zeros(lead + (cfg.d_model,), dtype=dtype, device=device),
        "ffn": {
            "w_gate": dense(cfg.d_model, cfg.d_ff),
            "w_up": dense(cfg.d_model, cfg.d_ff),
            "w_down": dense(cfg.d_ff, cfg.d_model),
        },
    }


def _init_moe_block(generator, cfg: LMConfig, dtype, device,
                    lead: tuple[int, ...] = ()) -> dict:
    return {
        "ln1": torch.zeros(lead + (cfg.d_model,), dtype=dtype, device=device),
        "attn": attn_mod.init_attention(generator, cfg.d_model, cfg.n_heads,
                                        cfg.n_kv_heads, cfg.head_dim, dtype,
                                        device, lead),
        "ln2": torch.zeros(lead + (cfg.d_model,), dtype=dtype, device=device),
        "moe": moe_mod.init_moe(generator, cfg.d_model, cfg.d_ff,
                                cfg.n_experts, dtype, cfg.shared_expert,
                                device, lead),
    }


def init_lm(generator: torch.Generator | None, cfg: LMConfig,
            device=None) -> LM:
    """The model drawn from ``generator`` on ``device`` (the GPU unless
    ``device="cpu"``; ``"meta"`` allocates nothing): the reference's
    distributions (dense weights N(0, 1/d_in), the embedding and the
    unembedding N(0, 0.02^2), norms 0, an MoE layer's router f32) in
    ``cfg.param_dtype``.  Experts are drawn a slab at a time and cast
    before the next (``models/moe._draw``)."""
    dev = _device(device)
    dtype = dtype_of(cfg.param_dtype)
    vpad = cfg.padded_vocab
    struct = structure(cfg)
    if struct == "dense":
        layers = _init_dense_block(generator, cfg, dtype, dev,
                                   (cfg.n_layers,))
    elif struct == "moe":
        layers = _init_moe_block(generator, cfg, dtype, dev, (cfg.n_layers,))
    else:  # dense_moe: groups of [dense, moe]
        lead = (cfg.n_layers // 2,)
        layers = {"dense": _init_dense_block(generator, cfg, dtype, dev, lead),
                  "moe": _init_moe_block(generator, cfg, dtype, dev, lead)}
    tree = {
        "embed": normal(generator, (vpad, cfg.d_model), dev).mul_(0.02
                                                                   ).to(dtype),
        "layers": layers,
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        tree["unembed"] = normal(generator, (cfg.d_model, vpad), dev).mul_(
            0.02).to(dtype)
    return LM(cfg, tree)


def lm_param_specs(cfg: LMConfig, axes: Axes) -> dict:
    """Spec tree matching ``init_lm``'s tree (the reference's): each layer
    leaf's spec behind its stacked layer axis, the embedding split over
    its vocabulary (Megatron-style), the unembedding over its columns."""
    tp = axes.tp
    fs = tuple(axes.dp) if cfg.fsdp else None
    a_specs = attn_mod.attention_specs(axes, cfg.attn_shard, cfg.fsdp)
    dense_block = {
        "ln1": P(None), "attn": a_specs, "ln2": P(None),
        "ffn": {"w_gate": P(fs, tp), "w_up": P(fs, tp), "w_down": P(tp, fs)},
    }
    moe_block = {
        "ln1": P(None), "attn": a_specs, "ln2": P(None),
        "moe": moe_mod.moe_specs(axes, cfg.shared_expert, cfg.fsdp,
                                 cfg.expert_fsdp),
    }

    def stack(spec_tree):
        return tree_map(lambda s: P(None, *s), spec_tree)

    struct = structure(cfg)
    if struct == "dense":
        layers = stack(dense_block)
    elif struct == "moe":
        layers = stack(moe_block)
    else:
        layers = {"dense": stack(dense_block), "moe": stack(moe_block)}
    specs = {
        "embed": P(tp, None),           # vocab-sharded (Megatron-style)
        "layers": layers,
        "final_norm": P(None),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = P(None, tp)
    return specs


def _act_spec(cfg: LMConfig, axes: Optional[Axes],
              x: Optional[torch.Tensor] = None) -> P:
    """Residual-stream sharding, degrading gracefully for non-divisible
    dims (decode has S=1; long-context decode has B=1), as the
    reference's."""
    if axes is None:
        return P()
    dp = tuple(axes.dp)
    bspec, sspec = dp, None
    if x is not None and axes.mesh is not None:
        sizes = mesh_sizes(axes.mesh)
        dpn = math.prod(sizes[a] for a in dp)
        if x.shape[0] % dpn:
            bspec = None
        if cfg.attn_shard == "sequence" and x.shape[1] % sizes[axes.tp] == 0:
            sspec = axes.tp
    elif cfg.attn_shard == "sequence":
        sspec = axes.tp
    return P(bspec, sspec, None)


def _logit_spec(axes: Axes) -> P:
    return P(tuple(axes.dp), None, axes.tp)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _cast(p, dtype):
    """Cast a param subtree to the compute dtype (norm and router math
    re-upcast internally where precision matters)."""
    return tree_map(lambda a: a.to(dtype), p)


def _ffn(p, x):
    x = whole(x, 1)          # a sequence-parallel residual, gathered
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def _attn_kwargs(cfg: LMConfig):
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim, rope_base=cfg.rope_base,
                attn_impl=cfg.attn_impl, kv_block=cfg.kv_block,
                unroll=cfg.unroll)


def _dense_block_fwd(p, x, positions, window, cfg: LMConfig,
                     axes: Optional[Axes] = None, cache=None, cache_pos=None):
    p = _cast(p, x.dtype)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a, new_cache = attn_mod.attention_fwd(
        p["attn"], h, positions, window, softcap=cfg.logit_softcap,
        cache=cache, cache_pos=cache_pos, **_attn_kwargs(cfg))
    x = _constrain(x + grad_whole(a, 1), axes, _act_spec(cfg, axes, x))
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    x = _constrain(x + grad_whole(_ffn(p["ffn"], h), 1), axes,
                   _act_spec(cfg, axes, x))
    return x, new_cache


def _moe_block_fwd(p, x, positions, window, cfg: LMConfig,
                   axes: Optional[Axes] = None, cache=None, cache_pos=None):
    p = _cast(p, x.dtype)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a, new_cache = attn_mod.attention_fwd(
        p["attn"], h, positions, window, softcap=cfg.logit_softcap,
        cache=cache, cache_pos=cache_pos, **_attn_kwargs(cfg))
    x = _constrain(x + grad_whole(a, 1), axes, _act_spec(cfg, axes, x))
    h = whole(rms_norm(x, p["ln2"], cfg.norm_eps), 1)
    b, s, d = h.shape
    t_tokens = b * s
    mesh = None if axes is None else axes.mesh
    sizes = {} if mesh is None else mesh_sizes(mesh)
    dpn = 1 if mesh is None else math.prod(sizes[a_] for a_ in axes.dp)
    tpn = 1 if mesh is None else sizes[axes.tp]
    if mesh is not None and cfg.moe_a2a and cfg.top_k == 1 \
            and t_tokens % (dpn * tpn) == 0:
        # top-1 all_to_all dispatch: tokens split over dp x tp
        out, aux = moe_mod.moe_fwd_a2a(
            p["moe"], h.reshape(b * s, d), n_experts=cfg.n_experts,
            capacity_factor=cfg.capacity_factor, axes=axes, fsdp=cfg.fsdp,
            gather_quant=cfg.moe_gather_quant)
    elif mesh is not None and t_tokens % dpn == 0:
        # expert-parallel dispatch (the cells' partials summed over tp)
        out, aux = moe_mod.moe_fwd_sharded(
            p["moe"], h.reshape(b * s, d), n_experts=cfg.n_experts,
            top_k=cfg.top_k, capacity_factor=cfg.capacity_factor, axes=axes,
            fsdp=cfg.fsdp, expert_fsdp=cfg.expert_fsdp,
            gather_quant=cfg.moe_gather_quant)
    else:
        out, aux = moe_mod.moe_fwd(
            p["moe"], h.reshape(b * s, d), n_experts=cfg.n_experts,
            top_k=cfg.top_k, capacity_factor=cfg.capacity_factor, axes=axes)
    x = _constrain(x + grad_whole(out.reshape(b, s, d), 1), axes,
                   _act_spec(cfg, axes, x))
    return x, new_cache, aux


def _layers(params: dict, n: int) -> list[dict]:
    """The stacked layer tree split into its ``n`` layers (or groups), each
    stacked leaf unbound once."""
    named = flatten_with_names(params["layers"])
    parts = [torch.unbind(leaf, 0) for _, leaf in named]
    return [unflatten(params["layers"], [p[i] for p in parts])
            for i in range(n)]


def _windows(cfg: LMConfig) -> list:
    """Each layer's window, or for ``dense_moe`` each group's (dense, MoE)
    pair."""
    w = list(cfg.layer_windows)
    if structure(cfg) == "dense_moe":
        return list(zip(w[0::2], w[1::2]))
    return w


def _block(cfg: LMConfig, p, x, positions, w, axes, cache=None,
           cache_pos=None, layer: int = 0):
    """Layer (or ``dense_moe`` group) ``layer``: (x, aux or None), the
    cache's layers written in place."""
    def kv(i):
        return None if cache is None else KVCache(cache.k[i], cache.v[i])

    struct = structure(cfg)
    if struct == "dense":
        return _dense_block_fwd(p, x, positions, w, cfg, axes, kv(layer),
                                cache_pos)[0], None
    if struct == "moe":
        x, _, aux = _moe_block_fwd(p, x, positions, w, cfg, axes, kv(layer),
                                   cache_pos)
        return x, aux
    x, _ = _dense_block_fwd(p["dense"], x, positions, w[0], cfg, axes,
                            kv(2 * layer), cache_pos)
    x, _, aux = _moe_block_fwd(p["moe"], x, positions, w[1], cfg, axes,
                               kv(2 * layer + 1), cache_pos)
    return x, aux


def _unembed(params: dict, cfg: LMConfig) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return w.to(dtype_of(cfg.compute_dtype))


def _embed(params: dict, tokens: torch.Tensor, cfg: LMConfig
           ) -> torch.Tensor:
    """The tokens' embedding rows in the compute dtype (``nn.Embedding``'s
    gather: its backward sums each token's rows; over a vocabulary split
    on a DeviceMesh, vocab-parallel: each rank's rows, summed)."""
    table = params["embed"]
    if is_dtensor(table):
        def local(tab, lo, ids, _):
            idx = ids.long() - lo
            mine = (idx >= 0) & (idx < tab.shape[0])
            rows = F.embedding(torch.where(mine, idx, 0), tab)
            return torch.where(mine[..., None], rows, 0)
        rows = row_split_gather(table, tokens, local)
    else:
        rows = F.embedding(tokens.long(), table)
    return rows.to(dtype_of(cfg.compute_dtype))


# ---------------------------------------------------------------------------
# forward (training / prefill, full sequence)
# ---------------------------------------------------------------------------


def forward(params, tokens: torch.Tensor, cfg: LMConfig,
            axes: Optional[Axes] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, Vpad) f32, aux_loss scalar)."""
    p = _tree(params)
    x, aux = forward_hidden(p, tokens, cfg, axes)
    logits = upcast(whole(x, 1) @ _unembed(p, cfg))
    if axes is not None:
        logits = constrain(logits, _logit_spec(axes))
    return logits, aux


def forward_hidden(params, tokens: torch.Tensor, cfg: LMConfig,
                   axes: Optional[Axes] = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Like forward() but stops before the unembedding: (hidden, aux)."""
    p = _tree(params)
    x = _embed(p, tokens, cfg)
    x = _constrain(x, axes, _act_spec(cfg, axes, x))
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    aux_sum = torch.zeros((), dtype=F32, device=x.device)
    windows = _windows(cfg)
    for p_i, w in zip(_layers(p, len(windows)), windows):
        def block(x, p_i=p_i, w=w):
            return _block(cfg, p_i, x, positions, w, axes)
        x, aux = checkpoint(block, x, use_reentrant=False) if remat \
            else block(x)
        if aux is not None:
            aux_sum = aux_sum + aux
    x = rms_norm(x, p["final_norm"], cfg.norm_eps)
    return x, aux_sum


def chunked_cross_entropy(x: torch.Tensor, unembed: torch.Tensor,
                          labels: torch.Tensor, vocab_size: int, chunk: int,
                          axes: Optional[Axes] = None,
                          unroll: bool = False) -> torch.Tensor:
    """CE without materializing (B, S, V) logits: a loop over sequence
    chunks, rematerializing each chunk's logits in the backward pass.
    ``s % chunk == 0`` is required, as the reference's reshape requires it."""
    b, s, d = x.shape
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the logit "
                         f"chunk {chunk}")
    vpad = unembed.shape[1]
    neg = torch.where(torch.arange(vpad, device=x.device) < vocab_size,
                      0.0, -1e9)

    def body(xc, lc):
        logits = upcast(xc @ unembed) + neg
        if axes is not None:
            logits = constrain(logits, _logit_spec(axes))
        return torch.sum(logsumexp_last(logits) - label_logits(logits, lc))

    remat = torch.is_grad_enabled()
    total = torch.zeros((), dtype=F32, device=x.device)
    for i in range(s // chunk):
        xc = x[:, i * chunk:(i + 1) * chunk]
        lc = labels[:, i * chunk:(i + 1) * chunk]
        total = total + (checkpoint(body, xc, lc, use_reentrant=False)
                         if remat else body(xc, lc))
    return total / (b * s)


def loss_fn(params, batch: dict, cfg: LMConfig,
            axes: Optional[Axes] = None, aux_weight: float = 0.01,
            logit_chunk: int = 0):
    """logit_chunk > 0 uses the chunked CE path (no (B,S,V) materialization)."""
    p = _tree(params)
    if logit_chunk:
        x, aux = forward_hidden(p, batch["tokens"], cfg, axes)
        ce = chunked_cross_entropy(whole(x, 1), _unembed(p, cfg),
                                   batch["labels"],
                                   cfg.vocab_size, logit_chunk, axes,
                                   unroll=cfg.unroll)
        loss = ce + aux_weight * aux
        return loss, {"ce": ce, "aux": aux}
    logits, aux = forward(p, batch["tokens"], cfg, axes)
    # mask out padded vocab entries
    vpad = cfg.padded_vocab
    if vpad != cfg.vocab_size:
        neg = torch.where(torch.arange(vpad, device=logits.device)
                          < cfg.vocab_size, 0.0, -1e9)
        logits = logits + neg
    mask = batch.get("mask")
    ce = softmax_cross_entropy(logits, batch["labels"], mask)
    loss = ce + aux_weight * aux
    return loss, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# decode (single-token step against a KV cache)
# ---------------------------------------------------------------------------


def init_cache(cfg: LMConfig, batch: int, s_max: int,
               dtype: torch.dtype = torch.bfloat16, device=None) -> KVCache:
    """Zero K and V of (n_layers, batch, s_max, KV, Dh) on ``device`` (the
    GPU unless ``device="cpu"``; ``"meta"`` allocates nothing)."""
    dev = _device(device)
    shape = (cfg.n_layers, batch, s_max, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=dev),
                   torch.zeros(shape, dtype=dtype, device=dev))


def cache_specs(cfg: LMConfig, axes: Axes) -> KVCache:
    """KV cache sharded over sequence (tp): decode reads dominate;
    splitting S over tp gives each card 1/tp of the cache-read bytes."""
    spec = P(None, tuple(axes.dp), axes.tp, None, None)
    return KVCache(spec, spec)


def decode_step(params, cache: KVCache, tokens: torch.Tensor,
                pos: torch.Tensor | int, cfg: LMConfig,
                axes: Optional[Axes] = None, last_only: bool = False
                ) -> tuple[torch.Tensor, KVCache]:
    """tokens (B, S) at absolute positions pos..pos+S-1 -> (logits, cache).

    S=1 is the decode hot loop; S=seq_len with pos=0 is prefill (pass
    last_only=True to only unembed the final position).  The cache's
    tensors are written in place (each layer's K / V at its slots) and the
    same cache is returned.
    """
    p = _tree(params)
    x = _embed(p, tokens, cfg)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    positions = pos + torch.arange(tokens.shape[1], dtype=torch.int32,
                                   device=x.device)
    windows = _windows(cfg)
    for i, (p_i, w) in enumerate(zip(_layers(p, len(windows)), windows)):
        x, _ = _block(cfg, p_i, x, positions, w, axes, cache, pos, i)
    if last_only:
        x = x[:, -1:, :]
    x = whole(rms_norm(x, p["final_norm"], cfg.norm_eps), 1)
    logits = upcast(x @ _unembed(p, cfg))
    return logits, cache
