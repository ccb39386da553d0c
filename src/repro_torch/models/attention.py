"""Grouped-query attention with causal / sliding-window masks and a KV cache
(port of ``repro/models/attention.py``).

Layouts are the reference's: q (B, S, H, Dh), k / v (B, S, KV, Dh), the
cache (B, S_max, KV, Dh) a layer.  ``attention_specs`` is the reference's
spec tree of the weights (``models/layers.P``): under "heads" and
"sequence" alike wq is column-split over tp and wo row-split, wk / wv
replicated, and FSDP splits the first weight axis over dp; the mode only
moves the activations' constraints (``models/transformer._act_spec``).

Scores are the products of q and k accumulated and returned in f32, as the
reference's ``preferred_element_type=jnp.float32`` gives them, never
rounded to the compute dtype (``_scores``); the probabilities are cast to
``v``'s dtype before the PV product, as the reference casts them.  Masked
scores take ``NEG_INF``, a large but finite constant, so a row with every
key masked gets a uniform softmax, not NaN.  A cache is written in place
(``index_copy_`` at the clamped start ``dynamic_update_slice_in_dim``
takes), the port's counterpart of XLA's donated buffer; a DTensor cache
split over its sequence is written rank by rank, each rank its own slots
(``_write_kv``).  On DTensors a call over several positions (train,
prefill) runs context parallel (``_sdpa_rows``: the query rows split
over the axes that do not split the batch, k and v gathered, each rank
running ``_sdpa`` or ``_sdpa_blockwise`` on its rows), as the reference's
"sequence" mode moves the attention math to the sequence axis; a decode
step reads its rank's share of a sequence-split cache (DTensor ops, the
f32 scores by ``_dt_bmm_f32``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.models.layers import (P, apply_rope, contiguous_stride,
                                       grad_whole, is_dtensor, normal,
                                       upcast, whole)

NEG_INF = -2.0**30  # large-but-finite: keeps softmax well-defined on all-masked rows
F32 = torch.float32


def init_attention(generator: torch.Generator | None, d_model: int,
                   n_heads: int, n_kv_heads: int, head_dim: int,
                   dtype: torch.dtype, device: torch.device | str = "cpu",
                   lead: tuple[int, ...] = ()) -> dict:
    """wq, wk, wv, wo drawn as ``dense_init`` draws them; ``lead`` stacks
    them, (n_layers,) for the transformer's layer axis."""
    dev = torch.device(device)

    def dense(d_in, d_out):
        return normal(generator, lead + (d_in, d_out), dev).mul_(
            1.0 / math.sqrt(d_in)).to(dtype)

    return {
        "wq": dense(d_model, n_heads * head_dim),
        "wk": dense(d_model, n_kv_heads * head_dim),
        "wv": dense(d_model, n_kv_heads * head_dim),
        "wo": dense(n_heads * head_dim, d_model),
    }


def attention_specs(axes, shard_mode: str, fsdp: bool = False) -> dict:
    """Spec tree matching ``init_attention``'s output (the reference's):
    Megatron-style, wq column-split over tp and wo row-split, the GQA KV
    projections replicated; FSDP also splits the first weight axis over
    dp.  ``shard_mode`` ("heads" or "sequence") places only activations."""
    del shard_mode
    tp = axes.tp
    fs = tuple(axes.dp) if fsdp else None
    return {"wq": P(fs, tp), "wk": P(fs, None), "wv": P(fs, None),
            "wo": P(tp, fs)}


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_max, KV, Dh); (n_layers, B, S_max, KV, Dh) stacked
    v: torch.Tensor


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
          window: torch.Tensor | int) -> torch.Tensor:
    """causal + optional sliding window; window<=0 means global (causal only).

    q_pos: (Sq,), k_pos: (Sk,) absolute positions. Returns (Sq, Sk) bool.
    """
    causal = q_pos[:, None] >= k_pos[None, :]
    dist = q_pos[:, None] - k_pos[None, :]
    if isinstance(window, int):      # a config's window: no device scalar
        return causal & (dist < window) if window > 0 else causal
    win = window.to(device=q_pos.device, dtype=torch.int32)
    windowed = torch.where(win > 0, dist < win, True)
    return causal & windowed


def _scores(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, M, D) @ (N, D, T) accumulated and returned in f32.  Operands in
    bf16 / f16 on the card go to ``bmm(out_dtype=f32)`` (the products and
    their sum in f32, nothing rounded) where no gradient is asked for;
    otherwise both are upcast (their values are exact in f32) and the
    product is IEEE fp32 (TF32 stays off).  Operands of two dtypes meet in
    the wider (an f32 query against a bf16 cache: f32), as jnp promotes
    them; f32 and float64 multiply as they are."""
    dt = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dt), b.to(dt)
    if dt not in (torch.bfloat16, torch.float16):
        return torch.bmm(a, b)
    if a.is_cuda and not (torch.is_grad_enabled()
                          and (a.requires_grad or b.requires_grad)):
        if is_dtensor(a):
            return _dt_bmm_f32(a, b)
        return torch.bmm(a, b, out_dtype=F32)
    return torch.bmm(a.float(), b.float())


def _dt_bmm_f32(a, b):
    """``bmm(out_dtype=f32)`` of DTensors (a decode step's scores against
    a sequence-split cache), which DTensor has no rule for:
    per mesh axis the batch split on both operands, or a's rows or b's
    columns split alone, is kept (others gathered), and each rank takes
    the product of its shards."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = a.device_mesh
    pa, pb, po = [], [], []
    for x, y in zip(a.placements, b.placements):
        if Shard(0) in (x, y):
            pa.append(Shard(0)), pb.append(Shard(0)), po.append(Shard(0))
        elif x == Shard(1) and y == Replicate():
            pa.append(x), pb.append(y), po.append(Shard(1))
        elif x == Replicate() and y == Shard(2):
            pa.append(x), pb.append(y), po.append(Shard(2))
        else:
            pa.append(Replicate()), pb.append(Replicate())
            po.append(Replicate())
    out = torch.bmm(a.redistribute(mesh, pa).to_local(),
                    b.redistribute(mesh, pb).to_local(), out_dtype=F32)
    shape = (a.shape[0], a.shape[1], b.shape[2])
    return DTensor.from_local(out, mesh, po, run_check=False, shape=shape,
                              stride=contiguous_stride(shape))


def _head_group(q: torch.Tensor, j: int, groups: int) -> torch.Tensor:
    """q (B, Sq, H, Dh) -> the query heads of KV head ``j`` as
    (B, groups * Sq, Dh), rows ordered (group, position)."""
    b, sq, _, dh = q.shape
    qj = q[:, :, j * groups:(j + 1) * groups, :]
    return qj.permute(0, 2, 1, 3).reshape(b, groups * sq, dh)


def _merge_heads(outs: list, b: int, sq: int, groups: int) -> torch.Tensor:
    """[(B, groups * Sq, Dh)] by KV head -> (B, Sq, H, Dh)."""
    dh = outs[0].shape[-1]
    out = torch.stack([o.view(b, groups, sq, dh) for o in outs], dim=1)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, len(outs) * groups, dh)


def _sdpa(q, k, v, mask, softcap: float = 0.0):
    """q (B,Sq,H,Dh), k/v (B,Sk,KV,Dh) GQA scaled-dot-product, f32 softmax."""
    b, sq, h, dh = q.shape
    kv = k.shape[2]
    groups = h // kv
    scale = torch.sqrt(torch.tensor(dh, dtype=F32))
    outs = []
    for j in range(kv):
        s = _scores(_head_group(q, j, groups), k[:, :, j, :].transpose(1, 2))
        s = s.view(b, groups, sq, k.shape[1]) / scale
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        s = torch.where(mask, s, NEG_INF)
        probs = torch.softmax(s, dim=-1).to(v.dtype)
        outs.append(torch.bmm(probs.view(b, groups * sq, k.shape[1]),
                              v[:, :, j, :]))
    return _merge_heads(outs, b, sq, groups)


def _sdpa_blockwise(q, k, v, q_pos, k_pos, window, softcap: float = 0.0,
                    kv_block: int = 1024, extra_kmask=None,
                    unroll: bool = False):
    """FlashAttention-style streaming softmax over KV blocks (plain PyTorch).

    Never materializes the (Sq, Skv) score matrix: a Python loop over KV
    blocks (the reference's ``unroll`` branch, whatever ``unroll`` says)
    carries the running (max, normalizer, weighted-accumulator), so live
    attention memory is O(Sq * kv_block).

    q (B,Sq,H,Dh); k/v (B,Skv,KV,Dh); q_pos (Sq,); k_pos (Skv,).
    ``extra_kmask`` (Skv,) optionally invalidates cache slots.
    """
    b, sq, h, dh = q.shape
    skv = k.shape[1]
    kvh = k.shape[2]
    groups = h // kvh
    kv_block = min(kv_block, skv)
    assert skv % kv_block == 0, "pad the KV length to the block size"
    nb = skv // kv_block
    scale = 1.0 / torch.sqrt(torch.tensor(dh, dtype=F32))
    acc_dtype = torch.promote_types(q.dtype, F32)
    masks = []
    for i in range(nb):
        blk = slice(i * kv_block, (i + 1) * kv_block)
        msk = _mask(q_pos, k_pos[blk], window)
        if extra_kmask is not None:
            msk = msk & extra_kmask[blk][None, :]
        masks.append(msk)

    outs = []
    for j in range(kvh):
        qj = _head_group(q, j, groups)
        m = torch.full((b, groups, sq), NEG_INF, dtype=acc_dtype,
                       device=q.device)
        l = torch.zeros((b, groups, sq), dtype=acc_dtype, device=q.device)
        acc = torch.zeros((b, groups, sq, dh), dtype=acc_dtype,
                          device=q.device)
        for i in range(nb):
            blk = slice(i * kv_block, (i + 1) * kv_block)
            v_blk = v[:, blk, j, :]
            s = _scores(qj, k[:, blk, j, :].transpose(1, 2)).view(
                b, groups, sq, kv_block) * scale
            if softcap:
                s = torch.tanh(s / softcap) * softcap
            s = torch.where(masks[i], s, NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            alpha = torch.exp(m - m_new)                     # (b,g,sq)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + torch.sum(p, dim=-1)
            pv = torch.bmm(p.to(v_blk.dtype).view(b, groups * sq, kv_block),
                           v_blk).view(b, groups, sq, dh)
            acc = acc * alpha[..., None] + upcast(pv)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]     # (b,g,sq,dh)
        outs.append(out.reshape(b, groups * sq, dh))
    return _merge_heads(outs, b, sq, groups).to(v.dtype)


def _plain(t):
    """A DTensor gathered whole on every rank, as a plain tensor; anything
    else as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def _sdpa_rows(q, k, v, q_pos, k_pos, window, softcap: float = 0.0,
               kv_block: int = 0, extra_kmask=None, unroll: bool = False):
    """The attention of DTensor queries over several positions, context
    parallel: the query rows split over every mesh axis that does not
    split the batch, k / v gathered whole on their positions, and each
    rank runs ``_sdpa`` (``kv_block`` 0) or ``_sdpa_blockwise`` on its
    local rows.  The gradients of k and v are partial over the axes that
    split the rows.  -> (B, Sq, H, Dh), its rows split as q's."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = q.device_mesh
    pq = [Shard(1) if isinstance(p, Replicate) else p for p in q.placements]
    q = q.redistribute(mesh, pq)
    pk = [Shard(0) if p == Shard(0) else Replicate() for p in pq]
    gk = [Partial() if p == Shard(1) else pk[i] for i, p in enumerate(pq)]
    # (a redistribution to the placements k / v hold already is skipped:
    # its backward would sum their partial gradients at once, where the
    # projections' backward can carry them to the residual's one sum)
    k, v = (t if list(t.placements) == pk else t.redistribute(mesh, pk)
            for t in (k, v))
    k, v = (t.to_local(grad_placements=gk) for t in (k, v))
    shape, offset = compute_local_shape_and_global_offset(q.shape, mesh, pq)
    rows = slice(offset[1], offset[1] + shape[1])
    q_pos, k_pos = _plain(q_pos)[rows], _plain(k_pos)
    window = _plain(window)
    q_loc = q.to_local(grad_placements=pq)
    if kv_block:
        out = _sdpa_blockwise(q_loc, k, v, q_pos, k_pos, window, softcap,
                              kv_block, extra_kmask=_plain(extra_kmask),
                              unroll=unroll)
    else:
        mask = _mask(q_pos, k_pos, window)
        if extra_kmask is not None:
            mask = mask & _plain(extra_kmask)[None, :]
        out = _sdpa(q_loc, k, v, mask, softcap)
    # contiguous, as DTensor's view rules take its local shard
    return DTensor.from_local(out.contiguous(), mesh, pq, run_check=False,
                              shape=tuple(q.shape),
                              stride=contiguous_stride(q.shape))


def _write_kv(buf: torch.Tensor, start: torch.Tensor, new: torch.Tensor):
    """Write ``new`` (B, s, KV, Dh) into the cache ``buf`` (B, S_max, KV,
    Dh) at slots ``start`` .. ``start + s - 1``, in place.  On a DTensor
    cache whose slots are split over mesh axes each rank writes the slots
    it holds: at s = 1 the one slot (its old value where another rank
    holds it), else every local slot from ``new`` where written."""
    if not is_dtensor(buf):
        slots = start + torch.arange(new.shape[1], device=buf.device)
        buf.index_copy_(1, slots.long(), new.to(buf.dtype))
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = buf.device_mesh
    whole = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
             for p in buf.placements]
    new_loc = new.to(buf.dtype).redistribute(mesh, whole).to_local()
    start = start.to_local() if is_dtensor(start) else start
    shape, offset = compute_local_shape_and_global_offset(
        buf.shape, mesh, buf.placements)
    lo, n, s = offset[1], shape[1], new.shape[1]
    loc = buf.to_local()
    if s == 1:
        rel = (start - lo).long().reshape(1)
        mine = (rel >= 0) & (rel < n)
        rel = rel.clamp(0, n - 1)
        old = loc.index_select(1, rel)
        loc.index_copy_(1, rel, torch.where(mine[:, None, None], new_loc,
                                            old))
        return
    g = lo + torch.arange(n, device=loc.device)
    hit = (g >= start) & (g < start + s)
    src = (g - start).clamp(0, s - 1).long()
    loc.copy_(torch.where(hit[:, None, None], new_loc.index_select(1, src),
                          loc))


def _cached_rows(q, k, v, positions, window, softcap, blocks, cache,
                 cache_pos, unroll):
    """The cache written, then ``_sdpa_rows`` against it (a prefill on
    DTensors)."""
    s, s_max = q.shape[1], cache.k.shape[1]
    pos = torch.as_tensor(cache_pos, dtype=torch.int32,
                          device=positions.device)
    start = torch.clamp(pos, 0, s_max - s)
    _write_kv(cache.k, start, k)
    _write_kv(cache.v, start, v)
    k_pos = torch.arange(s_max, dtype=torch.int32, device=positions.device)
    written = k_pos <= pos + s - 1   # not-yet-written cache slots
    return _sdpa_rows(q, cache.k, cache.v, positions, k_pos, window,
                      softcap, blocks, extra_kmask=written,
                      unroll=unroll), cache


def attention_fwd(params: dict, x: torch.Tensor, positions: torch.Tensor,
                  window: torch.Tensor | int, *, n_heads: int,
                  n_kv_heads: int, head_dim: int, rope_base: float,
                  softcap: float = 0.0, cache: KVCache | None = None,
                  cache_pos: torch.Tensor | int | None = None,
                  attn_impl: str = "dense", kv_block: int = 1024,
                  unroll: bool = False):
    """Full-sequence (training/prefill) or single-token (decode) attention.

    x: (B, S, D). If ``cache`` is given, x is the new chunk (S=1 for decode);
    K/V are written into the cache's tensors at ``cache_pos`` (clamped into
    [0, S_max - S], as ``dynamic_update_slice_in_dim`` clamps it; slots up to
    the unclamped ``cache_pos + S - 1`` count as written) and attention runs
    against the cache.  attn_impl "blockwise" streams KV blocks with a
    running softmax; "dense" materializes the score matrix.
    Returns (out (B, S, D), cache) -- the same cache, written in place.
    """
    b, s, _ = x.shape
    x = whole(x, 1)          # a sequence-parallel residual, gathered
    q = whole(x @ params["wq"], 2).reshape(b, s, n_heads, head_dim)
    k = whole(x @ params["wk"], 2).reshape(b, s, n_kv_heads, head_dim)
    v = whole(x @ params["wv"], 2).reshape(b, s, n_kv_heads, head_dim)
    q = apply_rope(q, positions, rope_base)
    k = apply_rope(k, positions, rope_base)

    blocks = kv_block if attn_impl == "blockwise" else 0
    if is_dtensor(q) and s > 1:
        if cache is None:
            out = _sdpa_rows(q, k, v, positions, positions.int(), window,
                             softcap, blocks, unroll=unroll)
            new_cache = None
        else:
            out, new_cache = _cached_rows(q, k, v, positions, window,
                                          softcap, blocks, cache, cache_pos,
                                          unroll)
    elif cache is None:
        if attn_impl == "blockwise":
            out = _sdpa_blockwise(q, k, v, positions, positions.int(),
                                  window, softcap, kv_block, unroll=unroll)
        else:
            mask = _mask(positions, positions, window)
            out = _sdpa(q, k, v, mask, softcap)
        new_cache = None
    else:
        s_max = cache.k.shape[1]
        pos = torch.as_tensor(cache_pos, dtype=torch.int32, device=x.device)
        start = torch.clamp(pos, 0, s_max - s)
        _write_kv(cache.k, start, k)
        _write_kv(cache.v, start, v)
        ck, cv = cache
        new_cache = cache
        k_pos = torch.arange(s_max, dtype=torch.int32, device=x.device)
        written = k_pos <= pos + s - 1   # not-yet-written cache slots
        if attn_impl == "blockwise":
            out = _sdpa_blockwise(q, ck, cv, positions, k_pos, window,
                                  softcap, kv_block, extra_kmask=written,
                                  unroll=unroll)
        else:
            mask = _mask(positions, k_pos, window) & written[None, :]
            out = _sdpa(q, ck, cv, mask, softcap)

    # its gradient gathered on the heads before the reshapes back to
    # (heads, head_dim) and (KV head, group), which a split that does not
    # divide the heads refuses; a bf16 cache's output meets f32 weights in
    # f32, as jnp promotes them
    out = grad_whole(whole(out.reshape(b, s, n_heads * head_dim), 1), 2)
    wo = params["wo"]
    dt = torch.promote_types(out.dtype, wo.dtype)
    return out.to(dt) @ wo.to(dt), new_cache
