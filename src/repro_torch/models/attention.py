"""Grouped-query attention with causal / sliding-window masks and a KV cache
(port of ``repro/models/attention.py``).

Layouts are the reference's: q (B, S, H, Dh), k / v (B, S, KV, Dh), the
cache (B, S_max, KV, Dh) a layer.  The reference's sharding modes only
place the math over a TPU mesh; one process has no counterpart.

Scores are the products of q and k accumulated and returned in f32, as the
reference's ``preferred_element_type=jnp.float32`` gives them, never
rounded to the compute dtype (``_scores``); the probabilities are cast to
``v``'s dtype before the PV product, as the reference casts them.  Masked
scores take ``NEG_INF``, a large but finite constant, so a row with every
key masked gets a uniform softmax, not NaN.  A cache is written in place
(``index_copy_`` at the clamped start ``dynamic_update_slice_in_dim``
takes), the port's counterpart of XLA's donated buffer.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.models.layers import apply_rope, normal, upcast

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
        return torch.bmm(a, b, out_dtype=F32)
    return torch.bmm(a.float(), b.float())


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
        s = s.view(b, groups, sq, -1) / scale
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        s = torch.where(mask, s, NEG_INF)
        probs = torch.softmax(s, dim=-1).to(v.dtype)
        outs.append(torch.bmm(probs.view(b, groups * sq, -1), v[:, :, j, :]))
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
    q = (x @ params["wq"]).reshape(b, s, n_heads, head_dim)
    k = (x @ params["wk"]).reshape(b, s, n_kv_heads, head_dim)
    v = (x @ params["wv"]).reshape(b, s, n_kv_heads, head_dim)
    q = apply_rope(q, positions, rope_base)
    k = apply_rope(k, positions, rope_base)

    if cache is None:
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
        slots = (torch.clamp(pos, 0, s_max - s)
                 + torch.arange(s, device=x.device)).long()
        cache.k.index_copy_(1, slots, k.to(cache.k.dtype))
        cache.v.index_copy_(1, slots, v.to(cache.v.dtype))
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

    # a bf16 cache's output meets f32 weights in f32, as jnp promotes them
    out = out.reshape(b, s, n_heads * head_dim)
    wo = params["wo"]
    dt = torch.promote_types(out.dtype, wo.dtype)
    return out.to(dt) @ wo.to(dt), new_cache
