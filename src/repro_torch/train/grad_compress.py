"""int8 error-feedback compressed gradient all-reduce (port of
``repro/train/grad_compress.py``).

Each data-parallel rank quantizes ``grad + residual`` to int8 with one
scale per leaf (``torch.round`` rounds half to even, as ``jnp.round``
does), all-reduces the payload as int32 (a sum of int8 would overflow) and
the scales as f32 over a ``torch.distributed`` group, dequantizes the mean
as the reference does, ``sum_q * (sum_scale / n) / n``, and keeps the
quantization error as the next step's residual.  The payloads of all
leaves travel in one int32 all-reduce and their scales in one f32
all-reduce.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.tree import leaves, tree_map, unflatten


def init_residuals(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def quantize(g: torch.Tensor, r: torch.Tensor):
    """(int8 payload, f32 scale, new residual) of ``g + r``.  The residual
    ``gf - q * scale`` is rounded once, as the fused multiply-add XLA emits
    for it: q * scale (at most 31 significant bits) and the difference are
    exact in f64."""
    gf = g.float() + r
    scale = torch.max(torch.abs(gf)) / 127.0 + 1e-12
    q = torch.clip(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale, (gf.double() - q.double() * scale.double()).float()


@torch.no_grad()
def compressed_psum(grads, residuals, group: Optional[dist.ProcessGroup],
                    n_shards: int):
    """(grads + residuals) -> int8 all-reduce over ``group`` -> (mean
    grads, new residuals).  ``group`` None is one shard in this process
    (no collective; ``n_shards`` must be 1)."""
    if group is None and n_shards != 1:
        raise ValueError("compressed_psum without a group is one shard")
    parts = [quantize(g, r) for g, r in zip(leaves(grads),
                                            leaves(residuals))]
    payload = torch.cat([q.reshape(-1).int() for q, _, _ in parts])
    scales = torch.stack([s for _, s, _ in parts])
    if group is not None:
        dist.all_reduce(payload, group=group)
        dist.all_reduce(scales, group=group)
    means, lo = [], 0
    for (q, _, _), ss in zip(parts, scales):
        sq = payload[lo:lo + q.numel()].view(q.shape)
        lo += q.numel()
        means.append(sq.float() * (ss / n_shards) / n_shards)
    return (unflatten(grads, means),
            unflatten(residuals, [r for _, _, r in parts]))
