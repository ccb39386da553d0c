"""Core NN layers as plain functions over tensors (port of
``repro/models/layers.py``).

The initializers draw from an explicit ``torch.Generator`` on the device
they allocate on; on the ``meta`` device they allocate nothing and take no
generator, which is how the cell programs read shapes without memory (the
reference's ``jax.eval_shape``).  Norms compute in f32 and return the input
dtype, as the reference's do.  "f32" means at least f32 throughout
(``upcast``): a float64 input computes in float64, which a float64
gradient check of the port needs and the reference never meets.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Axes:
    """Mesh axis naming: dp = batch/data axes (includes 'pod' when multi-pod),
    tp = tensor-model axis; ``mesh`` the ``core.sharded_index.Mesh`` the
    cell runs on."""

    dp: tuple[str, ...] = ("data",)
    tp: str = "model"
    mesh: object = None


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16, "float64": torch.float64}[name]


def upcast(t: torch.Tensor) -> torch.Tensor:
    """``t`` in f32, or in float64 where it is float64 (the reference's
    ``astype(jnp.float32)``)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


def normal(generator: torch.Generator | None, shape: tuple[int, ...],
           device: torch.device) -> torch.Tensor:
    """Standard-normal f32 draws of ``shape`` on ``device`` from
    ``generator``; uninitialized on the ``meta`` device."""
    if device.type == "meta":
        return torch.empty(shape, device=device)
    return torch.randn(shape, generator=generator, device=device)


def dense_init(generator: torch.Generator | None, d_in: int, d_out: int,
               dtype: torch.dtype, scale: float | None = None,
               device: torch.device | str = "cpu") -> torch.Tensor:
    """(d_in, d_out) normal weights scaled by ``scale`` (1 / sqrt(d_in))."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return normal(generator, (d_in, d_out), torch.device(device)
                  ).mul_(scale).to(dtype)


def embed_init(generator: torch.Generator | None, vocab: int, d: int,
               dtype: torch.dtype, device: torch.device | str = "cpu"
               ) -> torch.Tensor:
    return normal(generator, (vocab, d), torch.device(device)
                  ).mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    xf = upcast(x)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + gamma.to(xf.dtype))
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * gamma.float() + beta.float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, base: float,
               device: torch.device | str = "cpu") -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (base ** (torch.arange(0, half, dtype=torch.float32,
                                        device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, base: float
               ) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S)."""
    half = x.shape[-1] // 2
    x1f, x2f = upcast(x[..., :half]), upcast(x[..., half:])
    freqs = rope_freqs(x.shape[-1], base, x.device).to(x1f.dtype)  # (half,)
    angle = positions[..., None].to(x1f.dtype) * freqs    # (..., S, half)
    cos = torch.cos(angle)[..., None, :]                  # (..., S, 1, half)
    sin = torch.sin(angle)[..., None, :]
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor | None = None,
                          z_loss: float = 0.0) -> torch.Tensor:
    """logits (..., V) f32-upcast CE with optional z-loss; labels int
    (...,)."""
    logits = upcast(logits)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, labels.long()[..., None],
                              dim=-1)[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse ** 2
    if mask is not None:
        return torch.sum(loss * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(loss)


def pad_vocab(v: int, multiple: int) -> int:
    return ((v + multiple - 1) // multiple) * multiple
