"""Layer library of the port: RMSNorm, RoPE, grouped-query attention for
prefill and for one-token decode against a dense per-slot cache.

PyTorch twin of the JAX package's ``models/layers.py`` for the all-"attn"
MoE model class (Mixtral / Phi-MoE shapes).  Plain tensor math, written as
the reference writes it (``mha``): float32 scores and softmax, GQA without
materialising repeated K/V heads.  There is no kernel here: the reference
computes dense decode attention with plain ``jnp`` as well.

Conventions: activations (B, S, D) in the config dtype; q/k/v (B, S, H, hd);
decode takes x (B, 1, D) and a cache {"k", "v"} of (B, Smax, Hkv, hd) that is
updated in place.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

NEG_INF = -1e30


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[cfg.dtype]


def dense_init(shape, dtype: torch.dtype, gen: torch.Generator,
               device: torch.device, scale: Optional[float] = None) -> torch.Tensor:
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (w * scale).to(dtype)


def norm_init(cfg: ModelConfig, device: torch.device):
    return {"scale": torch.zeros((cfg.d_model,), dtype=torch.float32, device=device)}


def apply_norm(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """RMSNorm with a (1 + scale) gain, float32 statistics."""
    if cfg.norm_type != "rmsnorm":
        raise NotImplementedError(
            f"norm_type={cfg.norm_type!r} arrives with the remaining model "
            "classes (ROADMAP Queue 1, item 7)")
    xf = x.to(torch.float32)
    ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + cfg.norm_eps)
    return (y * (1.0 + p["scale"])).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    ex = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), ex)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) integer."""
    if theta <= 0:
        return x
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions[..., None].to(torch.float32) * freqs        # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mha(q, k, v, mask, softcap: float, scale: float) -> torch.Tensor:
    """q: (B,Sq,Hq,hd) k/v: (B,Sk,Hkv,hd); mask (B,Sq,Sk) bool (True =
    attendable).  GQA grouped einsum, float32 softmax."""
    b, sq, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    if softcap and softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    logits = torch.where(mask[:, None, None, :, :], logits,
                         torch.tensor(NEG_INF, dtype=logits.dtype, device=logits.device))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v.to(torch.float32))
    return out.reshape(b, sq, hq, hd).to(q.dtype)


def attn_init(cfg: ModelConfig, gen: torch.Generator, device: torch.device):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    dt = dtype_of(cfg)
    return {
        "wq": dense_init((d, hq * hd), dt, gen, device),
        "wk": dense_init((d, hkv * hd), dt, gen, device),
        "wv": dense_init((d, hkv * hd), dt, gen, device),
        "wo": dense_init((hq * hd, d), dt, gen, device),
    }


def _qkv(p, x, positions, cfg: ModelConfig):
    b, s, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(b, s, hq, hd)
    k = (x @ p["wk"]).reshape(b, s, hkv, hd)
    v = (x @ p["wv"]).reshape(b, s, hkv, hd)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_forward(p, x, positions, cfg: ModelConfig):
    """Full-sequence causal self attention (prefill).  positions (B, S).
    Returns (out (B, S, D), (k, v)) with the unexpanded GQA heads."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, positions, cfg)
    mask = positions[:, None, :] <= positions[:, :, None]         # (B, Sq, Sk)
    out = mha(q, k, v, mask, cfg.attn_logit_softcap,
              1.0 / math.sqrt(cfg.resolved_head_dim))
    return out.reshape(b, s, -1) @ p["wo"], (k, v)


def attn_decode(p, x, kv_cache, positions, cfg: ModelConfig):
    """One-token decode against a full-window dense cache.  x: (B, 1, D);
    kv_cache {"k", "v"}: (B, Smax, Hkv, hd), written in place at each row's
    position; positions: (B,) int64 current write index.  Returns out
    (B, 1, D)."""
    b = x.shape[0]
    q, k, v = _qkv(p, x, positions[:, None], cfg)
    smax = kv_cache["k"].shape[1]
    rows = torch.arange(b, device=x.device)
    # clamped like the reference's dynamic_update_slice (only a finished,
    # inactive slot can sit at smax; its row is junk either way)
    at = positions.clamp(max=smax - 1)
    kv_cache["k"][rows, at] = k[:, 0].to(kv_cache["k"].dtype)
    kv_cache["v"][rows, at] = v[:, 0].to(kv_cache["v"].dtype)
    idx = torch.arange(smax, device=x.device)
    mask = (idx[None, :] <= positions[:, None])[:, None, :]        # (B, 1, Smax)
    out = mha(q, kv_cache["k"], kv_cache["v"], mask, cfg.attn_logit_softcap,
              1.0 / math.sqrt(cfg.resolved_head_dim))
    return out.reshape(b, 1, -1) @ p["wo"]


def activate(z: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """FFN activation in the reference's precision: SwiGLU (silu of the
    first half in float32, times the second half) or GELU (tanh form)."""
    if cfg.ffn_activation == "swiglu":
        g, u = torch.chunk(z, 2, dim=-1)
        return F.silu(g.to(torch.float32)).to(z.dtype) * u
    if cfg.ffn_activation == "gelu":
        return F.gelu(z.to(torch.float32), approximate="tanh").to(z.dtype)
    raise NotImplementedError(
        f"ffn_activation={cfg.ffn_activation!r} arrives with the remaining "
        "model classes (ROADMAP Queue 1, item 7)")
