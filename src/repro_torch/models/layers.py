"""Layer library of the port: RMSNorm and layernorm, RoPE, grouped-query attention for
prefill and for one-token decode against a dense per-slot cache or a paged
KV pool, and the dense FFN.

PyTorch twin of the JAX package's ``models/layers.py`` for the all-"attn"
model class (Mixtral / Phi-MoE, Granite, Nemotron and InternVL2 shapes).  Plain tensor math,
written as the reference writes it (``mha``): float32 scores and softmax,
GQA without materialising repeated K/V heads.  Dense decode and paged
prefill-chunk attention have no kernel, as in the reference; paged decode
attention runs ``kernels.ops.paged_flash_decode``, and an FFN weight that
is a `QTensor` runs ``kernels.ops.dequant_matmul``.

Conventions: activations (B, S, D) in the config dtype; q/k/v (B, S, H, hd);
decode takes x (B, 1, D) and a cache {"k", "v"} of (B, Smax, Hkv, hd) that is
updated in place.  Paged layers take one layer's page buffers of
(P + 1, psz, Hkv, hd), updated in place; the last row is a write sink that
no page table names (``models.kv_pages``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.quant.quantize import QTensor

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
    """{"scale"} (zeros: a unit gain), plus a zero "bias" for layernorm;
    float32 whatever the config dtype."""
    p = {"scale": torch.zeros((cfg.d_model,), dtype=torch.float32, device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros((cfg.d_model,), dtype=torch.float32, device=device)
    return p


def apply_norm(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """RMSNorm, or layernorm (mean removed, biased variance, then a bias),
    with a (1 + scale) gain; statistics and gain in float32, the result in
    x's dtype."""
    xf = x.to(torch.float32)
    if cfg.norm_type == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        return (y * (1.0 + p["scale"]) + p["bias"]).to(x.dtype)
    ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + cfg.norm_eps)
    return (y * (1.0 + p["scale"])).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    ex = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    # torch.full, not torch.tensor: a host scalar copied to the card would
    # synchronise, which a CUDA-graph capture of the decode step refuses
    return 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32, device=device), ex)


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
                         torch.full((), NEG_INF, dtype=logits.dtype, device=logits.device))
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


def _paged_gather(pages: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Slot-contiguous logical K/V view (B, maxp*psz, Hkv, hd) gathered
    through the page table (B, maxp): logical token t of slot b lives at
    page table[b, t // psz], offset t % psz."""
    b, maxp = table.shape
    _, psz, hkv, hd = pages.shape
    return pages[table.to(torch.long)].reshape(b, maxp * psz, hkv, hd)


def _paged_write(pages: torch.Tensor, table: torch.Tensor, positions: torch.Tensor,
                 keep: torch.Tensor, rows: torch.Tensor) -> None:
    """pages[table[b, pos // psz], pos % psz] = rows for every (b, s) with
    keep[b, s]; the other rows go to the sink page (the last row of
    `pages`), so nothing is selected on the host.  positions/keep (B, S);
    rows (B, S, Hkv, hd)."""
    sink, psz = pages.shape[0] - 1, pages.shape[1]
    li = (positions // psz).clamp(max=table.shape[1] - 1)
    page = torch.gather(table, 1, li).to(torch.long)
    page = torch.where(keep, page, torch.full_like(page, sink))
    pages[page.reshape(-1), (positions % psz).reshape(-1)] = \
        rows.reshape(-1, *rows.shape[2:]).to(pages.dtype)


def paged_attn_decode(p, x, k_pages, v_pages, table, positions, active,
                      cfg: ModelConfig):
    """One-token decode against a paged KV pool.  x (B, 1, D); k_pages /
    v_pages (P + 1, psz, Hkv, hd) shared across slots, written in place;
    table (B, maxp) int32; positions (B,) write index; active (B,) bool —
    inactive slots write to the sink page (their table rows may point at
    pages a neighbour now owns).  Attention runs through
    `kops.paged_flash_decode` over tokens [0, position]; inactive rows'
    outputs are junk the caller ignores.  Returns out (B, 1, D)."""
    b = x.shape[0]
    hq, hd = cfg.num_heads, cfg.resolved_head_dim
    q, k, v = _qkv(p, x, positions[:, None], cfg)
    keep = active[:, None]
    _paged_write(k_pages, table, positions[:, None], keep, k)
    _paged_write(v_pages, table, positions[:, None], keep, v)
    sink = k_pages.shape[0] - 1
    out = kops.paged_flash_decode(q[:, 0].contiguous(), k_pages[:sink], v_pages[:sink],
                                  table, (positions + 1).to(torch.int32),
                                  scale=1.0 / math.sqrt(hd),
                                  softcap=cfg.attn_logit_softcap)
    return out.to(q.dtype).reshape(b, 1, hq * hd) @ p["wo"]


def paged_attn_prefill_chunk(p, x, k_pages, v_pages, table, start, n,
                             cfg: ModelConfig, wstart=None):
    """One prefill chunk against a paged KV pool: write the chunk's K/V into
    the rows' pages, then attend causally over everything written so far.
    x (B, C, D); start (B,) absolute position of each row's first token;
    n (B,) valid tokens per row (pads write to the sink, their outputs are
    junk); wstart optional (B,) write floor — positions below it attend
    over the aliased pages but do not write.  Returns out (B, C, D)."""
    b, c, _ = x.shape
    hq, hd = cfg.num_heads, cfg.resolved_head_dim
    idx = torch.arange(c, device=x.device)
    positions = start[:, None] + idx[None, :]
    q, k, v = _qkv(p, x, positions, cfg)
    keep = idx[None, :] < n[:, None]
    if wstart is not None:
        keep = keep & (positions >= wstart[:, None])
    _paged_write(k_pages, table, positions, keep, k)
    _paged_write(v_pages, table, positions, keep, v)
    sink = k_pages.shape[0] - 1
    kg = _paged_gather(k_pages[:sink], table)
    vg = _paged_gather(v_pages[:sink], table)
    kidx = torch.arange(kg.shape[1], device=x.device)
    mask = kidx[None, None, :] <= positions[:, :, None]           # (B, C, Smax)
    out = mha(q, kg, vg, mask, cfg.attn_logit_softcap, 1.0 / math.sqrt(hd))
    return out.reshape(b, c, hq * hd) @ p["wo"]


def activate(z: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """FFN activation in the reference's precision: SwiGLU (silu of the
    first half in float32, times the second half), GELU (tanh form) or
    squared ReLU, the last two taken in float32 and cast back."""
    if cfg.ffn_activation == "swiglu":
        g, u = torch.chunk(z, 2, dim=-1)
        return F.silu(g.to(torch.float32)).to(z.dtype) * u
    if cfg.ffn_activation == "gelu":
        return F.gelu(z.to(torch.float32), approximate="tanh").to(z.dtype)
    if cfg.ffn_activation == "sq_relu":
        return torch.square(F.relu(z.to(torch.float32))).to(z.dtype)
    raise ValueError(f"unknown ffn_activation {cfg.ffn_activation!r}")


# --------------------------------------------------------------------------
# dense FFN (MoE lives in moe.py)
# --------------------------------------------------------------------------

def ffn_init(cfg: ModelConfig, gen: torch.Generator, device: torch.device):
    """{"wi": (D, 2F) for SwiGLU else (D, F), "wo": (F, D)} in the config
    dtype."""
    d, f = cfg.d_model, cfg.d_ff
    dt = dtype_of(cfg)
    wi_cols = 2 * f if cfg.ffn_activation == "swiglu" else f
    return {"wi": dense_init((d, wi_cols), dt, gen, device),
            "wo": dense_init((f, d), dt, gen, device)}


def _matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w; a `QTensor` weight goes through the dequant-matmul kernel
    (float32 out, cast back to x's dtype as the reference casts)."""
    if isinstance(w, QTensor):
        return kops.dequant_matmul(x, w).to(x.dtype)
    return x @ w


def ffn_forward(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Dense FFN: wi, the activation, wo.  x (..., D) -> (..., D)."""
    return _matmul(activate(_matmul(x, p["wi"]), cfg), p["wo"])
