"""Plain float32 forward of the benchmark's mixture-of-experts decoders,
teacher-forced over a prompt and the tokens the program served.

It follows the published model (pre-norm attention with RoPE and grouped
K/V heads, top-k softmax routing renormalised over the chosen experts,
SwiGLU experts) and, at the positions the program decoded, HOBBIT's
token-level precision rule (Eq. 2): the rank-0 expert in full precision,
a later one in full precision while the gate mass ranked above it is at
most T1, in 4 bits (groupwise symmetric, along the contraction dimension)
while it is at most T2, skipped above; the kept gates renormalised.  The
4-bit weights are quantized here again from the full-precision ones.
Prompt positions route every chosen expert in full precision, as the
program's chunked prefill does.

Every product runs in float32 with TF32 off.  ``fp8=True`` is the control:
the same computation with every matrix product's operands rounded to fp8
(e4m3, one scale per row of the activations and per column of the
weights), the router's in bf16 (its weights are stated in float32); the
4-bit weights stay as they are.

Weights are the tree ``bench/benchlib/weights.py`` makes (the config's
dtype), read and upcast here; nothing the program derived is used.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

HI, LO, SKIP = 0, 1, 2
E4M3_MAX = 448.0


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to e4m3 with one scale per slice along `dim` (amax / 448)."""
    amax = x.abs().amax(dim=dim, keepdim=True)
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _mm(a: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    """a (T, K) float32 @ w (K, N) upcast to float32."""
    w = w.to(torch.float32)
    if fp8:
        return _fp8(a, -1) @ _fp8(w, 0)
    return a @ w


def quantize_dequantize(w: torch.Tensor, bits: int, group: int) -> torch.Tensor:
    """Groupwise symmetric quantization of w (K, N) along K, returned
    dequantized in float32: scale = amax * (1 / qmax) per group and column,
    codes rounded half to even and clamped to +-qmax."""
    qmax = (1 << (bits - 1)) - 1
    k, n = w.shape
    wg = w.to(torch.float32).reshape(k // group, group, n)
    scale = wg.abs().amax(dim=1) * (1.0 / qmax)
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    codes = torch.clamp(torch.round(wg / scale[:, None, :]), -qmax, qmax)
    return (codes * scale[:, None, :]).reshape(k, n)


def _norm(p: dict, x: torch.Tensor, spec: dict) -> torch.Tensor:
    if spec["norm"] == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + spec["norm_eps"]) * (1.0 + p["scale"]) + p["bias"]
    ms = x.square().mean(-1, keepdim=True)
    return x * torch.rsqrt(ms + spec["norm_eps"]) * (1.0 + p["scale"])


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, H, hd): rotate-half RoPE at positions 0 .. T - 1."""
    t, _, hd = x.shape
    ex = torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), ex)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(p: dict, h: torch.Tensor, spec: dict, fp8: bool) -> torch.Tensor:
    t = h.shape[0]
    hq, hkv, hd = spec["num_heads"], spec["num_kv_heads"], spec["head_dim"]
    q = _rope(_mm(h, p["wq"], fp8).view(t, hq, hd), spec["rope_theta"])
    k = _rope(_mm(h, p["wk"], fp8).view(t, hkv, hd), spec["rope_theta"])
    v = _mm(h, p["wv"], fp8).view(t, hkv, hd)
    g = hq // hkv
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    causal = torch.ones((t, t), dtype=torch.bool, device=h.device).tril()
    out = torch.empty((t, hq, hd), dtype=torch.float32, device=h.device)
    for h0 in range(0, hq, 8):                  # bounded score memory
        s = torch.einsum("qhd,khd->hqk", q[:, h0:h0 + 8], k[:, h0:h0 + 8]) / math.sqrt(hd)
        s = s.masked_fill(~causal, float("-inf"))
        out[:, h0:h0 + 8] = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1),
                                         v[:, h0:h0 + 8])
    return _mm(out.reshape(t, hq * hd), p["wo"], fp8)


def precision_decisions(gates: torch.Tensor, t1: float, t2: float) -> torch.Tensor:
    """HOBBIT Eq. 2 on (T, k) chosen-expert gates: the unimportance of the
    expert at rank i is the normalised gate mass ranked above it; rank 0
    is always HI, then HI up to t1, LO up to t2, SKIP above."""
    g = gates.to(torch.float64)
    g = g / g.sum(-1, keepdim=True).clamp_min(1e-12)
    order = torch.argsort(-g, dim=-1, stable=True)
    gs = torch.gather(g, -1, order)
    above = torch.cumsum(gs, dim=-1) - gs
    dec_sorted = torch.where(above <= t1, HI, torch.where(above <= t2, LO, SKIP))
    dec_sorted[:, 0] = HI
    dec = torch.empty_like(dec_sorted)
    dec.scatter_(-1, order, dec_sorted)
    return dec


def _expert(wi: torch.Tensor, wo: torch.Tensor, h: torch.Tensor, fp8: bool) -> torch.Tensor:
    z = _mm(h, wi, fp8)
    gate, up = torch.chunk(z, 2, dim=-1)
    return _mm(torch.nn.functional.silu(gate) * up, wo, fp8)


def _moe(p: dict, h: torch.Tensor, decode: torch.Tensor, spec: dict, fp8: bool) -> torch.Tensor:
    """Top-k routing, Eq. 2 precisions at decode positions, experts, combine."""
    router = p["router"].to(torch.float32)
    if fp8:
        logits = h.to(torch.bfloat16).float() @ router.to(torch.bfloat16).float()
    else:
        logits = h @ router
    probs = torch.softmax(logits, dim=-1)
    order = torch.argsort(-probs, dim=-1, stable=True)     # ties: lowest index
    top = order[:, :spec["top_k"]]
    gates = torch.gather(probs, -1, top)
    dec = precision_decisions(gates, *spec["thresholds"])
    dec = torch.where(decode[:, None], dec, torch.full_like(dec, HI))
    kept = torch.where(dec != SKIP, gates, torch.zeros_like(gates))
    y = torch.zeros_like(h)
    wi_all, wo_all = p["experts"]["wi"], p["experts"]["wo"]
    for e in torch.unique(top).tolist():
        for prec in (HI, LO):
            rows, ranks = torch.nonzero((top == e) & (dec == prec), as_tuple=True)
            if rows.numel() == 0:
                continue
            wi, wo = wi_all[e], wo_all[e]
            if prec == LO:
                wi = quantize_dequantize(wi, spec["lo_bits"], spec["group_size"])
                wo = quantize_dequantize(wo, spec["lo_bits"], spec["group_size"])
            out = _expert(wi, wo, h[rows], fp8)
            y.index_add_(0, rows, out * kept[rows, ranks][:, None])
    mass = kept.sum(-1, keepdim=True)
    return torch.where(mass > 0, y / torch.where(mass > 0, mass, 1.0), 0.0)


@torch.no_grad()
def logits(w: dict, spec: dict, tokens: torch.Tensor, n_prompt: int, *,
           fp8: bool = False, first: Optional[int] = None) -> torch.Tensor:
    """Float32 logits (T - first, vocab) at positions first .. T - 1 of
    `tokens` (T,), default first = n_prompt - 1; positions >= n_prompt were
    decoded (Eq. 2 precisions), earlier ones prefilled."""
    t = tokens.shape[0]
    dev = w["embed"].device
    tokens = tokens.to(dev)
    decode = torch.arange(t, device=dev) >= n_prompt
    x = w["embed"][tokens].to(torch.float32)
    for p in w["layers"]:
        x = x + _attention(p["attn"], _norm(p["pre_norm"], x, spec), spec, fp8)
        x = x + _moe(p["ffn"], _norm(p["ffn_norm"], x, spec), decode, spec, fp8)
    first = n_prompt - 1 if first is None else first
    h = _norm(w["final_norm"], x[first:], spec)
    head = w["embed"].T if spec["tied"] else w["lm_head"]
    return _mm(h, head, fp8)[:, :spec["vocab_size"]]
