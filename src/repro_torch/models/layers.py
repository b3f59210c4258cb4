"""Layer library of the port: RMSNorm and layernorm, qk-norm, RoPE, the
attention masks (global, sliding-window, chunked), grouped-query attention
for prefill and for one-token decode against a dense per-slot cache (a ring
of `window` slots for windowed layers) or a paged KV pool, DeepSeek-V2's
multi-head latent attention (MLA) over a latent cache, Whisper's
cross-attention into encoder states and its sinusoidal position table, and
the dense FFN.

PyTorch twin of the JAX package's ``models/layers.py`` for the decoder
layers ported so far: full-window "attn" layers (Mixtral / Phi-MoE,
Granite, Nemotron and InternVL2 shapes) and the windowed "attn_local" /
"attn_chunked" layers (Gemma-2, Gemma-3, Llama-4-Scout), with the attention
logit softcap and qk-norm, and MLA layers (DeepSeek-V2: the full-sequence
forward up-projects the latent per head, the decode step attends in the
latent space with the up projections absorbed).  Plain tensor math, written
as the reference writes it (``mha``): float32 scores and softmax, GQA
without materialising repeated K/V heads.  Dense, windowed and MLA decode
and paged prefill-chunk attention have no kernel, as in the reference;
paged decode attention runs ``kernels.ops.paged_flash_decode``, and an FFN
weight that is a `QTensor` runs ``kernels.ops.dequant_matmul``.

Conventions: activations (B, S, D) in the config dtype; q/k/v (B, S, H, hd);
decode takes x (B, 1, D) and a cache {"k", "v"} of (B, Smax, Hkv, hd) (MLA:
{"c_kv": (B, Smax, R), "k_rope": (B, Smax, rope)}) that is updated in place.
Paged layers take one layer's page buffers of (P + 1, psz, Hkv, hd),
updated in place; the last row is a write sink that no page table names
(``models.kv_pages``).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import shard_utils
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


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    """qk-norm over the head dim (Gemma-3): RMSNorm of each head's vector
    with a (1 + scale) gain, in float32, the result in x's dtype."""
    xf = x.to(torch.float32)
    ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(ms + eps)) * (1.0 + scale)).to(x.dtype)


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


def sinusoidal_positions(max_len: int, d: int) -> np.ndarray:
    """(max_len, d) float32 absolute position table (Whisper's decoder and
    encoder): sin then cos of pos / 10000^(2i/d), computed in float64 numpy
    and rounded to float32, as the reference computes it; callers cast it
    to the compute dtype, so bf16 rounds the same float32 values."""
    pos = np.arange(max_len)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / d)
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32)


def make_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, kind: str,
              window: int) -> torch.Tensor:
    """Boolean (..., Sq, Sk) mask, True = attendable.  q_pos / k_pos:
    integer tensors broadcastable to (..., Sq) / (..., Sk).  "attn" is
    causal; "attn_local" also keeps only the last `window` positions;
    "attn_chunked" keeps the query's own `window`-token chunk (floor
    division, so a negative key position falls in no query's chunk)."""
    dq = q_pos[..., :, None]
    dk = k_pos[..., None, :]
    causal = dk <= dq
    if kind == "attn":
        return causal
    if kind == "attn_local":
        return causal & (dq - dk < window)
    if kind == "attn_chunked":
        return causal & (torch.div(dq, window, rounding_mode="floor")
                         == torch.div(dk, window, rounding_mode="floor"))
    raise ValueError(kind)


def _softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """cap * tanh(x / cap); x itself when cap is 0."""
    if cap and cap > 0:
        return torch.tanh(x / cap) * cap
    return x


def _score_spec(b: int, hkv: int, sq: int, sk: int):
    """Sharding cascade for the (B, Hkv, g, Sq, Sk) score tensor under a
    mesh, the reference's: kv heads over `model`; else the query dim, then
    the key dim (context parallel); with a batch that cannot shard
    (long_500k's B = 1) the key dim takes every mesh axis, as the
    context-parallel cache does."""
    mdl = shard_utils.axis_size("model")
    dp = shard_utils.dp_size()
    if mdl * dp <= 1:
        return (None,) * 5
    if b % dp != 0:
        if sk % (dp * mdl) == 0:
            return (None, None, None, None, "all")
        if sk % mdl == 0:
            return (None, None, None, None, "model")
        return (None,) * 5
    if hkv % mdl == 0:
        return ("batch", "model", None, None, None)
    if sq % mdl == 0:
        return ("batch", None, None, "model", None)
    if sk % mdl == 0:
        return ("batch", None, None, None, "model")
    return ("batch", None, None, None, None)


def mha(q, k, v, mask, softcap: float, scale: float) -> torch.Tensor:
    """q: (B,Sq,Hq,hd) k/v: (B,Sk,Hkv,hd); mask (B,Sq,Sk) bool (True =
    attendable).  GQA grouped einsum, float32 softmax.

    Under a mesh the scores are laid out by `_score_spec`.  Split over
    batch, kv heads or queries, every shard's attention is its own: it
    runs on the local shards (``shard_utils.run_local``).  Split over keys
    (the context-parallel layout), the softmax spans shards and DTensor
    carries it."""
    b, sq, hq, hd = q.shape
    hkv = k.shape[2]
    spec = _score_spec(b, hkv, sq, k.shape[1])
    if shard_utils.is_sharded(q):
        qd, kd, md = (spec[0], spec[3], spec[1], None), (spec[0], spec[4], spec[1], None), \
            (spec[0], spec[3], spec[4])
        if spec[4] is None:
            return shard_utils.run_local(
                lambda q, k, v, m: _mha(q, k, v, m, softcap, scale), (q, k, v, mask),
                (qd, kd, kd, md), (qd,), partial_model=(1, 2) if spec[3] else ())
        q = shard_utils.constrain(q, *qd)
        k = shard_utils.constrain(k, *kd)
        v = shard_utils.constrain(v, *kd)
    return _mha(q, k, v, mask, softcap, scale, spec)


def _mha(q, k, v, mask, softcap: float, scale: float, spec=None) -> torch.Tensor:
    b, sq, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    if spec is not None:
        logits = shard_utils.constrain(logits, *spec)
    logits = _softcap(logits, softcap)
    logits = torch.where(mask[:, None, None, :, :], logits,
                         torch.full((), NEG_INF, dtype=logits.dtype, device=logits.device))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v.to(torch.float32))
    return out.reshape(b, sq, hq, hd).to(q.dtype)


def chunked_mha(q, k, v, q_pos, k_pos, kind: str, window: int, softcap: float,
                scale: float, q_chunk: int = 1024) -> torch.Tensor:
    """Attention in query chunks of `q_chunk` (and the tail): the live score
    tensor is (B, Hkv, g, q_chunk, Sk), not (..., Sq, Sk).  Each chunk is
    `mha` over every key with its own rows of the mask, so the numbers are
    `mha`'s.  q_pos (B, Sq), k_pos (B, Sk)."""
    sq = q.shape[1]
    outs = []
    for s0 in range(0, sq, q_chunk):
        s1 = min(s0 + q_chunk, sq)
        mask = make_mask(q_pos[:, s0:s1], k_pos, kind, window)
        outs.append(mha(q[:, s0:s1], k, v, mask, softcap, scale))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def attn_init(cfg: ModelConfig, gen: torch.Generator, device: torch.device,
              cross: bool = False):
    """wq, wk, wv, wo in the config dtype; with qk-norm also the float32
    "q_norm" / "k_norm" gains (zeros: a unit gain).  `cross`: a decoder
    layer's cross-attention into the encoder, whose wk / wv project from
    the encoder's width, without qk-norm."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    dt = dtype_of(cfg)
    kv_d = cfg.encoder.d_model if (cross and cfg.encoder) else d
    p = {
        "wq": dense_init((d, hq * hd), dt, gen, device),
        "wk": dense_init((kv_d, hkv * hd), dt, gen, device),
        "wv": dense_init((kv_d, hkv * hd), dt, gen, device),
        "wo": dense_init((hq * hd, d), dt, gen, device),
    }
    if cfg.qk_norm and not cross:
        p["q_norm"] = torch.zeros((hd,), dtype=torch.float32, device=device)
        p["k_norm"] = torch.zeros((hd,), dtype=torch.float32, device=device)
    return p


def heads(t: torch.Tensor, *shape) -> torch.Tensor:
    """A projection (..., H * hd) reshaped to `shape` (..., H, hd).  Under a
    mesh, a head count the model axis does not divide (6 Whisper heads on
    8 GPUs) first gathers the feature dim, which the weights' layout may
    have split mid-head."""
    if shard_utils.is_sharded(t) and shape[-2] % shard_utils.axis_size("model"):
        t = shard_utils.constrain(t, "batch", *([None] * (t.dim() - 1)))
    return t.reshape(*shape)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(..., H, hd) -> (..., H * hd).  Under a mesh, with a head count the
    model axis does not divide, the merged features are pinned replicated,
    so the gradient coming back from the output projection is gathered
    before it is split into heads again."""
    out = t.reshape(*t.shape[:-2], t.shape[-2] * t.shape[-1])
    if shard_utils.is_sharded(t) and t.shape[-2] % shard_utils.axis_size("model"):
        out = shard_utils.constrain(out, "batch", *([None] * (out.dim() - 1)))
    return out


def _qkv(p, x, positions, cfg: ModelConfig, use_rope: bool = True):
    """q (B, S, Hq, hd), k and v (B, S, Hkv, hd): the projections, qk-norm
    (when the config has it) and then RoPE at `positions` (B, S)."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = heads(x @ p["wq"], b, s, hq, hd)
    k = heads(x @ p["wk"], b, s, hkv, hd)
    v = heads(x @ p["wv"], b, s, hkv, hd)
    if cfg.qk_norm:
        q = rms_head_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_head_norm(p["k_norm"], k, cfg.norm_eps)
    if use_rope and cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_forward(p, x, positions, cfg: ModelConfig, kind: str = "attn",
                 use_rope: bool = True):
    """Full-sequence self attention (prefill) of a layer of `kind`, masked
    by `make_mask`, in query chunks (`chunked_mha`).  positions (B, S).
    Returns (out (B, S, D), (k, v)) with the unexpanded GQA heads."""
    b, s, _ = x.shape
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    q, k, v = _qkv(p, x, positions, cfg, use_rope)
    # under a mesh: the cache keeps the unexpanded GQA heads, laid out as
    # ``sharding.cache_shardings`` lays them (heads over model when they
    # divide it, else the sequence); attention expands the kv heads to the
    # q heads when only those divide the model axis (a layout change: the
    # numbers are the same)
    mdl = shard_utils.axis_size("model")
    kv_head_ax = "model" if hkv % mdl == 0 else None
    kv_seq_ax = None if kv_head_ax else "model"
    kv_out = (shard_utils.constrain(k, "batch", kv_seq_ax, kv_head_ax, None),
              shard_utils.constrain(v, "batch", kv_seq_ax, kv_head_ax, None))
    if mdl > 1 and hkv % mdl != 0 and hq % mdl == 0:
        k = torch.repeat_interleave(k, hq // hkv, dim=2)
        v = torch.repeat_interleave(v, hq // hkv, dim=2)
    h_ok = k.shape[2] % mdl == 0
    q_ax = "model" if hq % mdl == 0 else None
    q = shard_utils.constrain(q, "batch", None, q_ax, None)
    k = shard_utils.constrain(k, "batch", None if h_ok else "model",
                              "model" if h_ok else None, None)
    v = shard_utils.constrain(v, "batch", None if h_ok else "model",
                              "model" if h_ok else None, None)
    out = chunked_mha(q, k, v, positions, positions, kind, cfg.window_size,
                      cfg.attn_logit_softcap, 1.0 / math.sqrt(cfg.resolved_head_dim))
    out = shard_utils.constrain(out, "batch", None, q_ax, None)
    return merge_heads(out) @ p["wo"], kv_out


def attn_decode(p, x, kv_cache, positions, cfg: ModelConfig, kind: str = "attn",
                use_rope: bool = True):
    """One-token decode of a layer of `kind` against its dense cache.
    x: (B, 1, D); kv_cache {"k", "v"}: (B, Smax, Hkv, hd), written in place;
    positions: (B,) int64 current write index.  Returns out (B, 1, D).

    A windowed layer whose cache is no longer than its window is a RING
    (``Model.init_cache`` sizes it min(max_len, window)): position p lives
    at slot p % Smax, and slot j holds position p - ((p - j) mod Smax), so
    slots not yet written map below 0 and are masked.  Whether a cache is a
    ring is read from its shape; nothing leaves the device, so the step can
    be captured."""
    b = x.shape[0]
    q, k, v = _qkv(p, x, positions[:, None], cfg, use_rope)
    smax = kv_cache["k"].shape[1]
    ring = kind != "attn" and smax <= cfg.window_size
    # a full-window cache is clamped like the reference's dynamic_update_slice
    # (only a finished, inactive slot can sit at smax; its row is junk either way)
    at = positions % smax if ring else positions.clamp(max=smax - 1)
    if shard_utils.is_sharded(kv_cache["k"]):
        shard_utils.put_rows(kv_cache["k"], at, k[:, 0])
        shard_utils.put_rows(kv_cache["v"], at, v[:, 0])
    else:
        rows = torch.arange(b, device=x.device)
        kv_cache["k"][rows, at] = k[:, 0].to(kv_cache["k"].dtype)
        kv_cache["v"][rows, at] = v[:, 0].to(kv_cache["v"].dtype)
    idx = torch.arange(smax, device=x.device)[None, :]
    q_pos = positions[:, None]
    if ring:
        k_pos = q_pos - torch.remainder(q_pos - idx, smax)
        mask = make_mask(q_pos, k_pos, kind, cfg.window_size) & (k_pos >= 0)[:, None, :]
    else:
        mask = make_mask(q_pos, idx, kind, cfg.window_size)       # (B, 1, Smax)
    out = mha(q, kv_cache["k"], kv_cache["v"], mask, cfg.attn_logit_softcap,
              1.0 / math.sqrt(cfg.resolved_head_dim))
    return merge_heads(out) @ p["wo"]


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


def cross_attn_forward(p, x, enc_kv, cfg: ModelConfig) -> torch.Tensor:
    """Cross attention of x (B, S, D) into the encoder's keys and values
    enc_kv = (k, v), each (B, F, Hkv, hd), projected once per layer
    (Whisper's decoder): every frame attendable, no softcap, no RoPE.
    Returns (B, S, D)."""
    b, s, _ = x.shape
    hq, hd = cfg.num_heads, cfg.resolved_head_dim
    q = heads(x @ p["wq"], b, s, hq, hd)
    k, v = enc_kv
    mask = torch.ones((b, s, k.shape[1]), dtype=torch.bool, device=x.device)
    out = mha(q, k, v, mask, 0.0, 1.0 / math.sqrt(hd))
    return merge_heads(out) @ p["wo"]


# --------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# --------------------------------------------------------------------------

def mla_init(cfg: ModelConfig, gen: torch.Generator, device: torch.device):
    """wq (D, H (nope + rope)), the down projection w_dkv (D, R + rope), the
    up projections w_uk (R, H nope) and w_uv (R, H v), wo (H v, D) in the
    config dtype; the latent's float32 "kv_norm" gain (zeros: a unit
    gain).  Full-rank queries (q_lora_rank 0), as the reference."""
    m, d, h = cfg.mla, cfg.d_model, cfg.num_heads
    dt = dtype_of(cfg)
    return {
        "wq": dense_init((d, h * (m.nope_head_dim + m.rope_head_dim)), dt, gen, device),
        "w_dkv": dense_init((d, m.kv_lora_rank + m.rope_head_dim), dt, gen, device),
        "w_uk": dense_init((m.kv_lora_rank, h * m.nope_head_dim), dt, gen, device),
        "w_uv": dense_init((m.kv_lora_rank, h * m.v_head_dim), dt, gen, device),
        "wo": dense_init((h * m.v_head_dim, d), dt, gen, device),
        "kv_norm": torch.zeros((m.kv_lora_rank,), dtype=torch.float32, device=device),
    }


def _mla_split_q(p, x, cfg: ModelConfig):
    """(q_nope (B, S, H, nope), q_rope (B, S, H, rope)), RoPE not applied."""
    m = cfg.mla
    b, s, _ = x.shape
    q = heads(x @ p["wq"], b, s, cfg.num_heads, m.nope_head_dim + m.rope_head_dim)
    return q[..., : m.nope_head_dim], q[..., m.nope_head_dim:]


def _mla_compress_kv(p, x, positions, cfg: ModelConfig):
    """(c_kv (B, S, R), k_rope (B, S, 1, rope)): the latent RMS-normed in
    float32 with a (1 + kv_norm) gain and cast back to x's dtype; the rope
    key roped at `positions` (B, S) as a single head."""
    m = cfg.mla
    dkv = x @ p["w_dkv"]                                    # (B, S, R + rope)
    c_kv, k_rope = dkv[..., : m.kv_lora_rank], dkv[..., m.kv_lora_rank:]
    cf = c_kv.to(torch.float32)
    cf = cf * torch.rsqrt(torch.mean(torch.square(cf), dim=-1, keepdim=True) + cfg.norm_eps)
    c_kv = (cf * (1.0 + p["kv_norm"])).to(x.dtype)
    return c_kv, apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)


def mla_forward(p, x, positions, cfg: ModelConfig, q_chunk: int = 1024):
    """Full-sequence MLA (prefill): the latent up-projected to per-head
    k_nope and v in the model dtype, float32 scores (the nope and the rope
    products summed, scaled by 1/sqrt(nope + rope)) under a causal mask, in
    query chunks of `q_chunk` and a ragged tail.  positions (B, S).
    Returns (out (B, S, D), (c_kv (B, S, R), k_rope (B, S, rope))): the
    compressed cache."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.num_heads
    q_nope, q_rope = _mla_split_q(p, x, cfg)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv, k_rope = _mla_compress_kv(p, x, positions, cfg)
    k_nope = heads(c_kv @ p["w_uk"], b, s, h, m.nope_head_dim)
    v = heads(c_kv @ p["w_uv"], b, s, h, m.v_head_dim)
    scale = 1.0 / math.sqrt(m.nope_head_dim + m.rope_head_dim)
    k_rope_2d = k_rope[:, :, 0]

    def attend(q_nope, q_rope, k_nope, k_rope, v, positions):
        k_nope, v = k_nope.to(torch.float32), v.to(torch.float32)
        k_rope_f = k_rope.to(torch.float32)
        outs = []
        for s0 in range(0, s, q_chunk):
            s1 = min(s0 + q_chunk, s)
            logits = (torch.einsum("bqhd,bkhd->bhqk", q_nope[:, s0:s1].to(torch.float32),
                                   k_nope)
                      + torch.einsum("bqhd,bkd->bhqk", q_rope[:, s0:s1].to(torch.float32),
                                     k_rope_f)) * scale
            mask = make_mask(positions[:, s0:s1], positions, "attn", 0)
            logits = torch.where(mask[:, None], logits,
                                 torch.full((), NEG_INF, dtype=logits.dtype,
                                            device=logits.device))
            w = torch.softmax(logits, dim=-1)
            outs.append(torch.einsum("bhqk,bkhd->bqhd", w, v).to(q_nope.dtype))
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)

    args = (q_nope, q_rope, k_nope, k_rope_2d, v, positions)
    if shard_utils.is_sharded(x):   # per batch row and head: each shard its own
        head_ax = "model" if h % shard_utils.axis_size("model") == 0 else None
        rows = "batch" if b % shard_utils.dp_size() == 0 else None
        hd4 = (rows, None, head_ax, None)
        out = shard_utils.run_local(attend, args, (hd4, hd4, hd4, (rows, None, None), hd4,
                                                   (rows, None)), (hd4,),
                                    partial_model=(3,) if head_ax else ())
    else:
        out = attend(*args)
    return merge_heads(out) @ p["wo"], (
        shard_utils.constrain(c_kv, "batch", "model", None),
        shard_utils.constrain(k_rope[:, :, 0], "batch", "model", None))


def mla_decode(p, x, cache, positions, cfg: ModelConfig):
    """Absorbed-matrix MLA decode: attention in the R-wide latent space.
    x (B, 1, D); cache {"c_kv": (B, Smax, R), "k_rope": (B, Smax, rope)},
    this token's latent and rope key written in place at `positions` (B,)
    (clamped to Smax - 1, as the reference's dynamic_update_slice); w_uk
    folded into the query and w_uv applied to the latent output, both in
    float32, as the reference casts them.  Returns out (B, 1, D)."""
    m = cfg.mla
    b = x.shape[0]
    h = cfg.num_heads
    q_nope, q_rope = _mla_split_q(p, x, cfg)                # (B, 1, H, *)
    q_rope = apply_rope(q_rope, positions[:, None], cfg.rope_theta)
    c_new, k_rope_new = _mla_compress_kv(p, x, positions[:, None], cfg)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    smax = c_kv.shape[1]
    at = positions.clamp(max=smax - 1)
    if shard_utils.is_sharded(c_kv):
        shard_utils.put_rows(c_kv, at, c_new[:, 0])
        shard_utils.put_rows(k_rope, at, k_rope_new[:, 0, 0])
    else:
        rows = torch.arange(b, device=x.device)
        c_kv[rows, at] = c_new[:, 0].to(c_kv.dtype)
        k_rope[rows, at] = k_rope_new[:, 0, 0].to(k_rope.dtype)
    w_uk = p["w_uk"].reshape(m.kv_lora_rank, h, m.nope_head_dim)
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope.to(torch.float32), w_uk.to(torch.float32))
    c_f = c_kv.to(torch.float32)
    scale = 1.0 / math.sqrt(m.nope_head_dim + m.rope_head_dim)
    logits = (torch.einsum("bqhr,bkr->bhqk", q_lat, c_f)
              + torch.einsum("bqhd,bkd->bhqk", q_rope.to(torch.float32),
                             k_rope.to(torch.float32))) * scale
    mask = torch.arange(smax, device=x.device)[None, :] <= positions[:, None]
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.full((), NEG_INF, dtype=logits.dtype, device=x.device))
    w = torch.softmax(logits, dim=-1)
    o_lat = torch.einsum("bhqk,bkr->bqhr", w, c_f)                    # (B, 1, H, R)
    w_uv = p["w_uv"].reshape(m.kv_lora_rank, h, m.v_head_dim)
    out = torch.einsum("bqhr,rhd->bqhd", o_lat, w_uv.to(torch.float32)).to(x.dtype)
    return merge_heads(out) @ p["wo"]


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

def ffn_init(cfg: ModelConfig, gen: torch.Generator, device: torch.device,
             d_ff: Optional[int] = None):
    """{"wi": (D, 2F) for SwiGLU else (D, F), "wo": (F, D)} in the config
    dtype; F is `d_ff` (a MoE's shared experts) or the config's."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
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
    h = _matmul(x, p["wi"])
    h = shard_utils.constrain(h, *(("batch",) + (None,) * (h.dim() - 2) + ("model",)))
    return _matmul(activate(h, cfg), p["wo"])
