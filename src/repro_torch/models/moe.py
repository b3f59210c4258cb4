"""Sparse MoE layer of the dense model: top-k router, capacity-based
dispatch, all experts as one batched product, weighted combine.

PyTorch twin of the JAX package's ``models/moe.py`` (single dispatch group;
the reference only splits into groups across a data-parallel mesh).  The
dense model runs it for prefill and for the resident-weights decode path;
the offload engine's decode replaces it with the grouped hi/lo expert path.

  1. router logits (T, E) in float32; softmax; top-k per token (ties to the
     lowest expert index), renormalised combine weights.
  2. capacity C = ceil(T * k * capacity_factor / E) rounded up to 8; a
     token's slot is expert * C + its arrival index within that expert.
     Tokens past capacity are dropped (combine weight 0).
  3. gather into an (E, C, D) buffer, run every expert in one batched
     product, gather back and combine with the gate weights.
  4. shared experts (Llama-4-Scout's one beside its top-1 experts), when
     the config has them: a dense FFN over every token, added.

``moe_forward_dense_eval`` is the reference's dispatch oracle: every
expert on every token, combined by the top-k weights, nothing dropped.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.kernels.ref import topk_lowest_index
from repro_torch.models import layers
from repro_torch.quant.quantize import QTensor, dequantize


class RouterOutput(NamedTuple):
    probs: torch.Tensor        # (T, E) float32 full softmax
    top_w: torch.Tensor        # (T, k) normalised combine weights
    top_idx: torch.Tensor      # (T, k) int32 expert ids
    aux_loss: torch.Tensor     # scalar: load-balance + z loss


def moe_init(cfg: ModelConfig, gen: torch.Generator, device: torch.device):
    mc = cfg.moe
    d, f, e = cfg.d_model, mc.d_ff_expert, mc.num_experts
    wi_cols = 2 * f if cfg.ffn_activation == "swiglu" else f
    dt = layers.dtype_of(cfg)
    # one expert at a time keeps the float32 staging of init small at full width
    wi = torch.stack([layers.dense_init((d, wi_cols), dt, gen, device) for _ in range(e)])
    wo = torch.stack([layers.dense_init((f, d), dt, gen, device) for _ in range(e)])
    p = {"router": layers.dense_init((d, e), torch.float32, gen, device),
         "experts": {"wi": wi, "wo": wo}}
    if mc.num_shared_experts:
        p["shared"] = layers.ffn_init(cfg, gen, device,
                                      d_ff=(mc.d_ff_shared or f) * mc.num_shared_experts)
    return p


def route(router_w, x_flat, mc: MoEConfig) -> RouterOutput:
    """x_flat: (T, D) -> routing decision + aux losses."""
    logits = x_flat.to(torch.float32) @ router_w.to(torch.float32)    # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_idx = topk_lowest_index(probs, mc.top_k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    e = probs.shape[-1]
    hard = F.one_hot(top_idx[:, 0].to(torch.long), e).to(torch.float32)
    lb = e * torch.sum(hard.mean(0) * probs.mean(0)) * mc.router_aux_weight
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1))) * mc.router_z_weight
    return RouterOutput(probs, top_w, top_idx, lb + z)


def _capacity(t: int, mc: MoEConfig) -> int:
    c = int(math.ceil(t * mc.top_k * mc.capacity_factor / mc.num_experts))
    return max(8, -(-c // 8) * 8)  # round up to 8


def dispatch_indices(top_idx, mc: MoEConfig, capacity: int, token_mask=None):
    """(T, k) expert ids -> (T, k) buffer slots in [0, E*C] (E*C = dropped)
    and the keep mask.  token_mask: optional (T,) live-token mask; dead
    tokens take no capacity and combine with weight 0."""
    t, k = top_idx.shape
    e = mc.num_experts
    flat = top_idx.reshape(t * k).to(torch.long)
    onehot = F.one_hot(flat, e)                                  # (T*k, E)
    if token_mask is not None:
        live = token_mask.to(torch.long)[:, None].expand(t, k).reshape(-1)
        onehot = onehot * live[:, None]
    pos = torch.cumsum(onehot, dim=0) - 1                        # arrival index
    pos = torch.sum(pos * onehot, dim=-1)                        # (T*k,)
    keep = pos < capacity
    if token_mask is not None:
        keep = keep & (live > 0)
    slot = torch.where(keep, flat * capacity + pos, torch.full_like(flat, e * capacity))
    return slot.reshape(t, k), keep.reshape(t, k)


def expert_ffn(experts, xb: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """xb: (E, C, D) -> (E, C, D) through each expert's FFN."""
    h = torch.einsum("ecd,edf->ecf", xb, experts["wi"])
    return torch.einsum("ecf,efd->ecd", layers.activate(h, cfg), experts["wo"])


def moe_forward(p, x: torch.Tensor, cfg: ModelConfig, token_mask=None):
    """x: (B, S, D).  Returns (y (B, S, D), aux_loss)."""
    mc = cfg.moe
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    r = route(p["router"], xf, mc)
    e = mc.num_experts
    cap = _capacity(t, mc)
    slot, keep = dispatch_indices(r.top_idx, mc, cap, token_mask)
    # inverse slot map: slot -> token row (t = the zero pad row)
    # each token's row repeated top_k times (expand, not repeat_interleave:
    # nothing here may synchronise inside a captured decode step)
    tok_idx = torch.arange(t, device=x.device)[:, None].expand(t, mc.top_k).reshape(-1)
    gather_rows = torch.full((e * cap + 1,), t, dtype=torch.long, device=x.device)
    gather_rows[slot.reshape(-1)] = tok_idx
    xpad = torch.cat([xf, torch.zeros((1, d), dtype=xf.dtype, device=x.device)])
    xb = xpad[gather_rows[: e * cap]].reshape(e, cap, d)
    yb = expert_ffn(p["experts"], xb, cfg).reshape(e * cap, d)
    ypad = torch.cat([yb, torch.zeros((1, d), dtype=yb.dtype, device=x.device)])
    y_choice = ypad[slot.reshape(-1)].reshape(t, mc.top_k, d)
    w = (r.top_w * keep.to(r.top_w.dtype)).to(x.dtype)
    y = torch.einsum("tk,tkd->td", w, y_choice)
    if "shared" in p:
        y = y + layers.ffn_forward(p["shared"], xf, cfg)
    return y.reshape(b, s, d), r.aux_loss


def moe_forward_dense_eval(p, x: torch.Tensor, cfg: ModelConfig):
    """Oracle of the dispatch path: every expert on every token (O(E) work),
    combined by the top-k gate weights, no capacity and no drops; the
    shared experts added as in `moe_forward`.  x: (B, S, D).  Returns
    (y (B, S, D), the router's output)."""
    mc = cfg.moe
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    r = route(p["router"], xf, mc)
    wi, wo = p["experts"]["wi"], p["experts"]["wo"]
    if isinstance(wi, QTensor):
        wi = dequantize(wi, dtype=x.dtype)
    if isinstance(wo, QTensor):
        wo = dequantize(wo, dtype=x.dtype)
    h = layers.activate(torch.einsum("td,edf->etf", xf, wi), cfg)
    ye = torch.einsum("etf,efd->etd", h, wo)                        # (E, T, D)
    gate = torch.zeros((b * s, mc.num_experts), dtype=r.top_w.dtype, device=x.device)
    gate.scatter_(1, r.top_idx.to(torch.long), r.top_w)
    y = torch.einsum("te,etd->td", gate, ye.to(r.top_w.dtype)).to(x.dtype)
    if "shared" in p:
        y = y + layers.ffn_forward(p["shared"], xf, cfg)
    return y.reshape(b, s, d), r
