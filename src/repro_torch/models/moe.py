"""Sparse MoE layer of the dense model: top-k router, capacity-based
dispatch, all experts as one batched product, weighted combine.

PyTorch twin of the JAX package's ``models/moe.py``: one dispatch group on
a single device; over a data-parallel mesh (``shard_utils.mesh_scope``) the
tokens split into one group per data shard, as in the reference.  The
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

import dataclasses
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.kernels.ref import topk_lowest_index
from repro_torch.models import layers, shard_utils
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


def _router(router_w, x_flat, mc: MoEConfig):
    """(logits (T, E) float32, probs, normalised top-k weights, top-k ids)."""
    logits = x_flat.to(torch.float32) @ router_w.to(torch.float32)    # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_idx = topk_lowest_index(probs, mc.top_k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, top_w, top_idx


def route(router_w, x_flat, mc: MoEConfig) -> RouterOutput:
    """x_flat: (T, D) -> routing decision + aux losses."""
    logits, probs, top_w, top_idx = _router(router_w, x_flat, mc)
    e = probs.shape[-1]
    hard = F.one_hot(top_idx[:, 0].to(torch.long), e).to(torch.float32)
    lb = e * torch.sum(hard.mean(0) * probs.mean(0)) * mc.router_aux_weight
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1))) * mc.router_z_weight
    return RouterOutput(probs, top_w, top_idx, lb + z)


def _route_sharded(router_w, xf, mc: MoEConfig) -> RouterOutput:
    """`route` under a mesh: each data shard routes its own tokens on local
    tensors (the router weight gathered), and the aux losses' token means
    come from the shards' partial sums.  With a batch the data axes do not
    divide, every rank routes every token."""
    e, t = mc.num_experts, xf.shape[0]
    split = t % shard_utils.dp_size() == 0

    def local(x, w):
        logits, probs, top_w, top_idx = _router(w, x, mc)
        hard = F.one_hot(top_idx[:, 0].to(torch.long), e).to(torch.float32)
        return (probs, top_w, top_idx, hard.sum(0), probs.sum(0),
                torch.square(torch.logsumexp(logits, dim=-1)).sum())

    tok = ("batch" if split else None, None)
    whole = "sum" if split else (None,)
    probs, top_w, top_idx, f_sum, p_sum, z_sum = shard_utils.run_local(
        local, (xf, router_w), (tok, (None, None)),
        (tok, tok, tok, whole, whole, "sum" if split else ()), partial_data=(1,))
    lb = e * torch.sum((f_sum / t) * (p_sum / t)) * mc.router_aux_weight
    return RouterOutput(probs, top_w, top_idx, lb + (z_sum / t) * mc.router_z_weight)


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


def expert_ffn(experts, xb: torch.Tensor, cfg: ModelConfig, tok_ax=None) -> torch.Tensor:
    """xb: (E, C, D) or (G, E, C, D) -> the same shape through each expert's
    FFN.  `QTensor` expert weights are dequantized to xb's dtype first, as
    the reference does.

    Sharded (an active mesh, DTensor operands): experts over `model` when E
    divides it, otherwise the hidden d_ff dim takes the model axis
    (megatron-style within each expert); with G > 1 groups the group dim
    carries the data axes.  `tok_ax` is the token dim's axis token of the
    single-group path."""
    wi, wo = (_dequantized(experts[n], xb.dtype) for n in ("wi", "wo"))
    grouped = xb.dim() == 4
    e = xb.shape[1] if grouped else xb.shape[0]
    e_ok = e % shard_utils.axis_size("model") == 0
    e_ax = "model" if e_ok else None
    f_ax = None if e_ok else "model"
    if grouped:
        def ffn(xb, wi, wo):
            h = torch.einsum("gecd,edf->gecf", xb, wi)
            return torch.einsum("gecf,efd->gecd", layers.activate(h, cfg), wo)

        if shard_utils.is_sharded(xb) and e_ok:
            # FSDP: the experts' data-sharded dims gathered once per call;
            # then every (group, expert) shard is its own product
            g_ax = "batch" if xb.shape[0] > 1 else None
            return shard_utils.run_local(
                ffn, (xb, wi, wo), ((g_ax, e_ax, None, None), (e_ax, None, None),
                                    (e_ax, None, None)), ((g_ax, e_ax, None, None),),
                partial_data=(1, 2) if g_ax else ())
        wi = shard_utils.constrain(wi, e_ax, None, f_ax)
        wo = shard_utils.constrain(wo, e_ax, f_ax, None)
        h = torch.einsum("gecd,edf->gecf", xb, wi)
        h = shard_utils.constrain(h, "batch" if xb.shape[0] > 1 else None, e_ax, None, f_ax)
        return torch.einsum("gecf,efd->gecd", layers.activate(h, cfg), wo)
    h = torch.einsum("ecd,edf->ecf", xb, wi)
    # the decode path (few tokens, E divides the model axis) leaves h to
    # follow the weights' layout: forcing it replicated would gather the
    # column-sharded decode-mode expert weights
    if tok_ax is not None or not e_ok:
        h = shard_utils.constrain(h, e_ax, tok_ax, f_ax)
    return torch.einsum("ecf,efd->ecd", layers.activate(h, cfg), wo)


def _dequantized(w, dtype):
    """An expert weight in `dtype`: a `QTensor` dequantized, its codes and
    scales first made whole along the contraction dim under a mesh (a shard
    of K need not hold whole groups)."""
    if not isinstance(w, QTensor):
        return w
    w = dataclasses.replace(w, data=shard_utils.gather_dim(w.data, -2),
                            scale=shard_utils.gather_dim(w.scale, -2))
    return dequantize(w, dtype=dtype)


def _group_dispatch(top_idx, xg, mask, mc: MoEConfig, cap: int):
    """Each group's capacity dispatch on local tensors: top_idx (G, tl, k),
    xg (G, tl, D), mask (G, tl) or None -> slot, keep (G, tl, k) and the
    expert buffers (G, E * cap, D), a dropped or empty slot holding zeros."""
    g, tl, k = top_idx.shape
    d = xg.shape[-1]
    e = mc.num_experts
    per = [dispatch_indices(top_idx[i], mc, cap, None if mask is None else mask[i])
           for i in range(g)]
    slot = torch.stack([sl for sl, _ in per])
    keep = torch.stack([kp for _, kp in per])
    tok_idx = torch.arange(tl, device=xg.device)[:, None].expand(tl, k).reshape(-1)
    gather_rows = torch.full((g, e * cap + 1), tl, dtype=torch.long, device=xg.device)
    gather_rows.scatter_(1, slot.reshape(g, -1), tok_idx[None].expand(g, -1))
    xpad = torch.cat([xg, torch.zeros((g, 1, d), dtype=xg.dtype, device=xg.device)], dim=1)
    rows = gather_rows[:, : e * cap]
    xb = torch.gather(xpad, 1, rows[..., None].expand(g, e * cap, d))
    return slot, keep, xb


def _group_combine(yb, slot):
    """Each group's expert outputs (G, E * cap, D) read back at the tokens'
    slots (G, tl, k) -> (G, tl * k, D), the drop slot reading zeros."""
    g, _, d = yb.shape
    ypad = torch.cat([yb, torch.zeros((g, 1, d), dtype=yb.dtype, device=yb.device)], dim=1)
    sl = slot.reshape(g, -1).to(torch.long)
    return torch.gather(ypad, 1, sl[..., None].expand(g, sl.shape[1], d))


def _on_shards(fn, grouped: bool, n_out: int, *args):
    """fn(*args) on each rank's local tensors (``shard_utils.run_local``):
    with groups the group dim of every operand and of the three-dim results
    is split over the data axes, otherwise everything is replicated.  The
    data-dependent scatter and gathers of the dispatch have no DTensor
    sharding rule, and the grouping keeps each group on one data shard."""
    lead = "batch" if grouped else None
    dims = tuple((lead,) + (None,) * (x.dim() - 1) for x in args)
    return shard_utils.run_local(fn, args, dims, ((lead, None, None),) * n_out)


def moe_forward(p, x: torch.Tensor, cfg: ModelConfig, token_mask=None,
                groups: Optional[int] = None):
    """x: (B, S, D).  Returns (y (B, S, D), aux_loss).

    GShard-style grouped dispatch, as the reference: the tokens split into
    G groups (default the data-parallel size of the active mesh, when
    every group holds at least 512 tokens; 1 without a mesh), capacity
    counted per group, so each group's gather and scatter stay on one data
    shard.  With one group on a single device this is the plain dispatch."""
    mc = cfg.moe
    b, s, d = x.shape
    t = b * s
    xf = shard_utils.constrain(x.reshape(t, d), "batch", None)
    sharded = shard_utils.is_sharded(xf)
    r = (_route_sharded if sharded else route)(p["router"], xf, mc)
    e = mc.num_experts
    g = groups if groups is not None else shard_utils.dp_size()
    if groups is None and (t % g or t // g < 512):
        g = 1
    if t % g:
        g = 1
    tl = t // g
    cap = _capacity(tl, mc)
    mesh = shard_utils.active_mesh() if sharded else None
    if g == 1 and mesh is None:
        return _moe_single(p, xf, r, cfg, cap, token_mask).reshape(b, s, d), r.aux_loss
    tok_ax = "batch" if cap >= 512 or g > 1 else None
    e_ax = "model" if e % shard_utils.axis_size("model") == 0 else None
    # one group per data shard: each rank regroups its own rows
    regroup = shard_utils.local_reshape if mesh is not None and g > 1 else _reshape
    top_idx = regroup(r.top_idx, g, tl, mc.top_k)
    xg = shard_utils.constrain(regroup(xf, g, tl, d), "batch" if g > 1 else None,
                               None if g > 1 else tok_ax, None)
    mask = None if token_mask is None else regroup(token_mask, g, tl)
    if mesh is None:
        slot, keep, xb = _group_dispatch(top_idx, xg, mask, mc, cap)
    else:
        slot, keep, xb = _on_shards(
            lambda ti, xl, mk=None: _group_dispatch(ti, xl, mk, mc, cap), g > 1, 3,
            top_idx, xg, *(() if mask is None else (mask,)))
    xb = xb.reshape(g, e, cap, d)
    if g > 1:
        xb = shard_utils.constrain(xb, "batch", e_ax, None, None)
        yb = expert_ffn(p["experts"], xb, cfg)
    else:
        xb0 = shard_utils.constrain(xb[0], e_ax, tok_ax, None)
        yb = expert_ffn(p["experts"], xb0, cfg, tok_ax=tok_ax)[None]
    yb = yb.reshape(g, e * cap, d)
    if mesh is None:
        y_choice = _group_combine(yb, slot)
    else:
        y_choice = _on_shards(_group_combine, g > 1, 1, yb, slot)
    y_choice = shard_utils.constrain(regroup(y_choice, t, mc.top_k, d), "batch", None, None)
    top_w = shard_utils.constrain(r.top_w, "batch", None)
    w = (top_w * regroup(keep, t, mc.top_k).to(top_w.dtype)).to(x.dtype)
    y = torch.einsum("tk,tkd->td", w, y_choice)
    if "shared" in p:
        y = y + layers.ffn_forward(p["shared"], xf, cfg)
    # back to x's layout: tokens over the data axes only where the batch
    # rows split over them (a split of the merged token dim would not)
    y = shard_utils.constrain(y, "batch" if b % shard_utils.dp_size() == 0 else None, None)
    return y.reshape(b, s, d), r.aux_loss


def _reshape(x, *shape):
    return x.reshape(shape)


def _moe_single(p, xf, r: RouterOutput, cfg: ModelConfig, cap: int, token_mask):
    """The one-group dispatch on one device: xf (T, D) -> y (T, D)."""
    mc = cfg.moe
    t, d = xf.shape
    e = mc.num_experts
    slot, keep = dispatch_indices(r.top_idx, mc, cap, token_mask)
    # inverse slot map: slot -> token row (t = the zero pad row)
    # each token's row repeated top_k times (expand, not repeat_interleave:
    # nothing here may synchronise inside a captured decode step)
    tok_idx = torch.arange(t, device=xf.device)[:, None].expand(t, mc.top_k).reshape(-1)
    gather_rows = torch.full((e * cap + 1,), t, dtype=torch.long, device=xf.device)
    gather_rows[slot.reshape(-1)] = tok_idx
    xpad = torch.cat([xf, torch.zeros((1, d), dtype=xf.dtype, device=xf.device)])
    xb = xpad[gather_rows[: e * cap]].reshape(e, cap, d)
    yb = expert_ffn(p["experts"], xb, cfg).reshape(e * cap, d)
    ypad = torch.cat([yb, torch.zeros((1, d), dtype=yb.dtype, device=xf.device)])
    y_choice = ypad[slot.reshape(-1)].reshape(t, mc.top_k, d)
    w = (r.top_w * keep.to(r.top_w.dtype)).to(xf.dtype)
    y = torch.einsum("tk,tkd->td", w, y_choice)
    if "shared" in p:
        y = y + layers.ffn_forward(p["shared"], xf, cfg)
    return y


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
