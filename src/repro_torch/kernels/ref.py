"""Plain PyTorch versions of the hand-written kernels.

The CPU path runs these, the tests hold them against the JAX package, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.  The
grouped functions (the two dequant ones and ``grouped_matmul_ref``) take the
expert pools plus a per-pair ``slot`` index (the kernels read each expert in
place); pass ``slot = arange(P)`` with per-pair tensors for the JAX
package's gathered signature.
"""

from __future__ import annotations

import torch

from repro_torch.quant.quantize import QTensor, dequantize


def dequant_matmul_ref(x: torch.Tensor, q: QTensor) -> torch.Tensor:
    """y = x @ dequant(q) in float32 through the dense weight.  x (..., K);
    q a K x N QTensor.  Returns (..., N) float32."""
    w = dequantize(q, dtype=torch.float32)
    return x.to(torch.float32) @ w


def stacked_gating_ref(x: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """logits[p] = x @ gates[p] in float32.  x (B, D); gates (P, D, E).
    The products are formed elementwise and each (router, row, expert) is
    summed over D on its own, so on the CPU row r's logits for router p
    depend on neither B nor P, as in the kernel (a B-row call equals B
    one-row calls bit for bit, and slice 0 of a P = 2 call a P = 1 call; a
    batched einsum or matmul on the CPU blocks its sums by B and P)."""
    x, gates = x.to(torch.float32), gates.to(torch.float32)
    return (x[None, :, None, :] * gates.transpose(1, 2)[:, None]).sum(-1)


def softmax_last(logits: torch.Tensor) -> torch.Tensor:
    """exp(l - max) / sum(exp(l - max)) over the last axis, written out as
    the Pallas kernel and the JAX predictor write it."""
    z = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return z / z.sum(dim=-1, keepdim=True)


def topk_lowest_index(probs: torch.Tensor, k: int):
    """Iterative argmax top-k over the last axis: each round takes the
    largest value, ties going to the lowest index, then masks it with -1
    (probabilities are >= 0).  torch.topk does not fix the tie order."""
    work = probs.clone()
    vals, idx = [], []
    for _ in range(k):
        i = torch.argmax(work, dim=-1)          # first maximal index
        vals.append(torch.gather(work, -1, i.unsqueeze(-1)).squeeze(-1))
        idx.append(i)
        work.scatter_(-1, i.unsqueeze(-1), -1.0)
    return torch.stack(vals, dim=-1), torch.stack(idx, dim=-1).to(torch.int32)


def gating_topk_ref(x: torch.Tensor, gates: torch.Tensor, *, top_k: int):
    """Router matmul + softmax + top-k.  Returns (logits (P,B,E) f32,
    vals (P,B,K) f32 softmax probabilities of the selected experts,
    idx (P,B,K) int32); ties resolve to the lowest expert index."""
    logits = stacked_gating_ref(x, gates)
    vals, idx = topk_lowest_index(softmax_last(logits), top_k)
    return logits, vals, idx


def _pair_products(x, data, scale, slot, bits: int, group_size: int):
    """y[p] = x[p] @ dequant(data[slot[p]], scale[slot[p]]) in float32.
    A slot outside 0..S-1 raises IndexError (negative ones do not wrap)."""
    sl = slot.to(torch.long)
    if bool(((sl < 0) | (sl >= data.shape[0])).any()):
        raise IndexError(f"slot outside 0..{data.shape[0] - 1}: {slot.tolist()}")
    q = QTensor(data[sl], scale[sl], bits, group_size, x.shape[-1])
    w = dequantize(q, dtype=torch.float32)                  # (P, K, N)
    return torch.einsum("pk,pkn->pn", x.to(torch.float32), w)


def grouped_dequant_matmul_ref(x, data, scale, slot, *, bits: int,
                               group_size: int) -> torch.Tensor:
    """x (P, K); data (S, K//pack, N) int8; scale (S, K//group, N) f32;
    slot (P,) int -> (P, N) float32."""
    return _pair_products(x, data, scale, slot, bits, group_size)


def grouped_dequant_combine_ref(x, data, scale, slot, rows, weights, *,
                                bits: int, group_size: int,
                                num_rows: int) -> torch.Tensor:
    """out[rows[p]] += weights[p] * (x[p] @ dequant(data[slot[p]], ...)),
    added in pair order.  Pad pairs carry rows[p] == num_rows and are dropped;
    rows no pair visits stay 0.  Returns (num_rows, N) float32."""
    y = _pair_products(x, data, scale, slot, bits, group_size)
    out = torch.zeros((num_rows, y.shape[-1]), dtype=torch.float32, device=y.device)
    keep = (rows >= 0) & (rows < num_rows)
    contrib = weights.to(torch.float32)[:, None] * y
    return out.index_add_(0, rows[keep].to(torch.long), contrib[keep])


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """y[p] = x[p] @ w[slot[p]] in float32 (the reference's
    ``einsum("pd,pdc->pc", x, w[slot])``).  x (P, K); w (S, K, N); slot (P,)
    int.  A slot outside 0..S-1 raises IndexError (negative ones do not
    wrap).  Returns (P, N) float32."""
    sl = slot.to(torch.long)
    if bool(((sl < 0) | (sl >= w.shape[0])).any()):
        raise IndexError(f"slot outside 0..{w.shape[0] - 1}: {slot.tolist()}")
    return torch.einsum("pk,pkn->pn", x.to(torch.float32), w[sl].to(torch.float32))


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, scale=None) -> torch.Tensor:
    """Single-token decode attention over a contiguous cache: a masked
    float32 softmax (masked logits -1e30).  q (B, H, hd); k/v (B, S, H, hd)
    with the kv heads already expanded to H; lengths (B,).  A row with
    length <= 0 masks every position, so its weights are uniform over all S
    rows (the mean of V), as in the JAX oracle.  Returns (B, H, hd)
    float32."""
    hd = q.shape[-1]
    s = k.shape[1]
    scale = scale if scale is not None else 1.0 / (hd ** 0.5)
    logits = torch.einsum("bhd,bshd->bhs", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    mask = torch.arange(s, device=q.device)[None, None, :] < lengths.reshape(-1, 1, 1)
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhs,bshd->bhd", w, v.to(torch.float32))


def paged_flash_decode_ref(q: torch.Tensor, pages_k: torch.Tensor, pages_v: torch.Tensor,
                           table: torch.Tensor, lengths: torch.Tensor, *, scale=None,
                           softcap: float = 0.0) -> torch.Tensor:
    """Paged decode attention: gather the slot-contiguous logical K/V view
    through the page table, repeat the GQA heads, then a masked float32
    softmax (softcap before the mask, masked logits -1e30).
    q (B, Hq, hd); pages_k/v (P, psz, Hkv, hd); table (B, maxp) int;
    lengths (B,) int.  Returns (B, Hq, hd) float32, exact zeros where
    lengths == 0.  A page id outside 0..P-1 raises IndexError."""
    b, hq, hd = q.shape
    num_pages, psz, hkv, _ = pages_k.shape
    maxp = table.shape[1]
    t = table.to(torch.long)
    if bool(((t < 0) | (t >= num_pages)).any()):
        raise IndexError(f"page id outside 0..{num_pages - 1} in the table")
    kg = pages_k[t].reshape(b, maxp * psz, hkv, hd)
    vg = pages_v[t].reshape(b, maxp * psz, hkv, hd)
    if hkv != hq:
        kg = kg.repeat_interleave(hq // hkv, dim=2)
        vg = vg.repeat_interleave(hq // hkv, dim=2)
    scale = scale if scale is not None else 1.0 / (hd ** 0.5)
    logits = torch.einsum("bhd,bshd->bhs", q.to(torch.float32),
                          kg.to(torch.float32)) * scale
    if softcap and softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    pos = torch.arange(maxp * psz, device=q.device)
    mask = pos[None, None, :] < lengths.reshape(-1, 1, 1)
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", w, vg.to(torch.float32))
    return torch.where((lengths > 0).reshape(-1, 1, 1), out, torch.zeros_like(out))
