"""Model FLOPs of the configurations' forward steps, counted from shapes
(frozen with the benchmark).  A multiply-add is 2 FLOPs.  A token's step
counts its q/k/v/o projections, attention over its context (QK^T and PV),
the router, its top-k experts (SwiGLU: wi d x 2f, wo f x d) and the head;
the embedding gather and the norms count nothing.  Routed experts only:
neither the capacity einsum's padding nor skipped or duplicated work."""

from __future__ import annotations


def _fixed_per_layer(spec: dict) -> float:
    d, hd = spec["d_model"], spec["head_dim"]
    hq, hkv = spec["num_heads"], spec["num_kv_heads"]
    e, k, f = spec["num_experts"], spec["top_k"], spec["d_ff_expert"]
    return (2.0 * d * (hq + 2 * hkv) * hd + 2.0 * hq * hd * d
            + 2.0 * d * e + k * 6.0 * d * f)


def _attn_per_key(spec: dict) -> float:
    return 4.0 * spec["num_heads"] * spec["head_dim"]


def token_flops(spec: dict, context: int) -> float:
    """One token's forward through every layer and the head, attending to
    `context` keys (itself included)."""
    layers = spec["num_layers"]
    return (layers * (_fixed_per_layer(spec) + _attn_per_key(spec) * context)
            + 2.0 * spec["d_model"] * spec["vocab_size"])


def chunk_flops(spec: dict, start: int, n: int, *, head: bool = False) -> float:
    """A prefill chunk of n tokens at positions start .. start + n - 1 (causal:
    position p attends to p + 1 keys); the head runs on the chunk's last
    token only when `head`."""
    if n <= 0:
        return 0.0
    keys = n * start + n * (n + 1) / 2.0
    layers = spec["num_layers"]
    out = layers * (n * _fixed_per_layer(spec) + _attn_per_key(spec) * keys)
    return out + (2.0 * spec["d_model"] * spec["vocab_size"] if head else 0.0)
