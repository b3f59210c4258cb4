"""Seeded random weights, made on the device in the type they are served
in, in the tree that ``repro_torch``'s ``Model.init`` builds (a CPU test
holds the two trees' shapes and dtypes equal).  One ``randn`` call per
leaf, all layers' experts of a leaf drawn at once per layer.  The same
tensors go to the program and to the plain reference."""

from __future__ import annotations

import math

import torch


def _norm(spec: dict, device) -> dict:
    p = {"scale": torch.zeros((spec["d_model"],), dtype=torch.float32, device=device)}
    if spec["norm"] == "layernorm":
        p["bias"] = torch.zeros((spec["d_model"],), dtype=torch.float32, device=device)
    return p


VOCAB_PAD = 256          # the port pads the vocabulary to a multiple of this


def make_weights(spec: dict, seed: int, device) -> dict:
    """The parameter tree for `spec` (``spec.plain_spec``), drawn from
    `seed`: embedding scale 0.02, every other matrix 1 / sqrt(fan_in),
    norm gains 1 (stored as 0, the port's (1 + scale) form), biases 0; the
    router in float32, the rest in the configuration's dtype."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    d, hd = spec["d_model"], spec["head_dim"]
    hq, hkv = spec["num_heads"], spec["num_kv_heads"]
    e, f = spec["num_experts"], spec["d_ff_expert"]
    v_pad = -(-spec["vocab_size"] // VOCAB_PAD) * VOCAB_PAD
    dtype = getattr(torch, spec["dtype"])

    def draw(shape, scale=None, dt=dtype):
        t = torch.randn(shape, generator=gen, device=device, dtype=dt)
        return t.mul_(scale if scale is not None else 1.0 / math.sqrt(shape[-2]))

    w = {"embed": draw((v_pad, d), 0.02), "final_norm": _norm(spec, device), "layers": []}
    if not spec["tied"]:
        w["lm_head"] = draw((d, v_pad))
    for _ in range(spec["num_layers"]):
        w["layers"].append({
            "pre_norm": _norm(spec, device),
            "attn": {"wq": draw((d, hq * hd)), "wk": draw((d, hkv * hd)),
                     "wv": draw((d, hkv * hd)), "wo": draw((hq * hd, d))},
            "ffn_norm": _norm(spec, device),
            "ffn": {"router": draw((d, e), dt=torch.float32),
                    "experts": {"wi": draw((e, d, 2 * f)), "wo": draw((e, f, d))}},
        })
    return w
