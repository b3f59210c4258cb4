"""Parameters from the JAX package: its parameter tree, or its checkpoints.

``load_checkpoint(dir)`` reads the ``training/checkpoint.py`` format (one
``step_<n>.npz`` of leaves ``a0, a1, ...`` plus a ``step_<n>.json`` manifest
naming each leaf's tree path and dtype, bfloat16 stored as a uint16 view)
with numpy alone, so ``--ckpt-dir`` works without JAX.  It returns the
nested tree (lists for integer path components) of float arrays.

``from_jax_params(cfg, tree)`` turns that tree — or the reference's live
parameters mapped to numpy — into the port's flat per-layer layout, so the
port and the reference compute the same function.  A quantized leaf (the
reference's ``quantize_tree`` output: an object with ``data``, ``scale``,
``bits``, ``group_size`` and ``orig_k``, its arrays stacked over the scanned
blocks) becomes one `QTensor` per layer.

``to_jax_params(cfg, params)`` is its inverse for plain (unquantized)
parameters: the port's flat per-layer list back into the reference's
layout (``prefix`` / ``blocks`` stacked over the scanned blocks / ``tail``,
plus ``encoder``), each leaf a CPU tensor in its own dtype, which
``training.checkpoint.save`` writes in the reference's format.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import dtype_of
from repro_torch.quant.quantize import QTensor

_BF16 = "__bf16__"


def _bf16_bits_to_f32(u16: np.ndarray) -> np.ndarray:
    return (u16.astype(np.uint32) << 16).view(np.float32)


def _as_f32(arr) -> np.ndarray:
    """A float array as float32 numpy (bfloat16 values are exact in f32)."""
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        return _bf16_bits_to_f32(a.view(np.uint16))
    return a.astype(np.float32, copy=False)


def _insert(tree: Dict[str, Any], path: List[str], leaf) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        default: Any = [] if nxt.isdigit() else {}
        if isinstance(node, list):
            i = int(key)
            while len(node) <= i:
                node.append(None)
            if node[i] is None:
                node[i] = default
            node = node[i]
        else:
            node = node.setdefault(key, default)
    last = path[-1]
    if isinstance(node, list):
        i = int(last)
        while len(node) <= i:
            node.append(None)
        node[i] = leaf
    else:
        node[last] = leaf


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = os.path.join(ckpt_dir, "latest")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def load_checkpoint(ckpt_dir: str, step: Optional[int] = None) -> Dict[str, Any]:
    """Read a JAX-package checkpoint into a nested tree of float32 numpy
    arrays (bfloat16 leaves widened exactly)."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    with open(os.path.join(ckpt_dir, f"step_{step}.json")) as f:
        meta = json.load(f)
    tree: Dict[str, Any] = {}
    with np.load(os.path.join(ckpt_dir, f"step_{step}.npz")) as data:
        for key, entry in meta["leaves"].items():
            arr = data[key]
            if entry["dtype"] == _BF16:
                arr = _bf16_bits_to_f32(arr.view(np.uint16))
            _insert(tree, entry["path"].split("/"), arr)
    return tree


def _flat_layers(cfg: ModelConfig, tree) -> List[Dict[str, Any]]:
    """(prefix, stacked blocks, tail) -> one param dict per layer, as the
    reference's ``unstack_layers`` flattens them."""
    out = list(tree.get("prefix") or [])
    blocks = tree.get("blocks") or []
    for i in range(cfg.num_blocks):
        for j in range(cfg.period):
            out.append(_index_tree(blocks[j], i))
    out.extend(tree.get("tail") or [])
    return out


def _is_quantized(node) -> bool:
    # an array is never one (and `.data` of a bfloat16 numpy array raises)
    if isinstance(node, (np.ndarray, torch.Tensor)):
        return False
    return all(hasattr(node, a) for a in ("data", "scale", "bits", "group_size", "orig_k"))


def _index_tree(node, i: int):
    if isinstance(node, dict):
        return {k: _index_tree(v, i) for k, v in node.items()}
    if _is_quantized(node):
        return QTensor(np.asarray(node.data)[i], np.asarray(node.scale)[i], int(node.bits),
                       int(node.group_size), int(node.orig_k))
    return np.asarray(node)[i]


def _to_torch(node, dtype: torch.dtype, device: torch.device, f32_keys=()):
    if isinstance(node, dict):
        return {k: _to_torch(v, torch.float32 if k in f32_keys else dtype, device,
                             f32_keys) for k, v in node.items()}
    if isinstance(node, list):      # the encoder's layers
        return [_to_torch(v, dtype, device, f32_keys) for v in node]
    if _is_quantized(node):
        # int8 codes and float32 scales as they are, whatever the config dtype
        data = torch.from_numpy(np.array(node.data, dtype=np.int8)).to(device)
        scale = torch.from_numpy(np.array(_as_f32(node.scale))).to(device)
        return QTensor(data, scale, int(node.bits), int(node.group_size), int(node.orig_k))
    return torch.from_numpy(np.array(_as_f32(node))).to(device=device, dtype=dtype)


def from_jax_params(cfg: ModelConfig, params, device: DeviceLike = "cuda"):
    """The reference's parameter tree (numpy leaves, stacked ``blocks/<j>/...``
    layout, the scanned blocks at any period plus the tail) as the port's
    parameters on `device`.  Matrices take the config dtype, the untied
    ``lm_head``, a MoE's ``shared`` experts and an SSM mixer's
    ``in_proj`` / ``conv_w`` / ``out_proj`` too; norm scales (and layernorm
    biases) -- the sandwich norms, the qk-norm gains, MLA's latent
    ``kv_norm`` and the SSM's gated ``norm`` among them -- routers and the
    SSM's ``A_log``, ``D``, ``dt_bias`` and ``conv_b`` stay float32, as the
    reference keeps them.  Whisper's ``encoder`` (its layernorms ``norm1``,
    ``norm2`` and ``final_norm`` float32, the rest in the config dtype) and
    each decoder layer's ``cross`` projections and float32 ``cross_norm``
    map as they are."""
    dev = resolve_device(device)
    dt = dtype_of(cfg)
    f32_keys = ("pre_norm", "ffn_norm", "post_norm", "post_ffn_norm", "q_norm", "k_norm",
                "kv_norm", "final_norm", "router", "norm", "A_log", "D", "dt_bias", "conv_b",
                "cross_norm", "norm1", "norm2")
    out: Dict[str, Any] = {
        "embed": _to_torch(params["embed"], dt, dev),
        "final_norm": _to_torch(params["final_norm"], torch.float32, dev),
        "layers": [_to_torch(lp, dt, dev, f32_keys) for lp in _flat_layers(cfg, params)],
    }
    if "lm_head" in params:
        out["lm_head"] = _to_torch(params["lm_head"], dt, dev)
    if "encoder" in params:
        out["encoder"] = _to_torch(params["encoder"], dt, dev, f32_keys)
    if len(out["layers"]) != cfg.num_layers:
        raise ValueError(f"{cfg.name}: tree holds {len(out['layers'])} layers, "
                         f"config has {cfg.num_layers}")
    return out


def tree_flatten(tree, prefix: str = ""):
    """(path, leaf) pairs of a tree of dicts and lists in jax.tree_util's
    order (dict keys sorted, lists in order), path components joined by
    '/' as the checkpoint manifest writes them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_flatten(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_flatten(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def tree_leaves(tree) -> list:
    """The leaves of `tree` in ``tree_flatten``'s order."""
    return [leaf for _, leaf in tree_flatten(tree)]


def tree_map(fn, tree, *rest):
    """`fn` over the leaves of `tree` and of equally shaped trees, walking
    dicts in sorted key order (so a map's leaves come out in
    ``tree_leaves``' order)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, *xs) for xs in zip(tree, *rest)]
    return fn(tree, *rest)


def to_jax_params(cfg: ModelConfig, params) -> Dict[str, Any]:
    """The port's parameters (or a tree shaped like them, such as their
    gradients) in the reference's layout: ``prefix`` and ``tail`` lists of
    layer dicts, ``blocks`` a list over the period of dicts whose leaves
    stack the scanned blocks' layers (block-major, as ``_flat_layers``
    reads them), ``embed`` / ``final_norm`` / ``lm_head`` / ``encoder`` as
    they are; every leaf a detached CPU tensor in its own dtype."""
    def cpu(t):
        if isinstance(t, QTensor):
            raise TypeError("to_jax_params takes plain parameters, not QTensor leaves")
        return t.detach().to("cpu")

    lys = params["layers"]
    np_, nb, per = len(cfg.prefix_pattern), cfg.num_blocks, cfg.period
    if len(lys) != cfg.num_layers:
        raise ValueError(f"{cfg.name}: {len(lys)} layers, config has {cfg.num_layers}")
    out: Dict[str, Any] = {k: tree_map(cpu, v) for k, v in params.items() if k != "layers"}
    out["prefix"] = [tree_map(cpu, lp) for lp in lys[:np_]]
    out["blocks"] = [tree_map(lambda *xs: torch.stack([cpu(x) for x in xs]),
                              *[lys[np_ + i * per + j] for i in range(nb)])
                     for j in range(per)] if nb else []
    out["tail"] = [tree_map(cpu, lp) for lp in lys[np_ + nb * per:]]
    return out
