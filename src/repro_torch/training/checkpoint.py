"""Checkpoints of the port in the JAX package's format, readable by both.

A checkpoint directory holds ``step_<n>.npz`` (leaves ``a0, a1, ...``),
``step_<n>.json`` (each leaf's tree path and dtype, bfloat16 stored as a
uint16 view under the dtype ``__bf16__``) and ``latest``.  ``save`` writes
the port's parameters in the reference's tree layout (``prefix`` /
``blocks`` stacked over the scanned blocks / ``tail`` / ``encoder``,
``weights.to_jax_params``) with the leaves in ``jax.tree_util``'s flatten
order (dict keys sorted, lists in order), so the reference's ``restore``
loads it into ``Model.init``'s tree.  ``restore`` reads a checkpoint of
either package through ``weights.load_checkpoint`` and ``from_jax_params``
and holds every leaf's shape to the tree it restores into.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.weights import _BF16, from_jax_params, latest_step, load_checkpoint, \
    to_jax_params, tree_flatten

__all__ = ["latest_step", "restore", "save"]


def save(ckpt_dir: str, params, step: int = 0, *, cfg: ModelConfig) -> str:
    """Write the port's `params` (of the model `cfg`) as checkpoint `step`
    of `ckpt_dir`; returns the .npz path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays, meta = {}, {"step": step, "leaves": {}}
    for i, (path, leaf) in enumerate(tree_flatten(to_jax_params(cfg, params))):
        key = f"a{i}"
        if leaf.dtype == torch.bfloat16:
            arr, dt = leaf.view(torch.int16).numpy().view(np.uint16), _BF16
        else:
            arr = leaf.numpy()
            dt = str(arr.dtype)
        arrays[key] = arr
        meta["leaves"][key] = {"path": path, "dtype": dt}
    np.savez(os.path.join(ckpt_dir, f"step_{step}.npz"), **arrays)
    with open(os.path.join(ckpt_dir, f"step_{step}.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(ckpt_dir, "latest"), "w") as f:
        f.write(str(step))
    return os.path.join(ckpt_dir, f"step_{step}.npz")


def _check_like(got, like, path: str = "") -> None:
    if isinstance(like, dict):
        if not isinstance(got, dict) or sorted(got) != sorted(like):
            raise ValueError(f"{path or 'params'}: keys "
                             f"{sorted(got) if isinstance(got, dict) else type(got)} != "
                             f"{sorted(like)}")
        for k in like:
            _check_like(got[k], like[k], f"{path}/{k}" if path else k)
    elif isinstance(like, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(like):
            raise ValueError(f"{path}: {len(got)} entries != {len(like)}")
        for i, (g, w) in enumerate(zip(got, like)):
            _check_like(g, w, f"{path}/{i}")
    elif tuple(got.shape) != tuple(like.shape):
        raise ValueError(f"leaf {path}: shape {tuple(got.shape)} != {tuple(like.shape)}")


def restore(ckpt_dir: str, like, step: Optional[int] = None, *,
            cfg: ModelConfig) -> Tuple[Any, int]:
    """Checkpoint `step` (default the latest) of `ckpt_dir`, written by
    either package, as the port's parameters of the model `cfg` on the
    device of `like` (parameters of that model), every leaf's shape held
    to `like`'s.  Returns (params, step)."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    params = from_jax_params(cfg, load_checkpoint(ckpt_dir, step),
                             device=like["embed"].device)
    _check_like(params, like)
    return params, step
