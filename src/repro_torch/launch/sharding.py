"""Sharding rules of the port: parameter / cache tree -> spec tree -> DTensor
placements.

The JAX package's ``launch/sharding.py`` rule table, unchanged: rules are
name-based (path substrings) with divisibility-aware degradation -- an axis
is applied only to a tensor dim whose size it divides, otherwise that dim is
replicated -- so one table serves every architecture.

A spec is written as the reference writes a ``PartitionSpec``: a tuple with
one entry per tensor dim, each None, an axis name or a tuple of axis names
(in mesh order).  ``placements`` converts a spec to DTensor placements: a
mesh axis that names tensor dim d becomes ``Shard(d)``, an axis no dim names
``Replicate()``; a tuple such as ("pod", "data") on one dim shards it over
both mesh dims, pod-major, as XLA does.  ``fit_spec`` drops every axis that
does not divide its dim, so DTensor's uneven sharding is never used.  Those
two, and the cache layout ``cache_spec``, are pure mesh and spec arithmetic
that the model also applies: they live in ``models/shard_utils.py`` and are
re-exported here.

The port's paths are its flat per-layer tree (``layers/3/ffn/experts/wi``),
the reference's the stacked one (``blocks/0/ffn/experts/wi`` with a leading
block dim).  Rules match path substrings and trailing dims, so one table
serves both.  Meshes: a ``DeviceMesh``, or any object with ``axis_names``
and a ``shape`` mapping each name to its size (the reference's ``Mesh``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.models.shard_utils import (Spec, axis_names, axis_product, axis_sizes,
                                            cache_spec, dp_spec, fit_spec, placements)
from repro_torch.weights import tree_flatten, tree_map

__all__ = ["Spec", "axis_names", "axis_sizes", "fit_spec", "placements", "cache_spec",
           "param_rules", "spec_for_param", "param_shardings", "batch_spec",
           "cache_shardings", "replicated", "distribute", "distribute_tree",
           "distribute_params"]


# Rule table: (substring, base_spec_for_last_ndims). First match wins.
# Specs are written for the *trailing* dims; leading dims are replicated.
#
# mode="train": expert weights FSDP-shard their d_model/d_ff dims over `data`.
# mode="decode": megatron column/row sharding inside each expert so weights
#   never move at decode time; the only comm is a small activation reduction.
def param_rules(dp, mp, mode: str = "train"):
    if mode == "decode":
        return [
            ("experts/wi", (mp, None, dp)),  # (E, D, 2F): col-sharded
            ("experts/wo", (mp, dp, None)),  # (E, F, D): row-sharded
        ] + _common_rules(dp, mp)
    return [
        ("experts/wi", (mp, dp, None)),      # (E, D, 2F)
        ("experts/wo", (mp, None, dp)),      # (E, F, D)
    ] + _common_rules(dp, mp)


def _common_rules(dp, mp):
    return [
        ("router", (dp, None)),              # (D, E)
        ("embed", (mp, dp)),                 # (V, D)
        ("lm_head", (dp, mp)),               # (D, V)
        ("wq", (dp, mp)),
        ("wk", (dp, mp)),
        ("wv", (dp, mp)),
        ("wo", (mp, dp)),
        ("w_dkv", (dp, None)),               # (D, R+rope): R small
        ("w_uk", (None, mp)),                # (R, H*dh)
        ("w_uv", (None, mp)),
        ("ffn/wi", (dp, mp)),                # dense FFN
        ("ffn/wo", (mp, dp)),
        # shared experts: megatron col/row over the model axis only (their
        # weight gradients would otherwise meet the token sharding)
        ("shared/wi", (None, mp)),
        ("shared/wo", (mp, None)),
        ("in_proj", (dp, mp)),               # ssm
        ("out_proj", (mp, dp)),
        ("conv_w", (None, mp)),
        # everything else (norms, biases, A_log, scales): replicated
    ]


def spec_for_param(path_s: str, shape, mesh, dp, mp, mode: str = "train") -> Spec:
    # Expert-count fallback: when E doesn't divide the model axis the model
    # axis moves to the d_ff dim (megatron-style within each expert).
    if "experts/wi" in path_s or "experts/wo" in path_s:
        e = shape[-3]
        if e % axis_product(mesh, mp) != 0:
            base = (None, dp, mp) if "wi" in path_s else (None, mp, dp)
            lead = (None,) * (len(shape) - 3)
            return fit_spec(mesh, shape, (*lead, *base))
    for needle, base in param_rules(dp, mp, mode):
        if needle in path_s:
            nd = len(base)
            if len(shape) < nd:
                return fit_spec(mesh, shape, tuple(base[-len(shape):]))
            lead = (None,) * (len(shape) - nd)
            return fit_spec(mesh, shape, (*lead, *base))
    return ()  # replicate


def _specs(tree, one):
    """A tree shaped like `tree` of one(path, leaf) per leaf."""
    paths = iter(p for p, _ in tree_flatten(tree))
    return tree_map(lambda leaf: one(next(paths), leaf), tree)


def param_shardings(mesh, params: Any, mode: str = "train") -> Any:
    """Parameter tree (tensors, fake tensors or anything with .shape) ->
    spec tree."""
    dp, mp = dp_spec(mesh), "model"
    return _specs(params, lambda path, leaf: spec_for_param(
        path, tuple(leaf.shape), mesh, dp, mp, mode))


# ----------------------------------------------------------------------
# activation / cache shardings
# ----------------------------------------------------------------------

def batch_spec(mesh, batch: int, extra_dims: int = 1) -> Spec:
    """(B, ...) activations: B over (pod, data) when divisible."""
    return fit_spec(mesh, (batch,) + (0,) * extra_dims, (dp_spec(mesh),))


def cache_shardings(mesh, cache: Any, batch: int) -> Any:
    """Decode-cache tree -> spec tree (``cache_spec`` per leaf)."""
    del batch
    return _specs(cache, lambda path, leaf: cache_spec(mesh, path, tuple(leaf.shape)))


def replicated(mesh, tree: Any) -> Any:
    del mesh
    return tree_map(lambda _: (), tree)


def distribute(mesh, t, spec: Spec):
    """One tensor -> a DTensor over `mesh` laid out by `spec`, each rank
    keeping its own shard (no data moves between ranks).  A `QTensor`'s
    codes and scales each take the spec, fitted to their own shapes."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.quant.quantize import QTensor

    if isinstance(t, QTensor):
        return dataclasses.replace(
            t, data=distribute(mesh, t.data, fit_spec(mesh, tuple(t.data.shape), spec)),
            scale=distribute(mesh, t.scale, fit_spec(mesh, tuple(t.scale.shape), spec)))
    return distribute_tensor(t, mesh, placements(mesh, spec), src_data_rank=None)


def distribute_tree(mesh, tree: Any, specs: Any) -> Any:
    """A tensor tree and its spec tree -> the DTensor tree."""
    return tree_map(lambda t, s: distribute(mesh, t, s), tree, specs)


def distribute_params(mesh, params: Any, mode: str = "train") -> Any:
    """The port's flat per-layer parameter tree -> DTensors laid out by the
    rule table (``param_shardings``)."""
    return distribute_tree(mesh, params, param_shardings(mesh, params, mode))
