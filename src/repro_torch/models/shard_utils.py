"""Mesh-aware internal sharding constraints of the port.

The JAX package's ``models/shard_utils.py`` on a ``DeviceMesh``:
``constrain(x, *dims)`` redistributes a DTensor to the named layout when a
mesh is active (``with mesh_scope(mesh):``) and returns anything else
unchanged, so every single-device path (and every captured step) runs the
same ops as without it.  Dim tokens:

    "batch"  -> all data-parallel axes present (("pod", "data") or ("data",))
    "model"  -> the tensor-parallel axis
    "all"    -> every mesh axis (context-parallel long sequences)
    None     -> replicated

An axis that does not divide its dim is dropped, as ``fit_spec`` drops
it.  Inside ``mesh_scope`` plain tensors that meet DTensors (positions,
masks, ``torch.full`` constants built in the model) count as replicated
(``implicit_replication``).

Where XLA's partitioner would find the layout itself, the port says it:
``run_local`` runs a computation that is independent per shard on each
rank's local tensors (attention, the MoE routing and dispatch, the
embedding lookup), ``local_reshape`` regroups rows split over the data
axes, ``put_rows`` writes decode-cache rows on the rank that holds them,
and ``cache_zeros`` / ``as_cache`` give cache entries their layout.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Optional, Tuple

import torch

# ----------------------------------------------------------------------
# spec arithmetic (``launch/sharding.py`` builds its rule table on these)
# ----------------------------------------------------------------------
# A spec has one entry per tensor dim: None, an axis name or a tuple of
# axis names in mesh order (the reference's ``PartitionSpec``).  Meshes: a
# ``DeviceMesh``, or any object with ``axis_names`` and a ``shape`` mapping
# each name to its size (the reference's ``Mesh``).

Spec = Tuple[Any, ...]


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh) -> Dict[str, int]:
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def axis_product(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = axis_sizes(mesh)
    if isinstance(axis, tuple):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def fit_spec(mesh, shape: Tuple[int, ...], spec: Spec) -> Spec:
    """Drop axes that don't divide their dim; trim/extend rank mismatches."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, axis in zip(shape, entries[: len(shape)]):
        if axis is not None and dim % axis_product(mesh, axis) == 0 and dim > 0:
            out.append(axis)
        else:
            out.append(None)
    return tuple(out)


def placements(mesh, spec: Spec) -> tuple:
    """A spec -> one DTensor placement per mesh dim."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in axis_names(mesh):
        dims = [d for d, ax in enumerate(spec)
                if ax == name or (isinstance(ax, tuple) and name in ax)]
        if len(dims) > 1:
            raise ValueError(f"axis {name!r} names tensor dims {dims} of spec {spec}")
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def dp_spec(mesh):
    """The data-parallel spec entry: ("pod", "data"), "data" or None."""
    dp = tuple(a for a in axis_names(mesh) if a in ("pod", "data"))
    return dp if len(dp) > 1 else (dp[0] if dp else None)


def cache_spec(mesh, path: str, shape: Tuple[int, ...]) -> Spec:
    """The spec of one decode-cache leaf, named by the last component of
    its path.

    attention k/v (B, S, Hkv, hd): B over dp, Hkv over model when it
    divides, else S over model.  MLA c_kv / k_rope (B, S, R): S over model.
    SSM h (B, H, P, N): H over model.  conv (B, K-1, C): C over model.
    Whisper's cross_k / cross_v (B, F, Hkv, hd), the reference's enc_kv:
    B over dp only.  With B not divisible by dp (long_500k's B = 1) the
    sequence dim takes every axis (context parallel)."""
    dp_t = tuple(a for a in axis_names(mesh) if a in ("pod", "data"))
    dp = dp_spec(mesh)
    mp = "model"
    all_ax = dp_t + (mp,)
    shape = tuple(shape)
    name = path.rsplit("/", 1)[-1]
    base: Optional[Spec] = None
    if "enc_kv" in path or name in ("cross_k", "cross_v"):
        base = (dp, None, None, None)
    elif name in ("k", "v"):          # (B, S, Hkv, hd)
        b, s, hkv, hd = shape[-4:]
        b_ok = b % axis_product(mesh, dp) == 0
        h_ok = hkv % axis_product(mesh, mp) == 0
        if b_ok:
            base = (dp, None, mp, None) if h_ok else (dp, mp, None, None)
        else:  # batch too small (long_500k): context-parallel the seq dim
            base = (None, dp, mp, None) if h_ok else (None, all_ax, None, None)
    elif name in ("c_kv", "k_rope"):   # (B, S, R)
        b_ok = shape[-3] % axis_product(mesh, dp) == 0
        base = (dp, mp, None) if b_ok else (None, all_ax, None)
    elif name == "h":                  # (B, H, P, N)
        base = (dp, mp, None, None)
    elif name == "conv":               # (B, K-1, C)
        base = (dp, None, mp)
    if base is None:
        return ()
    lead = (None,) * (len(shape) - len(base))
    return fit_spec(mesh, shape, (*lead, *base))


# ----------------------------------------------------------------------
# the active mesh and the model's layout constraints
# ----------------------------------------------------------------------

# process-wide, not per thread: the autograd engine runs a CUDA backward
# (and the recomputed forward of a checkpointed layer) on its own thread
_STACK = []


def active_mesh():
    """The mesh of the innermost ``mesh_scope``, or None."""
    return _STACK[-1] if _STACK else None


@contextlib.contextmanager
def mesh_scope(mesh):
    """Run the model sharded over `mesh`: `constrain` and the MoE group
    count read it, and plain tensors join DTensors as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication

    _STACK.append(mesh)
    try:
        with implicit_replication():
            yield mesh
    finally:
        _STACK.pop()


def axis_size(name: str) -> int:
    """Size of a mesh axis in the active mesh, or 1 if absent."""
    mesh = active_mesh()
    if mesh is None or name not in mesh.mesh_dim_names:
        return 1
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def dp_size() -> int:
    """Combined size of the data-parallel axes (pod x data)."""
    return axis_size("pod") * axis_size("data")


def token_spec(names, d):
    """One dim token -> a spec entry over the axis `names` (None, a name or
    a tuple of names in mesh order)."""
    if d == "batch":
        ax = tuple(a for a in ("pod", "data") if a in names)
    elif d == "all":
        ax = tuple(a for a in ("pod", "data", "model") if a in names)
    elif d is not None and d in names:
        return d
    else:
        return None
    return ax if len(ax) > 1 else (ax[0] if ax else None)


def constrain(x, *dims):
    """Redistribute DTensor `x` to the layout `dims` (one token per dim)
    over the active mesh; the identity on anything else."""
    from torch.distributed.tensor import DTensor

    mesh = active_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    names = tuple(mesh.mesh_dim_names)
    spec = tuple(token_spec(names, d) for d in dims)
    spec = fit_spec(mesh, tuple(x.shape), spec)
    pl = placements(mesh, spec)
    if tuple(x.placements) != pl:
        x = x.redistribute(mesh, pl)
    return _pin_grad(x) if x.requires_grad else x


def _pin_grad(x):
    """x unchanged, its gradient redistributed to x's own layout on the way
    back (XLA's sharding constraint constrains the cotangent too; DTensor
    would otherwise hand back whatever layout the consumer produced)."""
    return _PinGrad.apply(x)


class _PinGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.layout = (x.device_mesh, tuple(x.placements))
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, pl = ctx.layout
        if tuple(g.placements) != pl:
            g = g.redistribute(mesh, pl)
        return g.contiguous()


def is_sharded(x) -> bool:
    """True for a DTensor under an active mesh."""
    from torch.distributed.tensor import DTensor
    return active_mesh() is not None and isinstance(x, DTensor)



def put_rows(buf, at, new) -> None:
    """buf[b, at[b]] = new[b] for every row b of DTensor `buf` (B, S, ...),
    in place: at (B,) integer, new (B, ...).  Written shard by shard: each
    rank writes the rows it holds whose position falls in its slice of the
    sequence dim (a sharded sequence is the context-parallel cache layout),
    with `new` laid out like buf's other dims."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh, pl = buf.device_mesh, buf.placements
    # the write's layout: buf's, with the sequence dim (1) gone
    new_pl = [Replicate() if not isinstance(q, Shard) or q.dim == 1
              else Shard(q.dim - (q.dim > 1)) for q in pl]
    row_pl = [Shard(0) if isinstance(q, Shard) and q.dim == 0 else Replicate() for q in pl]

    def local(x, placements):
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
        return x.redistribute(mesh, placements).to_local()

    new_l = local(new.to(buf.dtype), new_pl)
    at_l = local(at, row_pl)
    buf_l = buf.to_local()
    # this rank's first sequence position: the mesh dims sharding the
    # sequence split it in mesh order
    size, start = buf.shape[1], 0
    for i, q in enumerate(pl):
        if isinstance(q, Shard) and q.dim == 1:
            size //= mesh.size(i)
            start += mesh.get_local_rank(i) * size
    rel = at_l - start
    ok = (rel >= 0) & (rel < buf_l.shape[1])
    rel = rel.clamp(0, buf_l.shape[1] - 1)
    rows = torch.arange(buf_l.shape[0], device=buf_l.device)
    # a row whose position another rank holds writes its own value back
    ok = ok.reshape(ok.shape + (1,) * (new_l.dim() - 1))
    buf_l[rows, rel] = torch.where(ok, new_l, buf_l[rows, rel])


def cache_zeros(name: str, shape, dtype: torch.dtype, device) -> torch.Tensor:
    """A zeroed decode-cache buffer; under an active mesh a DTensor laid out
    by ``cache_spec`` for its `name`, each rank allocating only
    its shard."""
    mesh = active_mesh()
    if mesh is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import zeros as dzeros

    pl = placements(mesh, cache_spec(mesh, name, tuple(shape)))
    return dzeros(tuple(shape), dtype=dtype, device_mesh=mesh, placements=pl)


def as_cache(name: str, t):
    """A DTensor cache entry redistributed to its decode-cache layout
    (``cache_spec`` for `name`); anything else unchanged."""
    mesh = active_mesh()
    if mesh is None or not is_sharded(t):
        return t
    pl = placements(mesh, cache_spec(mesh, name, tuple(t.shape)))
    return t if tuple(t.placements) == pl else t.redistribute(mesh, pl)


def vocab_parallel_embed(embed, tokens):
    """Embedding rows of DTensor `embed` (V, D) at `tokens` (B, S) under the
    active mesh: each model shard looks up the tokens in its vocabulary
    slice (the rows' d_model dim gathered over the data axes first) and
    zeroes the others; the shards' lookups are stacked on a leading dim
    over the model axis and summed, so the reduction over the model axis
    (and its backward) is DTensor's.  Returns (B, S, D), the batch over the
    data axes."""
    mesh = active_mesh()
    names = mesh.mesh_dim_names

    def lookup(w, tok):
        v = w.shape[0]
        rel = tok - (mesh.get_local_rank("model") * v if "model" in names else 0)
        ok = (rel >= 0) & (rel < v)
        rows = torch.nn.functional.embedding(rel.clamp(0, v - 1), w)
        return (rows * ok[..., None].to(rows.dtype))[None]

    # each data shard looks up its own tokens: the gathered rows' gradient
    # is a partial sum over the data axes
    rows = "batch" if tokens.shape[0] % dp_size() == 0 else None
    stacked = run_local(lookup, (embed, tokens), (("model", None), (rows, None)),
                        (("model", rows, None, None),), partial_data=(0,) if rows else ())
    return stacked.sum(0)


def run_local(fn, args, in_dims, out_dims, partial_model=(), partial_data=()):
    """fn(*args) on each rank's shards (``local_map``) under the active
    mesh: arg i laid out by its dim tokens in_dims[i] (as `constrain`
    takes them; None passes a non-tensor through), each result by
    out_dims (the token "sum" for a whole result that is each data
    shard's partial sum).  The computation must be independent per
    shard.  The args whose index is in `partial_model` (`partial_data`)
    are replicated over the model (data) axes while others are split
    there: their gradients are partial sums over them.  Returns one
    DTensor or a tuple."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = active_mesh()
    names = tuple(mesh.mesh_dim_names)

    def pl(x, dims):
        spec = tuple(token_spec(names, d) for d in dims)
        return placements(mesh, fit_spec(mesh, tuple(x.shape), spec))

    args = [x if dims is None or isinstance(x, DTensor) else
            DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
            for x, dims in zip(args, in_dims)]
    in_pl = [None if dims is None else pl(x, dims) for x, dims in zip(args, in_dims)]
    def partial(i, a):
        return (i in partial_model and a == "model") or (
            i in partial_data and a in ("pod", "data"))

    grad_pl = [None if p is None else tuple(
        Partial() if partial(i, a) and isinstance(q, Replicate) else q
        for a, q in zip(names, p)) for i, p in enumerate(in_pl)]
    # results are laid out by their tokens as given (their shapes are not
    # known before fn runs): callers drop an axis that would not divide
    out_pl = tuple(
        tuple(Partial() if a in ("pod", "data") else Replicate() for a in names)
        if dims == "sum" else
        placements(mesh, tuple(token_spec(names, d) for d in dims))
        for dims in out_dims)

    return local_map(fn, out_placements=out_pl, in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl), redistribute_inputs=True,
                     device_mesh=mesh)(*args)


def local_reshape(x, *shape):
    """x reshaped to the global `shape`, x's dim 0 and the result's dim 0
    both split over the data axes (in mesh order) and replicated over the
    model axis: each rank reshapes its own rows, so a dim split into
    (groups, rows) or rows merged back needs no sharding rule for views
    (DTensor versions differ there)."""
    local = (shape[0] // dp_size(), *shape[1:])
    return run_local(lambda t: t.reshape(local), (x,), (("batch",) + (None,) * (x.dim() - 1),),
                     (("batch",) + (None,) * (len(shape) - 1),))


def gather_dim(x, dim: int):
    """DTensor x with tensor dim `dim` made whole on every rank (its other
    dims keep their layout); anything else unchanged."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    dim %= x.dim()
    pl = tuple(Replicate() if isinstance(q, Shard) and q.dim == dim else q
               for q in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(x.device_mesh, pl)


def gather_data_axes(tree):
    """Every DTensor leaf of `tree` with its data-axis (pod, data) splits
    gathered, its model-axis split kept: FSDP's gather of one layer's
    weights before the layer runs (its gradient is reduce-scattered back
    on the way out).  The identity without a mesh."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = active_mesh()
    if mesh is None:
        return tree
    data = [a in ("pod", "data") for a in mesh.mesh_dim_names]

    def one(x):
        if not isinstance(x, DTensor):
            return x
        pl = tuple(Replicate() if d else q for d, q in zip(data, x.placements))
        return x if pl == tuple(x.placements) else x.redistribute(mesh, pl)

    if isinstance(tree, dict):
        return {k: gather_data_axes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [gather_data_axes(v) for v in tree]
    return one(tree)
