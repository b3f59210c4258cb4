"""Per-GPU cost analysis of one step: the port's counterpart of the JAX
package's ``launch/hlo_analysis.py``.

PyTorch has no HLO to parse.  ``OpAnalysis`` is a ``TorchDispatchMode``
entered around the step; it sees every aten op the step runs and counts, per
GPU:

    flops        2*M*N*K for every mm / addmm / bmm / baddbmm (einsum and
                 matmul reach the dispatcher as these), by the formulas of
                 ``torch.utils.flop_counter``'s registry
    bytes        operand + result bytes of every op that moves data -- the
                 unfused eager counterpart of the reference's top-level
                 instruction bytes (a broadcast operand counted once, so
                 a product counts the same whether the dispatcher batches
                 it or folds it into one mm).  Views and allocations move
                 nothing;
                 a gather or index reads only the rows it returns and a
                 scatter or index_put writes only its values, as the
                 reference counts slices and dynamic-update-slices
    collectives  result bytes per kind (all_reduce, all_gather,
                 reduce_scatter, all_to_all, permute) of DTensor's
                 functional collectives, each also booked under the mesh
                 axis (or axes) its process group spans
    peak_bytes   the most bytes live at once: the arguments given to
                 ``track`` plus every storage an op created that is still
                 referenced

The reference also records XLA's cost analysis as a cross-check.  The port
has no counterpart: a mode above DTensor (``FlopCounterMode``) sees the
DTensor-level ops at their global shapes but the bodies that run on local
shards (``shard_utils.run_local``) at their local ones, a mix that moves
with the code's layout.  The dry run's check that no work is lost is
``model_flops <= flops_per_chip * chips``.

Per GPU, not global: a mode above DTensor sees each op at its global shape.
This one returns NotImplemented to DTensor operands, so DTensor turns the
op into its local ops on this rank's shards (and its collectives), which
come back through the mode and are counted.  The global-shape ops DTensor's
sharding propagation runs on fake tensors are skipped: while the analysis
is active that propagation runs under a fake mode of its own, which the
analysis tells apart from the step's.

Every layer runs as a Python loop, so there is no trip count to recover.
The sharded dense steps (train, prefill, decode) reach no hand-written
kernel; where a step does, the analysis counts the plain version's ops
(on CPU tensors ``kernels.ops`` picks the plain path), as the reference
cannot see inside a Pallas custom call either.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all", "permute")

# functional collective op name -> kind
_COLL_OPS = {
    "all_reduce": "all_reduce", "all_reduce_": "all_reduce",
    "all_reduce_coalesced": "all_reduce",
    "all_gather_into_tensor": "all_gather", "all_gather_into_tensor_out": "all_gather",
    "all_gather_into_tensor_coalesced": "all_gather",
    "reduce_scatter_tensor": "reduce_scatter",
    "reduce_scatter_tensor_coalesced": "reduce_scatter",
    "all_to_all_single": "all_to_all",
    "permute_tensor": "permute",
    "shard_dim_alltoall": "all_to_all",     # DTensor's own op (namespace _dtensor)
}

# ops that move no data
_FREE = frozenset({
    "empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
    "detach", "alias", "lift_fresh", "lift_fresh_copy", "_local_scalar_dense",
    "wait_tensor", "device", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset", "is_same_size", "set_", "_has_compatible_shallow_copy_type",
    "resize_", "_reshape_alias", "clone_preserve_strides", "_unsafe_view",
})

# windowed reads: read the rows returned (and the indices), write the result
_GATHERS = frozenset({"index", "gather", "embedding", "index_select", "take",
                      "take_along_dim"})
# windowed writes: read and write the values' window (and read the indices)
_SCATTERS = frozenset({"index_put", "index_put_", "_index_put_impl_", "scatter",
                       "scatter_", "scatter_add", "scatter_add_", "index_add",
                       "index_add_", "index_copy", "index_copy_", "masked_scatter",
                       "masked_scatter_"})


def _nbytes(t) -> int:
    """Distinct bytes a tensor addresses: a broadcast (stride-0) dim is
    read once, so an operand expanded for a batched product counts as
    the unexpanded one."""
    if not isinstance(t, torch.Tensor):
        return 0
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(tree):
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


@contextlib.contextmanager
def _propagation_under_own_fake_mode():
    """DTensor's sharding propagation reuses the fake mode it finds active;
    make it start one of its own, so its global-shape ops are told apart."""
    from torch.distributed.tensor import _sharding_prop

    saved = getattr(_sharding_prop, "detect_fake_mode", None)
    if saved is None:
        yield
        return
    _sharding_prop.detect_fake_mode = lambda *a, **k: None
    try:
        yield
    finally:
        _sharding_prop.detect_fake_mode = saved


class OpAnalysis(TorchDispatchMode):
    """Count one step's per-GPU FLOPs, bytes, collective bytes and peak live
    bytes.  `mesh`: the DeviceMesh whose process groups name the axes of
    the collectives (None: every collective is booked under "?")."""

    def __init__(self, mesh=None):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}
        self.collectives["count"] = 0
        self.axis_bytes: Dict[str, float] = {}
        self.ops = 0
        self.peak_bytes = 0
        self._live: Dict[int, int] = {}
        self._cur = 0
        self._groups: Dict[str, str] = {}
        if mesh is not None:
            names = mesh.mesh_dim_names
            for i, name in enumerate(names):
                self._groups[mesh.get_group(i).group_name] = name
        self._stack = contextlib.ExitStack()
        self._entry_fake = None

    # ---------------------------------------------------------- live bytes
    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self._cur += n
        weakref.finalize(st, self._drop, key)

    def _drop(self, key: int) -> None:
        self._cur -= self._live.pop(key, 0)

    def track(self, *trees) -> None:
        """Count the storages of these tensors (the step's arguments, local
        shards for DTensors) as live from now on."""
        from torch.distributed.tensor import DTensor

        for x in _tensors(trees):
            self._hold(x.to_local() if isinstance(x, DTensor) else x)
        self.peak_bytes = max(self.peak_bytes, self._cur)

    # ---------------------------------------------------------------- mode
    def __enter__(self):
        from torch._guards import active_fake_mode

        self._entry_fake = active_fake_mode()
        self._stack.enter_context(_propagation_under_own_fake_mode())
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._stack.close()
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if active_fake_mode() is self._entry_fake:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry

        name = func._overloadpacket.__name__
        ns = func.namespace
        self.ops += 1
        f = flop_registry.get(func._overloadpacket)
        if f is not None:
            self.flops += float(f(*args, **kwargs, out_val=out))
        outs = _tensors(out)
        if (ns == "_c10d_functional" and name in _COLL_OPS) or (
                ns == "_dtensor" and name == "shard_dim_alltoall"):
            kind = _COLL_OPS[name]
            nb = sum(_nbytes(t) for t in outs)
            self.collectives[kind] += nb
            self.collectives["count"] += 1
            group = next((a for a in reversed(args) if isinstance(a, str)), None)
            axis = self._groups.get(group, "?")
            self.axis_bytes[axis] = self.axis_bytes.get(axis, 0.0) + nb
            self.bytes += nb + sum(_nbytes(t) for t in _tensors(args))
        elif not (name in _FREE or func.is_view or ns == "prim"):
            ins = _tensors((args, kwargs))
            if name in _GATHERS:
                idx = sum(_nbytes(t) for t in ins[1:] if not t.is_floating_point())
                self.bytes += 2 * sum(_nbytes(t) for t in outs) + idx
            elif name in _SCATTERS:
                vals = ins[-1]
                idx = sum(_nbytes(t) for t in ins[1:-1])
                self.bytes += 2 * _nbytes(vals) + idx
            else:
                self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        for t in outs:
            self._hold(t)
        self.peak_bytes = max(self.peak_bytes, self._cur)

    def result(self) -> Dict:
        coll = dict(self.collectives)
        coll["total"] = sum(self.collectives[k] for k in COLLECTIVES)
        return {"flops": self.flops, "bytes": self.bytes,
                "collectives": coll,
                "axis_bytes": dict(self.axis_bytes), "peak_bytes": self.peak_bytes,
                "ops": self.ops}


def analyze(fn, *args, mesh=None, track: Optional[tuple] = None, **kwargs):
    """Run fn(*args, **kwargs) once under an ``OpAnalysis``; `track`: trees
    whose storages count as live from the start (default `args`).
    Returns (fn's result, the analysis's ``result()``)."""
    ana = OpAnalysis(mesh)
    ana.track(*(args if track is None else track))
    with ana:
        out = fn(*args, **kwargs)
    return out, ana.result()
