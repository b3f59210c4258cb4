"""Production mesh of the port (NVIDIA H100 SXM5 80 GB).

Single pod: 256 GPUs as (data=32, model=8).
Multi-pod:  512 GPUs as (pod=2, data=32, model=8); the pod axis is pure
data parallelism, as in the JAX package's ``launch/mesh.py``.

The chip counts are the JAX package's; the shape is the H100's: an 8-GPU
node is one NVLink domain, so the tensor-parallel `model` axis spans exactly
one node and its collectives stay on NVLink, while the data and pod axes
cross nodes over InfiniBand.  The reference's 16-way model axis would cross
nodes.

Functions, not module state: importing this module starts no process group.
``make_production_mesh`` builds a ``DeviceMesh`` over the process group
already started; the dry run starts a fake one (``start_fake_process_group``)
at the mesh's world size, where collectives move no data.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

# H100 SXM5 80 GB datasheet values for the roofline (per GPU); not measurements.
PEAK_FLOPS_BF16 = 989e12     # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12             # bytes/s, HBM3
NVLINK_BW = 450e9            # bytes/s per GPU per direction (model axis)
IB_BW = 50e9                 # bytes/s, one 400 Gb/s NIC per GPU (data, pod axes)

SINGLE_POD = ((32, 8), ("data", "model"))
MULTI_POD = ((2, 32, 8), ("pod", "data", "model"))


def production_shape(multi_pod: bool = False) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axis names) of the production mesh."""
    return MULTI_POD if multi_pod else SINGLE_POD


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda",
                         shape: Optional[Tuple[int, ...]] = None) -> DeviceMesh:
    """The production ``DeviceMesh`` over the started process group, whose
    world size must be the mesh's GPU count.  `shape` replaces the sizes
    (same axis names), e.g. (1, 1) on one GPU."""
    dims, names = production_shape(multi_pod)
    if shape is not None:
        if len(shape) != len(names):
            raise ValueError(f"shape {shape} does not fit the axes {names}")
        dims = tuple(shape)
    return init_device_mesh(device_type, dims, mesh_dim_names=names)


def data_axes(mesh) -> tuple:
    """The batch-sharding axes of a mesh (pod joins data when present)."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    return tuple(a for a in names if a in ("pod", "data"))


def num_chips(mesh) -> int:
    return math.prod(mesh.shape)


def start_fake_process_group(world_size: int) -> None:
    """(Re)start the default process group as PyTorch's "fake" backend at
    `world_size` ranks, this process rank 0: collectives return at once and
    move nothing, so a ``DeviceMesh`` of production size can be built on
    one host and DTensor programs traced over it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
