"""Device selection and host <-> device transfers shared by the port.

Entry points take ``device="cuda"`` by default and run on the CPU only when
the caller asks for it; a CUDA request on a machine without a card raises
instead of quietly running on the CPU.  The transfer helpers keep small
per-step host arrays (indices, positions, gate weights) off the implicit
stream synchronisation a pageable host buffer can cause: they go through
pinned memory and ``non_blocking`` copies, and reading results back costs
exactly one synchronisation of the current stream.
"""

from __future__ import annotations

from typing import List, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for but absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() "
                           "is False; pass device='cpu' (--device cpu) to run on "
                           "the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_device(arr, device: torch.device) -> torch.Tensor:
    """Copy a host array to `device` (a private copy on the CPU, a pinned
    non-blocking copy on CUDA, ordered on the current stream)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


def to_host(*tensors: torch.Tensor) -> List[np.ndarray]:
    """Copy tensors to host numpy arrays with ONE synchronisation of the
    current stream (none on the CPU).  bfloat16 callers convert first."""
    if not tensors:
        return []
    dev = tensors[0].device
    if dev.type != "cuda":
        return [t.detach().numpy().copy() for t in tensors]
    outs = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t.detach(), non_blocking=True)
        outs.append(h)
    torch.cuda.current_stream(dev).synchronize()
    return [h.numpy() for h in outs]
