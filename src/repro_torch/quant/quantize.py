"""Groupwise symmetric weight quantization: int8, packed int4 and int2.

PyTorch twin of the JAX package's ``quant/quantize.py``; it produces the same
packed int8 bytes and float32 scales bit for bit, so expert codes quantized
here and there are interchangeable.

    w[g*G + i, n]  ~=  q[g*G + i, n] * scale[g, n]

Groups run along the contraction (input) dimension.  int4 and int2 codes are
packed two (resp. four) per int8 byte along that dimension, two's complement
in the low bits, exactly the layout the grouped dequant kernels read.  The
functions run on whatever device their input lives on (the offload engine
quantizes expert by expert on the card).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

# Number of codes packed per int8 storage byte.
PACK_FACTOR = {8: 1, 4: 2, 2: 4}
# Max magnitude representable per bit-width (symmetric, zero-point-free).
QMAX = {8: 127, 4: 7, 2: 1}

DEFAULT_GROUP = 128


@dataclasses.dataclass(frozen=True)
class QTensor:
    """A groupwise-quantized 2-D (or stacked N-D) tensor.

    data:   int8 storage, shape (..., K // pack, N) — packed codes.
    scale:  float32, shape (..., K // group, N) — one scale per group per column.
    """

    data: torch.Tensor
    scale: torch.Tensor
    bits: int
    group_size: int
    orig_k: int

    @property
    def shape(self) -> Tuple[int, ...]:
        return (*self.data.shape[:-2], self.orig_k, self.data.shape[-1])

    @property
    def nbytes(self) -> int:
        # scales are counted at 2 bytes (bf16-able), as the loader's byte
        # budgets do; they are stored as float32
        return self.data.numel() * self.data.element_size() + self.scale.numel() * 2

    def astuple(self):
        return self.data, self.scale


def _check_dims(k: int, bits: int, group_size: int) -> None:
    if bits not in PACK_FACTOR:
        raise ValueError(f"unsupported bit-width {bits}; want one of {list(PACK_FACTOR)}")
    if k % group_size != 0:
        raise ValueError(f"contraction dim {k} not divisible by group size {group_size}")
    if group_size % PACK_FACTOR[bits] != 0:
        raise ValueError(f"group size {group_size} not divisible by pack factor")


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack signed integer codes (..., K, N) int8 -> (..., K//pack, N) int8,
    two's complement kept in the low bits of each field."""
    pack = PACK_FACTOR[bits]
    if pack == 1:
        return codes.to(torch.int8)
    *lead, k, n = codes.shape
    u = (codes.to(torch.int16) & ((1 << bits) - 1)).to(torch.uint8)
    u = u.reshape(*lead, k // pack, pack, n)
    out = torch.zeros((*lead, k // pack, n), dtype=torch.uint8, device=codes.device)
    for i in range(pack):
        out |= u[..., i, :] << (bits * i)
    return out.view(torch.int8)


def unpack_codes(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """Unpack (..., K//pack, N) int8 -> signed codes (..., K, N) int8."""
    pack = PACK_FACTOR[bits]
    if pack == 1:
        return packed
    *lead, kp, n = packed.shape
    u = packed.to(torch.int16) & 0xFF
    mask = (1 << bits) - 1
    half = 1 << (bits - 1)
    parts = []
    for i in range(pack):
        nib = (u >> (bits * i)) & mask
        parts.append(torch.where(nib >= half, nib - (1 << bits), nib).to(torch.int8))
    out = torch.stack(parts, dim=-2)  # (..., kp, pack, n)
    return out.reshape(*lead, kp * pack, n)


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over dim -2 left to right, one float32 add at a time."""
    acc = x[..., 0, :].clone()
    for i in range(1, x.shape[-2]):
        acc += x[..., i, :]
    return acc


def _group_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over dim -2 in the order XLA's CPU reduction uses (left to right
    within blocks of 32 rows, then left to right over the block sums), so the
    2-bit TWN scales match the JAX package bit for bit.  Checked for group
    sizes up to 32 and for multiples of 32."""
    n = x.shape[-2]
    if n <= 32:
        return _seq_sum(x)
    blocks = [_seq_sum(x[..., i:i + 32, :]) for i in range(0, n, 32)]
    return _seq_sum(torch.stack(blocks, dim=-2))


def quantize(w: torch.Tensor, bits: int = 8, group_size: int = DEFAULT_GROUP) -> QTensor:
    """Groupwise symmetric quantization along dim -2 (the contraction dim)."""
    *lead, k, n = w.shape
    _check_dims(k, bits, group_size)
    g = k // group_size
    wg = w.to(torch.float32).reshape(*lead, g, group_size, n)
    if bits == 2:
        # Ternary (TWN-style): threshold at 0.7*mean|w|, scale = mean |w|
        # above it.
        absw = wg.abs()
        delta = 0.7 * (_group_sum(absw) / group_size).unsqueeze(-2)
        mask = absw > delta
        count = mask.sum(dim=-2).to(torch.float32)
        scale = _group_sum(absw * mask) / torch.clamp(count, min=1.0)
    else:
        # XLA folds the jitted division by the constant QMAX into a multiply
        # by its float32 reciprocal; doing the same keeps the scales bit-equal
        scale = wg.abs().amax(dim=-2) * (1.0 / QMAX[bits])  # (..., g, n)
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    # torch.round rounds half to even, as jnp.round does
    codes = torch.clamp(torch.round(wg / scale.unsqueeze(-2)), -QMAX[bits], QMAX[bits])
    codes = codes.to(torch.int8).reshape(*lead, k, n)
    return QTensor(data=pack_codes(codes, bits), scale=scale, bits=bits,
                   group_size=group_size, orig_k=k)


def dequantize(q: QTensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Reconstruct the (approximate) dense weight."""
    codes = unpack_codes(q.data, q.bits).to(torch.float32)
    *lead, k, n = codes.shape
    g = k // q.group_size
    w = codes.reshape(*lead, g, q.group_size, n) * q.scale.unsqueeze(-2)
    return w.reshape(*lead, k, n).to(dtype)


def quantize_tree(tree, bits: int = 8, group_size: int = DEFAULT_GROUP,
                  predicate: Optional[Callable[[Tuple[str, ...], torch.Tensor], bool]] = None):
    """Quantize every >=2-D float tensor leaf of a nested dict / list / tuple
    tree (optionally filtered by path); the tree's structure is kept.

    A leaf is left as it is when it is not a tensor (a `QTensor` included),
    has fewer than 2 dims, is not floating point, is rejected by
    ``predicate(path, leaf)``, or has a contraction dim (dim -2) that
    `group_size` does not divide — the last without a word, as in the JAX
    package.  `path` is the leaf's position as a tuple of strings (dict keys,
    list and tuple indices as decimal strings); the JAX package passes a JAX
    key path instead, so a predicate that tests ``"ffn" in str(path)`` reads
    the same on both."""

    def _q(path: Tuple[str, ...], leaf: Any):
        if isinstance(leaf, dict):
            return {k: _q(path + (str(k),), v) for k, v in leaf.items()}
        if isinstance(leaf, (list, tuple)):
            return type(leaf)(_q(path + (str(i),), v) for i, v in enumerate(leaf))
        if not isinstance(leaf, torch.Tensor) or leaf.dim() < 2:
            return leaf
        if not leaf.is_floating_point():
            return leaf
        if predicate is not None and not predicate(path, leaf):
            return leaf
        if leaf.shape[-2] % group_size != 0:
            return leaf
        return quantize(leaf, bits=bits, group_size=group_size)

    return _q((), tree)


def quantization_error(w: torch.Tensor, bits: int, group_size: int = DEFAULT_GROUP) -> float:
    """Relative Frobenius reconstruction error (for tests / calibration)."""
    wr = dequantize(quantize(w, bits=bits, group_size=group_size))
    wf = w.to(torch.float32)
    num = torch.linalg.norm(wf - wr)
    den = torch.linalg.norm(wf) + 1e-12
    return float(num / den)


def expert_nbytes(d_model: int, d_ff: int, bits: int, n_matrices: int = 3,
                  group_size: int = DEFAULT_GROUP) -> int:
    """Bytes to store one (SwiGLU) expert at a given precision — the quantity
    that drives HOBBIT's loading-cost model.  bits=16 means bf16 dense."""
    params = n_matrices * d_model * d_ff
    if bits == 16:
        return params * 2
    scales = params // group_size
    return params * bits // 8 + scales * 2
