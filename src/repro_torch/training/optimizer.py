"""AdamW + cosine schedule + global-norm clipping of the port, the JAX
package's ``training/optimizer.py`` on torch tensors.

Moments are float32 by default; with ``moment_dtype="bfloat16"`` the whole
update runs in bf16, as in the reference (its scalars rounded to bf16
first, as JAX rounds a Python scalar to the array's dtype).  The update is
written into the parameters and moments in place, under ``torch.no_grad``,
in slices of at most ``_SLICE`` elements, so its float32 temporaries stay
small beside a full-width expert stack.

Weight decay: the reference decays every leaf of rank >= 2 in ITS layout,
where the scanned blocks' leaves are stacked over the blocks.  So every
leaf of a layer in ``params["blocks"]`` -- norm scales, biases and SSM
vectors too -- is decayed, while the same 1-D leaf in a ``prefix`` or
``tail`` layer (DeepSeek-V2's dense first layer), the encoder or
``final_norm`` is not.  ``decay_mask(cfg, params)`` gives that decision for
the port's flat per-layer layout, from the reference layout's rank.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.weights import tree_leaves, tree_map

_SLICE = 1 << 27        # elements per slice of a leaf in the update


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    # float32 by default; bf16 halves the moments' memory (the update then
    # runs in bf16, as in the reference)
    moment_dtype: str = "float32"


class OptState(NamedTuple):
    step: int           # updates applied (a host integer: the schedule runs on the host)
    mu: Any
    nu: Any


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def lr_at(cfg: OptimizerConfig, step: int) -> float:
    """Linear warm-up to `lr`, then a cosine down to min_lr_frac * lr at
    total_steps; in float32, as the reference computes it."""
    f32 = torch.float32
    s = torch.tensor(float(step), dtype=f32)
    warm = cfg.lr * s / max(cfg.warmup_steps, 1)
    t = torch.clamp((s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(torch.tensor(math.pi, dtype=f32) * t))
    return float(warm if step < cfg.warmup_steps else cfg.lr * cos)


def init_opt_state(params, moment_dtype: str = "float32") -> OptState:
    """Zeroed first and second moments, shaped like `params`, on their
    devices."""
    dt = _DTYPES[moment_dtype]

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    return OptState(step=0, mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def _slices(*ts: torch.Tensor):
    """Matching views of `ts` along dim 0, each at most _SLICE elements
    (whole rows; a leaf that fits is one view)."""
    t = ts[0]
    if t.dim() == 0 or t.numel() <= _SLICE:
        yield ts
        return
    rows = max(1, _SLICE // max(1, t[0].numel()))
    for r0 in range(0, t.shape[0], rows):
        yield tuple(x[r0:r0 + rows] for x in ts)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32 (a 0-dim tensor
    on the leaves' device)."""
    total = None
    for x in tree_leaves(tree):
        for (xs,) in _slices(x):
            sq = torch.sum(torch.square(xs.to(torch.float32)))
            total = sq if total is None else total + sq
    return torch.sqrt(total)


def decay_mask(cfg: ModelConfig, params):
    """A tree of bools shaped like the port's `params`: True where the
    reference decays the leaf -- rank >= 2 in its layout, so every leaf of
    a layer that sits in the scanned blocks (stacked there), and elsewhere
    the leaves of rank >= 2 (module docstring)."""
    np_ = len(cfg.prefix_pattern)
    stacked = range(np_, np_ + cfg.num_blocks * cfg.period)
    out = {k: tree_map(lambda x: x.dim() >= 2, v) for k, v in params.items() if k != "layers"}
    out["layers"] = [tree_map(lambda x, s=i in stacked: s or x.dim() >= 2, lp)
                     for i, lp in enumerate(params["layers"])]
    return out


@torch.no_grad()
def apply_updates(cfg: OptimizerConfig, params, grads, state: OptState,
                  decay: Optional[Any] = None):
    """One AdamW step with global-norm clipping, written into `params` and
    the moments in place.  `decay`: a tree of bools shaped like `params`
    (``decay_mask`` for the port's layout); None decays the leaves of rank
    >= 2, the reference's rule for a tree in its own layout.
    Returns (params, new state, {"grad_norm", "lr"})."""
    gnorm = global_norm(grads)
    scale = torch.clamp(torch.full((), cfg.clip_norm, dtype=torch.float32,
                                   device=gnorm.device) / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    f32 = torch.float32
    lr = lr_at(cfg, step)
    b1c = 1 - torch.tensor(cfg.b1, dtype=f32) ** float(step)
    b2c = 1 - torch.tensor(cfg.b2, dtype=f32) ** float(step)
    mdt = _DTYPES[cfg.moment_dtype]
    cdt = torch.float32 if mdt == torch.float32 else torch.bfloat16

    def c(v):
        """A scalar rounded to the compute dtype (a 0-dim CPU tensor)."""
        return torch.as_tensor(v, dtype=f32).to(cdt)

    lr_c, b1c_c, b2c_c = c(lr), c(b1c), c(b2c)
    b1, b2, nb1, nb2 = c(cfg.b1), c(cfg.b2), c(1 - cfg.b1), c(1 - cfg.b2)
    eps, wd = c(cfg.eps), c(cfg.weight_decay)
    s = scale.to(cdt)
    if decay is None:
        decay = tree_map(lambda p: p.dim() >= 2, params)
    for p, g, m, v, dec in zip(tree_leaves(params), tree_leaves(grads),
                               tree_leaves(state.mu), tree_leaves(state.nu),
                               tree_leaves(decay)):
        for ps, gs, ms, vs in _slices(p, g, m, v):
            gc = gs.to(cdt) * s
            m_new = (b1 * ms.to(cdt) + nb1 * gc).to(mdt)
            v_new = (b2 * vs.to(cdt) + nb2 * torch.square(gc)).to(mdt)
            delta = (m_new.to(cdt) / b1c_c) / (torch.sqrt(v_new.to(cdt) / b2c_c) + eps)
            if dec:
                delta = delta + wd * ps.to(cdt)
            ps.copy_((ps.to(cdt) - lr_c * delta).to(ps.dtype))
            ms.copy_(m_new)
            vs.copy_(v_new)
    metrics = {"grad_norm": gnorm, "lr": torch.tensor(lr, dtype=f32)}
    return params, OptState(step, state.mu, state.nu), metrics
