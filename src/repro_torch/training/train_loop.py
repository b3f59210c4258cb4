"""Training step and loop of the port: the loss's gradients by autograd,
global-norm clipping and the AdamW update (``optimizer``), metrics.

Eager PyTorch (no ``torch.compile``, no graph capture): a step runs
``Model.loss`` with ``requires_grad`` switched on for the parameters,
takes their gradients with ``torch.autograd.grad`` and updates the
parameters and moments in place under ``torch.no_grad``.  Metrics stay
tensors on the device until the loop logs them.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.device import DeviceLike
from repro_torch.models import shard_utils
from repro_torch.models.model import Batch, Model
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.optimizer import OptimizerConfig, OptState
from repro_torch.weights import tree_leaves, tree_map


class TrainState(NamedTuple):
    params: Any
    opt: OptState


def _unflatten(like, leaves: List[torch.Tensor]):
    """A tree shaped like `like` holding `leaves` in ``tree_leaves`` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def _split(batch: Batch, n: int) -> List[Batch]:
    """The batch cut into n equal parts along its batch axis.  A DTensor
    batch is cut shard by shard (each microbatch takes the i-th part of
    every rank's rows), so every part keeps the batch's layout."""
    b = batch.tokens.shape[0]
    if b % n:
        raise ValueError(f"batch of {b} rows does not split into {n} microbatches")

    def part(f, i):
        if f is None:
            return None
        if isinstance(f, DTensor):
            loc = f.to_local()
            r = loc.shape[0] // n
            return DTensor.from_local(loc[i * r:(i + 1) * r], f.device_mesh, f.placements,
                                      run_check=False)
        r = b // n
        return f[i * r:(i + 1) * r]

    return [Batch(*(part(f, i) for f in batch)) for i in range(n)]


def make_train_step(model: Model, ocfg: OptimizerConfig, *, remat: bool = True,
                    microbatches: int = 1, mesh=None) -> Callable:
    """train_step(state, batch) -> (state, metrics), the parameters and
    moments updated in place.

    microbatches > 1 accumulates gradients: the batch is cut along its
    batch axis, each part's gradients added in the moment dtype, then
    divided by the count (the loss and metrics averaged likewise) -- the
    reference's scanned accumulation, equal to the monolithic step up to
    float32 summation order.  Leaves without a gradient (``final_norm``:
    the loss reads the hidden state before it) get zeros, as under
    ``jax.grad``.  Weight decay follows the reference's layout
    (``optimizer.decay_mask``).

    `mesh`: the parameters, moments and batch are DTensors over it (laid
    out by ``launch.sharding``); the loss runs under
    ``shard_utils.mesh_scope`` and each gradient is redistributed to its
    parameter's layout before the update, which then runs shard by shard."""
    acc_dt = opt_lib._DTYPES[ocfg.moment_dtype]

    def scope():
        return contextlib.nullcontext() if mesh is None else shard_utils.mesh_scope(mesh)

    def grads_of(params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], list]:
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        try:
            with scope():
                loss, metrics = model.loss(params, batch, remat=remat)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for t in leaves:
                t.requires_grad_(False)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
        if mesh is not None:
            grads = [g.redistribute(t.device_mesh, t.placements) for t, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(state: TrainState, batch: Batch):
        params = state.params
        if microbatches == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            gsum, losses, mets = None, [], []
            for part in _split(batch, microbatches):
                l, met, g = grads_of(params, part)
                if gsum is None:
                    gsum = [x.to(acc_dt) for x in g]
                else:
                    for a, x in zip(gsum, g):
                        a.add_(x.to(acc_dt))
                losses.append(l)
                mets.append(met)
            grads = [a / microbatches for a in gsum]
            loss = sum(losses) / microbatches
            metrics = {k: torch.mean(torch.stack([m[k] for m in mets])) for k in mets[0]}
        with scope():
            _, new_opt, om = opt_lib.apply_updates(ocfg, params, _unflatten(params, grads),
                                                   state.opt,
                                                   decay=opt_lib.decay_mask(model.cfg, params))
        metrics = dict(metrics)
        metrics.update(om)
        metrics["loss"] = loss
        return TrainState(params, new_opt), metrics

    return train_step


def make_eval_step(model: Model) -> Callable:
    """eval_step(params, batch) -> the batch's nll (no gradients, no remat)."""
    @torch.no_grad()
    def eval_step(params, batch: Batch):
        _, metrics = model.loss(params, batch, remat=False)
        return metrics["nll"]

    return eval_step


def init_state(model: Model, seed: int = 0, *, device: DeviceLike = "cuda",
               moment_dtype: str = "float32") -> TrainState:
    params = model.init(seed, device=device)
    return TrainState(params, opt_lib.init_opt_state(params, moment_dtype))


def train(model: Model, ocfg: OptimizerConfig, data_iter, steps: int, *,
          log_every: int = 20, eval_fn: Optional[Callable] = None,
          state: Optional[TrainState] = None, device: DeviceLike = "cuda",
          log: Callable = print) -> Tuple[TrainState, List[Dict[str, float]]]:
    """Single-device training loop: `steps` batches from `data_iter`; every
    `log_every` steps and at the last, one history entry of the step's
    metrics as floats ("loss", "nll", "aux", "tokens", "grad_norm", "lr"),
    "step", "wall_s" and, with `eval_fn(params)`, "eval_nll".  Without a
    `state`, seeded parameters (seed 0) and zeroed moments on `device`."""
    state = state or init_state(model, device=device, moment_dtype=ocfg.moment_dtype)
    step_fn = make_train_step(model, ocfg)
    history = []
    t0 = time.time()
    for i in range(steps):
        batch = next(data_iter)
        state, metrics = step_fn(state, batch)
        if i % log_every == 0 or i == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = i
            m["wall_s"] = time.time() - t0
            if eval_fn is not None:
                m["eval_nll"] = float(eval_fn(state.params))
            history.append(m)
            log(f"step {i:5d} loss={m['loss']:.4f} nll={m['nll']:.4f} "
                f"gnorm={m['grad_norm']:.2f} lr={m['lr']:.2e}")
    return state, history
