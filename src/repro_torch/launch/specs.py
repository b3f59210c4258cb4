"""input_specs: the step and its arguments, laid out on a mesh, for every
(architecture x input shape) dry-run target -- the JAX package's
``launch/specs.py`` on DTensors.

  train_4k    -> train_step(TrainState, Batch)
  prefill_32k -> prefill_step(params, Batch)
  decode_32k  -> serve_step(params, cache, tokens, positions)
  long_500k   -> serve_step with a 524288-token cache, batch 1

The reference hands ``jax.jit`` ShapeDtypeStructs; the port builds the
arguments as DTensors over the mesh, each rank keeping its shard
(``sharding.distribute``).  Call it under a ``FakeTensorMode`` (the dry run
does): the arguments are then fake, and nothing is allocated.  The decode
step runs eagerly: ``capture.CapturedStep`` does not capture fake tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from repro_torch.configs import INPUT_SHAPES, ModelConfig
from repro_torch.configs.base import InputShape
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import data_axes
from repro_torch.models import shard_utils
from repro_torch.models.model import Batch, Model
from repro_torch.serving.decode import make_serve_step
from repro_torch.training.optimizer import OptimizerConfig, OptState, init_opt_state
from repro_torch.training.train_loop import TrainState, make_train_step

# the reference sizes the remat stack at 6 GB of a 16 GB v5e; the same share
# of an 80 GB H100
REMAT_BUDGET = 30e9
# the dry run's tensors are fake CPU tensors: nothing is allocated
_CPU = torch.device("cpu")


def batch_struct(cfg: ModelConfig, batch: int, seq: int) -> Batch:
    """Zeroed batch tensors of the step's shapes and dtypes (fake under a
    ``FakeTensorMode``)."""
    kw = {}
    if cfg.frontend == "vision_patches":
        kw["prefix_embeds"] = torch.zeros((batch, cfg.num_prefix_tokens, cfg.d_model),
                                          dtype=torch.bfloat16, device=_CPU)
    if cfg.frontend == "audio_frames":
        kw["audio_frames"] = torch.zeros((batch, cfg.encoder.seq_len, cfg.encoder.d_model),
                                         dtype=torch.float32, device=_CPU)
    return Batch(tokens=torch.zeros((batch, seq), dtype=torch.int32, device=_CPU),
                 loss_mask=torch.zeros((batch, seq), dtype=torch.float32, device=_CPU),
                 **kw)


def batch_shardings(mesh, b: Batch) -> Batch:
    """The batch's spec per field: the batch dim over the data axes."""
    dp = tuple(data_axes(mesh))
    dp = dp if len(dp) > 1 else dp[0]
    return Batch(*(None if f is None else sh.fit_spec(mesh, tuple(f.shape), (dp,))
                   for f in b))


def train_microbatches(cfg: ModelConfig, shape: InputShape, dp_size: int = 16,
                       budget: float = REMAT_BUDGET) -> int:
    """Microbatch count for gradient accumulation, sized so the per-GPU
    remat carry stack (layers x B_local x S x D x ~6 bytes incl. the fp32
    shadow) stays within `budget` bytes (the reference: 6 GB of a 16 GB
    v5e; here by default the same share of 80 GB)."""
    b_local = max(shape.global_batch // dp_size, 1)  # data(+pod)-axis shards
    stack = cfg.num_layers * b_local * shape.seq_len * cfg.d_model * 6
    mb = 1
    # cap: each microbatch must still shard its batch over the full dp axis
    mb_max = max(shape.global_batch // dp_size, 1)
    while stack / mb > budget and mb < mb_max:
        mb *= 2
    while shape.global_batch % mb:
        mb //= 2
    return max(mb, 1)


def _quantized_init(model: Model, bits: int):
    """init fn whose expert weights are groupwise-quantized `QTensor`s (group
    128) -- the mixed-precision resident-expert option of the reference."""
    from repro_torch.quant.quantize import quantize

    def init(seed=0):
        params = model.init(seed, device=_CPU)

        def walk(node):
            if isinstance(node, dict):
                return {k: ({n: quantize(w, bits=bits, group_size=128)
                             for n, w in v.items()} if k == "experts" else walk(v))
                        for k, v in node.items()}
            if isinstance(node, list):
                return [walk(v) for v in node]
            return node

        return walk(params)

    return init


def _dist_batch(mesh, b: Batch, specs: Batch) -> Batch:
    return Batch(*(None if f is None else sh.distribute(mesh, f, sp)
                   for f, sp in zip(b, specs)))


def _dp_size(mesh) -> int:
    sizes = sh.axis_sizes(mesh)
    n = 1
    for a in data_axes(mesh):
        n *= sizes[a]
    return n


def _scoped(fn, mesh, grad: bool):
    def step(*args):
        with shard_utils.mesh_scope(mesh), torch.set_grad_enabled(grad):
            return fn(*args)
    return step


def input_specs(cfg: ModelConfig, shape_name: str, mesh) -> Tuple[Callable, tuple, tuple, tuple]:
    """Returns (step_fn, args, arg_specs, donate_argnums): `args` laid out
    as DTensors over `mesh` by `arg_specs` (spec trees, ``launch.sharding``);
    step_fn(*args) runs the step sharded.  A model with sinusoidal
    positions gets a table as long as the shape's sequence (the reference
    computes its table at any length; the port otherwise refuses lengths
    past max_seq_len), which changes no parameter and no cost."""
    shape: InputShape = INPUT_SHAPES[shape_name]
    if cfg.rope_theta <= 0 and shape.seq_len > cfg.max_seq_len:
        cfg = dataclasses.replace(cfg, max_seq_len=shape.seq_len)
    model = Model(cfg)

    if shape.kind == "train":
        # bf16 Adam moments for >50B-param models, as the reference
        big = cfg.param_count() > 50e9
        ocfg = OptimizerConfig(total_steps=10_000,
                               moment_dtype="bfloat16" if big else "float32")
        mb = train_microbatches(cfg, shape, _dp_size(mesh))
        step = make_train_step(model, ocfg, remat=True, microbatches=mb, mesh=mesh)
        params = model.init(0, device=_CPU)
        p_specs = sh.param_shardings(mesh, params)
        opt = init_opt_state(params, ocfg.moment_dtype)
        state = TrainState(sh.distribute_tree(mesh, params, p_specs),
                           OptState(0, sh.distribute_tree(mesh, opt.mu, p_specs),
                                    sh.distribute_tree(mesh, opt.nu, p_specs)))
        state_specs = TrainState(p_specs, OptState((), p_specs, p_specs))
        b = batch_struct(cfg, shape.global_batch, shape.seq_len)
        b_specs = batch_shardings(mesh, b)
        return step, (state, _dist_batch(mesh, b, b_specs)), (state_specs, b_specs), (0,)

    if shape.kind == "prefill":
        # VLM prompts carry num_prefix_tokens patch embeddings on top of the
        # text tokens; the cache must hold both
        plen = shape.seq_len + (cfg.num_prefix_tokens
                                if cfg.frontend == "vision_patches" else 0)

        def prefill_step(params, batch):
            return model.prefill(params, batch, plen)

        params = model.init(0, device=_CPU)
        p_specs = sh.param_shardings(mesh, params)
        b = batch_struct(cfg, shape.global_batch, shape.seq_len)
        b_specs = batch_shardings(mesh, b)
        return (_scoped(prefill_step, mesh, False),
                (sh.distribute_tree(mesh, params, p_specs), _dist_batch(mesh, b, b_specs)),
                (p_specs, b_specs), ())

    # decode
    init_fn = lambda: model.init(0, device=_CPU)  # noqa: E731
    if cfg.moe is not None and cfg.moe.expert_precision in ("int8", "int4"):
        init_fn = _quantized_init(model, int(cfg.moe.expert_precision[3:]))
    params = init_fn()
    p_specs = sh.param_shardings(mesh, params, mode="decode")
    with shard_utils.mesh_scope(mesh):
        cache = model.init_cache(shape.global_batch, shape.seq_len, _CPU)
    cache_specs = sh.cache_shardings(mesh, cache, shape.global_batch)
    dp = tuple(data_axes(mesh))
    dp = dp if len(dp) > 1 else dp[0]
    toks = torch.zeros((shape.global_batch, 1), dtype=torch.int32, device=_CPU)
    pos = torch.zeros((shape.global_batch,), dtype=torch.long, device=_CPU)
    tok_spec = sh.fit_spec(mesh, tuple(toks.shape), (dp,))
    pos_spec = sh.fit_spec(mesh, tuple(pos.shape), (dp,))
    args = (sh.distribute_tree(mesh, params, p_specs), cache,
            sh.distribute(mesh, toks, tok_spec), sh.distribute(mesh, pos, pos_spec))
    return (_scoped(make_serve_step(model), mesh, False), args,
            (p_specs, cache_specs, tok_spec, pos_spec), (1,))

