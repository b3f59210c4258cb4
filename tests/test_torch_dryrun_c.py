"""The port's dry run on the (32, 8) production mesh: Mixtral-8x7B's
decode_32k and train_4k ok at full width, train_4k losing no work
(model FLOPs <= per-GPU FLOPs x GPUs x 1.02), the CLI; and on one device
the op analysis's FLOPs of a smoke train step against the JAX package's
HLO analysis of the same step."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.launch import dryrun
from test_torch_dryrun import check_record


def test_decode_32k_and_train_4k_ok_without_lost_work(tmp_path):
    check_record(dryrun.run_one("mixtral-8x7b", "decode_32k", verbose=False),
                 "mixtral-8x7b", "decode_32k")
    out = tmp_path / "rec.jsonl"
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "mixtral-8x7b", "--shape", "train_4k", "--out", str(out)])
    assert e.value.code == 0
    rec = json.loads(out.read_text().splitlines()[-1])
    check_record(rec, "mixtral-8x7b", "train_4k")
    assert rec["model_flops"] <= rec["flops_per_chip"] * rec["chips"] * 1.02


def test_train_step_flops_equal_reference_hlo_dot_flops():
    """One device, mixtral smoke (2 layers, 128 wide, float32), remat, a
    batch of 4 x 64: the port's op analysis of its train step against the
    reference's ``hlo_analysis.analyze`` of its jitted step, within 1%."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget, smoke_variant as jsmoke
    from repro.launch import hlo_analysis
    from repro.models import Batch as JBatch, build_model as jbuild
    from repro.training.optimizer import OptimizerConfig as JOpt, init_opt_state as jinit
    from repro.training.train_loop import TrainState as JState, make_train_step as jstep
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.launch.op_analysis import analyze
    from repro_torch.models.model import Batch, Model
    from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.training.train_loop import TrainState, make_train_step

    b, s = 4, 64
    jcfg = dataclasses.replace(jsmoke(jget("mixtral-8x7b"), layers=2, d_model=128, vocab=512),
                               dtype="float32")
    jm = jbuild(jcfg)
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    state = JState(params, jax.eval_shape(jinit, params))
    batch = JBatch(tokens=jax.ShapeDtypeStruct((b, s), jnp.int32),
                   loss_mask=jax.ShapeDtypeStruct((b, s), jnp.float32))
    hlo = jax.jit(jstep(jm, JOpt(), remat=True)).lower(state, batch).compile().as_text()
    ref = hlo_analysis.analyze(hlo)["flops"]

    cfg = dataclasses.replace(smoke_variant(get_config("mixtral-8x7b"), layers=2, d_model=128,
                                            vocab=512), dtype="float32")
    model = Model(cfg)
    p = model.init(0, device="cpu")
    rng = np.random.default_rng(0)
    tb = Batch(torch.from_numpy(rng.integers(0, 512, (b, s)).astype(np.int32)),
               torch.ones((b, s)))
    _, got = analyze(make_train_step(model, OptimizerConfig(), remat=True),
                     TrainState(p, init_opt_state(p)), tb)
    assert got["flops"] == pytest.approx(ref, rel=0.01), (got["flops"], ref)
