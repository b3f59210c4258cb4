"""Captured steps on a CUDA card (marked ``cuda``; each test skips
without a card).  This file imports neither JAX nor the reference, so it
runs on the machine with the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_capture_card.py

* ``DenseBackend(jit=True)`` on both KV layouts: the replayed step gives
  the eager step's logits bit for bit (the same kernels on the same
  inputs), one capture and then replays, and the kernel launch counts of
  the eager run (a replay adds its captured launches);
* ``start_batch`` drops the graphs with the buffers they bake in;
* ``CapturedStep`` around one kernel: replays agree with the plain version
  and count one launch each.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import capture
from repro_torch.configs import get_config, smoke_variant
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.serving import api


def _granite():
    cfg = smoke_variant(get_config("granite-3-2b"), layers=2, d_model=256, vocab=512)
    return build_model(dataclasses.replace(cfg, dtype="bfloat16"))


def _prompts(cfg, b=2, s=6, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


# --------------------------------------------------------------------------
# on a card: replay against eager, launch counts, graphs dropped
# --------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: chip_smoke.py runs these paths on the H100")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["dense-kv", "paged-kv"])
def test_dense_backend_replay_equals_eager_on_card(card, paged):
    port = _granite()
    params = port.init(0, device=card)
    logits = {}
    for jit in (True, False):
        be = api.DenseBackend(port, params, jit=jit, paged=paged)
        be.start_batch(2, 24)
        ops.reset_dispatch_counts()
        out = [be.prefill(_prompts(port.cfg))]
        out += [be.step(np.asarray([t, t + 1])) for t in range(5)]
        logits[jit] = np.stack(out), ops.dispatch_counts()
    np.testing.assert_array_equal(logits[True][0], logits[False][0])
    counts = logits[True][1]
    assert counts["serve_step.capture"] == 1 and counts["serve_step.graph"] == 4
    assert "serve_step.eager" not in counts
    kernels = {k: v for k, v in counts.items() if not k.startswith("serve_step.")}
    assert kernels == logits[False][1]          # launches grow on every replay


@pytest.mark.cuda
def test_start_batch_drops_the_graphs_on_card(card):
    port = _granite()
    be = api.DenseBackend(port, port.init(0, device=card), paged=True)
    be.start_batch(2, 24)
    be.prefill(_prompts(port.cfg))
    be.step(np.asarray([1, 2]))
    be.step(np.asarray([3, 4]))
    assert be._step.graphs == 1
    be.start_batch(2, 24)
    assert be._step.graphs == 0


@pytest.mark.cuda
def test_captured_step_counts_launches_on_replay(card):
    from repro_torch.kernels import ref
    x = torch.randn(4, 256, device=card, dtype=torch.bfloat16)
    gates = torch.randn(1, 256, 8, device=card)
    step = capture.CapturedStep(lambda a: ops.gating_topk(a, gates, top_k=2), "probe")
    ops.reset_dispatch_counts()
    outs = [tuple(t.clone() for t in step(x)) for _ in range(3)]
    assert ops.dispatch_counts() == {"probe.capture": 1, "probe.graph": 2,
                                     "gating_topk.cuda": 3}
    want = ref.gating_topk_ref(x.cpu(), gates.cpu(), top_k=2)
    for out in outs:
        for got, w in zip(out, want):
            torch.testing.assert_close(got.cpu(), w, rtol=1e-5, atol=1e-5)
