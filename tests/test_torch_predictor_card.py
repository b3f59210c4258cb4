"""The adaptive predictor's stacked gating on a CUDA card (marked ``cuda``;
each test skips without a card).  This file imports neither JAX nor the
reference, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_predictor_card.py

* ``kops.stacked_gating`` at Mixtral-8x7B's (D 4096, E 8) and
  Phi-3.5-MoE's (D 4096, E 16) router shapes, B = 1-8 float32 rows, P = 1
  and 2: row r of a B-row call, and its ``softmax_last``, equal the one-row
  call on x[r:r+1] bit for bit, and slice 0 of a P = 2 call a P = 1 call.
  That is what lets the grouped decode path gate every row inside a MoE
  layer's captured segment in place of one host call per row;
* the grouped engine on the card: the predictor probabilities a layer's
  replayed segment computes for every row equal the predictor's one-row
  host call on that row's float32 hidden state bit for bit (and so do the
  predictions made from them), one stacked-gating launch per MoE layer but
  the last and step, and no host call while it serves.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import EngineConfig, OffloadEngine
from repro_torch.kernels import ops
from repro_torch.kernels.ref import softmax_last
from repro_torch.models import build_model


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the gating kernel has no CPU build")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("d,e", [(4096, 8), (4096, 16)], ids=["mixtral", "phi"])
@pytest.mark.parametrize("p", [1, 2])
def test_stacked_gating_rows_do_not_depend_on_the_batch_on_card(card, d, e, p):
    g = torch.Generator(device=card).manual_seed(d + e + p)
    gates = torch.randn((2, d, e), generator=g, device=card) * 0.02
    for b in range(1, 9):
        x = torch.randn((b, d), generator=g, device=card)
        logits = ops.stacked_gating(x, gates[:p])
        probs = softmax_last(logits)
        assert logits.shape == (p, b, e)
        for r in range(b):
            one = ops.stacked_gating(x[r:r + 1].clone(), gates[:p])
            assert torch.equal(logits[:, r], one[:, 0]), (b, r)
            assert torch.equal(probs[:, r], softmax_last(one)[:, 0]), (b, r)
        if p == 2:
            first = ops.stacked_gating(x, gates[:1])
            assert torch.equal(logits[:1], first), b
            assert torch.equal(probs[:1], softmax_last(first)), b
    assert ops.dispatch_counts().get("stacked_gating.torch", 0) == 0


@pytest.mark.cuda
def test_segment_predictions_equal_one_row_calls_on_card(card):
    cfg = smoke_variant(get_config("mixtral-8x7b"), layers=4, d_model=256, vocab=512)
    port = build_model(dataclasses.replace(cfg, dtype="bfloat16"))
    eng = OffloadEngine(port, port.init(0, device=card), EngineConfig(
        hi_slots=3, lo_slots=2, async_prefetch=False))
    rng = np.random.default_rng(4)
    b, steps = 4, 6
    try:
        eng.start_batch(b, 32)
        eng.prefill_batch(rng.integers(0, port.cfg.vocab_size, (b, 6)))
        ops.reset_dispatch_counts()
        for _ in range(steps):
            eng.decode_step_batch(rng.integers(0, port.cfg.vocab_size, b))
        st = eng.stats()
        assert st["predictor_host_calls"] == 0
        assert st["segment_predictions"] == steps * b * (eng.num_moe_layers - 1)
        counts = ops.dispatch_counts()
        assert counts["stacked_gating.cuda"] == steps * (eng.num_moe_layers - 1)
        assert counts["engine_layer0.graph"] == steps - 1
        gen = torch.Generator(device=card).manual_seed(6)
        for mi in range(eng.num_moe_layers - 1):
            x = torch.randn((b, 1, port.cfg.d_model), generator=gen, device=card)
            key = eng._segment_key(eng.moe_layers[mi])
            _, hs, _, _, probs = (t.clone() for t in eng._layer_steps[mi](
                x.to(torch.bfloat16), key=key))
            assert probs.shape == (min(2, eng.num_moe_layers - 1 - mi), b,
                                   port.cfg.moe.num_experts)
            for r in range(b):
                h32 = hs[r].to(torch.float32)
                assert torch.equal(probs[:, r],
                                   eng.predictor.layer_probs(h32[None], mi)[:, 0])
                want = eng.predictor.predict_layers(h32.cpu().numpy(), mi)
                got = eng.predictor.predict_layers(None, mi, probs=probs[:, r].cpu().numpy())
                assert [(w.layer, w.experts) for w in want] == \
                    [(g.layer, g.experts) for g in got]
                assert all(np.array_equal(w.gate_vals, g.gate_vals)
                           for w, g in zip(want, got))
        assert eng.stats()["predictor_host_calls"] == b * (eng.num_moe_layers - 1)
    finally:
        eng.close()
