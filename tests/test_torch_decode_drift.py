"""bf16 decode against the teacher-forced forward: the port drifts no more
than the reference.

On the card the bf16 decode step of a deep windowed model departs from
``Model.forward`` over the same tokens (one-row and many-row products
round differently there).  On the CPU the question is whether the port's
own gap exceeds the reference's, which would be a fault of the port.  For
the bf16 smoke Llama-4-Scout (chunked layers) and Gemma-3 (a ring of
sliding-window layers), 8 layers at d_model 64 with a window and chunk of
8 and capacity factor 8 (no token dropped), weights from the reference's
init: one row's 4-token prompt, then teacher-forced decode through
positions 4-27, across every chunk boundary and the ring's wrap.  At every
position the port's max |decode - forward| is at most the reference's +
1e-3 (measured: the port 0 at every position for both; the reference 0 for
Llama-4 and 0.002-0.007 for Gemma-3).

With two rows the port's Llama-4 gap is 0.0005-0.0031 from position 7 on
where the reference's is 0 (and for Gemma-3 the port's 0 against the
reference's 0.002-0.004): the softmax over the forward's 28 keys (20 of
them masked to weight 0) and over the decode step's 8-slot ring sums the
same 8 weights in another float32 order (3e-8 apart), and one layer's
attention output then rounds to another bf16 value.  That is rounding on
the CPU, not a misplaced key; the float32 decode equals the forward to
3e-4 (tests/test_torch_windowed.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import smoke_variant as ref_smoke_variant
from repro.models import build_model as build_ref
from repro.models.model import Batch as RefBatch
from repro_torch.configs import get_config, smoke_variant
from repro_torch.models import build_model
from repro_torch.weights import from_jax_params

torch.set_num_threads(2)
WINDOW = 8
LAYERS = 8
PROMPT = 4
END = 28            # positions 4-27: chunk boundaries at 8, 16, 24; the ring wraps
MAX_LEN = 32
SLACK = 1e-3


def _smoke(get, smoke, arch):
    cfg = dataclasses.replace(smoke(get(arch), layers=2, d_model=64), dtype="bfloat16",
                              window_size=WINDOW, num_layers=LAYERS)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    return cfg.validate()


def _ref_gaps(ref, params, toks):
    """max |decode - forward| per decoded position, the reference's."""
    b = toks.shape[0]
    lg, cache, pos = ref.prefill(params, RefBatch(
        tokens=jnp.asarray(toks[:, :PROMPT], jnp.int32),
        loss_mask=jnp.ones((b, PROMPT))), MAX_LEN)
    x, _, _ = ref.forward(params, RefBatch(tokens=jnp.asarray(toks, jnp.int32),
                                           loss_mask=jnp.ones(toks.shape)))
    full = np.asarray(ref.logits(params, x), np.float32)
    step = jax.jit(ref.decode_step)
    gaps = []
    for i in range(PROMPT, END):
        lg, cache = step(params, cache, jnp.asarray(toks[:, i:i + 1], jnp.int32), pos)
        pos = pos + 1
        gaps.append(float(np.abs(np.asarray(lg, np.float32) - full[:, i]).max()))
    return np.asarray(gaps)


def _port_gaps(port, tparams, toks):
    """max |decode - forward| per decoded position, the port's."""
    _, cache, pos = port.prefill(tparams, torch.from_numpy(toks[:, :PROMPT]), MAX_LEN)
    x, _, _ = port.forward(tparams, torch.from_numpy(toks))
    full = port.logits(tparams, x).numpy()
    positions = torch.from_numpy(pos)
    gaps = []
    for i in range(PROMPT, END):
        lg = port.decode_step(tparams, cache, torch.from_numpy(toks[:, i:i + 1]), positions)
        positions = positions + 1
        gaps.append(float(np.abs(lg.numpy() - full[:, i]).max()))
    return np.asarray(gaps)


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "gemma3-27b"])
def test_bf16_decode_drifts_no_more_than_the_reference(arch):
    ref = build_ref(_smoke(ref_get_config, ref_smoke_variant, arch))
    port = build_model(_smoke(get_config, smoke_variant, arch))
    assert set(port.cfg.layer_kinds()) - {"attn"}
    params = ref.init(jax.random.PRNGKey(2))
    tparams = from_jax_params(port.cfg, jax.tree_util.tree_map(np.asarray, params),
                              device="cpu")
    toks = np.random.default_rng(3).integers(0, port.cfg.vocab_size, (1, END)).astype(np.int32)
    want = _ref_gaps(ref, params, toks)
    got = _port_gaps(port, tparams, toks)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    worse = {PROMPT + i: (g, w) for i, (g, w) in enumerate(zip(got, want)) if g > w + SLACK}
    assert not worse, f"positions where the port drifts more (port, reference): {worse}"
