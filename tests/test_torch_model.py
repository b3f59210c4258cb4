"""The port's model against the JAX reference on the trained smoke
checkpoints: parameters converted with `repro_torch.weights`, then prefill
and per-step decode logits compared in float32 (atol 1e-4: float32 sums
taken in another order over D=128 and four layers)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.common import CACHE_DIR, bench_config
from repro.models import build_model as build_ref
from repro.models.model import Batch
from repro.training import checkpoint as ckpt
from repro_torch.models import build_model
from repro_torch.models import moe as tmoe
from repro_torch.weights import from_jax_params, load_checkpoint

torch.set_num_threads(2)
ATOL = 1e-4
CPU = torch.device("cpu")


def _ckpt_dir(kind):
    return f"{CACHE_DIR}/{kind}"


@pytest.fixture(scope="module", params=["mixtral-smoke", "phi-smoke"])
def models(request):
    kind = request.param
    cfg = bench_config(kind)
    ref = build_ref(cfg)
    like = ref.init(jax.random.PRNGKey(0))
    params, _ = ckpt.restore(_ckpt_dir(kind), like)
    port = build_model(cfg)
    tparams = from_jax_params(cfg, load_checkpoint(_ckpt_dir(kind)), device="cpu")
    return cfg, ref, params, port, tparams


def test_checkpoint_reader_matches_jax_restore(models):
    """The numpy checkpoint reader and the reference's live tree give the
    same port parameters."""
    cfg, _, params, _, tparams = models
    live = from_jax_params(cfg, jax.tree_util.tree_map(np.asarray, params),
                           device="cpu")
    flat_a = [tparams["embed"], tparams["final_norm"]["scale"]]
    flat_b = [live["embed"], live["final_norm"]["scale"]]
    for la, lb in zip(tparams["layers"], live["layers"]):
        for key in ("wq", "wk", "wv", "wo"):
            flat_a.append(la["attn"][key])
            flat_b.append(lb["attn"][key])
        for key in ("wi", "wo"):
            flat_a.append(la["ffn"]["experts"][key])
            flat_b.append(lb["ffn"]["experts"][key])
        flat_a.append(la["ffn"]["router"])
        flat_b.append(lb["ffn"]["router"])
    assert len(tparams["layers"]) == cfg.num_layers
    for a, b in zip(flat_a, flat_b):
        assert torch.equal(a, b)


def test_prefill_and_decode_logits_match_reference(models):
    cfg, ref, params, port, tparams = models
    rng = np.random.default_rng(0)
    b, s, steps, max_len = 2, 12, 4, 24
    prompts = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    teacher = rng.integers(0, cfg.vocab_size, (steps, b)).astype(np.int32)

    lg_r, cache_r, pos_r = jax.jit(lambda p, bt: ref.prefill(p, bt, max_len))(
        params, Batch(tokens=jnp.asarray(prompts),
                      loss_mask=jnp.ones((b, s), jnp.float32)))
    lg_t, cache_t, pos_t = port.prefill(tparams, torch.from_numpy(prompts), max_len)
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_r), atol=ATOL)
    np.testing.assert_array_equal(pos_t, np.asarray(pos_r))

    step_r = jax.jit(ref.decode_step)
    positions = torch.from_numpy(pos_t)
    for t in range(steps):
        lg_r, cache_r = step_r(params, cache_r, jnp.asarray(teacher[t][:, None]), pos_r)
        pos_r = pos_r + 1
        lg_t = port.decode_step(tparams, cache_t, torch.from_numpy(teacher[t][:, None]),
                                positions)
        positions = positions + 1
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_r), atol=ATOL)


def test_dispatch_indices_match_reference_with_token_mask():
    from repro.models import moe as rmoe
    cfg = bench_config("mixtral-smoke")
    rng = np.random.default_rng(3)
    top_idx = rng.integers(0, cfg.moe.num_experts, (24, cfg.moe.top_k)).astype(np.int32)
    mask = rng.random(24) > 0.3
    for cap, m in ((8, None), (8, mask), (4, mask)):
        sr, kr = rmoe.dispatch_indices(jnp.asarray(top_idx), cfg.moe, cap,
                                       None if m is None else jnp.asarray(m))
        st, kt = tmoe.dispatch_indices(torch.from_numpy(top_idx), cfg.moe, cap,
                                       None if m is None else torch.from_numpy(m))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sr))
        np.testing.assert_array_equal(kt.numpy(), np.asarray(kr))
        assert tmoe._capacity(24, cfg.moe) == rmoe._capacity(24, cfg.moe)


def test_default_device_is_cuda_and_raises_without_a_card():
    """Entry points run on the card unless the caller asks for the CPU: on a
    machine without CUDA, the default raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is usable")
    port = build_model(bench_config("mixtral-smoke"))
    with pytest.raises(RuntimeError, match="cuda"):
        port.init(0)
    with pytest.raises(RuntimeError, match="cuda"):
        from_jax_params(port.cfg, load_checkpoint(_ckpt_dir("mixtral-smoke")))
