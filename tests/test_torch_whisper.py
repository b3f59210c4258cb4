"""Whisper-tiny in the port: the encoder, cross-attention and sinusoidal
positions (ROADMAP Queue 1, item 7.5), against the JAX reference.

* The config equals the reference's field by field; ``check_supported``
  takes it, the paged layout does not; its parameter count and the cross
  K/V bytes per slot at full width.
* ``sinusoidal_positions`` bit-equal to the reference's, in float32 and cast
  to bf16.
* The smoke model (d_model 64, 2 encoder + 2 decoder layers, float32,
  weights from the reference's init through ``from_jax_params``, 32 audio
  frames from a numpy seed): the encoder, a layer's cross-attention,
  forward, logits and loss within rtol 1e-5 / atol 1e-4; the prefill and 8
  decode steps against the reference's ``prefill`` / ``decode_step``
  within atol 1e-4; ``decode.generate`` with audio frames gives the
  reference's greedy tokens, captured and eager.
* The encoder at whisper-tiny's full width (384 wide, 6 heads, 4 layers)
  over 1500 frames, within rtol 1e-5 / atol 1e-4.
* bf16 trees keep every norm scale and bias float32 (encoder, cross_norm);
  a sinusoidal model refuses a max_len past max_seq_len; the forward
  without audio frames raises; the backends and the serve launcher refuse
  an encoder model, naming ``decode.generate``.

Inputs and weights come from numpy seeds or the reference's init, handed to
both sides as numpy arrays.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import smoke_variant as ref_smoke_variant
from repro.models import build_model as build_ref
from repro.models import layers as rlayers
from repro.models.model import Batch as RefBatch
from repro.models.model import _encoder_forward as ref_encoder_forward
from repro.serving import decode as ref_decode
from repro_torch.configs import ASSIGNED_ARCHS, get_config, smoke_variant
from repro_torch.models import build_model
from repro_torch.models import layers as tlayers
from repro_torch.models.model import Batch, _cross_kv, check_supported, supports_paged_kv
from repro_torch.serving import decode
from repro_torch.serving.api import BackendConfig, DenseBackend, make_backend
from repro_torch.weights import from_jax_params

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "whisper-tiny"
TOL = dict(rtol=1e-5, atol=1e-4)
B, S, MAX_LEN = 2, 12, 24


def _smoke(get, smoke, dtype="float32"):
    return dataclasses.replace(smoke(get(ARCH), d_model=64), dtype=dtype).validate()


_MODELS = {}


def _load(dtype="float32"):
    """(reference model, its params, port model, the same params in the port)."""
    if dtype not in _MODELS:
        ref = build_ref(_smoke(ref_get_config, ref_smoke_variant, dtype))
        port = build_model(_smoke(get_config, smoke_variant, dtype))
        params = ref.init(jax.random.PRNGKey(3))
        tparams = from_jax_params(port.cfg, jax.tree_util.tree_map(np.asarray, params),
                                  device="cpu")
        _MODELS[dtype] = (ref, params, port, tparams)
    return _MODELS[dtype]


def _inputs(cfg, b=B, s=S, seed=0):
    rng = np.random.default_rng(seed)
    frames = (rng.normal(size=(b, cfg.encoder.seq_len, cfg.encoder.d_model)) * 0.02
              ).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return tokens, frames


def _batches(tokens, frames):
    b, s = tokens.shape
    return (RefBatch(tokens=jnp.asarray(tokens), loss_mask=jnp.ones((b, s)),
                     audio_frames=jnp.asarray(frames)),
            Batch(tokens=torch.from_numpy(tokens), loss_mask=torch.ones((b, s)),
                  audio_frames=torch.from_numpy(frames)))


def test_config_matches_reference_and_is_supported():
    assert ARCH in ASSIGNED_ARCHS
    got, want = get_config(ARCH), ref_get_config(ARCH)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    check_supported(got)
    assert not supports_paged_kv(got)
    assert got.frontend == "audio_frames" and got.rope_theta == 0.0
    m = build_model(got)
    assert m.has_cross
    # the card's cross K/V per slot: 4 layers x (k, v) x 1500 frames x 384 x 2 B
    cache = m.init_cache(1, got.max_seq_len, "meta")
    cross = sum(c[n].numel() * c[n].element_size() for c in cache for n in ("cross_k", "cross_v"))
    assert cross == 4 * 2 * 1500 * 384 * 2 == 9_216_000
    assert round(got.param_count() / 1e6, 1) == round(want.param_count() / 1e6, 1)


def test_sinusoidal_positions_bit_equal():
    for n, d in ((448, 384), (1500, 384), (32, 64)):
        got = tlayers.sinusoidal_positions(n, d)
        want = np.asarray(rlayers.sinusoidal_positions(n, d))
        assert got.dtype == np.float32 and np.array_equal(got, want)
        bf_t = torch.from_numpy(got).to(torch.bfloat16).to(torch.float32).numpy()
        bf_r = np.asarray(jnp.asarray(want).astype(jnp.bfloat16).astype(jnp.float32))
        assert np.array_equal(bf_t, bf_r)


def test_encoder_matches_reference():
    ref, params, port, tparams = _load()
    _, frames = _inputs(port.cfg)
    want = ref_encoder_forward(params["encoder"], jnp.asarray(frames), ref.cfg)
    got = port.encode(tparams, torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_encoder_full_width_matches_reference():
    """whisper-tiny's encoder as published (4 layers, 384 wide, 6 heads of
    64, d_ff 1536) over 1500 frames, float32."""
    rcfg = dataclasses.replace(ref_get_config(ARCH), dtype="float32")
    tcfg = dataclasses.replace(get_config(ARCH), dtype="float32")
    ref, port = build_ref(rcfg), build_model(tcfg)
    params = ref.init(jax.random.PRNGKey(5))
    tparams = from_jax_params(tcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    frames = (np.random.default_rng(1).normal(size=(1, 1500, 384)) * 0.02).astype(np.float32)
    want = jax.jit(lambda p, f: ref_encoder_forward(p, f, rcfg))(params["encoder"],
                                                                 jnp.asarray(frames))
    got = port.encode(tparams, torch.from_numpy(frames))
    assert got.shape == (1, 1500, 384)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cross_attention_matches_reference():
    ref, params, port, tparams = _load()
    tokens, frames = _inputs(port.cfg)
    cfg = port.cfg
    enc = port.encode(tparams, torch.from_numpy(frames))
    lp = tparams["layers"][0]
    x = np.random.default_rng(2).normal(size=(B, S, cfg.d_model)).astype(np.float32)
    k, v = _cross_kv(lp, enc, cfg)
    got = tlayers.cross_attn_forward(lp["cross"], torch.from_numpy(x), (k, v), cfg)
    rp = jax.tree_util.tree_map(lambda a: a[0], params["blocks"][0])["cross"]
    want = rlayers.cross_attn_forward(rp, jnp.asarray(x), (jnp.asarray(k.numpy()),
                                                            jnp.asarray(v.numpy())), ref.cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_forward_logits_and_loss_match_reference():
    ref, params, port, tparams = _load()
    rb, tb = _batches(*_inputs(port.cfg))
    x_r, aux_r, _ = ref.forward(params, rb)
    x_t, kvs, aux_t = port.forward(tparams, tb)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_r), **TOL)
    assert len(kvs) == port.cfg.num_layers and all(len(kv) == 4 for kv in kvs)
    np.testing.assert_allclose(port.logits(tparams, x_t).numpy(),
                               np.asarray(ref.logits(params, x_r)), **TOL)
    (l_r, m_r), (l_t, m_t) = ref.loss(params, rb, remat=False), port.loss(tparams, tb)
    np.testing.assert_allclose(float(l_t), float(l_r), **TOL)
    np.testing.assert_allclose(float(m_t["nll"]), float(m_r["nll"]), **TOL)
    assert float(aux_t) == float(aux_r) == 0.0
    # remat changes nothing in the forward
    x_c, none, _ = port.forward(tparams, tb, remat=True)
    assert none is None and torch.equal(x_c, x_t)


def test_prefill_and_decode_match_reference():
    """Prefill of 12 tokens over 32 frames, then 8 teacher-forced decode
    steps (sinusoidal positions gathered at each step's position, cross
    K/V read from the cache) against the reference's jitted step."""
    ref, params, port, tparams = _load()
    tokens, frames = _inputs(port.cfg)
    rb, tb = _batches(tokens, frames)
    lg_r, cache_r, pos_r = ref.prefill(params, rb, MAX_LEN)
    lg_t, cache_t, pos_t = port.prefill(tparams, tb, MAX_LEN)
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_r), **TOL)
    np.testing.assert_array_equal(pos_t, np.asarray(pos_r))
    for li, c in enumerate(cache_t):
        np.testing.assert_allclose(c["cross_k"].numpy(), np.asarray(cache_r["enc_kv"][li, 0]),
                                   **TOL)
        np.testing.assert_allclose(c["cross_v"].numpy(), np.asarray(cache_r["enc_kv"][li, 1]),
                                   **TOL)
    step_r = jax.jit(ref.decode_step)
    teacher = np.random.default_rng(4).integers(0, port.cfg.vocab_size, (8, B))
    for t in range(8):
        lg_r, cache_r = step_r(params, cache_r, jnp.asarray(teacher[t][:, None], jnp.int32),
                               pos_r)
        lg_t = port.decode_step(tparams, cache_t, torch.from_numpy(teacher[t][:, None]),
                                torch.from_numpy(pos_t))
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_r), rtol=0, atol=1e-4)
        pos_r, pos_t = pos_r + 1, pos_t + 1


@pytest.mark.parametrize("jit", [True, False])
def test_generate_with_audio_frames_matches_reference(jit):
    ref, params, port, tparams = _load()
    tokens, frames = _inputs(port.cfg, s=4, seed=6)
    want = ref_decode.generate(ref, params, jnp.asarray(tokens), 10,
                               extra={"audio_frames": jnp.asarray(frames)})
    got = decode.generate(port, tparams, tokens, 10, extra={"audio_frames": frames}, jit=jit)
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_bf16_tree_keeps_norms_float32():
    _, _, port, tparams = _load("bfloat16")
    enc = tparams["encoder"]
    for lp in enc["layers"]:
        for n in ("norm1", "norm2"):
            assert all(t.dtype == torch.float32 for t in lp[n].values())
        assert lp["attn"]["wq"].dtype == lp["ffn"]["wi"].dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for t in enc["final_norm"].values())
    for lp in tparams["layers"]:
        assert all(t.dtype == torch.float32 for t in lp["cross_norm"].values())
        assert lp["cross"]["wk"].dtype == torch.bfloat16
        assert lp["cross"]["wk"].shape == (port.cfg.encoder.d_model,
                                          port.cfg.num_kv_heads * port.cfg.resolved_head_dim)


def test_max_len_past_max_seq_len_is_refused():
    """The reference's decode table ends at max_seq_len and its gather
    clamps beyond; the port refuses the length (a CUDA gather out of range
    is a device assert)."""
    _, _, port, tparams = _load()
    tokens, frames = _inputs(port.cfg, s=4)
    n = port.cfg.max_seq_len
    port.init_cache(1, n, "meta")
    with pytest.raises(ValueError, match="max_seq_len"):
        port.init_cache(1, n + 1, "meta")
    with pytest.raises(ValueError, match="max_seq_len"):
        port.prefill(tparams, _batches(tokens, frames)[1], n + 1)


def test_forward_without_audio_frames_raises():
    _, _, port, tparams = _load()
    with pytest.raises(ValueError, match="audio_frames"):
        port.forward(tparams, torch.zeros((1, 4), dtype=torch.int32))


@pytest.mark.parametrize("how", ["DenseBackend", "dense", "hobbit"])
def test_backends_refuse_an_encoder_model(how):
    _, _, port, tparams = _load()
    with pytest.raises(ValueError, match="decode.generate"):
        if how == "DenseBackend":
            DenseBackend(port, tparams)
        else:
            make_backend(BackendConfig(kind=how), port, tparams)


def test_serve_launcher_refuses_whisper():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
                          "--smoke", "--device", "cpu"], capture_output=True, text=True,
                         env=env, timeout=300, cwd=ROOT)
    assert res.returncode != 0
    assert "encoder-decoder model" in res.stderr and "decode.generate" in res.stderr
    assert "Traceback" not in res.stderr
