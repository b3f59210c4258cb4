"""Jamba-v0.1-52B in the port: periods of 7 Mamba-2 SSD layers and one
attention layer without positional encoding, dense and MoE FFN layers
alternating, against the JAX reference.

* The config equals the reference's field by field and ``check_supported``
  takes it; the 16-layer cut of the card's serve.
* The smoke model (d_model 64, one 8-layer period, float32, capacity factor
  8 so that no token is dropped; weights from the reference's init through
  ``from_jax_params``): forward, logits, the prefill and every decode step
  against the reference at 2e-4 and against the port's teacher-forced
  forward at 3e-4, after prompts of 2 and 37 tokens (over the 32-token SSD
  chunk), RoPE off in the attention layer; the same with the dense FFN
  quantized to 4 bits by the reference's ``quantize_tree``.
* ``DenseBackend(jit=True)`` equal to ``jit=False``; ``BatchingServer``
  greedy tokens equal to the reference server's; the paged KV layout,
  ``OffloadEngine`` and ``HobbitBackend`` refuse it, naming the ssm and the
  dense FFN layers; the launcher's ``--arch jamba-v0.1-52b --smoke`` on the
  CPU and its refusals.

Inputs and weights come from numpy seeds or the reference's init, handed to
both sides as numpy arrays.
"""

import dataclasses
import importlib
import json
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
from repro.models.model import Batch as RefBatch
from repro.serving.api import DenseBackend as RefDense
from repro.serving.batching import BatchingServer as RefServer
from repro.serving.batching import Request as RefRequest
from repro_torch.configs import ASSIGNED_ARCHS, get_config, smoke_variant
from repro_torch.core import EngineConfig, OffloadEngine
from repro_torch.models import build_model
from repro_torch.models.model import _use_rope, check_supported, supports_paged_kv
from repro_torch.quant.quantize import QTensor
from repro_torch.serving.api import BackendConfig, DenseBackend, make_backend
from repro_torch.serving.batching import BatchingServer, Request
from repro_torch.serving.workload import RequestClass, WorkloadConfig, generate_workload
from repro_torch.weights import from_jax_params

jq = importlib.import_module("repro.quant.quantize")
torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "jamba-v0.1-52b"
TOL = dict(rtol=2e-4, atol=2e-4)        # tests/test_arch_smoke.py: against the reference
STEP_TOL = dict(rtol=3e-4, atol=3e-4)   # ... and decode against teacher-forced forward
GROUP = 32
MAX_LEN = 48
KINDS = ("ssm",) * 4 + ("attn",) + ("ssm",) * 3
MOES = (False, True) * 4


def _dense_ffn(path, leaf):
    """The dense FFN layers' 2-D weights, not the experts or the router: the
    predicate of chip_smoke.py's q4 serve."""
    del leaf
    p = str(path)
    return "ffn" in p and "experts" not in p and "router" not in p


def _smoke(get, smoke):
    """The smoke variant at d_model 64 (one period: 7 SSD layers of 4 heads
    of 32 at d_state 32 and chunk 32, one attention layer of 4 heads, 4
    experts at top-2 in the odd layers), float32, capacity factor 8."""
    cfg = smoke(get(ARCH), d_model=64)
    return dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0)).validate()


_MODELS = {}


def _load(quant=False):
    """(reference model, its params, port model, the same params in the port)."""
    if quant not in _MODELS:
        ref = build_ref(_smoke(ref_get_config, ref_smoke_variant))
        port = build_model(_smoke(get_config, smoke_variant))
        params = ref.init(jax.random.PRNGKey(3))
        if quant:
            params = jq.quantize_tree(params, bits=4, group_size=GROUP, predicate=_dense_ffn)
        tparams = from_jax_params(port.cfg, jax.tree_util.tree_map(np.asarray, params),
                                  device="cpu")
        _MODELS[quant] = (ref, params, port, tparams)
    return _MODELS[quant]


def _ref_batch(tokens):
    b, s = tokens.shape
    return RefBatch(tokens=jnp.asarray(tokens, jnp.int32), loss_mask=jnp.ones((b, s)))


def test_config_matches_reference_and_is_supported():
    assert ARCH in ASSIGNED_ARCHS
    got, want = get_config(ARCH), ref_get_config(ARCH)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    check_supported(got)
    assert got.layer_kinds() == KINDS * 4 and got.layer_is_moe() == MOES * 4
    assert not supports_paged_kv(got) and not _use_rope(got)
    assert round(got.param_count() / 1e9, 1) == 51.2
    assert round(got.active_param_count() / 1e9, 1) == 11.7
    cut = dataclasses.replace(got, num_layers=16).validate()     # the card's serve
    assert cut.layer_kinds().count("attn") == 2
    assert round(cut.param_count() * 2 / 1e9, 1) == 51.5         # GB of bf16
    smoke = _smoke(get_config, smoke_variant)
    assert smoke.layer_kinds() == KINDS and smoke.layer_is_moe() == MOES


def test_layers_hold_a_mixer_or_attention_and_a_dense_or_moe_ffn():
    _, _, port, tparams = _load()
    for lp, kind, moe in zip(tparams["layers"], KINDS, MOES):
        assert set(lp) == {"pre_norm", "mixer" if kind == "ssm" else "attn", "ffn_norm", "ffn"}
        assert ("router" in lp["ffn"]) == moe


def test_forward_and_logits_match_reference():
    ref, params, port, tparams = _load()
    tokens = np.random.default_rng(5).integers(0, port.cfg.vocab_size, (2, 37))
    x_r, aux_r, _ = ref.forward(params, _ref_batch(tokens))
    x_t, kvs, aux_t = port.forward(tparams, torch.from_numpy(tokens))
    assert [type(kv).__name__ for kv in kvs] == ["dict"] * 4 + ["tuple"] + ["dict"] * 3
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_r), **TOL)
    np.testing.assert_allclose(port.logits(tparams, x_t).numpy(),
                               np.asarray(ref.logits(params, x_r)), **TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_r), **TOL)


def _decode_against_reference(ref, params, port, tparams, prompt_len, seed, steps=8):
    """Prefill a (2, prompt_len) prompt into caches of max_len 48 (SSM states
    and one attention layer's K/V), then decode teacher-forced tokens: every
    step against the reference's decode and the port's forward over the
    same tokens."""
    end = prompt_len + steps
    toks = np.random.default_rng(seed).integers(0, port.cfg.vocab_size,
                                                (2, end)).astype(np.int32)
    ref_step = jax.jit(ref.decode_step)
    lg_r, cache_r, pos_r = ref.prefill(params, _ref_batch(toks[:, :prompt_len]), MAX_LEN)
    lg_t, cache_t, pos_t = port.prefill(tparams, torch.from_numpy(toks[:, :prompt_len]),
                                        MAX_LEN)
    assert [set(c) for c in cache_t] == [{"h", "conv"}] * 4 + [{"k", "v"}] + \
        [{"h", "conv"}] * 3
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_r), **TOL)
    x, _, _ = port.forward(tparams, torch.from_numpy(toks))
    full = port.logits(tparams, x).numpy()
    positions = torch.from_numpy(pos_t)
    for i in range(prompt_len, end):
        step = toks[:, i:i + 1]
        lg_r, cache_r = ref_step(params, cache_r, jnp.asarray(step), pos_r)
        pos_r = pos_r + 1
        lg_t = port.decode_step(tparams, cache_t, torch.from_numpy(step), positions)
        positions = positions + 1
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_r), **TOL,
                                   err_msg=f"position {i}")
        np.testing.assert_allclose(lg_t.numpy(), full[:, i], **STEP_TOL,
                                   err_msg=f"position {i} against forward")


@pytest.mark.parametrize("prompt_len", [2, 37])
def test_prefill_and_decode_match_reference_and_forward(prompt_len):
    _decode_against_reference(*_load(), prompt_len, seed=6 + prompt_len)


def test_4bit_dense_ffn_matches_reference():
    """The dense FFN layers' weights quantized to 4 bits (group 32) by the
    reference's quantize_tree; the experts, the router, the mixers and the
    attention stay float32."""
    ref, params, port, tparams = _load(quant=True)
    for lp, moe in zip(tparams["layers"], MOES):
        if moe:
            assert not isinstance(lp["ffn"]["experts"]["wi"], QTensor)
            assert not isinstance(lp["ffn"]["router"], QTensor)
        else:
            assert all(isinstance(lp["ffn"][w], QTensor) for w in ("wi", "wo"))
        mix = lp.get("mixer", lp.get("attn"))
        assert not any(isinstance(v, QTensor) for v in mix.values())
    tokens = np.random.default_rng(11).integers(0, port.cfg.vocab_size, (2, 12))
    x_r, _, _ = ref.forward(params, _ref_batch(tokens))
    x_t, _, _ = port.forward(tparams, torch.from_numpy(tokens))
    np.testing.assert_allclose(port.logits(tparams, x_t).numpy(),
                               np.asarray(ref.logits(params, x_r)), **TOL)
    _decode_against_reference(ref, params, port, tparams, 10, seed=12, steps=6)


def _serve(server_cls, request_cls, backend, vocab):
    trace = generate_workload(WorkloadConfig(
        classes=(RequestClass("chat", prompt_tokens=(2, 37), new_tokens=(4, 9)),),
        num_requests=5, vocab=vocab, seed=7))
    srv = server_cls(backend, max_batch=2, max_len=MAX_LEN, admit_k=1)
    for w in trace:
        srv.submit(request_cls(rid=w.rid, prompt=w.prompt, max_new_tokens=w.max_new_tokens))
    try:
        srv.run()
        return {r.rid: np.asarray(r.output) for r in srv.completed}
    finally:
        srv.close()


def test_batching_server_tokens_match_reference():
    ref, params, port, tparams = _load()
    out_r = _serve(RefServer, RefRequest, RefDense(ref, params, jit=True),
                   port.cfg.vocab_size)
    out_t = _serve(BatchingServer, Request, DenseBackend(port, tparams),
                   port.cfg.vocab_size)
    assert sorted(out_t) == sorted(out_r) == list(range(5))
    for rid in out_r:
        np.testing.assert_array_equal(out_t[rid], out_r[rid])


def test_dense_backend_jit_equals_eager():
    _, _, port, tparams = _load()
    rng = np.random.default_rng(13)
    prompts = rng.integers(0, port.cfg.vocab_size, (2, 7))
    feed = rng.integers(0, port.cfg.vocab_size, (6, 2))
    runs = []
    for jit in (True, False):
        be = DenseBackend(port, tparams, jit=jit)
        be.start_batch(2, MAX_LEN)
        runs.append(np.stack([be.prefill(prompts)] + [be.step(t) for t in feed]))
    np.testing.assert_array_equal(runs[0], runs[1])


def test_refusals_name_the_ssm_and_dense_ffn_layers():
    _, _, port, tparams = _load()
    with pytest.raises(ValueError, match="paged KV layout.*SSM"):
        DenseBackend(port, tparams, paged=True)
    want = "jamba-v0.1-52b-smoke has ssm layers, dense FFN layers \\(serve"
    with pytest.raises(ValueError, match=want):
        OffloadEngine(port, tparams, EngineConfig(async_prefetch=False))
    with pytest.raises(ValueError, match=want):
        make_backend(BackendConfig(kind="hobbit"), port, tparams)


def _launcher(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--smoke",
         "--device", "cpu", "--prompt-len", "8", "--new-tokens", "4", *args],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)


def test_serve_launcher_on_cpu_and_its_refusals():
    res = _launcher("--backend", "dense", "--serve-requests", "3", "--max-batch", "2")
    assert res.returncode == 0, res.stderr[-2000:]
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report["serving"]["requests"] == 3
    assert not any(k.endswith(".cuda") for k in report["kernel_dispatch"])
    for flag, msg in (("--paged-kv", "does not support the paged KV layout"),
                      ("--backend=hobbit", "OffloadEngine serves MoE models of full-window "
                                           "'attn' layers only")):
        res = _launcher(flag)
        assert res.returncode != 0 and msg in res.stderr, res.stderr[-2000:]
        assert "ssm" in res.stderr or "SSM" in res.stderr
