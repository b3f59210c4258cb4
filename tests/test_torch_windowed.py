"""The windowed model family of the port (Gemma-2-27B, Gemma-3-27B,
Llama-4-Scout-17B-16E) on ring caches, against the JAX reference.

* The three configs equal the reference's field by field.
* ``make_mask`` for "attn", "attn_local" and "attn_chunked" (negative key
  positions, the ring's unwritten slots, included); ``rms_head_norm``; the
  attention logit softcap inside ``mha`` and the final logit softcap in
  ``Model.logits``; ``chunked_mha`` with more queries than ``q_chunk``
  against ``mha`` and against the reference's, at atol 1e-4.
* The smoke variants (d_model 64, float32; weights from the reference's
  init through ``from_jax_params``), with a window of 8 so that the rings
  wrap: forward and logits, and decode step by step after a prompt shorter
  and one longer than the ring, against the reference's decode and the
  port's own teacher-forced forward (Llama-4's decode crosses chunk
  boundaries at 8 and 16); a Gemma-3 variant whose 8 layers end in a
  2-layer tail; Gemma-2 with its FFN quantized to 4 bits by the reference's
  ``quantize_tree``.  rtol/atol 2e-4 and 3e-4, as the reference's
  tests/test_arch_smoke.py; atol 1e-4 on single layers.
* ``moe_forward`` (with a token mask) and ``moe_forward_dense_eval`` with
  Llama-4's shared expert beside top-1 routing at capacity factor 1.5.
* ``DenseBackend`` under ``BatchingServer``, greedy tokens equal to the
  reference server's; pause and resume of a slot whose ring has wrapped;
  ``decode.generate`` captured and eager against the reference's.
* ``from_jax_params`` on a bf16 tree keeps the sandwich norms and the
  qk-norm gains float32; ``OffloadEngine`` and ``--backend hobbit`` refuse
  Llama-4-Scout; the launcher's ``--arch gemma2-27b`` on the CPU and its
  ``--paged-kv`` refusal.

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
from repro.models import layers as rlayers
from repro.models import moe as rmoe
from repro.models.model import Batch as RefBatch
from repro.serving import decode as ref_decode
from repro.serving.api import DenseBackend as RefDense
from repro.serving.batching import BatchingServer as RefServer
from repro.serving.batching import Request as RefRequest
from repro_torch.configs import ASSIGNED_ARCHS, get_config, smoke_variant
from repro_torch.core import EngineConfig, OffloadEngine
from repro_torch.models import build_model
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.quant.quantize import QTensor
from repro_torch.serving import decode
from repro_torch.serving.api import BackendConfig, DenseBackend, make_backend
from repro_torch.serving.batching import BatchingServer, Request
from repro_torch.serving.workload import RequestClass, WorkloadConfig, generate_workload
from repro_torch.weights import from_jax_params

jq = importlib.import_module("repro.quant.quantize")
torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEMMA2, GEMMA3, LLAMA4 = "gemma2-27b", "gemma3-27b", "llama4-scout-17b-a16e"
ARCHS = [GEMMA2, GEMMA3, LLAMA4]
TOL = dict(rtol=2e-4, atol=2e-4)        # tests/test_arch_smoke.py: against the reference
STEP_TOL = dict(rtol=3e-4, atol=3e-4)   # ... and decode against teacher-forced forward
LAYER_ATOL = 1e-4
WINDOW = 8
GROUP = 32


def _ffn_path(path, leaf):
    del leaf
    return "ffn" in str(path)


def _smoke(get, smoke, arch, *, window=WINDOW, layers=None, dtype="float32"):
    """The smoke variant at d_model 64 with a `window`-token window (so the
    rings wrap in a short test); `layers` overrides the depth (Gemma-3 at 8
    layers: one 5:1 block and a 2-layer tail)."""
    cfg = dataclasses.replace(smoke(get(arch), layers=2, d_model=64), dtype=dtype,
                              window_size=window)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return cfg.validate()


_MODELS = {}


def _load(arch, *, layers=None, quant=False):
    """(reference model, its params, port model, the same params in the port)."""
    key = (arch, layers, quant)
    if key not in _MODELS:
        ref = build_ref(_smoke(ref_get_config, ref_smoke_variant, arch, layers=layers))
        port = build_model(_smoke(get_config, smoke_variant, arch, layers=layers))
        params = ref.init(jax.random.PRNGKey(ARCHS.index(arch)))
        if quant:
            params = jq.quantize_tree(params, bits=4, group_size=GROUP, predicate=_ffn_path)
        tparams = from_jax_params(port.cfg, jax.tree_util.tree_map(np.asarray, params),
                                  device="cpu")
        _MODELS[key] = (ref, params, port, tparams)
    return _MODELS[key]


def _ref_batch(tokens):
    b, s = tokens.shape
    return RefBatch(tokens=jnp.asarray(tokens, jnp.int32), loss_mask=jnp.ones((b, s)))


# --------------------------------------------------------------------------
# configs and the layer pieces
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    assert arch in ASSIGNED_ARCHS
    got, want = get_config(arch), ref_get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert set(got.layer_kinds()) - {"attn"}
    build_model(got)                    # check_supported takes it


def test_gemma3_layer_kinds_end_in_a_two_layer_tail():
    kinds = get_config(GEMMA3).layer_kinds()
    assert len(kinds) == 62
    assert kinds == ("attn_local",) * 5 + ("attn",) + kinds[6:]
    assert kinds[-2:] == ("attn_local", "attn_local") and kinds.count("attn") == 10


@pytest.mark.parametrize("kind", ["attn", "attn_local", "attn_chunked"])
def test_make_mask_matches_reference(kind):
    rng = np.random.default_rng(1)
    q_pos = rng.integers(0, 40, (3, 7))
    k_pos = rng.integers(-12, 40, (3, 11))          # below 0: a ring's empty slots
    want = rlayers.make_mask(jnp.asarray(q_pos), jnp.asarray(k_pos), kind, 8)
    got = tlayers.make_mask(torch.from_numpy(q_pos), torch.from_numpy(k_pos), kind, 8)
    assert tuple(got.shape) == (3, 7, 11) and got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rms_head_norm_matches_reference():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 5, 4, 16)) * 3).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32) * 0.5
    want = rlayers.rms_head_norm(jnp.asarray(scale), jnp.asarray(x), 1e-6)
    got = tlayers.rms_head_norm(torch.from_numpy(scale), torch.from_numpy(x), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def _qkv_case(seed, b=2, s=10, hq=4, hkv=2, hd=16):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, s, hq, hd)) * 2).astype(np.float32)
    k = (rng.standard_normal((b, s, hkv, hd)) * 2).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (b, s)).copy()
    return q, k, v, pos


@pytest.mark.parametrize("kind", ["attn", "attn_local", "attn_chunked"])
def test_chunked_mha_with_softcap_matches_mha_and_reference(kind):
    """10 queries in chunks of 4 (two chunks and a tail of 2), the 50.0
    attention softcap (Gemma-2's) on logits large enough to bend."""
    q, k, v, pos = _qkv_case(3)
    cap, scale, qc = 5.0, 0.25, 4
    tq, tk, tv, tpos = map(torch.from_numpy, (q, k, v, pos))
    got = tlayers.chunked_mha(tq, tk, tv, tpos, tpos, kind, 3, cap, scale, q_chunk=qc)
    whole = tlayers.mha(tq, tk, tv, tlayers.make_mask(tpos, tpos, kind, 3), cap, scale)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=1e-6, rtol=0)
    jq_, jk, jv, jpos = map(jnp.asarray, (q, k, v, pos))
    want = rlayers.chunked_mha(jq_, jk, jv, jpos, jpos, kind, 3, cap, scale, q_chunk=qc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LAYER_ATOL, rtol=0)
    uncapped = tlayers.chunked_mha(tq, tk, tv, tpos, tpos, kind, 3, 0.0, scale, q_chunk=qc)
    assert float((uncapped - got).abs().max()) > 1e-3      # the cap bends the scores


def test_final_logit_softcap_matches_reference():
    ref, params, port, tparams = _load(GEMMA2)
    assert port.cfg.final_logit_softcap == 30.0
    x = (np.random.default_rng(4).standard_normal((2, 3, port.cfg.d_model)) * 40
         ).astype(np.float32)
    got = port.logits(tparams, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.logits(params, jnp.asarray(x))),
                               atol=LAYER_ATOL, rtol=0)
    assert float(got.abs().max()) < 30.0


def test_scale_embedding_rounds_the_factor_to_bf16_as_the_reference():
    """sqrt(64) is exact; at d_model 4608 sqrt = 67.88 rounds to 68.0 in
    bf16 first: the embeddings equal the reference's bit for bit."""
    for d in (64, 4608):
        rcfg = dataclasses.replace(ref_smoke_variant(ref_get_config(GEMMA2), d_model=d),
                                   dtype="bfloat16")
        tcfg = dataclasses.replace(smoke_variant(get_config(GEMMA2), d_model=d),
                                   dtype="bfloat16")
        ref, port = build_ref(rcfg), build_model(tcfg)
        table = np.random.default_rng(d).standard_normal((port.v_pad, d)).astype(np.float32)
        tokens = np.random.default_rng(d + 1).integers(0, tcfg.vocab_size, (2, 5))
        want, _, _ = ref._embed({"embed": jnp.asarray(table, jnp.bfloat16)}, _ref_batch(tokens))
        got = port.embed({"embed": torch.from_numpy(table).to(torch.bfloat16)},
                         torch.from_numpy(tokens))
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


# --------------------------------------------------------------------------
# the smoke models: forward, decode across a wrapped ring
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_logits_match_reference(arch):
    ref, params, port, tparams = _load(arch)
    tokens = np.random.default_rng(5).integers(0, port.cfg.vocab_size, (2, 20))
    x_r, aux_r, _ = ref.forward(params, _ref_batch(tokens))
    x_t, kvs, aux_t = port.forward(tparams, torch.from_numpy(tokens))
    assert len(kvs) == port.cfg.num_layers
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_r), **TOL)
    np.testing.assert_allclose(port.logits(tparams, x_t).numpy(),
                               np.asarray(ref.logits(params, x_r)), **TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_r), **TOL)


def _decode_against_reference(ref, params, port, tparams, prompt_len, seed, end=24):
    """Prefill a (2, prompt_len) prompt into caches of max_len 32 (rings of
    8 slots), then decode teacher-forced tokens through position end - 1:
    every step against the reference's decode and the port's forward over
    the same tokens (a MoE forward at capacity factor 8, as the reference's
    test does: a decode step of 2 tokens drops none, a 48-token forward at
    1.5 would)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, port.cfg.vocab_size, (2, end)).astype(np.int32)
    ref_step = jax.jit(ref.decode_step)
    lg_r, cache_r, pos_r = ref.prefill(params, _ref_batch(toks[:, :prompt_len]), 32)
    lg_t, cache_t, pos_t = port.prefill(tparams, torch.from_numpy(toks[:, :prompt_len]), 32)
    assert [c["k"].shape[1] for c in cache_t] == \
        [32 if k == "attn" else WINDOW for k in port.cfg.layer_kinds()]
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_r), **TOL)
    whole = port
    if port.cfg.moe:
        whole = build_model(dataclasses.replace(
            port.cfg, moe=dataclasses.replace(port.cfg.moe, capacity_factor=8.0)))
    x, _, _ = whole.forward(tparams, torch.from_numpy(toks))
    full = whole.logits(tparams, x).numpy()
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


@pytest.mark.parametrize("prompt_len", [4, 12], ids=["prompt-in-ring", "prompt-past-ring"])
@pytest.mark.parametrize("arch", ARCHS)
def test_ring_decode_matches_reference_and_forward(arch, prompt_len):
    _decode_against_reference(*_load(arch), prompt_len, seed=6 + prompt_len)


def test_gemma3_with_a_two_layer_tail_matches_reference():
    ref, params, port, tparams = _load(GEMMA3, layers=8)
    assert port.cfg.num_blocks == 1 and port.cfg.tail_pattern == ("attn_local",) * 2
    assert len(params["tail"]) == 2 and len(tparams["layers"]) == 8
    tokens = np.random.default_rng(9).integers(0, port.cfg.vocab_size, (2, 14))
    x_r, _, _ = ref.forward(params, _ref_batch(tokens))
    x_t, _, _ = port.forward(tparams, torch.from_numpy(tokens))
    np.testing.assert_allclose(port.logits(tparams, x_t).numpy(),
                               np.asarray(ref.logits(params, x_r)), **TOL)
    _decode_against_reference(ref, params, port, tparams, 11, seed=10, end=20)


def test_gemma2_with_4bit_ffn_matches_reference():
    ref, params, port, tparams = _load(GEMMA2, quant=True)
    for lp in tparams["layers"]:
        assert all(isinstance(lp["ffn"][w], QTensor) for w in ("wi", "wo"))
        assert not isinstance(lp["attn"]["wq"], QTensor)
    tokens = np.random.default_rng(11).integers(0, port.cfg.vocab_size, (2, 12))
    x_r, _, _ = ref.forward(params, _ref_batch(tokens))
    x_t, _, _ = port.forward(tparams, torch.from_numpy(tokens))
    np.testing.assert_allclose(port.logits(tparams, x_t).numpy(),
                               np.asarray(ref.logits(params, x_r)), **TOL)
    _decode_against_reference(ref, params, port, tparams, 10, seed=12, end=18)


# --------------------------------------------------------------------------
# the MoE layer with a shared expert (Llama-4-Scout)
# --------------------------------------------------------------------------
def test_moe_with_shared_expert_matches_reference():
    """One MoE layer of the Llama-4 smoke model: top-1 routing at capacity
    factor 1.5 beside the shared expert, with a token mask, and the dense
    oracle, at atol 1e-4."""
    ref, params, port, tparams = _load(LLAMA4)
    cfg = port.cfg
    assert (cfg.moe.top_k, cfg.moe.capacity_factor, cfg.moe.num_shared_experts) == (1, 1.5, 1)
    rp, tp = params["blocks"][0]["ffn"], tparams["layers"][0]["ffn"]
    rp = jax.tree_util.tree_map(lambda a: a[0], rp)
    assert set(tp) == {"router", "experts", "shared"}
    rng = np.random.default_rng(13)
    x = rng.standard_normal((3, 8, cfg.d_model)).astype(np.float32)
    mask = rng.random(24) < 0.7
    y_r, aux_r, _ = rmoe.moe_forward(rp, jnp.asarray(x), ref.cfg, token_mask=jnp.asarray(mask))
    y_t, aux_t = tmoe.moe_forward(tp, torch.from_numpy(x), cfg, token_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_r), atol=LAYER_ATOL, rtol=0)
    np.testing.assert_allclose(float(aux_t), float(aux_r), atol=1e-6, rtol=0)
    d_r, r_r = rmoe.moe_forward_dense_eval(rp, jnp.asarray(x), ref.cfg)
    d_t, r_t = tmoe.moe_forward_dense_eval(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_r), atol=LAYER_ATOL, rtol=0)
    np.testing.assert_array_equal(r_t.top_idx.numpy(), np.asarray(r_r.top_idx))
    # the shared expert alone: what the routed experts add on a dead token is 0
    dead = ~mask.reshape(3, 8)
    shared = tlayers.ffn_forward(tp["shared"], torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y_t.numpy()[dead], shared.numpy()[dead], atol=1e-6, rtol=0)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------
def _serve(server_cls, request_cls, backend, vocab):
    trace = generate_workload(WorkloadConfig(
        classes=(RequestClass("chat", prompt_tokens=(5, 13), new_tokens=(4, 9)),),
        num_requests=5, vocab=vocab, seed=7))
    srv = server_cls(backend, max_batch=2, max_len=32, admit_k=1)
    for w in trace:
        srv.submit(request_cls(rid=w.rid, prompt=w.prompt, max_new_tokens=w.max_new_tokens))
    try:
        srv.run()
        return {r.rid: np.asarray(r.output) for r in srv.completed}
    finally:
        srv.close()


@pytest.mark.parametrize("arch", ARCHS)
def test_batching_server_tokens_match_reference(arch):
    ref, params, port, tparams = _load(arch)
    out_r = _serve(RefServer, RefRequest, RefDense(ref, params, jit=True),
                   port.cfg.vocab_size)
    out_t = _serve(BatchingServer, Request, DenseBackend(port, tparams),
                   port.cfg.vocab_size)
    assert sorted(out_t) == sorted(out_r) == list(range(5))
    for rid in out_r:
        np.testing.assert_array_equal(out_t[rid], out_r[rid])


@pytest.mark.parametrize("arch", [GEMMA2, LLAMA4])
def test_pause_and_resume_a_wrapped_ring(arch):
    """Two slots decode past the 8-slot ring (positions 6 -> 12); slot 0 is
    paused for 2 steps while slot 1 goes on, then resumed.  Every live row
    against the reference backend doing the same, and slot 0 after resume
    against a run that never paused it and fed it the same tokens."""
    ref, params, port, tparams = _load(arch)
    rng = np.random.default_rng(14)
    prompts = rng.integers(0, port.cfg.vocab_size, (2, 6))
    feed = rng.integers(0, port.cfg.vocab_size, (11, 2))

    def run(be, feed, pause=False):
        be.start_batch(2, 32)
        out, snap = [np.asarray(be.prefill(prompts))], None
        for t in range(len(feed)):
            if pause and t == 6:
                snap = be.pause(0)
            if pause and t == 8:
                be.resume(0, snap)
            out.append(np.asarray(be.step(feed[t])))
        return np.stack(out), snap

    got, snap = run(DenseBackend(port, tparams), feed, pause=True)
    want, _ = run(RefDense(ref, params, jit=True), feed, pause=True)
    assert snap["position"] == 12
    assert [r["k"].shape[0] for r in snap["cache"]] == \
        [32 if k == "attn" else WINDOW for k in port.cfg.layer_kinds()]
    live = np.ones(got.shape[:2], bool)
    live[7:9, 0] = False                # slot 0's two paused steps
    np.testing.assert_allclose(got[live], want[live], **TOL)
    # slot 0 saw feed[0:6] and then feed[8:11]: the same without a pause
    unpaused = np.concatenate([feed[:6], feed[8:]])
    unpaused[:, 1] = feed[:9, 1]
    plain, _ = run(DenseBackend(port, tparams), unpaused)
    np.testing.assert_allclose(got[9:, 0], plain[7:, 0], **TOL)


@pytest.mark.parametrize("jit", [True, False], ids=["jit", "eager"])
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference(arch, jit):
    """A 10-token prompt (past the ring) and 9 new tokens: greedy tokens of
    decode.generate, captured and eager, equal to the reference's."""
    ref, params, port, tparams = _load(arch)
    prompts = np.random.default_rng(15).integers(0, port.cfg.vocab_size, (2, 10))
    want = ref_decode.generate(ref, params, jnp.asarray(prompts, jnp.int32), 9, jit=True,
                               max_len=20)
    got = decode.generate(port, tparams, prompts, 9, jit=jit, max_len=20)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))


# --------------------------------------------------------------------------
# weights, refusals, the launcher
# --------------------------------------------------------------------------
def test_from_jax_params_keeps_new_norm_scales_f32():
    """A bf16 Gemma-3 tree (sandwich norms, qk-norm) and a bf16 Llama-4 tree
    (a shared expert): every norm gain and the router float32, the matrices
    bf16."""
    for arch in (GEMMA3, LLAMA4):
        rcfg = _smoke(ref_get_config, ref_smoke_variant, arch, dtype="bfloat16")
        tcfg = _smoke(get_config, smoke_variant, arch, dtype="bfloat16")
        params = build_ref(rcfg).init(jax.random.PRNGKey(16))
        tp = from_jax_params(tcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
        for lp in tp["layers"]:
            norms = [lp["pre_norm"], lp["ffn_norm"]]
            if tcfg.sandwich_norm:
                norms += [lp["post_norm"], lp["post_ffn_norm"]]
            assert all(n["scale"].dtype == torch.float32 for n in norms)
            if tcfg.qk_norm:
                assert lp["attn"]["q_norm"].dtype == lp["attn"]["k_norm"].dtype == torch.float32
            assert lp["attn"]["wq"].dtype == torch.bfloat16
            if tcfg.moe:
                assert lp["ffn"]["router"].dtype == torch.float32
                assert lp["ffn"]["shared"]["wi"].dtype == torch.bfloat16
        init = build_model(tcfg).init(0, device="cpu")["layers"][0]
        assert set(init) == set(tp["layers"][0])


def test_offload_engine_refuses_llama4_scout():
    _, _, port, tparams = _load(LLAMA4)
    with pytest.raises(ValueError, match="full-window 'attn' layers only.*attn_chunked.*"
                                         "shared expert"):
        OffloadEngine(port, tparams, EngineConfig(async_prefetch=False))
    with pytest.raises(ValueError, match="full-window 'attn' layers only"):
        make_backend(BackendConfig(kind="hobbit"), port, tparams)
    with pytest.raises(ValueError, match="paged KV layout"):
        DenseBackend(port, tparams, paged=True)


def _serve_cli(arch, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch, "--smoke",
         "--device", "cpu", *args], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=300)


def test_serve_launcher_on_cpu():
    res = _serve_cli(GEMMA2, "--backend", "dense", "--serve-requests", "3",
                     "--max-batch", "2", "--prompt-len", "6", "--new-tokens", "4")
    assert res.returncode == 0, res.stderr[-2000:]
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report["backend"] == "dense" and not report["paged_kv"]
    assert report["serving"]["requests"] == 3
    assert not any(k.endswith(".cuda") for k in report["kernel_dispatch"])


@pytest.mark.parametrize("case", ["paged-kv", "hobbit"])
def test_serve_launcher_refusals(case):
    if case == "paged-kv":
        res = _serve_cli(GEMMA2, "--backend", "dense", "--paged-kv")
        msg = "does not support the paged KV layout"
    else:
        res = _serve_cli(LLAMA4, "--backend", "hobbit")
        msg = "--backend hobbit: OffloadEngine serves MoE models of full-window 'attn'"
    assert res.returncode != 0
    assert msg in res.stderr, res.stderr[-2000:]
