"""DeepSeek-V2-236B in the port: multi-head latent attention (MLA) over a
latent cache and a dense first layer before MoE layers with two shared
experts, against the JAX reference.

* The config equals the reference's field by field and ``check_supported``
  takes it.
* ``mla_init`` shapes and dtypes; ``_mla_compress_kv``, ``mla_forward`` and
  the absorbed ``mla_decode`` on the reference's weights at rtol/atol 2e-4;
  ``mla_forward`` in query chunks of 5 (a ragged tail) against one chunk at
  1e-4, as the reference's tests/test_layers.py holds its own.
* The smoke variant (d_model 64, float32, capacity factor 8; weights from
  the reference's init through ``from_jax_params``): forward, logits, the
  prefill and every decode step against the reference at 2e-4 and against
  the port's teacher-forced forward at 3e-4; the same with the dense and
  the shared FFN quantized to 4 bits by the reference's ``quantize_tree``.
* ``DenseBackend(jit=True)`` equal to ``jit=False``; pause and resume of a
  latent row; ``BatchingServer`` and ``decode.generate`` greedy tokens
  equal to the reference's; the launcher's ``--smoke`` tokens equal to the
  reference launcher's on one checkpoint.
* ``from_jax_params`` on a bf16 tree keeps ``kv_norm`` float32; the paged
  KV layout, ``HobbitBackend`` and ``OffloadEngine`` (on an all-MoE MLA
  config too) refuse MLA by name.

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
from repro.models.model import Batch as RefBatch
from repro.serving import decode as ref_decode
from repro.serving.api import DenseBackend as RefDense
from repro.serving.batching import BatchingServer as RefServer
from repro.serving.batching import Request as RefRequest
from repro.training import checkpoint as ref_ckpt
from repro_torch.configs import ASSIGNED_ARCHS, get_config, smoke_variant
from repro_torch.configs.base import MLAConfig
from repro_torch.core import EngineConfig, OffloadEngine
from repro_torch.models import build_model
from repro_torch.models import layers as tlayers
from repro_torch.models.model import check_supported
from repro_torch.quant.quantize import QTensor
from repro_torch.serving import decode
from repro_torch.serving.api import BackendConfig, DenseBackend, make_backend
from repro_torch.serving.batching import BatchingServer, Request
from repro_torch.serving.workload import RequestClass, WorkloadConfig, generate_workload
from repro_torch.weights import from_jax_params

jq = importlib.import_module("repro.quant.quantize")
torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "deepseek-v2-236b"
TOL = dict(rtol=2e-4, atol=2e-4)        # tests/test_arch_smoke.py: against the reference
STEP_TOL = dict(rtol=3e-4, atol=3e-4)   # ... and decode against teacher-forced forward
CHUNK_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_layers.py: chunked against whole
GROUP = 32
MAX_LEN = 32


def _dense_and_shared_ffn(path, leaf):
    """The 2-D FFN leaves (the dense layer's and the shared experts'), not
    the routed experts or the router: the predicate of chip_smoke.py's q4
    serve."""
    del leaf
    p = str(path)
    return "ffn" in p and "experts" not in p and "router" not in p


def _smoke(get, smoke, *, dtype="float32"):
    """The smoke variant at d_model 64 (a dense first layer, then 2 MoE
    layers of 4 experts at top-2 beside the shared FFN) at capacity factor
    8, so no token is dropped in a forward of the test's lengths."""
    cfg = smoke(get(ARCH), d_model=64)
    return dataclasses.replace(cfg, dtype=dtype, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0)).validate()


_MODELS = {}


def _load(quant=False):
    """(reference model, its params, port model, the same params in the port)."""
    if quant not in _MODELS:
        ref = build_ref(_smoke(ref_get_config, ref_smoke_variant))
        port = build_model(_smoke(get_config, smoke_variant))
        params = ref.init(jax.random.PRNGKey(3))
        if quant:
            params = jq.quantize_tree(params, bits=4, group_size=GROUP,
                                      predicate=_dense_and_shared_ffn)
        tparams = from_jax_params(port.cfg, jax.tree_util.tree_map(np.asarray, params),
                                  device="cpu")
        _MODELS[quant] = (ref, params, port, tparams)
    return _MODELS[quant]


def _ref_batch(tokens):
    b, s = tokens.shape
    return RefBatch(tokens=jnp.asarray(tokens, jnp.int32), loss_mask=jnp.ones((b, s)))


def _layer0_attn():
    """The first (dense) layer's MLA weights on both sides, with a seeded
    kv_norm gain in place of the init's zeros."""
    ref, params, port, tparams = _load()
    rp = dict(params["prefix"][0]["attn"])
    gain = np.random.default_rng(19).standard_normal(rp["kv_norm"].shape).astype(np.float32)
    rp["kv_norm"] = jnp.asarray(gain * 0.5)
    tp = dict(tparams["layers"][0]["attn"], kv_norm=torch.from_numpy(gain * 0.5))
    return ref.cfg, rp, port.cfg, tp


def _x(seed, b=2, s=12, d=64):
    return (np.random.default_rng(seed).standard_normal((b, s, d)) * 0.5).astype(np.float32)


# --------------------------------------------------------------------------
# the config and the MLA layer
# --------------------------------------------------------------------------
def test_config_matches_reference_and_is_supported():
    assert ARCH in ASSIGNED_ARCHS
    got, want = get_config(ARCH), ref_get_config(ARCH)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    check_supported(got)
    assert got.layer_is_moe() == (False,) + (True,) * 59
    assert (got.mla.kv_lora_rank, got.mla.rope_head_dim, got.mla.q_lora_rank) == (512, 64, 0)
    smoke = _smoke(get_config, smoke_variant)
    assert smoke.layer_is_moe() == (False, True, True)
    assert smoke.moe.num_shared_experts == 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_init_shapes_and_dtypes(dtype):
    cfg = _smoke(get_config, smoke_variant, dtype=dtype)
    rcfg = _smoke(ref_get_config, ref_smoke_variant, dtype=dtype)
    got = tlayers.mla_init(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    want = rlayers.mla_init(jax.random.PRNGKey(0), rcfg)
    assert set(got) == set(want) == {"wq", "w_dkv", "w_uk", "w_uv", "wo", "kv_norm"}
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(w.dtype), k
    assert got["kv_norm"].dtype == torch.float32 and not got["kv_norm"].any()
    m, h = cfg.mla, cfg.num_heads
    assert tuple(got["wq"].shape) == (64, h * (m.nope_head_dim + m.rope_head_dim))


def test_mla_compress_kv_matches_reference():
    rcfg, rp, cfg, tp = _layer0_attn()
    x = _x(20)
    pos = np.broadcast_to(np.arange(12), (2, 12)).copy() + 3
    c_r, k_r = rlayers._mla_compress_kv(rp, jnp.asarray(x), jnp.asarray(pos), rcfg)
    c_t, k_t = tlayers._mla_compress_kv(tp, torch.from_numpy(x), torch.from_numpy(pos), cfg)
    assert tuple(c_t.shape) == (2, 12, cfg.mla.kv_lora_rank)
    assert tuple(k_t.shape) == (2, 12, 1, cfg.mla.rope_head_dim)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_r), **TOL)
    np.testing.assert_allclose(k_t.numpy(), np.asarray(k_r), **TOL)


def test_mla_forward_matches_reference():
    rcfg, rp, cfg, tp = _layer0_attn()
    x = _x(21)
    pos = np.broadcast_to(np.arange(12), (2, 12)).copy()
    out_r, (c_r, k_r) = rlayers.mla_forward(rp, jnp.asarray(x), jnp.asarray(pos), rcfg)
    out_t, (c_t, k_t) = tlayers.mla_forward(tp, torch.from_numpy(x), torch.from_numpy(pos),
                                            cfg)
    assert tuple(k_t.shape) == (2, 12, cfg.mla.rope_head_dim)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_r), **TOL)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_r), **TOL)
    np.testing.assert_allclose(k_t.numpy(), np.asarray(k_r), **TOL)


def test_mla_forward_chunked_matches_unchunked():
    """12 queries in chunks of 5 (two chunks and a ragged tail of 2) against
    one chunk, and against the reference's chunked forward."""
    rcfg, rp, cfg, tp = _layer0_attn()
    x = _x(22)
    pos = np.broadcast_to(np.arange(12), (2, 12)).copy()
    tx, tpos = torch.from_numpy(x), torch.from_numpy(pos)
    whole, kv_w = tlayers.mla_forward(tp, tx, tpos, cfg, q_chunk=64)
    chunked, kv_c = tlayers.mla_forward(tp, tx, tpos, cfg, q_chunk=5)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), **CHUNK_TOL)
    for a, b in zip(kv_c, kv_w):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    want, _ = rlayers.mla_forward(rp, jnp.asarray(x), jnp.asarray(pos), rcfg, q_chunk=5)
    np.testing.assert_allclose(chunked.numpy(), np.asarray(want), **TOL)


def test_mla_decode_matches_reference():
    """A 7-token prefill into a 16-row latent cache, then 3 absorbed decode
    steps: each step's output and the cache it writes in place against the
    reference's."""
    rcfg, rp, cfg, tp = _layer0_attn()
    x = _x(23, s=10)
    pos = np.broadcast_to(np.arange(7), (2, 7)).copy()
    _, (c_kv, k_rope) = tlayers.mla_forward(tp, torch.from_numpy(x[:, :7]),
                                            torch.from_numpy(pos), cfg)
    cache_t = {"c_kv": torch.zeros((2, 16, cfg.mla.kv_lora_rank)),
               "k_rope": torch.zeros((2, 16, cfg.mla.rope_head_dim))}
    cache_t["c_kv"][:, :7] = c_kv
    cache_t["k_rope"][:, :7] = k_rope
    cache_r = {k: jnp.asarray(v.numpy()) for k, v in cache_t.items()}
    positions = np.array([7, 7])
    for i in range(7, 10):
        xi = x[:, i:i + 1]
        out_r, cache_r = rlayers.mla_decode(rp, jnp.asarray(xi), cache_r,
                                            jnp.asarray(positions), rcfg)
        out_t = tlayers.mla_decode(tp, torch.from_numpy(xi), cache_t,
                                   torch.from_numpy(positions), cfg)
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_r), **TOL,
                                   err_msg=f"position {i}")
        for k in cache_t:
            np.testing.assert_allclose(cache_t[k].numpy(), np.asarray(cache_r[k]), **TOL)
        positions = positions + 1
    assert not cache_t["c_kv"][:, 10:].any()


# --------------------------------------------------------------------------
# the smoke model: forward, prefill and decode
# --------------------------------------------------------------------------
def test_forward_and_logits_match_reference():
    ref, params, port, tparams = _load()
    assert [("router" in lp["ffn"], "shared" in lp["ffn"]) for lp in tparams["layers"]] == \
        [(False, False), (True, True), (True, True)]
    tokens = np.random.default_rng(5).integers(0, port.cfg.vocab_size, (2, 20))
    x_r, aux_r, _ = ref.forward(params, _ref_batch(tokens))
    x_t, kvs, aux_t = port.forward(tparams, torch.from_numpy(tokens))
    assert [tuple(c.shape) for c in kvs[0]] == [(2, 20, 64), (2, 20, 32)]
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_r), **TOL)
    np.testing.assert_allclose(port.logits(tparams, x_t).numpy(),
                               np.asarray(ref.logits(params, x_r)), **TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_r), **TOL)


def _decode_against_reference(ref, params, port, tparams, prompt_len, seed, end=24):
    """Prefill a (2, prompt_len) prompt into latent caches of max_len 32,
    then decode teacher-forced tokens through position end - 1: every step
    against the reference's decode and the port's forward over the same
    tokens."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, port.cfg.vocab_size, (2, end)).astype(np.int32)
    ref_step = jax.jit(ref.decode_step)
    lg_r, cache_r, pos_r = ref.prefill(params, _ref_batch(toks[:, :prompt_len]), MAX_LEN)
    lg_t, cache_t, pos_t = port.prefill(tparams, torch.from_numpy(toks[:, :prompt_len]),
                                        MAX_LEN)
    m = port.cfg.mla
    assert [{k: tuple(v.shape) for k, v in c.items()} for c in cache_t] == \
        [{"c_kv": (2, MAX_LEN, m.kv_lora_rank), "k_rope": (2, MAX_LEN, m.rope_head_dim)}] * 3
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


def test_prefill_and_decode_match_reference_and_forward():
    _decode_against_reference(*_load(), 6, seed=6)


def test_4bit_dense_and_shared_ffn_match_reference():
    """The dense layer's and the shared experts' FFN weights quantized to 4
    bits (group 32) by the reference's quantize_tree; the routed experts,
    the router and the attention stay float32."""
    ref, params, port, tparams = _load(quant=True)
    dense, moes = tparams["layers"][0], tparams["layers"][1:]
    assert all(isinstance(dense["ffn"][w], QTensor) for w in ("wi", "wo"))
    for lp in moes:
        assert all(isinstance(lp["ffn"]["shared"][w], QTensor) for w in ("wi", "wo"))
        assert not isinstance(lp["ffn"]["experts"]["wi"], QTensor)
        assert not isinstance(lp["ffn"]["router"], QTensor)
    assert not any(isinstance(v, QTensor) for lp in tparams["layers"]
                   for v in lp["attn"].values())
    tokens = np.random.default_rng(11).integers(0, port.cfg.vocab_size, (2, 12))
    x_r, _, _ = ref.forward(params, _ref_batch(tokens))
    x_t, _, _ = port.forward(tparams, torch.from_numpy(tokens))
    np.testing.assert_allclose(port.logits(tparams, x_t).numpy(),
                               np.asarray(ref.logits(params, x_r)), **TOL)
    _decode_against_reference(ref, params, port, tparams, 10, seed=12, end=18)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------
def _serve(server_cls, request_cls, backend, vocab):
    trace = generate_workload(WorkloadConfig(
        classes=(RequestClass("chat", prompt_tokens=(5, 13), new_tokens=(4, 9)),),
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


def _backend_run(be, prompts, feed, pause=False):
    """prefill, then a step per row of `feed`; with `pause`, slot 0 is
    paused before step 4 and resumed before step 6.  Returns (logits per
    call, the snapshot)."""
    be.start_batch(2, MAX_LEN)
    out, snap = [np.asarray(be.prefill(prompts))], None
    for t in range(len(feed)):
        if pause and t == 4:
            snap = be.pause(0)
        if pause and t == 6:
            be.resume(0, snap)
        out.append(np.asarray(be.step(feed[t])))
    return np.stack(out), snap


def test_dense_backend_jit_equals_eager():
    _, _, port, tparams = _load()
    rng = np.random.default_rng(13)
    prompts = rng.integers(0, port.cfg.vocab_size, (2, 7))
    feed = rng.integers(0, port.cfg.vocab_size, (8, 2))
    got, _ = _backend_run(DenseBackend(port, tparams, jit=True), prompts, feed)
    want, _ = _backend_run(DenseBackend(port, tparams, jit=False), prompts, feed)
    np.testing.assert_array_equal(got, want)


def test_pause_and_resume_a_latent_row():
    """Slot 0 paused for 2 steps while slot 1 goes on, then resumed: every
    live row against the reference backend doing the same, and slot 0 after
    resume against a run that never paused it and fed it the same tokens."""
    ref, params, port, tparams = _load()
    rng = np.random.default_rng(14)
    prompts = rng.integers(0, port.cfg.vocab_size, (2, 6))
    feed = rng.integers(0, port.cfg.vocab_size, (9, 2))
    got, snap = _backend_run(DenseBackend(port, tparams), prompts, feed, pause=True)
    want, _ = _backend_run(RefDense(ref, params, jit=True), prompts, feed, pause=True)
    assert snap["position"] == 10
    m = port.cfg.mla
    assert [{k: tuple(v.shape) for k, v in row.items()} for row in snap["cache"]] == \
        [{"c_kv": (MAX_LEN, m.kv_lora_rank), "k_rope": (MAX_LEN, m.rope_head_dim)}] * 3
    live = np.ones(got.shape[:2], bool)
    live[5:7, 0] = False                # slot 0's two paused steps
    np.testing.assert_allclose(got[live], want[live], **TOL)
    unpaused = np.concatenate([feed[:4], feed[6:]])
    unpaused[:, 1] = feed[:7, 1]
    plain, _ = _backend_run(DenseBackend(port, tparams), prompts, unpaused)
    np.testing.assert_allclose(got[7:, 0], plain[5:, 0], **TOL)


@pytest.mark.parametrize("jit", [True, False], ids=["jit", "eager"])
def test_generate_matches_reference(jit):
    ref, params, port, tparams = _load()
    prompts = np.random.default_rng(15).integers(0, port.cfg.vocab_size, (2, 10))
    want = ref_decode.generate(ref, params, jnp.asarray(prompts, jnp.int32), 9, jit=True,
                               max_len=20)
    got = decode.generate(port, tparams, prompts, 9, jit=jit, max_len=20)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))


# --------------------------------------------------------------------------
# weights, refusals, the launcher
# --------------------------------------------------------------------------
def test_from_jax_params_keeps_kv_norm_f32():
    """A bf16 reference tree: each layer's kv_norm (and the norms and the
    router) float32, the MLA matrices and the shared experts bf16."""
    rcfg = _smoke(ref_get_config, ref_smoke_variant, dtype="bfloat16")
    tcfg = _smoke(get_config, smoke_variant, dtype="bfloat16")
    params = build_ref(rcfg).init(jax.random.PRNGKey(16))
    tp = from_jax_params(tcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    for lp in tp["layers"]:
        assert lp["attn"]["kv_norm"].dtype == torch.float32
        assert lp["pre_norm"]["scale"].dtype == lp["ffn_norm"]["scale"].dtype == torch.float32
        assert all(lp["attn"][w].dtype == torch.bfloat16
                   for w in ("wq", "w_dkv", "w_uk", "w_uv", "wo"))
        if "router" in lp["ffn"]:
            assert lp["ffn"]["router"].dtype == torch.float32
            assert lp["ffn"]["shared"]["wi"].dtype == torch.bfloat16
    init = build_model(tcfg).init(0, device="cpu")["layers"]
    assert [set(lp) for lp in init] == [set(lp) for lp in tp["layers"]]
    assert set(init[0]["attn"]) == set(tp["layers"][0]["attn"])


def test_refusals_name_mla():
    _, _, port, tparams = _load()
    with pytest.raises(ValueError, match="paged KV layout.*MLA"):
        DenseBackend(port, tparams, paged=True)
    with pytest.raises(ValueError, match="no MLA"):
        port.init_cache(2, 16, "cpu", paged=True)
    with pytest.raises(ValueError, match="MLA attention, dense FFN layers, 2 shared "
                                         "expert"):
        make_backend(BackendConfig(kind="hobbit"), port, tparams)
    # an MLA model the engine's other checks would take: MoE in every layer,
    # no shared experts
    cfg = smoke_variant(get_config("mixtral-8x7b"), d_model=64)
    mla = build_model(dataclasses.replace(
        cfg, name="mla-all-moe", mla=MLAConfig(kv_lora_rank=32, rope_head_dim=8,
                                               nope_head_dim=16, v_head_dim=16)))
    assert all(mla.cfg.layer_is_moe()) and not mla.cfg.moe.num_shared_experts
    with pytest.raises(ValueError, match="mla-all-moe has MLA attention \\(serve"):
        OffloadEngine(mla, mla.init(0, device="cpu"), EngineConfig(async_prefetch=False))


def _launcher(package, ckpt, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    extra = ["--device", "cpu"] if package == "repro_torch" else []
    return subprocess.run(
        [sys.executable, "-m", f"{package}.launch.serve", "--arch", ARCH, "--smoke",
         "--ckpt-dir", ckpt, "--backend", "dense", *extra, *args],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)


def test_serve_launcher_smoke_matches_reference_launcher(tmp_path):
    """Both launchers' --smoke on one checkpoint of the reference's smoke
    init: the same generated tokens; --paged-kv and --backend hobbit exit
    with the refusal."""
    cfg = dataclasses.replace(ref_smoke_variant(ref_get_config(ARCH)), dtype="float32")
    ref_ckpt.save(str(tmp_path), build_ref(cfg).init(jax.random.PRNGKey(0)), step=0)
    args = ("--prompt-len", "8", "--new-tokens", "6")
    runs = {pkg: _launcher(pkg, str(tmp_path), *args) for pkg in ("repro", "repro_torch")}
    for pkg, res in runs.items():
        assert res.returncode == 0, (pkg, res.stderr[-2000:])
    want, got = (json.loads(runs[p].stdout.strip().splitlines()[-1])
                 for p in ("repro", "repro_torch"))
    assert got["tokens"] == want["tokens"] and len(got["tokens"]) == 8
    assert not any(k.endswith(".cuda") for k in got["kernel_dispatch"])
    for flag, msg in (("--paged-kv", "does not support the paged KV layout"),
                      ("--backend=hobbit", "--backend hobbit: OffloadEngine serves MoE "
                                           "models of full-window 'attn' layers only")):
        res = _launcher("repro_torch", str(tmp_path), flag)
        assert res.returncode != 0 and msg in res.stderr, res.stderr[-2000:]
        assert "MLA" in res.stderr
