"""The 48/8-head dense family of the port (Nemotron-4-15B, InternVL2-26B)
against the JAX reference.

* Both configs equal the reference's field by field and resolve through
  ``get_config``.
* Layernorm (``apply_norm``, with a random nonzero scale and bias) on
  float32 and bfloat16 inputs, at atol 1e-5.
* The Nemotron smoke variant (2 layers, d_model 64, float32: layernorm,
  squared-ReLU FFN, an untied LM head), with its FFN weights as they are
  and quantized by ``quantize_tree`` (4 bits, group 32), through
  ``from_jax_params``: forward, prefill and decode on dense and on paged
  KV at atol 1e-4 (tests/test_torch_model.py's tolerance: float32 sums in
  another order); the logits read ``lm_head``, not ``embed.T``.
* A g = 6 variant of both smoke configs (12 query heads on 2 kv heads; the
  smoke variants have g = 1): forward and chunked prefill + paged decode.
* The InternVL2 smoke variant with its 8 prefix embeddings (256 in the
  published config): forward, prefill + decode, and ``decode.generate``
  with ``extra={"prefix_embeds": ...}`` against the reference's
  ``generate``, greedy tokens equal.
* ``BatchingServer`` over ``DenseBackend`` on Nemotron smoke,
  token-identical to the reference server on both KV layouts, and the
  launcher's ``--arch nemotron-4-15b`` / ``internvl2-26b`` on the CPU.

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
from repro.models import kv_pages as rkv
from repro.models import layers as rlayers
from repro.models.model import Batch as RefBatch
from repro.serving import decode as ref_decode
from repro.serving.api import DenseBackend as RefDense
from repro.serving.batching import BatchingServer as RefServer
from repro.serving.batching import Request as RefRequest
from repro_torch.configs import ASSIGNED_ARCHS, get_config, smoke_variant
from repro_torch.models import build_model
from repro_torch.models import kv_pages as tkv
from repro_torch.models import layers as tlayers
from repro_torch.models.model import Batch
from repro_torch.quant.quantize import QTensor
from repro_torch.serving import decode
from repro_torch.serving.api import DenseBackend
from repro_torch.serving.batching import BatchingServer, Request
from repro_torch.serving.workload import RequestClass, WorkloadConfig, generate_workload
from repro_torch.weights import from_jax_params

jq = importlib.import_module("repro.quant.quantize")
torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEMOTRON, INTERNVL = "nemotron-4-15b", "internvl2-26b"
ATOL = 1e-4
GROUP = 32


def _ffn_path(path, leaf):
    del leaf
    return "ffn" in str(path)


def _smoke(get, smoke, arch, g6=False):
    """The float32 smoke variant (2 layers, d_model 64); g6: 12 query heads
    on 2 kv heads of 16 dims (g = 6, as the published 48/8)."""
    cfg = dataclasses.replace(smoke(get(arch), layers=2, d_model=64), dtype="float32")
    if g6:
        cfg = dataclasses.replace(cfg, num_heads=12, num_kv_heads=2, head_dim=16)
    return cfg.validate()


_MODELS = {}


def _load(arch, g6=False, quant=False):
    """(reference model, its params, port model, the same params in the port)."""
    key = (arch, g6, quant)
    if key not in _MODELS:
        ref = build_ref(_smoke(ref_get_config, ref_smoke_variant, arch, g6))
        port = build_model(_smoke(get_config, smoke_variant, arch, g6))
        params = ref.init(jax.random.PRNGKey(1 if g6 else 0))
        if quant:
            params = jq.quantize_tree(params, bits=4, group_size=GROUP, predicate=_ffn_path)
        tparams = from_jax_params(port.cfg, jax.tree_util.tree_map(np.asarray, params),
                                  device="cpu")
        _MODELS[key] = (ref, params, port, tparams)
    return _MODELS[key]


def _ref_batch(tokens, prefix=None):
    b, s = tokens.shape
    return RefBatch(tokens=jnp.asarray(tokens, jnp.int32), loss_mask=jnp.ones((b, s)),
                    prefix_embeds=None if prefix is None else jnp.asarray(prefix))


def _batch(tokens, prefix=None):
    b, s = tokens.shape
    return Batch(tokens=torch.from_numpy(tokens), loss_mask=torch.ones((b, s)),
                 prefix_embeds=None if prefix is None else torch.from_numpy(prefix))


def _prefix(cfg, b, seed):
    """Seeded patch embeddings (B, P, D), P = the config's prefix tokens."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, cfg.num_prefix_tokens, cfg.d_model)) * 0.5
            ).astype(np.float32)


# --------------------------------------------------------------------------
# configs and layernorm
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", [NEMOTRON, INTERNVL])
def test_configs_match_reference(arch):
    assert arch in ASSIGNED_ARCHS
    got, want = get_config(arch), ref_get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.num_heads, got.num_kv_heads, got.resolved_head_dim) == (48, 8, 128)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    cfg = _smoke(get_config, smoke_variant, NEMOTRON)
    rcfg = _smoke(ref_get_config, ref_smoke_variant, NEMOTRON)
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 5, cfg.d_model)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(cfg.d_model).astype(np.float32) * 0.5,
         "bias": rng.standard_normal(cfg.d_model).astype(np.float32) * 0.5}
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else \
        (jnp.float32, torch.float32)
    want = rlayers.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x).astype(jdt), rcfg)
    got = tlayers.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x).to(tdt), cfg)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=1e-5, rtol=0)
    init = tlayers.norm_init(cfg, torch.device("cpu"))
    assert set(init) == {"scale", "bias"}
    assert all(v.dtype == torch.float32 and not v.any() for v in init.values())


def test_from_jax_params_keeps_norm_biases_f32_and_the_untied_head():
    """A bf16 Nemotron smoke tree: layernorm scales and biases stay float32,
    matrices and the untied lm_head take bf16."""
    cfg = dataclasses.replace(_smoke(ref_get_config, ref_smoke_variant, NEMOTRON),
                              dtype="bfloat16")
    params = build_ref(cfg).init(jax.random.PRNGKey(3))
    tcfg = dataclasses.replace(_smoke(get_config, smoke_variant, NEMOTRON), dtype="bfloat16")
    tp = from_jax_params(tcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    assert tp["lm_head"].dtype == torch.bfloat16
    assert tp["lm_head"].shape == (cfg.d_model, build_model(tcfg).v_pad)
    np.testing.assert_array_equal(tp["lm_head"].float().numpy(),
                                  np.asarray(params["lm_head"].astype(jnp.float32)))
    for norm in [tp["final_norm"]] + [lp[k] for lp in tp["layers"]
                                      for k in ("pre_norm", "ffn_norm")]:
        assert set(norm) == {"scale", "bias"}
        assert all(v.dtype == torch.float32 for v in norm.values())
    assert tp["layers"][0]["attn"]["wq"].dtype == torch.bfloat16


# --------------------------------------------------------------------------
# the Nemotron smoke model, with plain and 4-bit FFN weights
# --------------------------------------------------------------------------
@pytest.fixture(scope="module", params=["unquantized", "q4-ffn"])
def nemotron(request):
    quant = request.param == "q4-ffn"
    ref, params, port, tparams = _load(NEMOTRON, quant=quant)
    assert not port.cfg.tie_embeddings and "lm_head" in tparams
    for lp in tparams["layers"]:
        assert set(lp["pre_norm"]) == {"scale", "bias"}
        for key in ("wi", "wo"):
            assert isinstance(lp["ffn"][key], QTensor) == quant
    return ref, params, port, tparams


def test_nemotron_forward_matches_reference(nemotron):
    ref, params, port, tparams = nemotron
    tokens = np.random.default_rng(1).integers(0, port.cfg.vocab_size, (2, 12))
    x_r, _, _ = ref.forward(params, _ref_batch(tokens))
    x_t, _, _ = port.forward(tparams, _batch(tokens))
    np.testing.assert_allclose(port.logits(tparams, x_t).numpy(),
                               np.asarray(ref.logits(params, x_r)), atol=ATOL)


def _prefill_decode(ref, params, port, tparams, prefix=None, seed=2):
    """Prefill a (2, 10) prompt (behind `prefix`) into a dense cache, then 4
    teacher-forced decode steps; logits and positions against the
    reference's at every step."""
    rng = np.random.default_rng(seed)
    b, s, steps = 2, 10, 4
    max_len = s + steps + 6 + (0 if prefix is None else prefix.shape[1])
    prompts = rng.integers(0, port.cfg.vocab_size, (b, s)).astype(np.int32)
    teacher = rng.integers(0, port.cfg.vocab_size, (steps, b)).astype(np.int32)
    lg_r, cache_r, pos_r = ref.prefill(params, _ref_batch(prompts, prefix), max_len)
    lg_t, cache_t, pos_t = port.prefill(tparams, _batch(prompts, prefix), max_len)
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_r), atol=ATOL)
    np.testing.assert_array_equal(pos_t, np.asarray(pos_r))
    positions = torch.from_numpy(pos_t)
    for t in range(steps):
        lg_r, cache_r = ref.decode_step(params, cache_r, jnp.asarray(teacher[t][:, None]),
                                        pos_r)
        pos_r = pos_r + 1
        lg_t = port.decode_step(tparams, cache_t, torch.from_numpy(teacher[t][:, None]),
                                positions)
        positions = positions + 1
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_r), atol=ATOL)


def test_nemotron_prefill_and_decode_match_reference(nemotron):
    _prefill_decode(*nemotron)


def _paged(ref, params, port, tparams, seed=3):
    """Two prompts through 4-token pages in 5-token chunks, then 4 paged
    decode steps with every slot live, against the reference's."""
    kw = dict(paged=True, page_size=4, prefix_sharing=True)
    rpool = ref.init_cache(2, 32, **kw)
    tpool = port.init_cache(2, 32, "cpu", **kw)
    radm = rkv.ChunkedPrefill(ref, params, rpool, chunk=5, jit=False)
    tadm = tkv.ChunkedPrefill(port, tparams, tpool, chunk=5)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, port.cfg.vocab_size, n) for n in (11, 7)]
    for slot, prompt in enumerate(prompts):
        np.testing.assert_allclose(tadm.run(slot, prompt, len(prompt) + 6),
                                   radm.run(slot, prompt, len(prompt) + 6), atol=ATOL)
    active = np.ones(2, bool)
    positions = np.asarray([len(p) for p in prompts])
    teacher = rng.integers(0, port.cfg.vocab_size, (4, 2))
    for t in range(4):
        for pool in (tpool, rpool):
            for r in (0, 1):
                pool.ensure(r, int(positions[r]) + 1)
                pool.make_writable(r, int(positions[r]), int(positions[r]) + 1)
        lg_t = port.decode_step_paged(
            tparams, tpool.k, tpool.v, tpool.table_device(),
            torch.from_numpy(teacher[t][:, None]), torch.from_numpy(positions),
            torch.from_numpy(active))
        lg_r, ks, vs = ref.decode_step_paged(
            params, rpool.k, rpool.v, rpool.table_device(),
            jnp.asarray(teacher[t][:, None], jnp.int32), jnp.asarray(positions, jnp.int32),
            jnp.asarray(active))
        rpool.k, rpool.v = list(ks), list(vs)
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_r), atol=ATOL)
        positions = positions + 1


def test_nemotron_chunked_prefill_and_paged_decode_match_reference(nemotron):
    _paged(*nemotron)


def test_nemotron_logits_read_the_untied_head():
    """The logits are the final norm's output times lm_head: replacing
    lm_head changes them to the new product; embed.T gives others."""
    _, _, port, tparams = _load(NEMOTRON)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 3, port.cfg.d_model)).astype(np.float32))
    h = tlayers.apply_norm(tparams["final_norm"], x, port.cfg)
    v = port.cfg.vocab_size
    np.testing.assert_allclose(port.logits(tparams, x).numpy(),
                               (h @ tparams["lm_head"])[..., :v].numpy(), atol=1e-5)
    other = dict(tparams, lm_head=torch.from_numpy(np.random.default_rng(8).standard_normal(
        tuple(tparams["lm_head"].shape)).astype(np.float32)))
    np.testing.assert_allclose(port.logits(other, x).numpy(),
                               (h @ other["lm_head"])[..., :v].numpy(), atol=1e-5)
    tied = (h @ tparams["embed"].T)[..., :v]
    assert float((port.logits(tparams, x) - tied).abs().max()) > 1e-2


# --------------------------------------------------------------------------
# g = 6 (12 query heads on 2 kv heads): forward and paged decode
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", [NEMOTRON, INTERNVL])
def test_g6_forward_matches_reference(arch):
    ref, params, port, tparams = _load(arch, g6=True)
    assert port.cfg.num_heads // port.cfg.num_kv_heads == 6
    tokens = np.random.default_rng(11).integers(0, port.cfg.vocab_size, (2, 12))
    x_r, _, _ = ref.forward(params, _ref_batch(tokens))
    x_t, _, _ = port.forward(tparams, _batch(tokens))
    np.testing.assert_allclose(port.logits(tparams, x_t).numpy(),
                               np.asarray(ref.logits(params, x_r)), atol=ATOL)


@pytest.mark.parametrize("arch", [NEMOTRON, INTERNVL])
def test_g6_chunked_prefill_and_paged_decode_match_reference(arch):
    _paged(*_load(arch, g6=True), seed=12)


# --------------------------------------------------------------------------
# InternVL2: the vision-patch prefix
# --------------------------------------------------------------------------
def test_internvl2_forward_with_prefix_matches_reference():
    ref, params, port, tparams = _load(INTERNVL)
    cfg = port.cfg
    assert cfg.frontend == "vision_patches" and cfg.num_prefix_tokens == 8
    tokens = np.random.default_rng(13).integers(0, cfg.vocab_size, (2, 12))
    prefix = _prefix(cfg, 2, 14)
    x_r, _, _ = ref.forward(params, _ref_batch(tokens, prefix))
    x_t, kvs, _ = port.forward(tparams, _batch(tokens, prefix))
    assert tuple(x_t.shape) == (2, 8 + 12, cfg.d_model)
    assert tuple(kvs[0][0].shape) == (2, 8 + 12, cfg.num_kv_heads, cfg.resolved_head_dim)
    np.testing.assert_allclose(port.logits(tparams, x_t).numpy(),
                               np.asarray(ref.logits(params, x_r)), atol=ATOL)
    # the prefix changes every text position's output
    x_plain, _, _ = port.forward(tparams, _batch(tokens))
    assert float((x_t[:, 8:] - x_plain).abs().max()) > 1e-3


def test_internvl2_prefill_and_decode_with_prefix_match_reference():
    ref, params, port, tparams = _load(INTERNVL)
    _prefill_decode(ref, params, port, tparams, prefix=_prefix(port.cfg, 2, 15), seed=16)


@pytest.mark.parametrize("jit", [True, False], ids=["jit", "eager"])
def test_internvl2_generate_with_prefix_matches_reference(jit):
    """decode.generate(extra={"prefix_embeds": ...}) against the
    reference's generate: the port's default cache holds prefix + prompt +
    new tokens; the reference's default counts only the prompt, so it is
    given that length."""
    ref, params, port, tparams = _load(INTERNVL)
    rng = np.random.default_rng(17)
    prompts = rng.integers(0, port.cfg.vocab_size, (2, 6)).astype(np.int32)
    prefix = _prefix(port.cfg, 2, 18)
    new = 5
    want = ref_decode.generate(ref, params, jnp.asarray(prompts), new, jit=False,
                               max_len=8 + 6 + new + 1,
                               extra={"prefix_embeds": jnp.asarray(prefix)})
    got = decode.generate(port, tparams, prompts, new, jit=jit,
                          extra={"prefix_embeds": prefix})
    assert got.tokens.shape == (2, 6 + new)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))


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


@pytest.mark.parametrize("paged", [False, True], ids=["dense-kv", "paged-kv"])
def test_nemotron_batching_server_tokens_match_reference(nemotron, paged):
    ref, params, port, tparams = nemotron
    kw = dict(paged=True, page_size=4, prefill_chunk=4) if paged else {}
    out_r = _serve(RefServer, RefRequest, RefDense(ref, params, jit=False, **kw),
                   port.cfg.vocab_size)
    out_t = _serve(BatchingServer, Request, DenseBackend(port, tparams, **kw),
                   port.cfg.vocab_size)
    assert sorted(out_t) == sorted(out_r) == list(range(5))
    for rid in out_r:
        np.testing.assert_array_equal(out_t[rid], out_r[rid])


def _serve_cli(arch, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch, "--smoke",
         "--device", "cpu", *args], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=300)


@pytest.mark.parametrize("arch", [NEMOTRON, INTERNVL])
def test_serve_launcher_on_cpu(arch):
    res = _serve_cli(arch, "--backend", "dense", "--paged-kv", "--serve-requests", "3",
                     "--max-batch", "2", "--prompt-len", "6", "--new-tokens", "4")
    assert res.returncode == 0, res.stderr[-2000:]
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report["backend"] == "dense" and report["paged_kv"]
    assert report["serving"]["requests"] == 3
    counts = report["kernel_dispatch"]
    assert counts.get("paged_flash_decode.torch", 0) > 0
    assert not any(k.endswith(".cuda") for k in counts)


def test_hobbit_backend_on_nemotron_fails_clearly():
    res = _serve_cli(NEMOTRON, "--backend", "hobbit")
    assert res.returncode != 0
    assert "--backend hobbit requires a MoE arch" in res.stderr
