"""The dense model family of the port (Granite-3.0-2B) against the JAX
reference.

* ``quantize_tree`` gives the reference's QTensors bit for bit and leaves the
  same leaves alone (1-D, non-float, rejected by the predicate, and a
  contraction dim the group does not divide).
* The Granite smoke variant (2 layers, d_model 64, float32), with its FFN
  weights as they are and quantized by ``quantize_tree`` (4 bits, group 32:
  the default group 128 does not divide d_model 64, so it would leave every
  weight as it is), through ``from_jax_params``: forward, prefill and decode
  on dense and on paged KV.  atol 1e-4, as tests/test_torch_model.py: float32
  sums taken in another order over two layers.
* ``BatchingServer`` over ``DenseBackend`` token-identical to the reference
  server on both KV layouts, and the launcher's dense path; ``--backend
  hobbit`` on a dense arch fails with a clear message.

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
from repro.models.model import Batch
from repro.serving.api import DenseBackend as RefDense
from repro.serving.batching import BatchingServer as RefServer
from repro.serving.batching import Request as RefRequest
from repro_torch.configs import get_config, smoke_variant
from repro_torch.configs.base import EncoderConfig, MLAConfig, SSMConfig
from repro_torch.models import build_model
from repro_torch.models import kv_pages as tkv
from repro_torch.models.model import check_supported
from repro_torch.quant.quantize import QTensor, quantization_error, quantize_tree
from repro_torch.serving.api import BackendConfig, DenseBackend, make_backend
from repro_torch.serving.batching import BatchingServer, Request
from repro_torch.serving.workload import RequestClass, WorkloadConfig, generate_workload
from repro_torch.weights import from_jax_params

jq = importlib.import_module("repro.quant.quantize")
torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "granite-3-2b"
ATOL = 1e-4
GROUP = 32


def _ffn_path(path, leaf):
    """True under an "ffn" key: the reference passes a JAX key path, the port
    a tuple of strings; str() of either names the key."""
    del leaf
    return "ffn" in str(path)


# --------------------------------------------------------------------------
# quantize_tree
# --------------------------------------------------------------------------
def _tree(rng):
    return {
        "norm": rng.standard_normal(64).astype(np.float32),             # 1-D
        "ids": rng.integers(0, 9, (64, 8)).astype(np.int32),            # not float
        "odd": rng.standard_normal((96, 8)).astype(np.float32),         # 96 % 64
        "layers": [
            {"attn": {"wq": rng.standard_normal((64, 32)).astype(np.float32)},
             "ffn": {"wi": rng.standard_normal((128, 48)).astype(np.float32),
                     "wo": (rng.standard_normal((64, 16)) * 0.02).astype(np.float32)}},
            {"ffn": {"wi": rng.standard_normal((3, 64, 24)).astype(np.float32)}},
        ],
    }


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, tree


def _jax_leaf(tree, path):
    for key in path:
        tree = tree[int(key)] if isinstance(tree, list) else tree[key]
    return tree


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("predicate", [None, _ffn_path], ids=["all", "ffn-only"])
def test_quantize_tree_matches_reference(bits, predicate):
    rng = np.random.default_rng(bits)
    tree = _tree(rng)
    want = jq.quantize_tree(jax.tree_util.tree_map(jnp.asarray, tree), bits=bits,
                            group_size=64, predicate=predicate)
    torch_tree = jax.tree_util.tree_map(torch.from_numpy, tree)
    got = quantize_tree(torch_tree, bits=bits, group_size=64, predicate=predicate)
    n_quantized = 0
    for path, leaf in _leaves(got):
        ref = _jax_leaf(want, path)
        if isinstance(ref, jq.QTensor):
            assert isinstance(leaf, QTensor), path
            np.testing.assert_array_equal(leaf.data.numpy(), np.asarray(ref.data))
            np.testing.assert_array_equal(leaf.scale.numpy(), np.asarray(ref.scale))
            assert (leaf.bits, leaf.group_size, leaf.orig_k) == \
                (ref.bits, ref.group_size, ref.orig_k)
            n_quantized += 1
        else:
            # skipped leaves come back as they went in
            assert leaf is _jax_leaf(torch_tree, path), path
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(ref))
    assert n_quantized == (4 if predicate is None else 3)


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_quantization_error_matches_reference(bits):
    w = np.random.default_rng(bits).standard_normal((256, 64)).astype(np.float32)
    want = jq.quantization_error(jnp.asarray(w), bits, group_size=64)
    got = quantization_error(torch.from_numpy(w), bits, group_size=64)
    np.testing.assert_allclose(got, want, rtol=1e-5)


# --------------------------------------------------------------------------
# the Granite smoke model
# --------------------------------------------------------------------------
def _smoke(get, smoke):
    return dataclasses.replace(smoke(get(ARCH), layers=2, d_model=64), dtype="float32")


@pytest.fixture(scope="module")
def granite():
    ref = build_ref(_smoke(ref_get_config, ref_smoke_variant))
    port = build_model(_smoke(get_config, smoke_variant))
    return ref, port, ref.init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module", params=["unquantized", "q4-ffn"])
def weights(request, granite):
    """(kind, reference, its params, port, the same params in the port)."""
    ref, port, params = granite
    if request.param == "q4-ffn":
        params = jq.quantize_tree(params, bits=4, group_size=GROUP, predicate=_ffn_path)
    tparams = from_jax_params(port.cfg, jax.tree_util.tree_map(np.asarray, params),
                              device="cpu")
    for lp in tparams["layers"]:
        for key in ("wi", "wo"):
            assert isinstance(lp["ffn"][key], QTensor) == (request.param == "q4-ffn")
    return request.param, ref, params, port, tparams


def test_port_quantize_tree_equals_converted_reference_tree(granite):
    """quantize_tree on the port's flat per-layer parameters gives the
    reference's stacked QTensors, split per layer by from_jax_params."""
    ref, port, params = granite
    plain = from_jax_params(port.cfg, jax.tree_util.tree_map(np.asarray, params),
                            device="cpu")
    qref = jq.quantize_tree(params, bits=4, group_size=GROUP, predicate=_ffn_path)
    want = from_jax_params(port.cfg, jax.tree_util.tree_map(np.asarray, qref), device="cpu")
    got = quantize_tree(plain, bits=4, group_size=GROUP, predicate=_ffn_path)
    assert torch.equal(got["embed"], plain["embed"])
    for lg, lw in zip(got["layers"], want["layers"]):
        assert torch.equal(lg["attn"]["wq"], lw["attn"]["wq"])
        for key in ("wi", "wo"):
            assert torch.equal(lg["ffn"][key].data, lw["ffn"][key].data)
            assert torch.equal(lg["ffn"][key].scale, lw["ffn"][key].scale)


def test_forward_matches_reference(weights):
    _, ref, params, port, tparams = weights
    tokens = np.random.default_rng(1).integers(0, port.cfg.vocab_size, (2, 12))
    x_r, _, _ = ref.forward(params, Batch(tokens=jnp.asarray(tokens, jnp.int32),
                                          loss_mask=jnp.ones((2, 12), jnp.float32)))
    x_t, _, _ = port.forward(tparams, torch.from_numpy(tokens))
    np.testing.assert_allclose(port.logits(tparams, x_t).numpy(),
                               np.asarray(ref.logits(params, x_r)), atol=ATOL)


def test_prefill_and_decode_match_reference(weights):
    _, ref, params, port, tparams = weights
    rng = np.random.default_rng(2)
    b, s, steps, max_len = 2, 10, 4, 20
    prompts = rng.integers(0, port.cfg.vocab_size, (b, s)).astype(np.int32)
    teacher = rng.integers(0, port.cfg.vocab_size, (steps, b)).astype(np.int32)
    lg_r, cache_r, pos_r = ref.prefill(
        params, Batch(tokens=jnp.asarray(prompts), loss_mask=jnp.ones((b, s), jnp.float32)),
        max_len)
    lg_t, cache_t, pos_t = port.prefill(tparams, torch.from_numpy(prompts), max_len)
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_r), atol=ATOL)
    positions = torch.from_numpy(pos_t)
    for t in range(steps):
        lg_r, cache_r = ref.decode_step(params, cache_r, jnp.asarray(teacher[t][:, None]),
                                        pos_r)
        pos_r = pos_r + 1
        lg_t = port.decode_step(tparams, cache_t, torch.from_numpy(teacher[t][:, None]),
                                positions)
        positions = positions + 1
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_r), atol=ATOL)


def test_chunked_prefill_and_paged_decode_match_reference(weights):
    """Two prompts through 4-token pages in 5-token chunks, then paged decode
    steps with every slot live."""
    _, ref, params, port, tparams = weights
    kw = dict(paged=True, page_size=4, prefix_sharing=True)
    rpool = ref.init_cache(2, 32, **kw)
    tpool = port.init_cache(2, 32, "cpu", **kw)
    radm = rkv.ChunkedPrefill(ref, params, rpool, chunk=5, jit=False)
    tadm = tkv.ChunkedPrefill(port, tparams, tpool, chunk=5)
    rng = np.random.default_rng(3)
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
def test_batching_server_tokens_match_reference(weights, paged):
    _, ref, params, port, tparams = weights
    kw = dict(paged=True, page_size=4, prefill_chunk=4) if paged else {}
    out_r = _serve(RefServer, RefRequest, RefDense(ref, params, jit=False, **kw),
                   port.cfg.vocab_size)
    out_t = _serve(BatchingServer, Request, DenseBackend(port, tparams, **kw),
                   port.cfg.vocab_size)
    assert sorted(out_t) == sorted(out_r) == list(range(5))
    for rid in out_r:
        np.testing.assert_array_equal(out_t[rid], out_r[rid])


def _serve_cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--smoke",
         "--device", "cpu", *args], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=300)


def test_serve_launcher_dense_paged_on_cpu():
    res = _serve_cli("--backend", "dense", "--paged-kv", "--serve-requests", "3",
                     "--max-batch", "2", "--prompt-len", "6", "--new-tokens", "4")
    assert res.returncode == 0, res.stderr[-2000:]
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report["backend"] == "dense" and report["paged_kv"]
    assert report["serving"]["requests"] == 3
    counts = report["kernel_dispatch"]
    assert counts.get("paged_flash_decode.torch", 0) > 0
    assert not any(k.endswith(".cuda") for k in counts)


def test_hobbit_backend_on_a_dense_arch_fails_clearly(granite):
    res = _serve_cli("--backend", "hobbit")
    assert res.returncode != 0
    assert "--backend hobbit requires a MoE arch" in res.stderr
    _, port, _ = granite
    with pytest.raises(ValueError, match="requires a MoE model.*dense"):
        make_backend(BackendConfig(kind="hobbit"), port, port.init(0, device="cpu"))


def test_check_supported_takes_dense_and_moe_and_names_what_remains():
    for arch in ("granite-3-2b", "mixtral-8x7b", "phi-moe", "nemotron-4-15b",
                 "internvl2-26b", "gemma2-27b", "gemma3-27b", "llama4-scout-17b-a16e",
                 "deepseek-v2-236b", "mamba2-780m", "jamba-v0.1-52b", "whisper-tiny"):
        check_supported(get_config(arch))
    nemotron = dataclasses.replace(get_config(ARCH), name="nemotron-like",
                                   norm_type="layernorm", ffn_activation="sq_relu",
                                   tie_embeddings=False)
    check_supported(nemotron)
    windowed = dataclasses.replace(get_config(ARCH), name="windowed",
                                   block_pattern=("attn_local", "attn"),
                                   moe_pattern=(False, False), window_size=64).validate()
    check_supported(windowed)           # ring caches: ROADMAP Queue 1, item 7.2, done
    mla = dataclasses.replace(smoke_variant(get_config("mixtral-8x7b")), name="mla",
                              mla=MLAConfig(kv_lora_rank=64, rope_head_dim=32,
                                            nope_head_dim=64, v_head_dim=64)).validate()
    check_supported(mla)                # MLA: item 7.3, done
    mixed = dataclasses.replace(get_config("mixtral-8x7b"), block_pattern=("attn", "attn"),
                                moe_pattern=(True, False)).validate()
    check_supported(mixed)              # dense and MoE FFN layers mixed: item 7.3, done
    ssm = dataclasses.replace(get_config(ARCH), name="ssm", block_pattern=("ssm",),
                              moe_pattern=(False,), ssm=SSMConfig()).validate()
    check_supported(ssm)                # SSM and hybrid layers: item 7.4, done
    enc = dataclasses.replace(get_config(ARCH), name="enc", encoder=EncoderConfig()).validate()
    check_supported(enc)                # encoders: item 7.5, done
    other = dataclasses.replace(get_config(ARCH), name="other", frontend="mel").validate()
    with pytest.raises(NotImplementedError, match="'mel' frontend"):
        check_supported(other)          # what remains: a frontend the reference has not


@pytest.mark.parametrize("act", ["swiglu", "gelu", "sq_relu"])
def test_ffn_activations_match_reference(act):
    """ffn_forward with each activation (Nemotron's squared ReLU included)
    on the same float32 weights."""
    from repro.models import layers as rlayers
    from repro_torch.models import layers as tlayers
    cfg = dataclasses.replace(_smoke(get_config, smoke_variant), ffn_activation=act)
    rcfg = dataclasses.replace(_smoke(ref_get_config, ref_smoke_variant), ffn_activation=act)
    rng = np.random.default_rng(4)
    wi_cols = 2 * cfg.d_ff if act == "swiglu" else cfg.d_ff
    p = {"wi": (rng.standard_normal((cfg.d_model, wi_cols)) / 8).astype(np.float32),
         "wo": (rng.standard_normal((cfg.d_ff, cfg.d_model)) / 8).astype(np.float32)}
    x = rng.standard_normal((2, 3, cfg.d_model)).astype(np.float32)
    want = rlayers.ffn_forward({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), rcfg)
    got = tlayers.ffn_forward({k: torch.from_numpy(v) for k, v in p.items()},
                              torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-5)
    init = tlayers.ffn_init(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    assert init["wi"].shape == (cfg.d_model, wi_cols)
    assert init["wo"].shape == (cfg.d_ff, cfg.d_model)
