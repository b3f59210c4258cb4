"""Mamba2-780m in the port: Mamba-2 SSD layers (``models/ssm.py``) without
attention or FFN, against the JAX reference.

* The config equals the reference's field by field and ``check_supported``
  takes it; the state's bytes per slot at full width.
* ``ssm_init`` shapes and dtypes; ``_causal_conv``, ``_gated_norm``,
  ``ssd_chunked``, ``ssm_forward`` (prompts of 2, 32 and 37 tokens: shorter
  than the conv tail, one chunk, a chunk and a padded one) and
  ``ssm_decode`` (its state written in place) on the reference's weights at
  rtol 1e-5 / atol 1e-4; ``ssd_chunked`` against the naive recurrence at
  2e-4 and across chunk sizes at 1e-4, as the reference's tests/test_ssm.py
  holds its own.
* The smoke model (d_model 64, float32, d_ff 0 as the published model: no
  FFN; weights from the reference's init through ``from_jax_params``):
  forward, logits, the prefill and every decode step against the reference
  at 2e-4 and against the port's teacher-forced forward at 3e-4, after
  prompts of 2, 32 and 37 tokens.
* ``DenseBackend(jit=True)`` equal to ``jit=False``; pause and resume of a
  state row, continuing bit-identical to a run that was not preempted;
  ``BatchingServer`` and ``decode.generate`` greedy tokens equal to the
  reference's; the launcher's ``--smoke`` tokens equal to the reference
  launcher's on one checkpoint.
* ``from_jax_params`` on a bf16 tree keeps the mixer's float32 leaves
  float32 (Mamba-2 and Jamba); the paged KV layout and ``HobbitBackend``
  refuse Mamba-2.

Inputs and weights come from numpy seeds or the reference's init, handed to
both sides as numpy arrays.
"""

import dataclasses
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
from repro.models import ssm as rssm
from repro.models.model import Batch as RefBatch
from repro.serving import decode as ref_decode
from repro.serving.api import DenseBackend as RefDense
from repro.serving.batching import BatchingServer as RefServer
from repro.serving.batching import Request as RefRequest
from repro.training import checkpoint as ref_ckpt
from repro_torch.configs import ASSIGNED_ARCHS, get_config, smoke_variant
from repro_torch.models import build_model
from repro_torch.models import ssm as tssm
from repro_torch.models.model import check_supported, supports_paged_kv
from repro_torch.serving import decode
from repro_torch.serving.api import BackendConfig, DenseBackend, make_backend
from repro_torch.serving.batching import BatchingServer, Request
from repro_torch.serving.workload import RequestClass, WorkloadConfig, generate_workload
from repro_torch.weights import from_jax_params

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "mamba2-780m"
TOL = dict(rtol=2e-4, atol=2e-4)        # tests/test_arch_smoke.py: against the reference
STEP_TOL = dict(rtol=3e-4, atol=3e-4)   # ... and decode against teacher-forced forward
FN_TOL = dict(rtol=1e-5, atol=1e-4)     # the SSM functions against the reference's
NAIVE_TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_ssm.py: chunked against the recurrence
CHUNK_TOL = dict(rtol=1e-4, atol=1e-4)  # ... and across chunk sizes
MAX_LEN = 48
PROMPT_LENS = [2, 32, 37]               # shorter than the conv tail; one chunk; padded


def _smoke(get, smoke, *, dtype="float32"):
    """The smoke variant at d_model 64 (2 layers, 4 heads of 32, d_state 32,
    chunk 32) with d_ff 0, as the published model: SSD layers without FFN."""
    return dataclasses.replace(smoke(get(ARCH), d_model=64), d_ff=0, dtype=dtype).validate()


_MODELS = {}


def _load():
    """(reference model, its params, port model, the same params in the port)."""
    if not _MODELS:
        ref = build_ref(_smoke(ref_get_config, ref_smoke_variant))
        port = build_model(_smoke(get_config, smoke_variant))
        params = ref.init(jax.random.PRNGKey(3))
        tparams = from_jax_params(port.cfg, jax.tree_util.tree_map(np.asarray, params),
                                  device="cpu")
        _MODELS.update(ref=ref, params=params, port=port, tparams=tparams)
    return _MODELS["ref"], _MODELS["params"], _MODELS["port"], _MODELS["tparams"]


def _ref_batch(tokens):
    b, s = tokens.shape
    return RefBatch(tokens=jnp.asarray(tokens, jnp.int32), loss_mask=jnp.ones((b, s)))


def _layer0_mixer():
    """The first layer's mixer weights on both sides, with seeded conv_b,
    dt_bias, D and norm in place of the init's zeros and ones."""
    ref, params, port, tparams = _load()
    rp = {k: np.asarray(v[0]) for k, v in params["blocks"][0]["mixer"].items()}
    rng = np.random.default_rng(19)
    for k in ("conv_b", "dt_bias", "D", "norm"):
        rp[k] = (rng.standard_normal(rp[k].shape) * 0.5).astype(np.float32)
    tp = {k: torch.from_numpy(v.copy()) for k, v in rp.items()}
    return ref.cfg, {k: jnp.asarray(v) for k, v in rp.items()}, port.cfg, tp


def _x(seed, b=2, s=12, d=64):
    return (np.random.default_rng(seed).standard_normal((b, s, d)) * 0.5).astype(np.float32)


def _ssd_inputs(seed, b, s, h, p, n, g=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, p)).astype(np.float32),
            rng.uniform(0.1, 0.9, size=(b, s, h)).astype(np.float32),
            -rng.uniform(0.5, 2.0, size=(h,)).astype(np.float32),
            rng.normal(size=(b, s, g, n)).astype(np.float32),
            rng.normal(size=(b, s, g, n)).astype(np.float32),
            rng.normal(size=(h,)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# --------------------------------------------------------------------------
# the config and the SSM functions
# --------------------------------------------------------------------------
def test_config_matches_reference_and_is_supported():
    assert ARCH in ASSIGNED_ARCHS
    got, want = get_config(ARCH), ref_get_config(ARCH)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    check_supported(got)
    assert got.layer_kinds() == ("ssm",) * 48 and got.d_ff == 0 and got.moe is None
    assert not supports_paged_kv(got)
    assert round(got.param_count() / 1e9, 2) == 0.78
    d_in, nheads, conv_dim = tssm.ssm_dims(got)
    assert (d_in, nheads, conv_dim) == (3072, 48, 3328)
    state = tssm.init_ssm_state(got, 1, "meta")
    per_layer = sum(t.numel() * t.element_size() for t in state.values())
    assert per_layer == 48 * 64 * 128 * 4 + 3 * 3328 * 4
    assert round(per_layer * 48 / 1e6, 1) == 77.4       # bytes per slot at full depth


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_init_shapes_and_dtypes(dtype):
    cfg = _smoke(get_config, smoke_variant, dtype=dtype)
    rcfg = _smoke(ref_get_config, ref_smoke_variant, dtype=dtype)
    got = tssm.ssm_init(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    want = rssm.ssm_init(jax.random.PRNGKey(0), rcfg)
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(w.dtype), k
    for k in ("conv_b", "dt_bias", "norm"):
        assert not got[k].any(), k
    np.testing.assert_allclose(got["A_log"].numpy(), np.asarray(want["A_log"]), rtol=1e-6)
    np.testing.assert_array_equal(got["D"].numpy(), np.asarray(want["D"]))


def test_causal_conv_and_gated_norm_match_reference():
    rcfg, rp, cfg, tp = _layer0_mixer()
    _, _, conv_dim = tssm.ssm_dims(cfg)
    rng = np.random.default_rng(20)
    xbc = rng.standard_normal((2, 9, conv_dim)).astype(np.float32)
    got = tssm._causal_conv(torch.from_numpy(xbc), tp["conv_w"], tp["conv_b"], cfg)
    want = rssm._causal_conv(jnp.asarray(xbc), rp["conv_w"], rp["conv_b"], rcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FN_TOL)
    y, z = (rng.standard_normal((2, 5, 128)).astype(np.float32) for _ in range(2))
    got = tssm._gated_norm(*_t(y, z), tp["norm"], cfg.norm_eps)
    want = rssm._gated_norm(jnp.asarray(y), jnp.asarray(z), rp["norm"], rcfg.norm_eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FN_TOL)


@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_chunked_matches_reference(groups):
    """Three chunks of 8, B and C shared by 1 and by 2 groups of heads, with
    a scaled by 20 so that exp(diff) above the diagonal overflows float32:
    no NaN may leak from the masked triangle."""
    x, dt, a, b, c, d = _ssd_inputs(0, 2, 24, 4, 8, 4, groups)
    a = a * 20.0
    got_y, got_h = tssm.ssd_chunked(*_t(x, dt, a, b, c, d), chunk=8)
    want_y, want_h = rssm.ssd_chunked(*map(jnp.asarray, (x, dt, a, b, c, d)), chunk=8)
    assert bool(torch.isfinite(got_y).all())
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **FN_TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **FN_TOL)


def test_ssd_chunked_matches_naive_recurrence():
    b, s, h, p, n = 2, 32, 3, 8, 4
    x, dt, a, bb, cc, d_skip = _ssd_inputs(1, b, s, h, p, n)
    y, hf = tssm.ssd_chunked(*_t(x, dt, a, bb, cc, d_skip), chunk=8)
    state = np.zeros((b, h, p, n))
    ys = np.zeros((b, s, h, p))
    for t in range(s):
        da = np.exp(dt[:, t] * a[None, :])
        state = state * da[:, :, None, None] + np.einsum(
            "bh,bn,bhp->bhpn", dt[:, t], bb[:, t, 0], x[:, t])
        ys[:, t] = np.einsum("bn,bhpn->bhp", cc[:, t, 0], state)
    ys = ys + x * d_skip[None, None, :, None]
    np.testing.assert_allclose(y.numpy(), ys, **NAIVE_TOL)
    np.testing.assert_allclose(hf.numpy(), state, **NAIVE_TOL)


@pytest.mark.parametrize("c1,c2", [(4, 16), (8, 32)])
def test_ssd_chunk_size_invariance(c1, c2):
    x, dt, a, bb, cc, _ = _ssd_inputs(2, 1, 32, 2, 4, 4)
    d = np.zeros((2,), np.float32)
    y1, h1 = tssm.ssd_chunked(*_t(x, dt, a, bb, cc, d), chunk=c1)
    y2, h2 = tssm.ssd_chunked(*_t(x, dt, a, bb, cc, d), chunk=c2)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), **CHUNK_TOL)
    np.testing.assert_allclose(h1.numpy(), h2.numpy(), **CHUNK_TOL)


@pytest.mark.parametrize("seq", PROMPT_LENS)
def test_ssm_forward_matches_reference(seq):
    """The output and the state handed to decode (the final SSM state and
    the conv tail, zero-padded in front of a 2-token prompt); at 37 tokens
    the padded steps (dt = 0) leave the state as 37 steps left it."""
    rcfg, rp, cfg, tp = _layer0_mixer()
    x = _x(21 + seq, s=seq)
    out_r, st_r = rssm.ssm_forward(rp, jnp.asarray(x), rcfg)
    out_t, st_t = tssm.ssm_forward(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_r), **FN_TOL)
    assert set(st_t) == {"h", "conv"}
    for k in st_t:
        assert st_t[k].dtype == torch.float32
        np.testing.assert_allclose(st_t[k].numpy(), np.asarray(st_r[k]), **FN_TOL)
    if seq < cfg.ssm.d_conv - 1:
        assert not st_t["conv"][:, : cfg.ssm.d_conv - 1 - seq].any()


def test_ssm_decode_matches_reference_and_writes_the_state_in_place():
    """A 37-token forward, then 4 decode steps: each step's output and the
    state it writes into the caller's buffers against the reference's."""
    rcfg, rp, cfg, tp = _layer0_mixer()
    x = _x(23, s=41)
    _, st = tssm.ssm_forward(tp, torch.from_numpy(x[:, :37]), cfg)
    state_t = tssm.init_ssm_state(cfg, 2, "cpu")
    for k in state_t:
        state_t[k].copy_(st[k])
    bufs = {k: v.data_ptr() for k, v in state_t.items()}
    state_r = {k: jnp.asarray(v.numpy()) for k, v in state_t.items()}
    for i in range(37, 41):
        xi = x[:, i:i + 1]
        out_r, state_r = rssm.ssm_decode(rp, jnp.asarray(xi), state_r, rcfg)
        out_t = tssm.ssm_decode(tp, torch.from_numpy(xi), state_t, cfg)
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_r), **FN_TOL,
                                   err_msg=f"position {i}")
        for k in state_t:
            np.testing.assert_allclose(state_t[k].numpy(), np.asarray(state_r[k]), **FN_TOL)
    assert {k: v.data_ptr() for k, v in state_t.items()} == bufs


# --------------------------------------------------------------------------
# the smoke model: forward, prefill and decode
# --------------------------------------------------------------------------
def test_forward_and_logits_match_reference():
    ref, params, port, tparams = _load()
    assert [set(lp) for lp in tparams["layers"]] == [{"pre_norm", "mixer"}] * 2
    tokens = np.random.default_rng(5).integers(0, port.cfg.vocab_size, (2, 37))
    x_r, aux_r, _ = ref.forward(params, _ref_batch(tokens))
    x_t, states, aux_t = port.forward(tparams, torch.from_numpy(tokens))
    assert [set(st) for st in states] == [{"h", "conv"}] * 2
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_r), **TOL)
    np.testing.assert_allclose(port.logits(tparams, x_t).numpy(),
                               np.asarray(ref.logits(params, x_r)), **TOL)
    assert float(aux_t) == float(aux_r) == 0.0


@pytest.mark.parametrize("prompt_len", PROMPT_LENS)
def test_prefill_and_decode_match_reference_and_forward(prompt_len):
    """Prefill a (2, prompt_len) prompt, then decode teacher-forced tokens
    through position prompt_len + 7: the prefill's state and logits and
    every step against the reference's decode and the port's forward over
    the same tokens."""
    ref, params, port, tparams = _load()
    end = prompt_len + 8
    toks = np.random.default_rng(6 + prompt_len).integers(
        0, port.cfg.vocab_size, (2, end)).astype(np.int32)
    ref_step = jax.jit(ref.decode_step)
    lg_r, cache_r, pos_r = ref.prefill(params, _ref_batch(toks[:, :prompt_len]), MAX_LEN)
    lg_t, cache_t, pos_t = port.prefill(tparams, torch.from_numpy(toks[:, :prompt_len]),
                                        MAX_LEN)
    s = port.cfg.ssm
    _, nheads, conv_dim = tssm.ssm_dims(port.cfg)
    assert [{k: tuple(v.shape) for k, v in c.items()} for c in cache_t] == \
        [{"h": (2, nheads, s.head_dim, s.d_state), "conv": (2, s.d_conv - 1, conv_dim)}] * 2
    for j, c in enumerate(cache_t):
        for k, v in c.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(cache_r["blocks"][0][k][j]),
                                       **TOL, err_msg=f"layer {j} {k}")
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


def test_prefill_takes_a_prompt_longer_than_max_len():
    """An all-SSM model keeps no row per position, so, as the reference, its
    prefill takes a prompt longer than the cache's max_len."""
    ref, params, port, tparams = _load()
    toks = np.random.default_rng(8).integers(0, port.cfg.vocab_size, (1, 20))
    lg_t, _, pos = port.prefill(tparams, torch.from_numpy(toks), 8)
    lg_r, _, _ = ref.prefill(params, _ref_batch(toks), 8)
    assert pos.tolist() == [20]
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_r), **TOL)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------
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


def test_pause_and_resume_a_state_row():
    """Slot 0 paused for 2 steps while slot 1 goes on (the dead row is
    stepped with junk meanwhile), then resumed: every live row against the
    reference backend doing the same, and slot 0 after resume bit-identical
    to a run that never paused it and fed it the same tokens."""
    ref, params, port, tparams = _load()
    rng = np.random.default_rng(14)
    prompts = rng.integers(0, port.cfg.vocab_size, (2, 6))
    feed = rng.integers(0, port.cfg.vocab_size, (9, 2))
    got, snap = _backend_run(DenseBackend(port, tparams), prompts, feed, pause=True)
    want, _ = _backend_run(RefDense(ref, params, jit=True), prompts, feed, pause=True)
    assert snap["position"] == 10
    s = port.cfg.ssm
    _, nheads, conv_dim = tssm.ssm_dims(port.cfg)
    assert [{k: tuple(v.shape) for k, v in row.items()} for row in snap["cache"]] == \
        [{"h": (nheads, s.head_dim, s.d_state), "conv": (s.d_conv - 1, conv_dim)}] * 2
    live = np.ones(got.shape[:2], bool)
    live[5:7, 0] = False                # slot 0's two paused steps
    np.testing.assert_allclose(got[live], want[live], **TOL)
    unpaused = np.concatenate([feed[:4], feed[6:]])
    unpaused[:, 1] = feed[:7, 1]
    plain, _ = _backend_run(DenseBackend(port, tparams), prompts, unpaused)
    np.testing.assert_array_equal(got[7:, 0], plain[5:, 0])


@pytest.mark.parametrize("jit", [True, False], ids=["jit", "eager"])
def test_generate_matches_reference(jit):
    ref, params, port, tparams = _load()
    prompts = np.random.default_rng(15).integers(0, port.cfg.vocab_size, (2, 37))
    want = ref_decode.generate(ref, params, jnp.asarray(prompts, jnp.int32), 9, jit=True)
    got = decode.generate(port, tparams, prompts, 9, jit=jit)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))


# --------------------------------------------------------------------------
# weights, refusals, the launcher
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", [ARCH, "jamba-v0.1-52b"])
def test_from_jax_params_keeps_the_mixer_f32_leaves_f32(arch):
    """A bf16 reference tree (the smoke init at d_model 64): every leaf of
    the port's layers in the reference leaf's dtype -- A_log, D, dt_bias,
    conv_b and the gated norm float32, in_proj, conv_w and out_proj bf16 --
    and the same keys as the port's own init."""
    rcfg = dataclasses.replace(ref_smoke_variant(ref_get_config(arch), d_model=64),
                               dtype="bfloat16")
    tcfg = dataclasses.replace(smoke_variant(get_config(arch), d_model=64), dtype="bfloat16")
    params = build_ref(rcfg).init(jax.random.PRNGKey(16))
    tp = from_jax_params(tcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")

    def leaves(node, path=()):
        if isinstance(node, dict):
            for k, v in node.items():
                yield from leaves(v, path + (k,))
        else:
            yield path, node

    want = {}
    for j in range(tcfg.period):
        for path, leaf in jax.tree_util.tree_flatten_with_path(params["blocks"][j])[0]:
            want[(j,) + tuple(p.key for p in path)] = str(leaf.dtype)
    seen = set()
    for i, lp in enumerate(tp["layers"]):
        for path, leaf in leaves(lp):
            key = (i % tcfg.period,) + path
            assert str(leaf.dtype).split(".")[-1] == want[key], (i, path)
            seen.add(path)
    assert {("mixer", k) for k in ("A_log", "D", "dt_bias", "conv_b", "norm")} <= seen
    assert all(lp["mixer"][k].dtype == torch.float32 for lp in tp["layers"] if "mixer" in lp
               for k in ("A_log", "D", "dt_bias", "conv_b", "norm"))
    init = build_model(tcfg).init(0, device="cpu")["layers"]
    assert [set(lp) for lp in init] == [set(lp) for lp in tp["layers"]]


def test_refusals_of_paged_kv_and_the_offload_engine():
    _, _, port, tparams = _load()
    with pytest.raises(ValueError, match="paged KV layout.*SSM"):
        DenseBackend(port, tparams, paged=True)
    with pytest.raises(ValueError, match="paged KV unsupported for arch mamba2-780m"):
        port.init_cache(2, 16, "cpu", paged=True)
    with pytest.raises(ValueError, match="requires a MoE model; mamba2-780m-smoke has no "
                                         "FFN layers"):
        make_backend(BackendConfig(kind="hobbit"), port, tparams)


def _launcher(package, ckpt, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    extra = ["--device", "cpu"] if package == "repro_torch" else []
    return subprocess.run(
        [sys.executable, "-m", f"{package}.launch.serve", "--arch", ARCH, "--smoke",
         "--ckpt-dir", ckpt, "--backend", "dense", *extra, *args],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)


def test_serve_launcher_smoke_matches_reference_launcher(tmp_path):
    """Both launchers' --smoke (the smoke variant as the launcher makes it,
    with its FFN) on one checkpoint of the reference's smoke init: the same
    generated tokens; --paged-kv and --backend hobbit exit with the
    refusal."""
    cfg = dataclasses.replace(ref_smoke_variant(ref_get_config(ARCH)), dtype="float32")
    ref_ckpt.save(str(tmp_path), build_ref(cfg).init(jax.random.PRNGKey(0)), step=0)
    args = ("--prompt-len", "37", "--new-tokens", "6")
    runs = {pkg: _launcher(pkg, str(tmp_path), *args) for pkg in ("repro", "repro_torch")}
    for pkg, res in runs.items():
        assert res.returncode == 0, (pkg, res.stderr[-2000:])
    want, got = (json.loads(runs[p].stdout.strip().splitlines()[-1])
                 for p in ("repro", "repro_torch"))
    assert got["tokens"] == want["tokens"] and len(got["tokens"]) == 8
    assert not any(k.endswith(".cuda") for k in got["kernel_dispatch"])
    for flag, msg in (("--paged-kv", "does not support the paged KV layout"),
                      ("--backend=hobbit", "--backend hobbit requires a MoE arch")):
        res = _launcher("repro_torch", str(tmp_path), flag)
        assert res.returncode != 0 and msg in res.stderr, res.stderr[-2000:]
