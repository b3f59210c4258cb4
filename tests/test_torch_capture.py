"""The port's captured steps (the counterpart of the reference's ``jit``)
against the JAX reference, on the CPU where a captured step runs eagerly.

* ``serving.decode.generate`` against the reference's
  ``repro.serving.decode.generate`` on the same weights (carried across
  with ``weights.from_jax_params``): the mixtral-smoke float32 model of
  tests/test_api.py and the Granite smoke model of tests/test_serving.py,
  with ``jit`` True and False on both sides.  Greedy tokens equal.
* ``make_serve_step`` logits against the reference's at atol 1e-3 (the
  ROADMAP's dense-vs-offload tolerance; float32 sums in another order).
* ``DenseBackend(jit=True)`` equal to ``jit=False`` exactly on both KV
  layouts, its counters showing the eager route, and equal to the
  reference's ``decode.generate``; the engine's captured segments run
  eagerly on the CPU, one per MoE layer and step.
* ``launch.serve --jit`` / ``--no-jit`` reach ``BackendConfig.jit``.
* ``make_backend``'s deprecated keyword form (twins of
  tests/test_scheduling.py's shim tests) and the reference's package names.

The card's side (a replay equals the eager step, launch counts grow on
every replay, ``start_batch`` drops the graphs) is in
tests/test_torch_capture_card.py, which imports no JAX.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.models as ref_models
from repro.configs import get_config as ref_get_config
from repro.configs import smoke_variant as ref_smoke_variant
from repro.core.predictor import gating_input_similarity as ref_similarity
from repro.models import build_model as build_ref
from repro.models.model import Batch as RefBatch
from repro.serving import decode as ref_decode
from repro_torch import capture
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import EngineConfig, OffloadEngine, Thresholds
from repro_torch.core.predictor import gating_input_similarity
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.serving import api, decode
from repro_torch.weights import from_jax_params

torch.set_num_threads(2)
ATOL = 1e-3
NEW = 6


def _mixtral(get, smoke):
    cfg = smoke(get("mixtral-8x7b"), layers=4, d_model=128, vocab=256)
    # ample capacity so the dense MoE dispatch never drops tokens at batch > 1
    return dataclasses.replace(cfg, dtype="float32",
                               moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


def _granite(get, smoke):
    return dataclasses.replace(smoke(get("granite-3-2b"), layers=2, d_model=64, vocab=128),
                               dtype="float32")


_SETUPS = {"mixtral": _mixtral, "granite": _granite}


_MODELS = {}


def _load(name):
    """(name, reference model, its params, port model, the same params)."""
    if name not in _MODELS:
        make = _SETUPS[name]
        ref = build_ref(make(ref_get_config, ref_smoke_variant))
        params = ref.init(jax.random.PRNGKey(0))
        port = build_model(make(get_config, smoke_variant))
        tparams = from_jax_params(port.cfg, jax.tree_util.tree_map(np.asarray, params),
                                  device="cpu")
        _MODELS[name] = name, ref, params, port, tparams
    return _MODELS[name]


@pytest.fixture(scope="module", params=sorted(_SETUPS))
def models(request):
    return _load(request.param)


def _prompts(cfg, b=2, s=8, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


_REF_TOKENS = {}


def _ref_tokens(models, jit):
    name, ref, params, port, _ = models
    if (name, jit) not in _REF_TOKENS:
        res = ref_decode.generate(ref, params, jnp.asarray(_prompts(port.cfg)), NEW, jit=jit)
        _REF_TOKENS[name, jit] = np.asarray(res.tokens)
    return _REF_TOKENS[name, jit]


# --------------------------------------------------------------------------
# decode.generate and make_serve_step against the reference
# --------------------------------------------------------------------------
@pytest.mark.parametrize("ref_jit", [True, False], ids=["ref-jit", "ref-eager"])
@pytest.mark.parametrize("jit", [True, False], ids=["jit", "eager"])
def test_generate_matches_reference(models, jit, ref_jit):
    _, _, _, port, tparams = models
    ops.reset_dispatch_counts()
    res = decode.generate(port, tparams, _prompts(port.cfg), NEW, jit=jit)
    counts = ops.dispatch_counts()
    np.testing.assert_array_equal(res.tokens, _ref_tokens(models, ref_jit))
    assert res.tokens.shape == (2, 8 + NEW) and res.steps == NEW and res.decode_tok_s > 0
    # NEW tokens take NEW - 1 decode steps; on the CPU the captured step is eager
    assert counts.get("serve_step.eager", 0) == (NEW - 1 if jit else 0)
    assert not any(k.startswith("serve_step.") and not k.endswith(".eager") for k in counts)


def test_serve_step_logits_match_reference(models):
    _, ref, params, port, tparams = models
    rng = np.random.default_rng(2)
    b, s, steps, max_len = 2, 10, 4, 20
    prompts = rng.integers(0, port.cfg.vocab_size, (b, s)).astype(np.int32)
    teacher = rng.integers(0, port.cfg.vocab_size, (steps, b)).astype(np.int32)
    lg_r, cache_r, pos_r = ref_decode.make_prefill_step(ref, max_len)(
        params, RefBatch(tokens=jnp.asarray(prompts), loss_mask=jnp.ones((b, s))))
    batch = decode.Batch(tokens=torch.from_numpy(prompts), loss_mask=torch.ones((b, s)))
    lg_t, cache_t, pos_t = decode.make_prefill_step(port, max_len)(tparams, batch)
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_r), atol=ATOL)
    np.testing.assert_array_equal(pos_t, np.asarray(pos_r))
    step_r, step_t = ref_decode.make_serve_step(ref), decode.make_serve_step(port)
    for t in range(steps):
        lg_r, cache_r = step_r(params, cache_r, jnp.asarray(teacher[t][:, None]), pos_r)
        lg_t, same = step_t(tparams, cache_t, torch.from_numpy(teacher[t][:, None]),
                            torch.from_numpy(pos_t))
        assert same is cache_t                  # written in place and handed back
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_r), atol=ATOL)
        pos_r, pos_t = pos_r + 1, pos_t + 1


def test_prefill_step_refuses_frontend_inputs(models):
    """Frontend inputs a model has no use for are ignored, as the reference
    ignores them: audio frames (read only by an encoder model, Whisper:
    tests/test_torch_whisper.py holds them to the reference) leave a
    decoder-only model's prefill unchanged.  Prefix embeddings are taken by
    a "vision_patches" model (tests/test_torch_gqa6_dense.py)."""
    _, _, _, port, tparams = models
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    plain = decode.Batch(tokens=tokens, loss_mask=torch.ones((1, 4)))
    batch = plain._replace(audio_frames=torch.ones((1, 2, port.cfg.d_model)))
    prefill = decode.make_prefill_step(port, 8)
    (lg, cache, pos), (lg0, cache0, pos0) = prefill(tparams, batch), prefill(tparams, plain)
    assert torch.equal(lg, lg0) and np.array_equal(pos, pos0)
    assert all(torch.equal(c[n], c0[n]) for c, c0 in zip(cache, cache0) for n in c0)
    assert all(set(c) == set(c0) for c, c0 in zip(cache, cache0))


# --------------------------------------------------------------------------
# DenseBackend(jit=)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("paged", [False, True], ids=["dense-kv", "paged-kv"])
def test_dense_backend_jit_equals_eager_and_reference(models, paged):
    """Greedy tokens and per-step logits of jit=True equal jit=False exactly
    (the same eager code on the CPU), and the tokens equal the reference's
    decode.generate; only the captured run counts serve_step.eager, on
    paged KV prefill_chunk.eager (8-token prompts in 4-token chunks) and on
    dense KV prefill.eager (the one-shot prefill)."""
    _, _, _, port, tparams = models
    runs = {}
    for jit in (True, False):
        be = api.DenseBackend(port, tparams, jit=jit, paged=paged, page_size=4,
                              prefill_chunk=4)
        assert be._jit is jit
        ops.reset_dispatch_counts()
        res = api.generate(be, _prompts(port.cfg), NEW)
        runs[jit] = res.tokens, ops.dispatch_counts()
        be.start_batch(2, 16)
        lg = [be.prefill(_prompts(port.cfg, seed=5))]
        lg += [be.step(np.asarray([t, t + 1])) for t in range(3)]
        runs[jit] += (np.stack(lg),)
    np.testing.assert_array_equal(runs[True][0], runs[False][0])
    np.testing.assert_array_equal(runs[True][2], runs[False][2])
    np.testing.assert_array_equal(runs[True][0], _ref_tokens(models, True))
    assert runs[True][1]["serve_step.eager"] == NEW - 1
    assert runs[True][1].get("prefill_chunk.eager", 0) == (2 if paged else 0)
    assert runs[True][1].get("prefill.eager", 0) == (0 if paged else 1)
    steps = ("serve_step.", "prefill_chunk.", "prefill.")
    assert not any(k.startswith(steps) for k in runs[False][1])
    kernels = {k: v for k, v in runs[True][1].items() if not k.startswith(steps)}
    assert kernels == runs[False][1]            # the same launches on either route


def test_engine_segments_run_eagerly_on_cpu():
    """The grouped path's embed, per-layer segment, grouped FFN and logits
    go through their captured steps: on the CPU the segment and the FFN
    count one eager call per MoE layer and step, the embed and the logits
    one per step; nothing is captured or replayed."""
    models = _load("mixtral")
    _, _, _, port, tparams = models
    n = port.cfg.num_layers * port.cfg.moe.num_experts
    eng = OffloadEngine(port, tparams, EngineConfig(
        hi_slots=n, lo_slots=1, thresholds=Thresholds(1.0, 1.0), prefetch=False))
    try:
        ops.reset_dispatch_counts()
        res = api.generate(api.HobbitBackend(eng), _prompts(port.cfg), NEW)
        counts = ops.dispatch_counts()
    finally:
        eng.close()
    np.testing.assert_array_equal(res.tokens, _ref_tokens(models, True))
    steps = NEW - 1
    want = {"engine_embed.eager": steps, "engine_logits.eager": steps}
    want.update({f"engine_layer{mi}.eager": steps for mi in range(port.cfg.num_layers)})
    want["engine_ffn.eager"] = steps * port.cfg.num_layers
    got = {k: v for k, v in counts.items() if k.startswith("engine_")}
    assert got == want
    assert counts["gating_topk.torch"] == steps * port.cfg.num_layers
    # the fixed-shape FFN: one launch of each grouped kernel per MoE layer and step
    for op, per_layer in (("grouped_matmul", 2), ("grouped_dequant_matmul", 1),
                          ("grouped_dequant_combine", 1)):
        assert counts[f"{op}.torch"] == per_layer * steps * port.cfg.num_layers, op


# --------------------------------------------------------------------------
# ChunkedPrefill(jit=)
# --------------------------------------------------------------------------
def _admissions(adm, pool, prompts):
    """Three admissions through a ChunkedPrefill of chunk 5 on a pool of
    4-token pages: the first two blocking (the second aliases the first's
    prefix and copies a shared partial page on write), the third stepped.
    Returns the last-token logits of each."""
    out = [adm.run(slot, p, len(p) + 8) for slot, p in enumerate(prompts[:2])]
    adm.begin(2, prompts[2], 12)
    done = {}
    while 2 not in done:
        done.update(adm.step())
    return np.stack(out + [done[2]])


def _shared_prompts(vocab):
    rng = np.random.default_rng(3)
    sys_p = rng.integers(0, vocab, 10)
    return (sys_p, np.concatenate([sys_p, rng.integers(0, vocab, 6)]),
            rng.integers(0, vocab, 7))


@pytest.mark.parametrize("ref_jit", [True, False], ids=["ref-jit", "ref-eager"])
def test_chunked_prefill_jit_equals_eager_and_reference(models, ref_jit):
    """ChunkedPrefill(jit=True) gives jit=False's logits and pool contents
    exactly (the same eager code on the CPU) and counts one
    prefill_chunk.eager per chunk step; both equal the reference's
    ChunkedPrefill(jit=ref_jit) on the same weights and pool (the
    reference's model tolerance, atol 1e-3)."""
    from repro.models import kv_pages as rkv
    from repro_torch.models import kv_pages as tkv
    _, ref, params, port, tparams = models
    prompts = _shared_prompts(port.cfg.vocab_size)
    kw = dict(paged=True, page_size=4)
    runs = {}
    for jit in (True, False):
        pool = port.init_cache(3, 40, "cpu", **kw)
        adm = tkv.ChunkedPrefill(port, tparams, pool, chunk=5, jit=jit)
        ops.reset_dispatch_counts()
        runs[jit] = _admissions(adm, pool, prompts), pool, ops.dispatch_counts()
    rpool = ref.init_cache(3, 40, **kw)
    want = _admissions(rkv.ChunkedPrefill(ref, params, rpool, chunk=5, jit=ref_jit), rpool,
                       prompts)
    np.testing.assert_array_equal(runs[True][0], runs[False][0])
    for a, b in zip((*runs[True][1].k, *runs[True][1].v), (*runs[False][1].k, *runs[False][1].v)):
        assert torch.equal(a, b)
    np.testing.assert_allclose(runs[True][0], want, atol=ATOL)
    # chunks of 5: the first prompt's 10 tokens in 2, the second's 6 past its
    # 10 shared tokens in 2, the third's 7 in 2
    counts = runs[True][2]
    steps = counts["prefill_chunk.eager"]
    assert steps == 2 + 2 + 2 and runs[True][1].cow_copies == rpool.cow_copies >= 1
    assert not any(k.startswith("prefill_chunk.") for k in runs[False][2])
    kernels = {k: v for k, v in counts.items() if not k.startswith("prefill_chunk.")}
    assert kernels == runs[False][2]


# --------------------------------------------------------------------------
# CapturedStep routing on the CPU
# --------------------------------------------------------------------------
def test_captured_step_routes_by_device():
    calls = []

    def fn(a, b):
        calls.append(1)
        return a + b

    step = capture.CapturedStep(fn, "probe")
    ops.reset_dispatch_counts()
    x = torch.ones(3)
    assert torch.equal(step(x, x, key=(1, 2)), 2 * x)
    assert ops.dispatch_counts() == {"probe.eager": 1} and step.graphs == 0
    with pytest.raises(ValueError, match="probe"):
        step(torch.empty(3, device="meta"), torch.empty(3, device="meta"))
    assert len(calls) == 1 and ops.dispatch_counts() == {"probe.eager": 1}


# --------------------------------------------------------------------------
# the launcher's --jit flag
# --------------------------------------------------------------------------
@pytest.mark.parametrize("flag", ["--jit", "--no-jit"])
def test_launcher_jit_flag_reaches_backend_config(monkeypatch, capsys, flag):
    seen = []

    def recording(config, model, params):
        seen.append(config)
        return api.make_backend(config, model, params)

    monkeypatch.setattr(launch_serve, "make_backend", recording)
    ops.reset_dispatch_counts()
    launch_serve.main(["--arch", "granite-3-2b", "--smoke", "--device", "cpu",
                       "--backend", "dense", "--prompt-len", "4", "--new-tokens", "3", flag])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jit = flag == "--jit"
    assert len(seen) == 1 and seen[0].jit is jit
    assert report["kernel_dispatch"].get("serve_step.eager", 0) == (2 if jit else 0)


# --------------------------------------------------------------------------
# make_backend's deprecated keyword form (tests/test_scheduling.py twins)
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mixtral_port():
    port = build_model(_mixtral(get_config, smoke_variant))
    return port, port.init(0, device="cpu")


def test_make_backend_legacy_kwargs_deprecated_and_equivalent(mixtral_port):
    m, params = mixtral_port
    with pytest.warns(DeprecationWarning):
        old = api.make_backend("dense", m, params, jit=False, paged=True, page_size=32,
                               kv_pages=24, prefill_chunk=16, prefix_sharing=False)
    new = api.make_backend(api.BackendConfig(
        kind="dense", jit=False, paged=True, page_size=32, kv_pages=24,
        prefill_chunk=16, prefix_sharing=False), m, params)
    for attr in ("paged", "page_size", "kv_pages", "prefill_chunk",
                 "prefix_sharing", "_jit"):
        assert getattr(old, attr) == getattr(new, attr), attr
    assert old._jit is False and old._step is None

    ecfg = EngineConfig(hi_slots=4, lo_slots=2)
    with pytest.warns(DeprecationWarning):
        old_h = api.make_backend("hobbit", m, params, engine_config=ecfg)
    new_h = api.make_backend(api.BackendConfig(kind="hobbit", engine=ecfg), m, params)
    try:
        assert old_h.engine.ecfg == new_h.engine.ecfg
    finally:
        old_h.close()
        new_h.close()


def test_make_backend_rejects_config_plus_kwargs(mixtral_port):
    m, params = mixtral_port
    with pytest.raises(TypeError):
        api.make_backend(api.BackendConfig(), m, params, paged=True)
    with pytest.raises(TypeError):
        api.make_backend(api.BackendConfig(), m, params, jit=False)


def test_make_backend_default_config_captures(mixtral_port):
    m, params = mixtral_port
    assert api.BackendConfig().jit is True
    assert api.make_backend("dense", m, params)._jit is True


# --------------------------------------------------------------------------
# the reference's package names
# --------------------------------------------------------------------------
@pytest.mark.parametrize("pkg", ["core", "models"])
def test_reference_package_names_import_from_the_port(pkg):
    import importlib
    ref = {"core": ref_core, "models": ref_models}[pkg]
    port = importlib.import_module(f"repro_torch.{pkg}")
    # AsyncExpertScheduler was removed by design (StagingEngine(streams=1,
    # ordered=True) takes its place), and TPU_V5E_HOST is the reference's
    # host model for a TPU (the port's is H100_HOST, measured on its card)
    want = set(ref.__all__) - {"AsyncExpertScheduler", "TPU_V5E_HOST"}
    assert want <= set(port.__all__)
    for name in want:
        assert getattr(port, name) is not None, name


@pytest.mark.parametrize("shape", [(6, 32), (5, 3, 16)], ids=["tokenwise", "averaged"])
@pytest.mark.parametrize("max_dist", [1, 3])
def test_gating_input_similarity_matches_reference(shape, max_dist):
    rng = np.random.default_rng(sum(shape) + max_dist)
    base = rng.standard_normal(shape[1:])
    # a slowly drifting residual stream, as the predictor assumes
    h = np.stack([base + 0.3 * i * rng.standard_normal(shape[1:]) for i in range(shape[0])])
    want = ref_similarity(h.astype(np.float32), max_dist)
    got = gating_input_similarity(h.astype(np.float32), max_dist)
    assert got == want and sorted(got) == list(range(1, max_dist + 1))


# --------------------------------------------------------------------------
# nothing a captured step runs reads back to the host
# --------------------------------------------------------------------------
_HOST_READS = {"item", "cpu", "tolist", "nonzero", "numpy", "synchronize"}


def _assert_no_host_reads(tree, where: str) -> None:
    import ast
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            name = node.func.attr
            assert name not in _HOST_READS, f"{where}:{node.lineno} calls .{name}()"
            owner = node.func.value
            assert not (name == "tensor" and isinstance(owner, ast.Name)
                        and owner.id == "torch"), f"{where}:{node.lineno} torch.tensor()"


@pytest.mark.parametrize("module", ["models/layers.py", "models/moe.py", "models/model.py",
                                    "models/ssm.py", "kernels/ops.py", "capture.py"])
def test_captured_code_has_no_host_reads(module):
    """The decode steps and segments run inside a CUDA-graph capture on the
    card, where a host read (or a host scalar copied to the card with
    torch.tensor) fails the capture: none in the modules they run."""
    import ast
    import pathlib
    path = pathlib.Path(capture.__file__).parent / module
    _assert_no_host_reads(ast.parse(path.read_text()), module)


@pytest.mark.parametrize("module,function", [
    ("core/engine.py", "grouped_ffn"),
    ("core/engine.py", "OffloadEngine._ffn"),
    ("core/engine.py", "OffloadEngine._layer_segment"),
    ("core/engine.py", "OffloadEngine._attn_layer"),
    ("core/engine.py", "OffloadEngine._embed"),
    ("core/engine.py", "OffloadEngine._logits"),
    ("core/engine.py", "OffloadEngine._attn_segment"),
    ("core/engine.py", "OffloadEngine._hi_expert"),
    ("core/engine.py", "OffloadEngine._lo_expert"),
    ("models/kv_pages.py", "ChunkedPrefill._prefill_chunk"),
    ("models/model.py", "Model.prefill_entries"),
    ("serving/api.py", "DenseBackend._decode"),
    ("models/prefill.py", "DenseKVPrefill._entries"),
])
def test_captured_functions_have_no_host_reads(module, function):
    """The functions captured from modules that also hold host code (the
    engine's segments, grouped FFN and single experts, the chunked-prefill
    step, the one-shot prefill's forward, the dense backend's decode step)
    read nothing back to the host either."""
    import ast
    import pathlib
    tree = ast.parse((pathlib.Path(capture.__file__).parent / module).read_text())
    scope = tree.body
    for part in function.split("."):
        node = next(n for n in scope if isinstance(n, (ast.ClassDef, ast.FunctionDef))
                    and n.name == part)
        scope = node.body
    _assert_no_host_reads(node, f"{module}:{function}")
