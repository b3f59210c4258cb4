"""Training in the port (ROADMAP Queue 1, item 8) against the JAX reference:
the optimizer, the train loop, gradient accumulation, bf16 moments,
checkpoints both ways and the launcher.

* ``lr_at`` over warm-up and cosine within rel 1e-6; ``init_opt_state``.
* ``apply_updates`` fed the reference's own gradients (DeepSeek-V2 with its
  dense prefix layer, Jamba's 8-layer period, Whisper's encoder; every
  leaf perturbed from a numpy seed so that decay shows on norm scales)
  matches the reference's new parameters and moments over two steps
  within 1e-6; ``decay_mask`` decays every leaf of a layer in the
  reference's scanned blocks and no 1-D leaf of a prefix layer, the
  encoder or ``final_norm``.
* 20-step loss curves of ``train`` within 1e-3 of the reference's for the
  Mixtral, Granite and Whisper smoke models (d_model 64, float32, the same
  data pipeline; seeded frames for Whisper); bf16 moments (Mixtral): the
  update bit-identical to the reference's run op by op, and training.
* ``make_train_step(microbatches=2)``: the loss, grad norm and first
  moments equal the reference's microbatched step (1e-6), and, for the
  dense Granite (a MoE's capacity and aux loss are per microbatch), the
  port's monolithic step.
* Checkpoints: the port's ``save`` of bf16 and float32 models (Whisper,
  Jamba, DeepSeek-V2) restores through the reference's ``restore`` into
  ``Model.init``'s tree bit for bit; the reference's ``save`` restores
  through the port's; save / restore in the port is bit-identical; a
  shape mismatch raises on either side.
* ``python -m repro_torch.launch.train --smoke --device cpu`` prints the
  reference's history keys last and writes a checkpoint the reference
  restores; Whisper trains through it with seeded frames.
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
from repro.data import pipeline as ref_pipeline
from repro.models import build_model as build_ref
from repro.training import checkpoint as ref_ckpt
from repro.training import optimizer as ref_opt
from repro.training import train_loop as ref_loop
from repro.training.checkpoint import _path_str
from repro_torch.configs import get_config, smoke_variant
from repro_torch.data import pipeline
from repro_torch.models import build_model
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import TrainState, make_train_step, train
from repro_torch.weights import from_jax_params, to_jax_params, tree_flatten, tree_leaves, \
    tree_map

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HISTORY_KEYS = {"loss", "nll", "aux", "tokens", "grad_norm", "lr", "step", "wall_s"}
CURVE_ATOL = 1e-3


def _cfgs(arch, dtype="float32", d_model=64):
    """(reference config, port config): the smoke variant at d_model."""
    return tuple(dataclasses.replace(smoke(get(arch), d_model=d_model), dtype=dtype).validate()
                 for get, smoke in ((ref_get_config, ref_smoke_variant),
                                    (get_config, smoke_variant)))


def _pair(arch, dtype="float32", seed=0, d_model=64):
    """(reference model, its params, port model, the same params in the port)."""
    rcfg, tcfg = _cfgs(arch, dtype, d_model)
    ref, port = build_ref(rcfg), build_model(tcfg)
    params = ref.init(jax.random.PRNGKey(seed))
    return ref, params, port, _port_params(tcfg, params)


def _port_params(cfg, params):
    return from_jax_params(cfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")


def _flat(tree):
    """{path: float32 numpy} of a reference-layout tree (jax or torch leaves)."""
    if isinstance(tree, dict) and "layers" in tree:
        raise TypeError("a port tree: map it with to_jax_params first")
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        a = leaf.to(torch.float32).numpy() if isinstance(leaf, torch.Tensor) else \
            np.asarray(jnp.asarray(leaf).astype(jnp.float32))
        out[_path_str(path)] = a
    return out


def _frames(cfg, b, seed=0):
    return (np.random.default_rng(seed).normal(size=(b, cfg.encoder.seq_len,
                                                     cfg.encoder.d_model)) * 0.02
            ).astype(np.float32)


# --------------------------------------------------------------------------
# the optimizer
# --------------------------------------------------------------------------
@pytest.mark.parametrize("step", [0, 1, 5, 99, 100, 101, 500, 9_999, 10_000, 20_000])
def test_lr_schedule_matches_reference(step):
    want = float(ref_opt.lr_at(ref_opt.OptimizerConfig(), step))
    np.testing.assert_allclose(opt.lr_at(opt.OptimizerConfig(), step), want, rtol=1e-6)


def test_init_opt_state_shapes_and_dtypes():
    _, _, port, tparams = _pair("mixtral-8x7b")
    for dt, want in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        st = opt.init_opt_state(tparams, dt)
        assert st.step == 0
        for p, m, v in zip(*(tree_leaves(t) for t in (tparams, st.mu, st.nu))):
            assert m.shape == v.shape == p.shape and m.dtype == v.dtype == want
            assert not m.any() and not v.any()


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "whisper-tiny", "jamba-v0.1-52b"])
def test_decay_mask_follows_reference_layout(arch):
    ref, params, port, tparams = _pair(arch)
    mask = opt.decay_mask(port.cfg, tparams)
    stacked = to_jax_params(port.cfg, tree_map(lambda d: torch.tensor(d), mask))
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        got = _flat(stacked)[_path_str(path)]
        assert bool(got.all()) == bool(got.any()) == (leaf.ndim >= 2), _path_str(path)
    cfg = port.cfg
    np_ = len(cfg.prefix_pattern)
    assert mask["final_norm"]["scale"] is False
    assert all(mask["layers"][i]["pre_norm"]["scale"] is False for i in range(np_))
    assert all(mask["layers"][i]["pre_norm"]["scale"] is True
               for i in range(np_, np_ + cfg.num_blocks * cfg.period))
    if cfg.encoder is not None:
        assert all(m is False for lp in mask["encoder"]["layers"]
                   for m in tree_leaves(lp["norm1"]))


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "whisper-tiny", "jamba-v0.1-52b"])
def test_apply_updates_matches_reference(arch):
    ref, params, port, _ = _pair(arch)
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + rng.normal(size=a.shape).astype(np.float32) * 0.1),
        params)
    grads = [jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32) * s), params)
        for s in (1e-2, 3e-3)]
    ocfg = dict(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.1)
    tparams = _port_params(port.cfg, params)
    state_r, state_t = ref_opt.init_opt_state(params), opt.init_opt_state(tparams)
    decay = opt.decay_mask(port.cfg, tparams)
    for g in grads:
        params, state_r, met_r = ref_opt.apply_updates(ref_opt.OptimizerConfig(**ocfg), params,
                                                       g, state_r)
        tg = _port_params(port.cfg, g)
        _, state_t, met_t = opt.apply_updates(opt.OptimizerConfig(**ocfg), tparams, tg,
                                              state_t, decay=decay)
        np.testing.assert_allclose(float(met_t["grad_norm"]), float(met_r["grad_norm"]),
                                   rtol=1e-6)
        for got, want in ((tparams, params), (state_t.mu, state_r.mu),
                          (state_t.nu, state_r.nu)):
            g_flat, w_flat = _flat(to_jax_params(port.cfg, got)), _flat(want)
            assert sorted(g_flat) == sorted(w_flat)
            for k, w in w_flat.items():
                np.testing.assert_allclose(g_flat[k], w, rtol=0, atol=1e-6, err_msg=k)
    assert state_t.step == int(state_r.step) == 2


# --------------------------------------------------------------------------
# the loop: loss curves, bf16 moments, microbatches
# --------------------------------------------------------------------------
def _curves(arch, steps=20, moment_dtype="float32"):
    ref, params, port, tparams = _pair(arch)
    dc = dict(vocab_size=port.cfg.vocab_size, seq_len=32, batch_size=4)
    ocfg = dict(lr=1e-3, warmup_steps=2, total_steps=steps, moment_dtype=moment_dtype)
    it_r = ref_pipeline.batches(ref_pipeline.DataConfig(**dc))
    it_t = pipeline.batches(pipeline.DataConfig(**dc), device="cpu")
    if port.cfg.encoder is not None:
        it_r = (b._replace(audio_frames=jnp.asarray(_frames(port.cfg, 4, i)))
                for i, b in enumerate(it_r))
        it_t = (b._replace(audio_frames=torch.from_numpy(_frames(port.cfg, 4, i)))
                for i, b in enumerate(it_t))
    quiet = lambda *_: None  # noqa: E731
    _, hist_r = ref_loop.train(ref, ref_opt.OptimizerConfig(**ocfg), it_r, steps, log_every=1,
                               state=ref_loop.TrainState(params, ref_opt.init_opt_state(params)),
                               log=quiet)
    state, hist_t = train(port, opt.OptimizerConfig(**ocfg), it_t, steps, log_every=1,
                          state=TrainState(tparams, opt.init_opt_state(tparams, moment_dtype)),
                          device="cpu", log=quiet)
    return hist_r, hist_t, state


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "granite-3-2b", "whisper-tiny"])
def test_loss_curve_matches_reference(arch):
    hist_r, hist_t, state = _curves(arch)
    assert state.opt.step == 20 and len(hist_t) == len(hist_r) == 20
    assert set(hist_t[-1]) == set(hist_r[-1]) == HISTORY_KEYS
    lr, lt = np.array([h["loss"] for h in hist_r]), np.array([h["loss"] for h in hist_t])
    np.testing.assert_allclose(lt, lr, rtol=0, atol=CURVE_ATOL)
    assert lt[-1] < lt[0]
    for k in ("lr", "tokens"):
        np.testing.assert_allclose([h[k] for h in hist_t], [h[k] for h in hist_r], rtol=1e-6)


def test_bf16_moments_update_matches_reference_and_trains():
    """moment_dtype="bfloat16": the whole update in bf16, every scalar
    rounded to bf16 first.  Two updates bit-identical to the reference's
    apply_updates run op by op (jitted, XLA fuses the bf16 chain and keeps
    float32 between its ops, which moves a parameter by up to one bf16 ulp
    of its update from the op-by-op result); then 8 steps of training lower
    the loss with bf16 moments."""
    ref, params, port, tparams = _pair("mixtral-8x7b")
    rng = np.random.default_rng(3)
    ocfg = dict(lr=1e-2, warmup_steps=1, total_steps=10, moment_dtype="bfloat16")
    state_r, state_t = ref_opt.init_opt_state(params), opt.init_opt_state(tparams, "bfloat16")
    for s in (1e-2, 3e-3):
        g = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32) * s), params)
        params, state_r, _ = ref_opt.apply_updates(ref_opt.OptimizerConfig(**ocfg), params, g,
                                                   state_r)
        _, state_t, _ = opt.apply_updates(opt.OptimizerConfig(**ocfg), tparams,
                                          _port_params(port.cfg, g), state_t,
                                          decay=opt.decay_mask(port.cfg, tparams))
        for got, want in ((tparams, params), (state_t.mu, state_r.mu),
                          (state_t.nu, state_r.nu)):
            g_flat = _flat(to_jax_params(port.cfg, got))
            for k, w in _flat(want).items():
                assert np.array_equal(g_flat[k], w), k
    _, hist_t, state = _curves("mixtral-8x7b", steps=8, moment_dtype="bfloat16")
    assert all(m.dtype == torch.bfloat16 for m in tree_leaves(state.opt.mu))
    lt = np.array([h["loss"] for h in hist_t])
    assert np.isfinite(lt).all() and lt[-1] < lt[0]


@pytest.mark.parametrize("arch", ["granite-3-2b", "mixtral-8x7b"])
def test_microbatches_match_reference_and_monolithic(arch):
    ref, params, port, _ = _pair(arch)
    dc = dict(vocab_size=port.cfg.vocab_size, seq_len=32, batch_size=4)
    rb = next(ref_pipeline.batches(ref_pipeline.DataConfig(**dc)))
    tb = next(pipeline.batches(pipeline.DataConfig(**dc), device="cpu"))
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    step_r = jax.jit(ref_loop.make_train_step(ref, ref_opt.OptimizerConfig(**ocfg),
                                              microbatches=2))
    st_r, met_r = step_r(ref_loop.TrainState(params, ref_opt.init_opt_state(params)), rb)
    runs = {}
    for mb in (1, 2):
        tparams = _port_params(port.cfg, params)
        st, met = make_train_step(port, opt.OptimizerConfig(**ocfg), microbatches=mb)(
            TrainState(tparams, opt.init_opt_state(tparams)), tb)
        runs[mb] = (st, met)
    st_t, met_t = runs[2]
    for k in ("loss", "nll", "aux", "tokens", "grad_norm", "lr"):
        np.testing.assert_allclose(float(met_t[k]), float(met_r[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    mu_t, mu_r = _flat(to_jax_params(port.cfg, st_t.opt.mu)), _flat(st_r.opt.mu)
    for k, w in mu_r.items():
        np.testing.assert_allclose(mu_t[k], w, rtol=0, atol=1e-6, err_msg=k)
    if port.cfg.moe is None:        # a dense model: the same step either way
        st_1, met_1 = runs[1]
        for k in ("loss", "nll", "grad_norm"):
            np.testing.assert_allclose(float(met_1[k]), float(met_t[k]), rtol=1e-5, err_msg=k)
        mu_1 = _flat(to_jax_params(port.cfg, st_1.opt.mu))
        for k, w in mu_1.items():
            np.testing.assert_allclose(mu_t[k], w, rtol=0, atol=1e-6, err_msg=k)


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch,dtype", [("whisper-tiny", "bfloat16"),
                                        ("jamba-v0.1-52b", "bfloat16"),
                                        ("deepseek-v2-236b", "float32")])
def test_port_checkpoint_restores_in_reference(arch, dtype, tmp_path):
    ref, params, port, tparams = _pair(arch, dtype, seed=1)
    _, _, _, trained = _pair(arch, dtype, seed=2)       # other values than `params`
    path = ckpt.save(str(tmp_path), trained, step=7, cfg=port.cfg)
    assert path.endswith("step_7.npz") and ckpt.latest_step(str(tmp_path)) == 7
    got, step = ref_ckpt.restore(str(tmp_path), params)
    assert step == 7
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(params)
    want = tree_flatten(to_jax_params(port.cfg, trained))
    for (path_, leaf), (name, w) in zip(jax.tree_util.tree_flatten_with_path(got)[0], want):
        assert _path_str(path_) == name
        assert leaf.dtype == jnp.dtype(str(w.dtype).replace("torch.", ""))
        assert np.array_equal(np.asarray(jnp.asarray(leaf).astype(jnp.float32)),
                              w.to(torch.float32).numpy()), name
    # the port restores its own checkpoint bit for bit
    back, _ = ckpt.restore(str(tmp_path), tparams, cfg=port.cfg)
    for a, b in zip(tree_leaves(back), tree_leaves(trained)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_reference_checkpoint_restores_in_port(tmp_path):
    ref, params, port, tparams = _pair("whisper-tiny", "bfloat16", seed=1)
    trained = build_ref(ref.cfg).init(jax.random.PRNGKey(9))
    ref_ckpt.save(str(tmp_path), trained, step=3)
    got, step = ckpt.restore(str(tmp_path), tparams, cfg=port.cfg)
    want = _port_params(port.cfg, trained)
    assert step == 3
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_shape_mismatch_raises(tmp_path):
    _, params, port, tparams = _pair("mixtral-8x7b")
    ckpt.save(str(tmp_path), tparams, step=1, cfg=port.cfg)
    other_ref, other_params, other, other_tparams = _pair("mixtral-8x7b", d_model=32)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), other_tparams, cfg=other.cfg)
    with pytest.raises(ValueError, match="shape"):
        ref_ckpt.restore(str(tmp_path), other_params)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), tparams, cfg=port.cfg)


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------
def _launch(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args,
                          "--device", "cpu"], capture_output=True, text=True, env=env,
                         timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout.strip().splitlines()


def test_train_launcher_prints_reference_keys_and_checkpoint(tmp_path):
    out = _launch("--arch", "mixtral-8x7b", "--smoke", "--steps", "4", "--batch", "2",
                  "--seq", "16", "--eval-every", "2", "--ckpt-dir", str(tmp_path))
    last = json.loads(out[-1])
    assert set(last) == HISTORY_KEYS | {"eval_nll"} and last["step"] == 3
    assert np.isfinite(last["loss"]) and np.isfinite(last["eval_nll"])
    assert out[0].startswith("arch=mixtral-8x7b-smoke params=")
    assert any(line.startswith("checkpoint: ") for line in out)
    rcfg = dataclasses.replace(ref_smoke_variant(ref_get_config("mixtral-8x7b")),
                               dtype="float32")
    restored, step = ref_ckpt.restore(str(tmp_path), build_ref(rcfg).init(jax.random.PRNGKey(0)))
    assert step == 4 and all(np.isfinite(np.asarray(x)).all()
                             for x in jax.tree_util.tree_leaves(restored))


def test_train_launcher_trains_whisper():
    last = json.loads(_launch("--arch", "whisper-tiny", "--smoke", "--steps", "2",
                              "--batch", "2", "--seq", "16")[-1])
    assert set(last) == HISTORY_KEYS and np.isfinite(last["loss"])
