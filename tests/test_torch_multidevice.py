"""The port's sharded steps on 8 CPU processes (gloo), a 2x4 (data, model)
mesh, against the single-device steps: the port's counterpart of the JAX
package's tests/test_multidevice.py (same model, batch and bounds).

One run of 8 rank processes holds:
  * the sharded train step (training rules, remat) to the single-device
    step: loss within 1e-4, every updated parameter within 5e-4;
  * the sharded prefill and decode step (decode rules, cache layouts from
    ``sharding.cache_shardings``) to the single-device logits within 1e-4,
    at batch 8 and at batch 1, where the cache's sequence is split over the
    data axis (the long_500k layout) and each decode write lands on the
    rank holding its position;
  * a train step whose MoE layers dispatch in 2 groups (1024 tokens,
    capacity factor 8: no drops either way) to the single-device step;
  * the grouped MoE dispatch at 1024 tokens, where the mesh's 2 data shards
    make 2 groups of 512: rank 0 writes the output, which the test holds to
    the reference's ``moe_forward(groups=2)`` on the same weights and input
    within 1e-5, and to the port's own ``moe_forward(groups=2)``.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

WORLD = 8

_WORKER = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, store_path, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, 8)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=8)

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import moe as moe_lib, shard_utils
    from repro_torch.models.model import Batch, Model
    from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.training.train_loop import TrainState, make_train_step
    from repro_torch.weights import tree_leaves, tree_map

    cfg = smoke_variant(get_config("mixtral-8x7b"), layers=2, d_model=128, vocab=512)
    cfg = dataclasses.replace(cfg, dtype="float32")
    model = Model(cfg)
    mesh = make_production_mesh(device_type="cpu", shape=(2, 4))
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, 512, (8, 32)).astype(np.int32))
    mask = torch.ones((8, 32), dtype=torch.float32)
    res = {}

    def batch_of(mesh_or_none):
        if mesh_or_none is None:
            return Batch(tokens, mask)
        dist_ = lambda t: sh.distribute(mesh, t, sh.fit_spec(mesh, tuple(t.shape), ("data",)))
        return Batch(dist_(tokens), dist_(mask))

    def full(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    # ---- train step
    step = make_train_step(model, ocfg, remat=True)
    if rank == 0:
        params = model.init(0, device="cpu")
        s_ref, m_ref = step(TrainState(params, init_opt_state(params)), batch_of(None))
        ref_leaves = tree_leaves(s_ref.params)
        res["loss_ref"] = float(m_ref["loss"])
    params = model.init(0, device="cpu")
    specs = sh.param_shardings(mesh, params)
    dparams = sh.distribute_tree(mesh, params, specs)
    opt = init_opt_state(params)
    dopt = type(opt)(opt.step, sh.distribute_tree(mesh, opt.mu, specs),
                     sh.distribute_tree(mesh, opt.nu, specs))
    sstep = make_train_step(model, ocfg, remat=True, mesh=mesh)
    s_sp, m_sp = sstep(TrainState(dparams, dopt), batch_of(mesh))
    loss_sp = float(full(m_sp["loss"]))
    sp_leaves = [full(t) for t in tree_leaves(s_sp.params)]
    sharded = sum(any(not p.is_replicate() for p in t.placements)
                  for t in tree_leaves(s_sp.params))
    if rank == 0:
        res["loss_sp"] = loss_sp
        res["max_param_diff"] = max(float((a - b).abs().max())
                                    for a, b in zip(ref_leaves, sp_leaves))
        res["sharded_leaves"] = sharded

    # ---- prefill + decode step
    params = model.init(1, device="cpu")
    nxt = torch.from_numpy(rng.integers(0, 512, (8, 1)).astype(np.int32))
    with torch.no_grad():
        if rank == 0:
            last_ref, cache, pos = model.prefill(params, batch_of(None), 48)
            dec_ref = model.decode_step(params, cache, nxt, torch.from_numpy(pos))
        dparams = sh.distribute_params(mesh, params, mode="decode")
        with shard_utils.mesh_scope(mesh):
            last_sp, dcache, pos = model.prefill(dparams, batch_of(mesh), 48)
            layouts = [{k: tuple(map(str, v.placements)) for k, v in c.items()}
                       for c in dcache]
            posd = sh.distribute(mesh, torch.from_numpy(pos), ("data",))
            tokd = sh.distribute(mesh, nxt, ("data", None))
            dec_sp = model.decode_step(dparams, dcache, tokd, posd)
        last_sp, dec_sp = full(last_sp), full(dec_sp)
    if rank == 0:
        res["prefill_diff"] = float((last_ref - last_sp).abs().max())
        res["decode_diff"] = float((dec_ref - dec_sp).abs().max())
        res["cache_layout"] = layouts[0]

    # ---- one row (B = 1, the long-context layout): the cache's sequence
    # split over the data axis, each decode write on the rank holding it
    with torch.no_grad():
        one = Batch(tokens[:1], mask[:1])
        if rank == 0:
            last1, cache1, pos1 = model.prefill(params, one, 64)
            dec1 = model.decode_step(params, cache1, nxt[:1], torch.from_numpy(pos1))
        with shard_utils.mesh_scope(mesh):
            lastd, dcache1, pos1 = model.prefill(dparams, Batch(
                sh.distribute(mesh, tokens[:1], ()), sh.distribute(mesh, mask[:1], ())), 64)
            layout1 = tuple(map(str, dcache1[0]["k"].placements))
            decd = model.decode_step(dparams, dcache1, sh.distribute(mesh, nxt[:1], ()),
                                     sh.distribute(mesh, torch.from_numpy(pos1), ()))
        lastd, decd = full(lastd), full(decd)
    if rank == 0:
        res["b1_prefill_diff"] = float((last1 - lastd).abs().max())
        res["b1_decode_diff"] = float((dec1 - decd).abs().max())
        res["b1_layout"] = layout1

    # ---- a train step whose MoE layers dispatch in 2 groups (8 x 128
    # tokens); capacity factor 8, so neither 1 nor 2 groups drop a token
    gcfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    gmodel = Model(gcfg)
    gtok = torch.from_numpy(rng.integers(0, 512, (8, 128)).astype(np.int32))
    gbatch = Batch(gtok, torch.ones((8, 128)))
    if rank == 0:
        params = gmodel.init(3, device="cpu")
        g_ref, gm_ref = make_train_step(gmodel, ocfg, remat=True)(
            TrainState(params, init_opt_state(params)), gbatch)
        gref = tree_leaves(g_ref.params)
    params = gmodel.init(3, device="cpu")
    opt = init_opt_state(params)
    gstate = TrainState(sh.distribute_tree(mesh, params, specs),
                        type(opt)(opt.step, sh.distribute_tree(mesh, opt.mu, specs),
                                  sh.distribute_tree(mesh, opt.nu, specs)))
    g_sp, gm_sp = make_train_step(gmodel, ocfg, remat=True, mesh=mesh)(
        gstate, Batch(*(sh.distribute(mesh, f, ("data",)) for f in gbatch[:2])))
    gloss = float(full(gm_sp["loss"]))
    gsp = [full(t) for t in tree_leaves(g_sp.params)]
    if rank == 0:
        res["g2_loss_ref"], res["g2_loss_sp"] = float(gm_ref["loss"]), gloss
        res["g2_param_diff"] = max(float((a - b).abs().max()) for a, b in zip(gref, gsp))

    # ---- grouped dispatch: 1024 tokens, 2 data shards -> 2 groups of 512;
    # capacity factor 0.5, so each group drops tokens
    params = model.init(2, device="cpu")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    ffn = params["layers"][0]["ffn"]
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((8, 128, 128))
                         .astype(np.float32))
    dffn = sh.distribute_params(mesh, {"layers": [{"ffn": ffn}]})["layers"][0]["ffn"]
    with torch.no_grad(), shard_utils.mesh_scope(mesh):
        xd = sh.distribute(mesh, x, ("data", None, None))
        groups = 1024 // 512 if shard_utils.dp_size() == 2 else None
        y_sp, aux_sp = moe_lib.moe_forward(dffn, xd, cfg)
        y_sp, aux_sp = full(y_sp), full(aux_sp)
    if rank == 0:
        res["groups"] = groups
        np.savez(out_path + ".npz", y=y_sp.numpy(), aux=float(aux_sp), x=x.numpy(),
                 router=ffn["router"].numpy(), wi=ffn["experts"]["wi"].numpy(),
                 wo=ffn["experts"]["wo"].numpy())
        with open(out_path, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mdev")
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    out = str(tmp / "res.json")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(tmp / "store"), out],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(WORLD)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        errs.append((p.returncode, err))
    bad = [(i, rc, e[-3000:]) for i, (rc, e) in enumerate(errs) if rc != 0]
    assert not bad, bad[0]
    with open(out) as f:
        res = json.load(f)
    return res, dict(np.load(out + ".npz"))


def test_sharded_train_step_matches_single_device(run):
    res, _ = run
    assert res["sharded_leaves"] > 0
    assert abs(res["loss_ref"] - res["loss_sp"]) < 1e-4, res
    assert res["max_param_diff"] < 5e-4, res


def test_sharded_decode_step_matches_single_device(run):
    res, _ = run
    # batch over data, the 4 kv heads over the 4-way model axis
    assert res["cache_layout"]["k"] == ["S(0)", "S(2)"], res
    assert res["prefill_diff"] < 1e-4, res
    assert res["decode_diff"] < 1e-4, res


def test_one_row_context_parallel_decode_matches_single_device(run):
    res, _ = run
    # B = 1 does not divide the data axis: the sequence takes it (context
    # parallel) and the 4 kv heads the model axis
    assert res["b1_layout"] == ["S(1)", "S(2)"], res["b1_layout"]
    assert res["b1_prefill_diff"] < 1e-4, res
    assert res["b1_decode_diff"] < 1e-4, res


def test_sharded_train_step_with_two_dispatch_groups(run):
    res, _ = run
    assert abs(res["g2_loss_ref"] - res["g2_loss_sp"]) < 1e-4, res
    assert res["g2_param_diff"] < 5e-4, res


def test_grouped_dispatch_matches_reference_groups_2(run):
    import dataclasses

    import jax.numpy as jnp
    import torch

    from repro.configs import get_config as jget, smoke_variant as jsmoke
    from repro.models import moe as jmoe
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models import moe as moe_lib

    res, arrs = run
    assert res["groups"] == 2
    jcfg = dataclasses.replace(jsmoke(jget("mixtral-8x7b"), layers=2, d_model=128, vocab=512),
                               dtype="float32")
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=0.5))
    p = {"router": jnp.asarray(arrs["router"]),
         "experts": {"wi": jnp.asarray(arrs["wi"]), "wo": jnp.asarray(arrs["wo"])}}
    y_ref, aux_ref, _ = jmoe.moe_forward(p, jnp.asarray(arrs["x"]), jcfg, groups=2)
    y_ref = np.asarray(y_ref)
    np.testing.assert_allclose(arrs["y"], y_ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(arrs["aux"], float(aux_ref), atol=1e-6, rtol=0)
    # capacity per group: the 2-group result differs from one group of 1024
    y_one, _, _ = jmoe.moe_forward(p, jnp.asarray(arrs["x"]), jcfg, groups=1)
    assert np.abs(np.asarray(y_one) - y_ref).max() > 1e-3
    # the port's plain grouped path (no mesh) gives the same
    cfg = dataclasses.replace(smoke_variant(get_config("mixtral-8x7b"), layers=2,
                                            d_model=128, vocab=512), dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    tp = {"router": torch.from_numpy(arrs["router"]),
          "experts": {"wi": torch.from_numpy(arrs["wi"]), "wo": torch.from_numpy(arrs["wo"])}}
    y2, _ = moe_lib.moe_forward(tp, torch.from_numpy(arrs["x"]), cfg, groups=2)
    np.testing.assert_allclose(y2.numpy(), y_ref, atol=1e-5, rtol=0)
