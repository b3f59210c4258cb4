"""The port's sharding rules, op analysis, roofline and dry-run sizing held
to the JAX package's (``launch/sharding.py``, ``hlo_analysis.py``,
``roofline.py``, ``specs.py``, ``configs``).

Parameter shapes are full width on both sides: ``jax.eval_shape`` of the
reference's init, the port's init under a ``FakeTensorMode``.  The meshes
are duck-typed (the reference's rules read only ``mesh.shape`` and
``mesh.axis_names``; its ``NamedSharding`` is patched to return the spec).
"""

import dataclasses
import math
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import INPUT_SHAPES as JSHAPES, get_config as jget
from repro.configs import shape_supported as jshape_supported
from repro.launch import roofline as jroof, sharding as jsh, specs as jspecs
from repro.models import build_model as jbuild
from repro_torch.configs import (ARCHS, INPUT_SHAPES, LONG_CONTEXT_SKIPS, get_config,
                                 shape_supported, smoke_variant)
from repro_torch.launch import mesh as meshlib, op_analysis as oa, roofline, sharding as sh
from repro_torch.launch import specs
from repro_torch.models.model import Model
from repro_torch.weights import to_jax_params, tree_flatten, tree_map

MESHES = [((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((32, 8), ("data", "model"))]


def _mesh(dims, names):
    return SimpleNamespace(shape=dict(zip(names, dims)), axis_names=names)


def _dp(names):
    dp = tuple(a for a in names if a in ("pod", "data"))
    return dp if len(dp) > 1 else dp[0]


def _norm(spec, rank):
    t = tuple(spec)
    return t + (None,) * (rank - len(t))


_PORT_TREES = {}


def _port_tree(arch):
    """The port's full-width parameters (fake) and, per reference leaf
    path, the port leaf indices it stacks."""
    if arch not in _PORT_TREES:
        cfg = get_config(arch)
        with FakeTensorMode():
            params = Model(cfg).init(0, device="cpu")
        flat = list(tree_flatten(params))
        ids = iter(range(len(flat)))
        index = tree_map(lambda _: torch.tensor(next(ids)), params)
        ref_layout = {p: t for p, t in tree_flatten(to_jax_params(cfg, index))}
        _PORT_TREES[arch] = (params, flat, ref_layout)
    return _PORT_TREES[arch]


@pytest.fixture(scope="module")
def ref_shapes():
    out = {}
    for arch in ARCHS:
        m = jbuild(jget(arch))
        shapes = jax.eval_shape(m.init, jax.random.PRNGKey(0))
        out[arch] = {jsh._path_str(p): leaf.shape
                     for p, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
    return out


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_equal_reference_on_every_leaf(arch, ref_shapes):
    params, flat, ref_layout = _port_tree(arch)
    ref = ref_shapes[arch]
    assert set(ref_layout) == set(ref), arch
    for dims, names in MESHES:
        mesh = _mesh(dims, names)
        dp = _dp(names)
        for mode in ("train", "decode"):
            port_specs = sh.param_shardings(mesh, params, mode)
            port_flat = [s for _, s in tree_flatten_specs(port_specs)]
            for rpath, idx in ref_layout.items():
                rshape = ref[rpath]
                rspec = _norm(jsh.spec_for_param(rpath, rshape, mesh, dp, "model", mode),
                              len(rshape))
                lead = idx.dim()
                for i in (idx.reshape(-1).tolist() if lead else [int(idx)]):
                    ppath, leaf = flat[i]
                    assert tuple(leaf.shape) == tuple(rshape[lead:]), (rpath, ppath)
                    want = (None,) * lead + _norm(port_flat[i], leaf.dim())
                    assert rspec == want, (arch, dims, mode, rpath, ppath, rspec, want)


def tree_flatten_specs(tree, prefix=""):
    """tree_flatten over a spec tree (tuples are leaves)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_flatten_specs(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_flatten_specs(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def test_decode_mode_flips_expert_sharding():
    mesh = _mesh((1, 1), ("data", "model"))
    spec_t = sh.spec_for_param("layers/0/ffn/experts/wi", (4, 64, 128), mesh,
                               "data", "model", mode="train")
    spec_d = sh.spec_for_param("layers/0/ffn/experts/wi", (4, 64, 128), mesh,
                               "data", "model", mode="decode")
    assert spec_t == ("model", "data", None)
    assert spec_d == ("model", None, "data")


def test_expert_count_fallback_moves_model_axis_to_dff():
    # 8 experts on a 16-way model axis: the model axis shards d_ff instead
    mesh = _mesh((16, 16), ("data", "model"))
    for path in ("layers/0/ffn/experts/wi", "layers/0/ffn/experts/wo"):
        shape = (8, 4096, 28672) if path.endswith("wi") else (8, 14336, 4096)
        got = sh.spec_for_param(path, shape, mesh, "data", "model")
        want = _norm(jsh.spec_for_param("blocks/0/ffn/experts/" + path[-2:], (32,) + shape,
                                        mesh, "data", "model")[1:], 3)
        assert got == want
    assert got == (None, "model", "data")


def test_fit_spec_drops_nondividing_axes():
    mesh = _mesh((32, 8), ("data", "model"))
    assert sh.fit_spec(mesh, (8, 3), ("data", "model")) == (None, None)
    assert sh.fit_spec(mesh, (64, 16, 5), ("data", "model")) == ("data", "model", None)
    assert sh.fit_spec(mesh, (256, 4), (("data", "model"),)) == (("data", "model"), None)
    for shape, spec in (((8, 3), P("data", "model")), ((64, 16, 5), P("data", "model")),
                        ((256, 4), P(("data", "model")))):
        assert sh.fit_spec(mesh, shape, tuple(spec)) == tuple(jsh.fit_spec(mesh, shape, spec))


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _mesh((2, 32, 8), ("pod", "data", "model"))
    assert sh.placements(mesh, (("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert sh.placements(mesh, ()) == (Replicate(),) * 3
    assert sh.placements(mesh, (None, "data")) == (Replicate(), Shard(1), Replicate())


@pytest.mark.parametrize("arch,batch", [("jamba-v0.1-52b", 64), ("deepseek-v2-236b", 64),
                                        ("whisper-tiny", 64), ("mixtral-8x7b", 1),
                                        ("gemma3-27b", 1), ("deepseek-v2-236b", 1),
                                        ("jamba-v0.1-52b", 1), ("granite-3-2b", 128)])
def test_cache_specs_equal_reference(arch, batch, monkeypatch):
    """Every cache leaf at full width, batch 64 / 128 and the B = 1
    context-parallel fallback; leaves matched by name and trailing dims
    (the reference stacks blocks, and keeps Whisper's cross K/V as one
    enc_kv leaf (L, 2, B, F, H, hd))."""
    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: spec)
    seq = 256
    cfg = get_config(arch)
    with FakeTensorMode():
        cache = Model(cfg).init_cache(batch, seq, "cpu")
    jm = jbuild(jget(arch))
    jcache = jax.eval_shape(lambda: jm.init_cache(batch, seq))
    for dims, names in MESHES:
        mesh = _mesh(dims, names)
        port = {}
        for (path, leaf), (_, spec) in zip(tree_flatten(cache),
                                          tree_flatten_specs(sh.cache_shardings(mesh, cache,
                                                                                batch))):
            name = path.rsplit("/", 1)[-1]
            name = "enc_kv" if name.startswith("cross_") else name
            port.setdefault(name, set()).add((tuple(leaf.shape), _norm(spec, leaf.dim())))
        ref = jsh.cache_shardings(mesh, jcache, batch)
        for (p, leaf), spec in zip(jax.tree_util.tree_leaves_with_path(jcache),
                                   jax.tree_util.tree_leaves(
                                       ref, is_leaf=lambda x: isinstance(x, P))):
            name = jsh._path_str(p).rsplit("/", 1)[-1]
            rank = 4 if name == "enc_kv" else len(next(iter(port[name]))[0])
            rs = _norm(spec, len(leaf.shape))
            assert all(x is None for x in rs[: len(rs) - rank])
            want = (tuple(leaf.shape[-rank:]), rs[-rank:])
            assert want in port[name], (arch, dims, name, want, port[name])


def test_batch_spec_and_shardings():
    mesh = _mesh((2, 16, 16), ("pod", "data", "model"))
    assert sh.batch_spec(mesh, 256) == (("pod", "data"), None)
    assert sh.batch_spec(mesh, 1) == (None, None)
    assert tuple(jsh.batch_spec(mesh, 256)) == (("pod", "data"), None)
    cfg = get_config("internvl2-26b")
    with FakeTensorMode():
        b = specs.batch_struct(cfg, 64, 32)
    bs = specs.batch_shardings(mesh, b)
    assert bs.tokens == (("pod", "data"), None)
    assert bs.prefix_embeds == (("pod", "data"), None, None)
    assert bs.audio_frames is None


# ----------------------------------------------------------- configs / sizing
def test_shape_supported_equals_reference():
    from repro.configs import LONG_CONTEXT_SKIPS as JSKIPS
    assert LONG_CONTEXT_SKIPS == JSKIPS
    for arch in ARCHS:
        for s in INPUT_SHAPES:
            assert shape_supported(arch, s) == jshape_supported(arch, s), (arch, s)


@pytest.mark.parametrize("dp", [16, 32, 64])
def test_train_microbatches_equal_reference_at_6gb(dp):
    for arch in ARCHS:
        for name, shape in INPUT_SHAPES.items():
            got = specs.train_microbatches(get_config(arch), shape, dp, budget=6e9)
            assert got == jspecs.train_microbatches(jget(arch), JSHAPES[name], dp), (arch, name)


def test_train_microbatches_h100_budget():
    """The H100 default (30 GB, the reference's 6/16 share of 80 GB) needs
    no more microbatches than the reference's 6 GB anywhere."""
    assert specs.REMAT_BUDGET == 30e9
    for arch in ARCHS:
        shape = INPUT_SHAPES["train_4k"]
        assert (specs.train_microbatches(get_config(arch), shape, 32)
                <= specs.train_microbatches(get_config(arch), shape, 32, budget=6e9))


def test_model_flops_equal_reference():
    for arch in ARCHS:
        for name, shape in INPUT_SHAPES.items():
            n = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
            assert roofline.model_flops(get_config(arch), shape, n) == \
                jroof.model_flops(jget(arch), JSHAPES[name], n)


# ------------------------------------------------------------- op analysis
def test_flops_exact_for_chained_matmuls():
    def f(x, w):
        for _ in range(8):
            x = x @ w
        return x
    x, w = torch.randn(64, 64), torch.randn(64, 64)
    _, a = oa.analyze(f, x, w)
    assert a["flops"] == 2 * 64 ** 3 * 8
    # each product reads two 64x64 float32 operands and writes one
    assert a["bytes"] == 8 * 3 * 64 * 64 * 4


def test_flops_multiply_over_nested_loops():
    def f(x, w):
        for _ in range(5):
            for _ in range(3):
                x = x @ w
        return x
    _, a = oa.analyze(f, torch.randn(32, 32), torch.randn(32, 32))
    assert a["flops"] == 2 * 32 ** 3 * 15


def test_bytes_of_known_shapes():
    x = torch.randn(4, 8)
    idx = torch.tensor([0, 2], dtype=torch.long)
    table = torch.randn(1000, 16)

    def f(x, table, idx):
        y = x.view(8, 4)                 # a view moves nothing
        z = y + 1.0                      # reads 128 B, writes 128 B
        rows = table[idx]                # reads 2 rows (128 B) + 16 B of index, writes 128 B
        e = torch.empty(10)              # an allocation moves nothing
        return z, rows, e
    _, a = oa.analyze(f, x, table, idx)
    assert a["bytes"] == 128 + 128 + (2 * 128 + 16)
    assert a["flops"] == 0


def test_all_reduce_on_fake_group_counts_32_bytes():
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate

    meshlib.start_fake_process_group(8)
    try:
        mesh = meshlib.make_production_mesh(device_type="cpu", shape=(2, 4))
        x = DTensor.from_local(torch.ones(8), mesh, [Partial(), Replicate()], run_check=False)
        _, a = oa.analyze(lambda t: t.redistribute(mesh, [Replicate(), Replicate()]).to_local(),
                          x, mesh=mesh)
        assert a["collectives"]["all_reduce"] == 32
        assert a["collectives"]["count"] == 1
        assert a["axis_bytes"] == {"data": 32}
    finally:
        dist.destroy_process_group()


def test_dtensor_matmul_counts_per_gpu_flops():
    """A (32 x 8) mesh: the mode sees DTensor's local product, 1/256 of the
    global one that a mode above DTensor sees."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode

    meshlib.start_fake_process_group(256)
    try:
        mesh = meshlib.make_production_mesh(device_type="cpu")
        with FakeTensorMode():
            a = distribute_tensor(torch.empty(2048, 512), mesh, [Shard(0), Replicate()],
                                  src_data_rank=None)
            w = distribute_tensor(torch.empty(512, 1024), mesh, [Replicate(), Shard(1)],
                                  src_data_rank=None)
            _, r = oa.analyze(lambda a, w: a @ w, a, w, mesh=mesh)
            with FlopCounterMode(display=False) as fc:
                a @ w
        assert r["flops"] == 2 * 64 * 512 * 128
        assert fc.get_total_flops() == 256 * r["flops"] == 2 * 2048 * 512 * 1024
        assert r["peak_bytes"] == (64 * 512 + 512 * 128 + 64 * 128) * 4
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------- roofline
def test_roofline_terms_with_h100_constants():
    assert (meshlib.PEAK_FLOPS_BF16, meshlib.HBM_BW, meshlib.NVLINK_BW, meshlib.IB_BW) == (
        989e12, 3.35e12, 450e9, 50e9)
    r = roofline.Roofline("a", "s", "32x8", flops_per_chip=989e12, bytes_per_chip=6.7e12,
                          coll_bytes_per_chip=450e9 + 100e9, nvlink_bytes_per_chip=450e9)
    assert math.isclose(r.compute_s, 1.0)
    assert math.isclose(r.memory_s, 2.0)
    assert math.isclose(r.collective_s, 1.0 + 2.0)
    assert r.bottleneck == "collective" and math.isclose(r.step_s, 3.0)
    d = r.asdict()
    for k in ("compute_s", "memory_s", "collective_s", "bottleneck", "step_s"):
        assert k in d
    c = roofline.collective_bytes({"collectives": {"all_reduce": 32.0, "count": 1}})
    assert c["all_reduce"] == 32 and c["total"] == 32 and c["count"] == 1


def test_production_mesh_shapes():
    assert meshlib.production_shape() == ((32, 8), ("data", "model"))
    assert meshlib.production_shape(True) == ((2, 32, 8), ("pod", "data", "model"))
    assert math.prod(meshlib.production_shape(True)[0]) == 512


def test_private_fake_backend_import():
    """The dry run's fake process group comes from a private module; pin it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: F401
    import torch.distributed as dist

    meshlib.start_fake_process_group(512)
    try:
        assert dist.get_world_size() == 512 and dist.get_backend() == "fake"
        mesh = meshlib.make_production_mesh(multi_pod=True, device_type="cpu")
        assert meshlib.num_chips(mesh) == 512
        assert meshlib.data_axes(mesh) == ("pod", "data")
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------- model repairs
def test_expert_ffn_takes_qtensor_experts():
    """The port's expert_ffn on 4-bit QTensor experts equals the reference's
    on the same (bit-identical) quantization."""
    import jax.numpy as jnp

    from repro.models import moe as jmoe
    from repro.quant.quantize import quantize as jquantize
    from repro_torch.models import moe as moe_lib
    from repro_torch.quant.quantize import quantize

    cfg = dataclasses.replace(smoke_variant(get_config("mixtral-8x7b"), d_model=256),
                              dtype="float32")
    jcfg = dataclasses.replace(jsmoke_mixtral(), dtype="float32")
    rng = np.random.default_rng(0)
    wi = rng.standard_normal((4, 256, 512)).astype(np.float32) * 0.05
    wo = rng.standard_normal((4, 256, 256)).astype(np.float32) * 0.05
    xb = rng.standard_normal((4, 16, 256)).astype(np.float32)
    ex = {"wi": quantize(torch.from_numpy(wi), bits=4, group_size=128),
          "wo": quantize(torch.from_numpy(wo), bits=4, group_size=128)}
    jex = {"wi": jquantize(jnp.asarray(wi), bits=4, group_size=128),
           "wo": jquantize(jnp.asarray(wo), bits=4, group_size=128)}
    got = moe_lib.expert_ffn(ex, torch.from_numpy(xb), cfg).numpy()
    want = np.asarray(jmoe.expert_ffn(jex, jnp.asarray(xb), jcfg))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


def jsmoke_mixtral():
    from repro.configs import smoke_variant as jsmoke
    return jsmoke(jget("mixtral-8x7b"), d_model=256)


def test_single_device_outputs_bit_identical_with_constrain(tmp_path):
    """Without a mesh `constrain` returns its argument, so the single-device
    paths run the ops they ran before it; on a one-rank (1, 1) mesh (gloo)
    the DTensor `Model.loss` and `moe_forward` equal the plain ones bit for
    bit."""
    import torch.distributed as dist

    from repro_torch.models import moe as moe_lib, shard_utils
    from repro_torch.models.model import Batch

    cfg = dataclasses.replace(smoke_variant(get_config("mixtral-8x7b"), layers=2, d_model=128,
                                            vocab=512), dtype="float32")
    model = Model(cfg)
    params = model.init(0, device="cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 64, 128)).astype(np.float32))
    assert shard_utils.constrain(x, "batch", None, None) is x
    batch = Batch(torch.from_numpy(rng.integers(0, 512, (4, 64)).astype(np.int32)),
                  torch.ones((4, 64)))
    ffn = params["layers"][0]["ffn"]
    loss0, _ = model.loss(params, batch)
    y0, aux0 = moe_lib.moe_forward(ffn, x, cfg)
    y1, _ = moe_lib.moe_forward(ffn, x, cfg, groups=1)
    assert torch.equal(y0, y1)

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        mesh = meshlib.make_production_mesh(device_type="cpu", shape=(1, 1))
        dparams = sh.distribute_params(mesh, params)
        dbatch = Batch(*(sh.distribute(mesh, f, ("data",)) for f in batch[:2]))
        with shard_utils.mesh_scope(mesh):
            loss1, _ = model.loss(dparams, dbatch)
            yd, auxd = moe_lib.moe_forward(dparams["layers"][0]["ffn"],
                                           sh.distribute(mesh, x, ("data", None, None)), cfg)
        assert torch.equal(loss1.full_tensor(), loss0)
        assert torch.equal(yd.full_tensor(), y0)
        assert torch.equal(auxd.full_tensor(), aux0)
    finally:
        dist.destroy_process_group()


def test_run_local_body_counted_per_gpu():
    """A DTensor product and a body on local shards (``run_local``): both
    are counted at one rank's shard sizes."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models import shard_utils

    meshlib.start_fake_process_group(256)
    try:
        mesh = meshlib.make_production_mesh(device_type="cpu")
        with FakeTensorMode():
            a = distribute_tensor(torch.empty(2048, 512), mesh, [Shard(0), Replicate()],
                                  src_data_rank=None)
            w = distribute_tensor(torch.empty(512, 1024), mesh, [Replicate(), Shard(1)],
                                  src_data_rank=None)

            def step(a, w):
                with shard_utils.mesh_scope(mesh):
                    return a @ w, shard_utils.run_local(lambda x: x @ x.T, (a,),
                                                        (("batch", None),), (("batch", None),))
            _, r = oa.analyze(step, a, w, mesh=mesh)
        assert r["flops"] == 2 * 64 * 512 * 128 + 2 * 64 * 512 * 64
    finally:
        dist.destroy_process_group()


def test_models_do_not_import_launch():
    """The model layer applies the layouts; the launch layer builds its rule
    table on the model's spec arithmetic, never the other way round."""
    import pathlib

    import repro_torch.models as models_pkg

    for f in pathlib.Path(models_pkg.__file__).parent.glob("*.py"):
        assert "repro_torch.launch" not in f.read_text(), f.name
