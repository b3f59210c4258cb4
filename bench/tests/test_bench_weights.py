"""The benchmark's weight generators make the tree the port's ``Model.init``
makes (same keys, shapes and dtypes), from the seed alone: every
configuration file through its block."""

import pytest
import torch

from benchlib import paths, spec as specs
from benchlib.cell import load_block
from benchlib.weights import make_weights
from smoke import smoke_config

CONFIGS = sorted(p.stem for p in (paths.BENCH / "configs").glob("*.json"))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("name", CONFIGS)
def test_tree_matches_model_init(name):
    from repro_torch.models.model import Model
    cfg = smoke_config(name)
    block = load_block(cfg)
    model = Model(block.port_config(cfg))
    ours = dict(_leaves(block.make_weights(block.plain_spec(cfg), 7, "cpu")))
    theirs = dict(_leaves(model.init(7, device="cpu")))
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert ours[k].shape == theirs[k].shape, k
        assert ours[k].dtype == theirs[k].dtype, k


def test_seeded_and_scaled():
    s = specs.plain_spec(smoke_config())
    a, b = make_weights(s, 2**31 + 5, "cpu"), make_weights(s, 2**31 + 5, "cpu")
    c = make_weights(s, 2**31 + 6, "cpu")
    assert torch.equal(a["layers"][1]["ffn"]["experts"]["wi"], b["layers"][1]["ffn"]["experts"]["wi"])
    assert not torch.equal(a["embed"], c["embed"])
    wi = a["layers"][0]["ffn"]["experts"]["wi"].float()
    assert wi.std().item() == pytest.approx(s["d_model"] ** -0.5, rel=0.1)
    assert a["embed"].float().std().item() == pytest.approx(0.02, rel=0.1)


def test_port_config_takes_the_file():
    cfg = specs.port_config(smoke_config("phi-3.5-moe-l8"))
    assert (cfg.norm_type, cfg.norm_eps, cfg.tie_embeddings) == ("layernorm", 1e-5, False)
    assert (cfg.moe.num_experts, cfg.moe.capacity_factor) == (8, 8.0)
    full = specs.port_config(paths.load_json(paths.BENCH / "configs" / "mixtral-8x7b-l8.json"))
    assert (full.d_model, full.num_layers, full.moe.d_ff_expert, full.rope_theta) == \
        (4096, 8, 14336, 1e6)
