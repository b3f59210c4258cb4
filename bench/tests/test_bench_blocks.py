"""The default block, ``moe_gqa``, is the harness's Mixtral / Phi path: the
same sizes, port configuration, weights, FLOP counts and reference as
``benchlib/spec.py``, ``benchlib/weights.py``, ``benchlib/flops.py`` and
``reference/plain.py``, bit for bit."""

import numpy as np
import pytest
import torch

from benchlib import flops, paths, spec as specs, weights
from benchlib.cell import load_block, load_reference
from reference import plain
from smoke import smoke_config

NAMES = ["mixtral-8x7b-l8", "phi-3.5-moe-l8"]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("name", NAMES)
def test_spec_port_config_and_flops_at_published_widths(name):
    cfg = paths.load_json(paths.BENCH / "configs" / f"{name}.json")
    assert "block" not in cfg
    block = load_block(cfg)
    spec = block.plain_spec(cfg)
    assert spec == specs.plain_spec(cfg)
    assert block.port_config(cfg) == specs.port_config(cfg)
    for context in (1, 97, 2048, 32768):
        assert block.token_flops(spec, context) == flops.token_flops(spec, context)
    for start, n, head in ((0, 64, False), (1984, 64, True), (100, 7, True), (5, 0, False)):
        assert block.chunk_flops(spec, start, n, head=head) == \
            flops.chunk_flops(spec, start, n, head=head)


@pytest.mark.parametrize("name", NAMES)
def test_weights_and_reference_bit_equal_at_smoke_size(name):
    cfg = smoke_config(name)
    block = load_block(cfg)
    spec = block.plain_spec(cfg)
    ours = dict(_leaves(block.make_weights(spec, 2**31 + 9, "cpu")))
    theirs = dict(_leaves(weights.make_weights(specs.plain_spec(cfg), 2**31 + 9, "cpu")))
    assert ours.keys() == theirs.keys()
    assert all(torch.equal(ours[k], theirs[k]) for k in ours)
    w = block.make_weights(spec, 5, "cpu")
    ref = load_reference(block)
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, spec["vocab_size"], 40))
    for fp8 in (False, True):
        assert torch.equal(ref.logits(w, spec, toks, 24, fp8=fp8),
                           plain.logits(w, specs.plain_spec(cfg), toks, 24, fp8=fp8))
