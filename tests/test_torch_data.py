"""The port's data pipeline against the JAX reference's: for a seed, the
token streams (train batches, host shards, resumed steps, the held-out
set) are equal token for token, and so is the unigram entropy."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.data import pipeline as ref_pipeline
from repro_torch.data import pipeline
from repro_torch.models.model import Batch


def _configs(seed):
    kw = dict(vocab_size=512, seq_len=48, batch_size=4, seed=seed)
    return ref_pipeline.DataConfig(**kw), pipeline.DataConfig(**kw)


@pytest.mark.parametrize("seed", [0, 77])
def test_batches_equal_reference(seed):
    rcfg, tcfg = _configs(seed)
    for kw in (dict(), dict(host_id=1, num_hosts=2), dict(start_step=5)):
        rit = ref_pipeline.batches(rcfg, **kw)
        tit = pipeline.batches(tcfg, device="cpu", **kw)
        for _ in range(3):
            rb, tb = next(rit), next(tit)
            assert isinstance(tb, Batch)
            assert tb.tokens.dtype == torch.int32 and tb.loss_mask.dtype == torch.float32
            np.testing.assert_array_equal(tb.tokens.numpy(), np.asarray(rb.tokens))
            np.testing.assert_array_equal(tb.loss_mask.numpy(), np.asarray(rb.loss_mask))
            assert tb.prefix_embeds is None and tb.audio_frames is None


@pytest.mark.parametrize("seed", [0, 77])
def test_eval_batches_and_entropy_equal_reference(seed):
    rcfg, tcfg = _configs(seed)
    for rb, tb in zip(ref_pipeline.eval_batches(rcfg, 2),
                      pipeline.eval_batches(tcfg, 2, device="cpu")):
        np.testing.assert_array_equal(tb.tokens.numpy(), np.asarray(rb.tokens))
    assert pipeline.unigram_entropy(tcfg) == ref_pipeline.unigram_entropy(rcfg)
    wide = dataclasses.replace(tcfg, vocab_size=32000)
    assert pipeline.unigram_entropy(wide) == ref_pipeline.unigram_entropy(
        dataclasses.replace(rcfg, vocab_size=32000))


def test_batches_default_to_the_card_and_check_host_split():
    _, tcfg = _configs(0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            next(pipeline.batches(tcfg))
    with pytest.raises(ValueError, match="split"):
        next(pipeline.batches(tcfg, num_hosts=3, device="cpu"))
