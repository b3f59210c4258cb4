"""The port's quantizer against the JAX package's: the same packed int8
bytes and float32 scales, bit for bit, for 8, 4 and 2 bits (2 bits is the
TWN ternary path), and the same dequantized weights."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.quant.quantize import (PACK_FACTOR, QTensor, dequantize,
                                        expert_nbytes, pack_codes, quantize,
                                        unpack_codes)

jq = importlib.import_module("repro.quant.quantize")
torch.set_num_threads(2)

SHAPES = [((128, 256), 64), ((3, 256, 96), 64), ((2, 640, 128), 64),
          ((4096, 64), 128), ((64, 32), 32)]


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("shape,gs", SHAPES)
@pytest.mark.parametrize("scale", [1.0, 0.02])
def test_quantize_bit_exact_with_jax(bits, shape, gs, scale):
    w = (np.random.default_rng(bits + len(shape)).standard_normal(shape)
         * scale).astype(np.float32)
    a = jq.quantize(jnp.asarray(w), bits=bits, group_size=gs)
    b = quantize(torch.from_numpy(w), bits=bits, group_size=gs)
    assert b.data.dtype == torch.int8 and b.scale.dtype == torch.float32
    np.testing.assert_array_equal(b.data.numpy(), np.asarray(a.data))
    np.testing.assert_array_equal(b.scale.numpy(), np.asarray(a.scale))
    np.testing.assert_array_equal(dequantize(b).numpy(), np.asarray(jq.dequantize(a)))
    assert b.nbytes == a.nbytes and b.shape == a.shape


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_zero_groups_and_halfway_rounding(bits):
    """All-zero groups take scale 1 (the guard); values exactly halfway
    between codes round half to even on both sides."""
    w = np.zeros((128, 16), np.float32)
    qmax = {8: 127, 4: 7, 2: 1}[bits]
    w[64:, :] = np.linspace(-1.0, 1.0, 64, dtype=np.float32)[:, None]
    w[64, :] = 1.0                      # amax 1 -> scale 1/qmax
    w[65, :8] = 0.5 / qmax              # exactly halfway: rounds to even
    w[66, :8] = 1.5 / qmax
    a = jq.quantize(jnp.asarray(w), bits=bits, group_size=64)
    b = quantize(torch.from_numpy(w), bits=bits, group_size=64)
    np.testing.assert_array_equal(b.data.numpy(), np.asarray(a.data))
    np.testing.assert_array_equal(b.scale.numpy(), np.asarray(a.scale))
    assert np.all(b.scale.numpy()[0] == 1.0)


@pytest.mark.parametrize("bits", [4, 2])
def test_pack_unpack_round_trip_matches_jax(bits):
    qmax = {4: 7, 2: 1}[bits]
    codes = np.random.default_rng(bits).integers(-qmax - (bits == 4), qmax + 1,
                                                 (2, 64, 24)).astype(np.int8)
    packed = pack_codes(torch.from_numpy(codes), bits)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jq.pack_codes(jnp.asarray(codes), bits)))
    assert packed.shape == (2, 64 // PACK_FACTOR[bits], 24)
    np.testing.assert_array_equal(unpack_codes(packed, bits).numpy(), codes)


def test_expert_nbytes_and_qtensor_bytes_match_reference():
    for bits in (16, 8, 4, 2):
        assert expert_nbytes(4096, 14336, bits, group_size=64) == \
            jq.expert_nbytes(4096, 14336, bits, group_size=64)
    q = QTensor(torch.zeros((8, 4), dtype=torch.int8), torch.zeros((2, 4)), 4, 8, 16)
    assert q.nbytes == 8 * 4 + 2 * 4 * 2     # scales counted at 2 bytes


def test_bad_dims_raise():
    with pytest.raises(ValueError):
        quantize(torch.zeros(100, 8), bits=4, group_size=64)
    with pytest.raises(ValueError):
        quantize(torch.zeros(128, 8), bits=3, group_size=64)
