"""The port's dry run (``repro_torch.launch.dryrun``) on the (32, 8)
production mesh of 256 H100s, with PyTorch's fake process group and fake
tensors: decode_32k of the first group of architectures ok at full width,
and long_500k skipped exactly where the JAX package skips it.  The other
architectures' decode_32k, Mixtral's train_4k and the FLOP parity with the
reference's HLO analysis are in test_torch_dryrun_b.py / _c.py (each file
stays near a minute and a half on one worker)."""

import pytest

from repro.configs import LONG_CONTEXT_SKIPS as JSKIPS
from repro_torch.configs import ARCHS
from repro_torch.launch import dryrun

ARCHS_A = ("deepseek-v2-236b", "gemma2-27b", "gemma3-27b", "whisper-tiny", "nemotron-4-15b")


def check_record(rec, arch, shape):
    assert rec["status"] == "ok", rec.get("traceback", rec)
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["chips"]) == (arch, shape, "32x8", 256)
    for key in ("flops_per_chip", "bytes_per_chip", "model_flops", "lower_s"):
        assert rec[key] > 0, key
    mem = rec["memory"]
    for key in ("argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
                "peak_bytes_per_chip"):
        assert mem[key] >= 0, key
    assert mem["peak_bytes_per_chip"] >= mem["argument_bytes"]
    rl = rec["roofline"]
    assert rl["bottleneck"] in ("compute", "memory", "collective")
    assert rl["step_s"] == max(rl["compute_s"], rl["memory_s"], rl["collective_s"])
    coll = rec["collectives"]
    assert coll["total"] == sum(coll[k] for k in ("all_reduce", "all_gather", "reduce_scatter",
                                                  "all_to_all", "permute"))
    assert sum(rec["collective_axes"].values()) == pytest.approx(coll["total"])


@pytest.mark.parametrize("arch", ARCHS_A)
def test_decode_32k_ok_on_production_mesh(arch):
    check_record(dryrun.run_one(arch, "decode_32k", verbose=False), arch, "decode_32k")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_long_500k_skipped_where_the_reference_skips(arch):
    if arch in JSKIPS:
        rec = dryrun.run_one(arch, "long_500k", verbose=False)
        assert rec["status"] == "skip" and "reason" in rec
    else:
        from repro_torch.configs import shape_supported
        assert shape_supported(arch, "long_500k")
