"""The port's dry run on the (32, 8) production mesh: decode_32k of the
second group of architectures ok at full width (see test_torch_dryrun.py)."""

import pytest

from repro_torch.launch import dryrun
from test_torch_dryrun import check_record

ARCHS_B = ("granite-3-2b", "internvl2-26b", "jamba-v0.1-52b", "llama4-scout-17b-a16e",
           "mamba2-780m", "phi-moe")


@pytest.mark.parametrize("arch", ARCHS_B)
def test_decode_32k_ok_on_production_mesh(arch):
    check_record(dryrun.run_one(arch, "decode_32k", verbose=False), arch, "decode_32k")
