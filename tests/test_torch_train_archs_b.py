"""The training objective of the port against the JAX reference on the
last six of the reference's 12 architectures in sorted order (Llama-4-Scout,
Mamba2, Mixtral, Nemotron, Phi-MoE, Whisper): ``Model.loss``, every
gradient leaf and one train step, with the checks and tolerances of
tests/test_torch_train_archs.py (which runs the first six); Mamba2's
reference gradient is taken through the masked-exp copy of its SSD scan
described there, and the original's NaN shown.
"""

import pytest

from test_torch_train_archs import (ALL_ARCHS, REF_ARCHS, check_gradients_match_reference,
                                    check_loss_matches_reference,
                                    check_reference_ssd_gradient_nan_is_the_references,
                                    check_train_step_matches_reference)

ARCHS = ALL_ARCHS[6:]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference(arch):
    check_loss_matches_reference(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch):
    check_gradients_match_reference(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    check_train_step_matches_reference(arch)


@pytest.mark.parametrize("arch", [a for a in ARCHS if REF_ARCHS[a].ssm is not None])
def test_reference_ssd_gradient_nan_is_the_references(arch):
    check_reference_ssd_gradient_nan_is_the_references(arch)
