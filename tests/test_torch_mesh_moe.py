"""The model on the mesh for the MoE family (OLMoE-1B-7B): four gloo
ranks at (2, 2) against the JAX package's steps on its (2, 2) mesh of
``Auto`` axes, with ``tests/test_torch_mesh_model.py``'s machinery and
tolerances (see there).  The MoE layers run with their dispatch and
expert pins (``"moe_dispatch"``, ``"moe_expert"``): the experts sharded
over ``model``."""

import pytest

from test_torch_mesh_model import (check_losses, check_params, check_serve,
                                   reference_start, run_both)

FAMILIES = ("olmoe-1b-7b",)


@pytest.fixture(scope="module")
def both():
    return run_both(FAMILIES)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_losses_follow_the_reference_mesh(both, arch):
    check_losses(*both[arch])


@pytest.mark.parametrize("arch", FAMILIES)
def test_trained_params_follow_the_reference_mesh(both, arch):
    check_params(*both[arch], reference_start(arch))


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_logits_follow_the_reference_mesh(both, arch):
    check_serve(*both[arch])
