"""The model on the mesh for the RWKV6 family: four gloo ranks at (2, 2)
against the JAX package's steps on its (2, 2) mesh of ``Auto`` axes, with
``tests/test_torch_mesh_model.py``'s machinery and tolerances (see
there).  The recurrence runs through its local call
(``models.layers.sharded_call``: kernels B7 and B6 on the card) on each
rank's rows and heads, the bonus ``u``'s gradient summed over the ranks
of the batch."""

import pytest

from test_torch_mesh_model import (check_losses, check_params, check_serve,
                                   reference_start, run_both)

FAMILIES = ("rwkv6-3b",)


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
