"""The model on the mesh for the Mamba family (Jamba-v0.1):
four gloo ranks at (2, 2) against the JAX package's steps on its (2, 2)
mesh of ``Auto`` axes, with ``tests/test_torch_mesh_model.py``'s
machinery and tolerances (see there).  The scans run through their local
call (``models.layers.sharded_call``) on each rank's rows and
``d_inner`` channels, the gradients of ``b``, ``c``, ``a`` and ``d``
(which lack one of the sharded dims) summed over the ranks.  Jamba-v0.1
runs at 2 of its SMOKE
config's 8 layers (``LAYERS``): a Mamba layer with an MLP and one with a
MoE layer, its pins included; its attention layer's arithmetic is the
other families'."""

import pytest

from test_torch_mesh_model import (check_losses, check_params, check_serve,
                                   reference_start, run_both)

FAMILIES = ("jamba-v0.1-52b",)


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
