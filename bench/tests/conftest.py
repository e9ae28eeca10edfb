"""Fixtures of the benchmark's CPU tests: a throwaway layout (``tiny.py``)
and the gate of the tests that need the card, decided inside a fixture."""

import pytest


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    from bench.tests import tiny
    return tiny.make(tmp_path_factory.mktemp("bench"))


@pytest.fixture(scope="module")
def tiny_root32(tmp_path_factory):
    """The throwaway layout with the port in float32: the port and the
    reference then differ by float32 rounding alone."""
    from bench.tests import tiny
    return tiny.make(tmp_path_factory.mktemp("bench32"), dtype="float32",
                     rms_limit=1e-3)


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
