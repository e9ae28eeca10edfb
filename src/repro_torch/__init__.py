"""PyTorch/CUDA port of the lazy WSP fusion runtime (``repro``).

``repro_torch`` mirrors ``repro`` path for path and imports neither JAX nor
the ``repro`` package.  ``repro_torch.core.lazy`` is the user entry point;
it runs on the CUDA card unless a runtime is given ``device="cpu"``.
"""
