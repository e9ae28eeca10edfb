"""Launchers: the port of ``repro/launch`` for one card (the model on the
mesh, ``launch/mesh.py``, waits for ROADMAP A10b-iii)."""
