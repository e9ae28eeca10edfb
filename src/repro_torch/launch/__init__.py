"""Launchers: the port of ``repro/launch``: the meshes (``mesh.py``), the
train and serve steps with their partition specs (``steps.py``) and the
train and serve entry points, on one card or on a ``DeviceMesh``."""
