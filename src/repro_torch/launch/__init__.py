"""Launchers: the port of ``repro/launch``: the meshes (``mesh.py``), the
train and serve steps with their partition specs (``steps.py``), the
train and serve entry points, on one card or on a ``DeviceMesh``, and the
multi-pod dry run (``dryrun.py``), which traces every (arch × shape) cell
over the production mesh of 256 or 512 fake ranks on fake tensors."""
