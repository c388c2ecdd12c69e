"""Launchers, ported from ``repro.launch``: the serving and training
launchers, and the one-device launch tooling (``dryrun``: every
(arch × shape) run on the meta device and counted by ``op_stats``, with
an H100 ``roofline``). The production meshes (``mesh.py``) wait for
ROADMAP §A.10."""
