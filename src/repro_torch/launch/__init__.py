"""Launchers, ported from ``repro.launch``: the serving and training
launchers, and the one-device launch tooling (``dryrun``: every
(arch × shape) run on the meta device and counted by ``op_stats``, with
an H100 ``roofline``) and the meshes (``mesh.py``: ``DeviceMesh``
constructors and the ``run_spmd`` helper; the multi-pod mesh is the LM
half of ROADMAP §A.10)."""
