"""Launchers, ported from ``repro.launch``: the serving and training
launchers, the launch tooling (``dryrun``: every (arch × shape) run on
the meta device and counted by ``op_stats``, as one device or as rank 0
of the reference's production meshes over a fake process group, with
an H100 ``roofline``) and the meshes (``mesh.py``: ``DeviceMesh``
constructors, the multi-pod (pod, data, model) mesh among them, and the
``run_spmd`` helper)."""
