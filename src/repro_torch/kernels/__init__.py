"""Hand-written CUDA kernels for Hopper, one package per Pallas kernel of
``repro.kernels`` they replace: ``ref.py`` is the plain PyTorch version,
``ops.py`` the wrapper, and the source is ``repro_torch/csrc/<name>.cu``
(built by ``repro_torch.kernels.build``)."""
