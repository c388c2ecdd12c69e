"""PyTorch + CUDA port of ``repro`` for NVIDIA Hopper.

The package mirrors the JAX package's layout (``core/``, ``ops/``,
``kernels/``, ``graph/``, ``serve/``, ...), so the counterpart of
``repro/graph/plan.py`` is ``repro_torch/graph/plan.py``. It imports
``torch`` and numpy and nothing of JAX. The Pallas TPU kernels become
hand-written CUDA C++ kernels (``csrc/``), built with ``nvcc`` at first
use and registered as the op registry's ``cuda`` backend.

Entry points run on the CUDA device unless the caller asks for the CPU.
"""
