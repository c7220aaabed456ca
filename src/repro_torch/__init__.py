"""FedPC on PyTorch and CUDA — the twin of ``repro`` for NVIDIA Hopper.

Module names mirror ``repro`` (``repro_torch/core/flat.py`` is the
counterpart of ``repro/core/flat.py``). The package imports ``torch`` and
``numpy`` only. Its entry points run on CUDA unless the caller passes
``device="cpu"``, and the wire kernels are hand-written CUDA C++
(``kernels/csrc/``) built with ``nvcc`` at first use.
"""
