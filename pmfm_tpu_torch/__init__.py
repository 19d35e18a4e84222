"""PMFM on PyTorch and CUDA: the evolutionary FM-synthesis parameter matcher
of ``pmfm_tpu`` ported to one NVIDIA Hopper GPU.

The layout follows ``pmfm_tpu`` module for module (``ops/``, ``es/``,
``kernels/``) so each function's counterpart is found under the same path.
This package imports ``torch`` and never ``jax`` or ``pmfm_tpu``; the CUDA
kernels under ``csrc/`` are compiled with ``nvcc`` at their first launch, so
importing the package needs no GPU and no compiler.

Entry points take ``device="cuda"`` by default and raise when no card is
present; pass ``device="cpu"`` to run the kernels' plain PyTorch versions.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
