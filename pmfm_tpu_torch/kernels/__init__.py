"""Hand-written CUDA kernels for Hopper (csrc/fused_eval.cu), each with its
wrapper, launch count and plain PyTorch version."""
from .generation import fused_generation
from .synth_fitness import fused_synth_fitness

__all__ = ["fused_generation", "fused_synth_fitness"]
