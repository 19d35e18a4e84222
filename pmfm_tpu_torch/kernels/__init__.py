"""Hand-written CUDA kernels for Hopper (``csrc/``), each with its wrapper,
launch count and plain PyTorch version: B1 ``fused_synth_fitness`` and B2
``fused_generation`` (``csrc/fused_eval.cu`` int8, ``csrc/fused_f32.cu`` true
f32), B5 ``fused_evolve`` (``csrc/evolve.cu``: B2's kernels and a selection
kernel a generation); B3 ``fused_synth_fold`` and B4 ``fused_synth_stream``
(``csrc/large_frame.cu``)."""
from .evolve import fused_evolve
from .generation import fused_generation
from .synth_fitness import fused_synth_fitness
from .synth_fold import fused_synth_fold
from .synth_stream import fused_synth_stream

__all__ = ["fused_evolve", "fused_generation", "fused_synth_fitness", "fused_synth_fold",
           "fused_synth_stream"]
