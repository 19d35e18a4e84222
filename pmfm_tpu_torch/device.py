"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on.

    A CUDA device must exist: asking for one without a card raises instead
    of silently running on the CPU. Callers that want the CPU (the tests)
    pass ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pmfm_tpu_torch: device 'cuda' requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev


class exact_f32_matmul:
    """Context in which CUDA float32 matrix products run in full float32.

    The plain versions of the kernels contract integer-valued float32 tensors
    (int8 audio against the int8 DFT operand) whose partial sums stay below
    2^24, so the product is exact only if TF32 is off. The previous setting
    is restored on exit.
    """

    def __enter__(self):
        self._prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self._prev
        return False
