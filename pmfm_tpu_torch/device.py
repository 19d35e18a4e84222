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
    """Context in which CUDA matrix products keep float32 accumulation:
    float32 products run in full float32 (TF32 off, the reference's
    ``Precision.HIGHEST``) and bf16 products do not reduce in bf16. The
    previous settings are restored on exit.
    """

    def __enter__(self):
        m = torch.backends.cuda.matmul
        self._prev = (m.allow_tf32, m.allow_bf16_reduced_precision_reduction)
        m.allow_tf32 = False
        m.allow_bf16_reduced_precision_reduction = False
        return self

    def __exit__(self, *exc):
        m = torch.backends.cuda.matmul
        m.allow_tf32, m.allow_bf16_reduced_precision_reduction = self._prev
        return False
