"""Debug-mode numerical checking (port of ``pmfm_tpu/utils/debug.py``).

The reference turns on ``jax_debug_nans`` for the whole match when the
config's ``general.isDebug`` is set (parsed but never consulted in the
original program). PyTorch has no op-level NaN trap for the forward pass,
so the port checks the values that carry the match instead: inside
``debug_nans(True)`` every generation's offspring and fitness
(``es/pipeline.py::generation_step``) and every chunk's best candidate
(``match_audio``) are checked with ``check_finite``, which raises
``FloatingPointError`` naming the value. A NaN fitness is rejected like a
NaN operation in the reference; outside the context nothing is checked and
nothing is read back from the device. ``checked_fitness`` wraps an
evaluate-like function so that a non-finite fitness raises, as the
reference's checkify wrapper does.
"""
from __future__ import annotations

import contextlib

import torch

_enabled = False


def enabled() -> bool:
    """Whether the checks are on."""
    return _enabled


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Scoped NaN checks (the reference's scoped ``jax_debug_nans``)."""
    global _enabled
    prev = _enabled
    _enabled = enable
    try:
        yield
    finally:
        _enabled = prev


def checked_fitness(evaluate_fn):
    """``evaluate_fn`` wrapped so that a NaN or infinite value in its output
    raises ``FloatingPointError`` (one read back from the device a call)."""

    def wrapped(*args, **kw):
        out = evaluate_fn(*args, **kw)
        if not bool(torch.isfinite(out).all()):
            raise FloatingPointError("non-finite fitness detected")
        return out

    return wrapped


def check_finite(name: str, t: torch.Tensor) -> None:
    """Inside ``debug_nans(True)``: raise ``FloatingPointError`` if ``t``
    holds a NaN (an infinite fitness is the initial "unevaluated" value and
    passes). Outside it: nothing."""
    if _enabled and bool(torch.isnan(t).any()):
        raise FloatingPointError(f"NaN detected in {name}")
