"""Wavetable oscillator primitives (port of ``pmfm_tpu/ops/wavetable.py``).

The reference synthesises with a 32768-entry sine wavetable,
``wavetable[i] = sinf(i / (size - 1) * 2 * pi)``, looked up with a
truncating cast of a float phase accumulator kept in wavetable units.

* ``osc_mode="floor"`` — ``sin(floor(pos) * 2*pi / (size-1))``: the same
  function the reference table lookup computes (up to libm rounding).
* ``osc_mode="exact"`` — ``sin(pos * 2*pi / (size-1))``.
* ``osc_mode="table"`` — a real gather from a device-resident table.
"""
from __future__ import annotations

import math

import numpy as np
import torch

DEFAULT_WAVETABLE_SIZE = 32768
DEFAULT_SAMPLE_RATE = 44100

OSC_MODES = ("floor", "exact", "table")


def build_wavetable(size: int = DEFAULT_WAVETABLE_SIZE, dtype=np.float32) -> np.ndarray:
    """Host-side sine wavetable, identical to the reference's initWavetable."""
    i = np.arange(size, dtype=np.float64)
    return np.sin(i / (size - 1.0) * 2.0 * math.pi).astype(dtype)


def wrap_pos(pos: torch.Tensor, size: float) -> torch.Tensor:
    """Wrap a phase accumulator that only grows: ``if (p >= size) p -= size``."""
    return torch.where(pos >= size, pos - size, pos)


def wrap_pos_both(pos: torch.Tensor, size: float) -> torch.Tensor:
    """Wrap a phase accumulator that can also go negative."""
    pos = torch.where(pos >= size, pos - size, pos)
    return torch.where(pos < 0.0, pos + size, pos)


def make_osc(osc_mode: str, wavetable_size: int, wavetable: torch.Tensor | None = None):
    """Return ``osc(pos) -> sample`` for phase in wavetable units [0, size)."""
    if osc_mode not in OSC_MODES:
        raise ValueError(f"osc_mode must be one of {OSC_MODES}, got {osc_mode!r}")
    scale = float(np.float32(2.0 * math.pi / (wavetable_size - 1.0)))
    if osc_mode == "floor":

        def osc(pos):
            return torch.sin(torch.floor(pos) * scale)

    elif osc_mode == "exact":

        def osc(pos):
            return torch.sin(pos * scale)

    else:

        def osc(pos):
            wt = wavetable
            if wt is None:
                wt = torch.from_numpy(build_wavetable(wavetable_size)).to(pos.device)
            idx = torch.clamp(pos.to(torch.int64), 0, wavetable_size - 1)
            return wt[idx]

    return osc
