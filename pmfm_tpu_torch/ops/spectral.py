"""Windowing, magnitude spectra and the L2 spectral fitness (port of
``pmfm_tpu/ops/spectral.py``, the ``"dft"`` method).

* Hann-like window ``w[i] = 1 - cos(i * (1/N - 1) * 2*pi)`` in float64.
* ``windowFactor = sum(w)/N``; magnitudes are normalised by
  ``1 / (N * windowFactor)``.
* Fitness: sum of squared differences between a candidate's normalised
  magnitude spectrum and the target's over the first ``num_bins`` bins.

The spectrum is the real DFT as two matrix products against
``window * cos/sin`` operands, with the window and the normalisation folded
in. The fused kernels take the FOLDED operand ``dft_packed`` (2K, N/2):
``w[N-n] = w[n]`` turns the windowed spectrum into two half-length
contractions over ``a+/- [n] = q[n] +- q[N-n]`` plus an ``x[N/2]`` edge
term. In int8 mode its entries are ``round(63.5 * w[n] * trig)`` and the
normalisation moves to ``dft_packed_scale``; these bytes are built by the
same numpy code as the reference, so they match it exactly.

The rfft and factored engines, the operand disk cache and the multi-frame
spectra wait for later slices (ROADMAP Queue A items 9-10).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..device import exact_f32_matmul, resolve_device

SPECTRUM_METHODS = ("dft",)
DFT_MAX_MATERIALIZE_N = 16384
DFT_DTYPES = ("float32", "bfloat16", "int8")


def hann_window(n: int) -> np.ndarray:
    """Reference window, float64."""
    i = np.arange(n, dtype=np.float64)
    return 1.0 - np.cos(i * (1.0 / n - 1.0) * 2.0 * math.pi)


def window_factor(n: int) -> float:
    """windowFactor = sum(w)/N; ~1.0."""
    return float(hann_window(n).sum() / n)


def default_num_bins(n: int) -> int:
    """CPU ground-truth bin count N/2."""
    return n // 2


class SpectrumOps(NamedTuple):
    """Precomputed constants for one DFT size, on one device."""

    n: int
    num_bins: int
    window: torch.Tensor  # (N,) float32
    norm: float  # 1 / (N * windowFactor)
    dft_cos: torch.Tensor  # (N, K) window & norm folded in
    dft_sin: torch.Tensor
    method: str
    dft_dtype: torch.dtype  # dtype of dft_cos/dft_sin (bf16 in int8 mode)
    # FOLDED (2K, N/2) kernel operand: int8 (dft_packed_scale > 0), bf16 or f32
    dft_packed: torch.Tensor | None = None
    dft_packed_scale: float = 0.0


def _bf16_bytes(a: np.ndarray) -> np.ndarray:
    """float64 -> bfloat16 bit patterns (int16), rounded to nearest even
    through float32, which gives the reference's bytes."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).view(torch.int16).numpy()


def _build_dft_operands(n, num_bins, w, norm, int8_mode, out_dtype):
    """Host-side construction of the DFT operands over blocks of time rows.

    Returns ``(cos_out (N, K), sin_out (N, K), packed (2K, N/2) or None)`` as
    numpy arrays: float32, or int16 bfloat16 bit patterns when ``out_dtype``
    is ``"bfloat16"``. ``packed`` is int8 ``round(63.5*w*trig)`` in int8 mode,
    else window+norm folded in at ``out_dtype``. The per-element arithmetic
    (float64 trig times window, one cast) is the reference's, so every
    output bit is too.
    """
    bf16 = out_dtype == "bfloat16"
    k = np.arange(num_bins, dtype=np.float64)[None, :]
    cos_out = np.empty((n, num_bins), np.int16 if bf16 else np.float32)
    sin_out = np.empty_like(cos_out)
    packed = None
    if int8_mode:
        packed = np.empty((2 * num_bins, n // 2), np.int8)
    elif n % 2 == 0:
        packed = np.empty((2 * num_bins, n // 2), cos_out.dtype)
    blk = max(128, (1 << 25) // max(num_bins, 1))
    for t0 in range(0, n, blk):
        t1 = min(t0 + blk, n)
        t = np.arange(t0, t1, dtype=np.float64)[:, None]
        ang = 2.0 * math.pi * t * k / n
        c_raw = np.cos(ang) * w[t0:t1, None]
        s_raw = np.sin(ang) * -w[t0:t1, None]
        if bf16:
            cos_out[t0:t1] = _bf16_bytes(c_raw * norm)
            sin_out[t0:t1] = _bf16_bytes(s_raw * norm)
        else:
            cos_out[t0:t1] = c_raw * norm
            sin_out[t0:t1] = s_raw * norm
        if packed is not None and t0 < n // 2:
            p1 = min(t1, n // 2)
            rows = slice(0, p1 - t0)
            if int8_mode:
                packed[:num_bins, t0:p1] = np.round(c_raw[rows].T * 63.5)
                packed[num_bins:, t0:p1] = np.round(s_raw[rows].T * 63.5)
            else:
                cp = (c_raw[rows] * norm).astype(np.float32).T
                sp = (s_raw[rows] * norm).astype(np.float32).T
                packed[:num_bins, t0:p1] = _bf16_bytes(cp) if bf16 else cp
                packed[num_bins:, t0:p1] = _bf16_bytes(sp) if bf16 else sp
    return cos_out, sin_out, packed


def _to_tensor(a: np.ndarray, bf16: bool, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if bf16:
        t = t.view(torch.bfloat16)
    return t.to(device)


def make_spectrum_ops(
    n: int,
    num_bins: int | None = None,
    method: str = "dft",
    dft_dtype: str = "float32",
    *,
    device: str | torch.device = "cuda",
) -> SpectrumOps:
    """DFT operands for ``n``-point frames on ``device``.

    ``dft_dtype`` is ``"float32"``, ``"bfloat16"`` or ``"int8"``; int8 gives
    the int8 folded kernel operand and keeps bf16 for ``dft_cos/dft_sin``,
    as the reference does.
    """
    dev = resolve_device(device)
    if method not in SPECTRUM_METHODS:
        raise NotImplementedError(f"spectrum method {method!r} is not ported yet (dft only)")
    if dft_dtype not in DFT_DTYPES:
        raise ValueError(f"dft_dtype must be one of {DFT_DTYPES}, got {dft_dtype!r}")
    if n > DFT_MAX_MATERIALIZE_N:
        raise NotImplementedError(
            f"n={n} > DFT_MAX_MATERIALIZE_N={DFT_MAX_MATERIALIZE_N} needs the factored "
            f"DFT engine, which is not ported yet"
        )
    if num_bins is None:
        num_bins = default_num_bins(n)
    w = hann_window(n)
    norm = 1.0 / (n * window_factor(n))
    int8_mode = dft_dtype == "int8"
    if int8_mode:
        if n % 2:
            raise ValueError("the int8 folded engine needs even n")
        dft_dtype = "bfloat16"
    bf16 = dft_dtype == "bfloat16"
    cos_out, sin_out, packed = _build_dft_operands(n, num_bins, w, norm, int8_mode, dft_dtype)
    dft_packed = None
    dft_packed_scale = 0.0
    if packed is not None:
        dft_packed = _to_tensor(packed, bf16 and not int8_mode, dev)
        if int8_mode:
            dft_packed_scale = norm / (63.5 * 63.0)
    return SpectrumOps(
        n=n,
        num_bins=num_bins,
        window=torch.from_numpy(w.astype(np.float32)).to(dev),
        norm=float(norm),
        dft_cos=_to_tensor(cos_out, bf16, dev),
        dft_sin=_to_tensor(sin_out, bf16, dev),
        method=method,
        dft_dtype=torch.bfloat16 if bf16 else torch.float32,
        dft_packed=dft_packed,
        dft_packed_scale=dft_packed_scale,
    )


def magnitude_spectrum(audio_tm: torch.Tensor, ops: SpectrumOps) -> torch.Tensor:
    """``(N, pop)`` audio -> ``(pop, num_bins)`` normalised magnitudes.

    The audio is rounded to the operand dtype first (bf16 in the bf16 and
    int8 configs, as the reference does); the products of two bf16 values
    are exact in float32, so the contraction runs in float32 with TF32 off.
    """
    a = audio_tm.to(ops.dft_dtype).to(torch.float32)
    with exact_f32_matmul():
        re = a.T @ ops.dft_cos.to(torch.float32)
        im = a.T @ ops.dft_sin.to(torch.float32)
    return torch.sqrt(re * re + im * im)


def target_spectrum(target_audio: torch.Tensor, ops: SpectrumOps) -> torch.Tensor:
    """Spectrum of one target frame ``(N,)`` -> ``(num_bins,)``."""
    return magnitude_spectrum(target_audio[:, None], ops)[0]


def spectral_fitness(spectra: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``sum_k (spectra[p, k] - target[k])^2`` -> ``(pop,)``."""
    d = spectra - target[None, :]
    return torch.sum(d * d, dim=-1)


def evaluate_fitness(audio_tm: torch.Tensor, target: torch.Tensor, ops: SpectrumOps) -> torch.Tensor:
    """window -> spectrum -> L2 error: ``(N, pop), (bins,) -> (pop,)``."""
    return spectral_fitness(magnitude_spectrum(audio_tm, ops), target)
