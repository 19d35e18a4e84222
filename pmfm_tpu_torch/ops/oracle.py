"""NumPy "CPU reference" twin of the ops layer — the FFTW-path ground truth
(a copy of ``pmfm_tpu/ops/oracle.py``, numpy only).

This mirrors the reference CPU implementation semantics
(Objective::synthesiseAudio* Evolutionary_Strategy.hpp:368-495,
Objective::calculateFFT :524-542) with an actual float32 wavetable and
truncating table lookups, exactly like the C++ code. It exists so the
pipeline can be golden-tested against an independent scalar implementation
(SURVEY.md §4 test-strategy item (b)); it is deliberately slow and never used
in the production path.

Deviations from the C++ (documented quirks, SURVEY.md §7.4):
* phase accumulators reset to zero per candidate (the C++ Objective carries
  them across calls via member variables — GPU kernels reset them, so the
  GPU/zero-reset behaviour is the intended semantics);
* scaling uses mins + v*(maxs-mins) (the GPU/scaleParams form); the C++
  synthesiseAudio* uses v*maxs which is identical for the all-zero mins the
  reference always runs with.
"""
from __future__ import annotations

import math

import re

import numpy as np

from .wavetable import DEFAULT_SAMPLE_RATE, DEFAULT_WAVETABLE_SIZE, build_wavetable


def _series_ops(topology: str):
    # numpy-only twin of ops.synthesis.series_ops (keeps the oracle torch-free)
    m = re.match(r"^fm(\d+)_series$", topology)
    return int(m.group(1)) if m and int(m.group(1)) >= 3 else None


def _parallel_pairs(topology: str):
    m = re.match(r"^fm(\d+)_parallel$", topology)
    return int(m.group(1)) if m and int(m.group(1)) >= 2 else None


def scale_params_np(values, mins, maxs):
    values = np.asarray(values, np.float32)
    return np.asarray(mins, np.float32) + values * (
        np.asarray(maxs, np.float32) - np.asarray(mins, np.float32)
    )


class OracleObjective:
    """Scalar float32 mirror of the reference Objective."""

    def __init__(
        self,
        n_samples: int,
        wavetable_size: int = DEFAULT_WAVETABLE_SIZE,
        sample_rate: int = DEFAULT_SAMPLE_RATE,
        num_bins: int | None = None,
    ):
        self.n = int(n_samples)
        self.wavetable = build_wavetable(wavetable_size)
        self.wavetable_size = wavetable_size
        self.w2sr = np.float32(wavetable_size / float(sample_rate))
        self.num_bins = self.n // 2 if num_bins is None else int(num_bins)
        i = np.arange(self.n, dtype=np.float64)
        self.window = 1.0 - np.cos(i * (1.0 / self.n - 1.0) * 2.0 * math.pi)
        self.window_factor = float(self.window.sum() / self.n)
        self.norm = np.float32((1.0 / self.n) * (1.0 / self.window_factor))

    # -- synthesis ---------------------------------------------------------
    def _osc(self, pos: np.float32) -> np.float32:
        return self.wavetable[int(pos)]

    def synthesize(self, params_scaled, topology: str = "fm3_series") -> np.ndarray:
        p = np.asarray(params_scaled, np.float32)
        out = np.zeros(self.n, np.float32)
        size = np.float32(self.wavetable_size)
        w2sr = self.w2sr
        if topology == "fm2":
            m = np.float32(p[0] * p[1])
            cf, amp = np.float32(p[2]), np.float32(p[3])
            inc1 = np.float32(w2sr * p[0])
            pos1 = pos2 = np.float32(0.0)
            for i in range(self.n):
                cur = np.float32(self._osc(pos1) * m + cf)
                pos1 = np.float32(pos1 + inc1)
                if pos1 >= size:
                    pos1 = np.float32(pos1 - size)
                out[i] = np.float32(self._osc(pos2) * amp)
                pos2 = np.float32(pos2 + w2sr * cur)
                if pos2 >= size:
                    pos2 = np.float32(pos2 - size)
                if pos2 < 0.0:
                    pos2 = np.float32(pos2 + size)
        elif _series_ops(topology):
            # generic k-operator serial chain (k=3 = reference DoubleSeries)
            kn = _series_ops(topology)
            ms = [np.float32(p[2 * j] * p[2 * j + 1]) for j in range(kn)]
            cs = [np.float32(p[2 * j + 3]) for j in range(kn - 1)]
            inc1 = np.float32(w2sr * p[1])
            poss = [np.float32(0.0)] * kn
            for i in range(self.n):
                cur = np.float32(self._osc(poss[0]) * ms[0] + cs[0])
                poss[0] = np.float32(poss[0] + inc1)
                if poss[0] >= size:
                    poss[0] = np.float32(poss[0] - size)
                for j in range(1, kn - 1):
                    nxt_cur = np.float32(self._osc(poss[j]) * ms[j] + cs[j])
                    poss[j] = np.float32(poss[j] + w2sr * cur)
                    if poss[j] >= size:
                        poss[j] = np.float32(poss[j] - size)
                    if poss[j] < 0.0:
                        poss[j] = np.float32(poss[j] + size)
                    cur = nxt_cur
                jl = kn - 1
                out[i] = np.float32(self._osc(poss[jl]) * ms[jl])
                poss[jl] = np.float32(poss[jl] + w2sr * cur)
                if poss[jl] >= size:
                    poss[jl] = np.float32(poss[jl] - size)
                if poss[jl] < 0.0:
                    poss[jl] = np.float32(poss[jl] + size)
        elif _parallel_pairs(topology):
            kp = _parallel_pairs(topology)
            p = p.reshape(kp, 4)
            acc = np.stack([self.synthesize(p[j], "fm2") for j in range(kp)])
            # average of the k 2-op pairs (Evolutionary_Strategy.hpp:493)
            out = (acc.sum(axis=0) / np.float32(kp)).astype(np.float32)
        else:
            raise ValueError(topology)
        return out

    # -- spectrum / fitness ------------------------------------------------
    def magnitude_spectrum(self, audio: np.ndarray) -> np.ndarray:
        """Objective::calculateFFT: double-precision window+FFT, float32
        magnitude normalisation (Evolutionary_Strategy.hpp:524-542)."""
        windowed = audio.astype(np.float64) * self.window
        spec = np.fft.rfft(windowed)[: self.num_bins]
        raw = np.hypot(spec.real, spec.imag).astype(np.float32)
        return (raw * self.norm).astype(np.float32)

    def fitness(self, spectrum: np.ndarray, target: np.ndarray) -> np.float32:
        d = spectrum.astype(np.float64) - target.astype(np.float64)
        return np.float32(np.sum(d * d))
