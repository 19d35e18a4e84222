"""Windowing, magnitude spectra and the L2 spectral fitness (port of
``pmfm_tpu/ops/spectral.py``: the ``"dft"``, ``"dft_factored"`` and
``"rfft"`` methods).

* Hann-like window ``w[i] = 1 - cos(i * (1/N - 1) * 2*pi)`` in float64.
* ``windowFactor = sum(w)/N``; magnitudes are normalised by
  ``1 / (N * windowFactor)``.
* Fitness: sum of squared differences between a candidate's normalised
  magnitude spectrum and the target's over the first ``num_bins`` bins.

``"dft"`` (n <= ``DFT_MAX_MATERIALIZE_N``): the real DFT as two matrix
products against ``window * cos/sin`` operands, with the window and the
normalisation folded in. The fused kernels take the FOLDED operand
``dft_packed`` (2K, N/2): ``w[N-n] = w[n]`` turns the windowed spectrum into
two half-length contractions over ``a+/- [n] = q[n] +- q[N-n]`` plus an
``x[N/2]`` edge term. In int8 mode its entries are ``round(63.5 * w[n] *
trig)`` and the normalisation moves to ``dft_packed_scale``; these bytes are
built by the same numpy code as the reference, so they match it exactly.
``magnitude_spectrum_prefolded`` contracts the synth_fold kernel's (B3)
folded audio against it: exactly in int32 for int8 (``torch._int_mm`` on the
card), in float32 from bf16 operands otherwise; ``magnitude_spectrum_folded``
folds and quantises unfused audio in torch first (the ``xla_folded_dft``
engine).

``"dft_factored"`` (above it): the four-step factored DFT (``FactoredOps``),
two matmul stages with an O(N) twiddle between them, fed by the synth_stream
kernel (B4) with audio it has already windowed.

``"rfft"``: ``torch.fft.rfft`` of the windowed float32 audio (cuFFT on the
card), where ``"auto"`` and non-factorable ``"dft"`` requests fall back to it
as in the reference.

The multi-frame spectra and the operand disk cache are not ported yet
(ROADMAP Queue A items 6 and 7).
"""
from __future__ import annotations

import math
import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..device import exact_f32_matmul, resolve_device

SPECTRUM_METHODS = ("rfft", "dft", "dft_factored", "auto")
DFT_DTYPES = ("float32", "bfloat16", "int8")

# The engine ladder's thresholds are the reference's, measured on a TPU v5e
# (pmfm_tpu/ops/spectral.py: the folded matmul against rfft up to 4096 for
# f32 and 16384 for bf16/int8; the streamed + factored engine against
# synth_fold at 32768). They are copied, not re-derived: the H100's times at
# n = 8192 and 65536 are in PERF.md as the first data for that (ROADMAP
# Queue A item 7).
AUTO_DFT_MAX_N = 4096
DFT_MAX_MATERIALIZE_N = 16384


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


class FactoredOps(NamedTuple):
    """Operands of the four-step factored DFT (method ``"dft_factored"``).

    With N = N1*N2, n = n1*N2 + n2 and k = k2*N1 + k1:

      A[k1, n2]  = sum_n1 y[n1, n2] * exp(-2i pi n1 k1 / N1)   (stage 1)
      B[k1, n2]  = A[k1, n2] * exp(-2i pi n2 k1 / N)           (twiddle)
      X[k2*N1+k1] = sum_n2 B[k1, n2] * exp(-2i pi n2 k2 / N2)  (stage 2)

    2N(N1+N2) real multiply-adds per candidate against N^2/2 for the direct
    form, with O(N) operand floats. Only bins k < N/2 are needed, so stage 2
    computes k2 < N2/2. float32; the magnitude normalisation rides in stage 2.
    """

    n1: int
    n2: int
    c1: torch.Tensor  # (N1, N1)  cos(2 pi n1 k1 / N1)
    s1n: torch.Tensor  # (N1, N1) -sin(2 pi n1 k1 / N1)
    tw_re: torch.Tensor  # (N1, N2)  cos(2 pi n2 k1 / N)   [k1 is axis 0]
    tw_imn: torch.Tensor  # (N1, N2) -sin(2 pi n2 k1 / N)
    c2: torch.Tensor  # (N2, N2//2)  cos(2 pi n2 k2 / N2) * norm
    s2n: torch.Tensor  # (N2, N2//2) -sin(2 pi n2 k2 / N2) * norm


def _factored_split(n: int) -> tuple[int, int]:
    """N = N1 * N2 with N1 >= N2, both powers of two (N1 = N2 or 2*N2)."""
    if n < 16 or n & (n - 1):
        raise ValueError(f"dft_factored needs a power-of-two n >= 16, got {n}")
    log2n = n.bit_length() - 1
    n1 = 1 << ((log2n + 1) // 2)
    return n1, n // n1


def _build_factored_operands(n: int, norm: float, device) -> FactoredOps:
    """Host-side float64 trig, cast to float32 (the reference's values)."""
    n1, n2 = _factored_split(n)
    i1 = np.arange(n1, dtype=np.float64)
    ang1 = 2.0 * math.pi * i1[:, None] * i1[None, :] / n1
    i2 = np.arange(n2, dtype=np.float64)
    angt = 2.0 * math.pi * i2[None, :] * i1[:, None] / n  # (N1 k1, N2 n2)
    k2 = np.arange(n2 // 2, dtype=np.float64)
    ang2 = 2.0 * math.pi * i2[:, None] * k2[None, :] / n2

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    return FactoredOps(
        n1=n1, n2=n2, c1=f32(np.cos(ang1)), s1n=f32(-np.sin(ang1)), tw_re=f32(np.cos(angt)),
        tw_imn=f32(-np.sin(angt)), c2=f32(np.cos(ang2) * norm), s2n=f32(-np.sin(ang2) * norm),
    )


class SpectrumOps(NamedTuple):
    """Precomputed constants for one DFT size, on one device."""

    n: int
    num_bins: int
    window: torch.Tensor  # (N,) float32
    norm: float  # 1 / (N * windowFactor)
    dft_cos: torch.Tensor | None  # (N, K) window & norm folded in ("dft" only)
    dft_sin: torch.Tensor | None
    method: str
    dft_dtype: torch.dtype  # the engine's dtype: bf16 in the int8 and bf16 configs
    # FOLDED (2K, N/2) kernel operand: int8 (dft_packed_scale > 0), bf16 or f32
    dft_packed: torch.Tensor | None = None
    dft_packed_scale: float = 0.0
    factored: FactoredOps | None = None  # "dft_factored" only
    # a float32 dft_packed rounded to bf16 once: what B3's bf16 mode (the
    # refine tail's synth_fold engine) contracts with
    dft_packed_bf16: torch.Tensor | None = None


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


def resolve_method(n: int, num_bins: int, method: str, dft_dtype: str) -> str:
    """The spectrum engine ``make_spectrum_ops`` builds for a request, as the
    reference resolves it: ``"auto"`` takes the matmul DFT up to
    ``AUTO_DFT_MAX_N`` (``DFT_MAX_MATERIALIZE_N`` in the bf16 and int8
    configs), the factored DFT above ``DFT_MAX_MATERIALIZE_N`` where the frame
    factors, else ``"rfft"``; ``"dft"`` above ``DFT_MAX_MATERIALIZE_N`` becomes
    ``"dft_factored"``, or ``"rfft"`` with a warning where it does not factor."""
    if method not in SPECTRUM_METHODS:
        raise ValueError(f"method must be one of {SPECTRUM_METHODS}, got {method!r}")
    factorable = n >= 16 and not (n & (n - 1)) and num_bins <= n // 2
    if method == "auto":
        limit = DFT_MAX_MATERIALIZE_N if dft_dtype in ("int8", "bfloat16") else AUTO_DFT_MAX_N
        if n <= limit:
            method = "dft"
        elif n > DFT_MAX_MATERIALIZE_N and factorable:
            method = "dft_factored"
        else:
            method = "rfft"
    if method == "dft" and n > DFT_MAX_MATERIALIZE_N:
        if factorable:
            method = "dft_factored"
        else:
            warnings.warn(
                f"spectrum method 'dft' at n={n} exceeds the operand materialisation limit "
                f"(DFT_MAX_MATERIALIZE_N={DFT_MAX_MATERIALIZE_N}) and the size/band does not "
                f"factor; falling back to rfft (different numerics)",
                stacklevel=3,
            )
            method = "rfft"
    if method == "dft_factored" and not factorable:
        raise ValueError(
            f"dft_factored needs a power-of-two n >= 16 and num_bins <= n/2 "
            f"(got n={n}, num_bins={num_bins})"
        )
    return method


def make_spectrum_ops(
    n: int,
    num_bins: int | None = None,
    method: str = "dft",
    dft_dtype: str = "float32",
    *,
    device: str | torch.device = "cuda",
) -> SpectrumOps:
    """Spectrum operands for ``n``-point frames on ``device``.

    ``dft_dtype`` is ``"float32"``, ``"bfloat16"`` or ``"int8"``; int8 gives
    the int8 folded kernel operand and keeps bf16 for everything else, as the
    reference does. ``method`` resolves as in ``resolve_method``.
    """
    dev = resolve_device(device)
    if dft_dtype not in DFT_DTYPES:
        raise ValueError(f"dft_dtype must be one of {DFT_DTYPES}, got {dft_dtype!r}")
    if num_bins is None:
        num_bins = default_num_bins(n)
    method = resolve_method(n, num_bins, method, dft_dtype)
    w = hann_window(n)
    norm = 1.0 / (n * window_factor(n))
    int8_mode = dft_dtype == "int8"
    if int8_mode:
        dft_dtype = "bfloat16"
    bf16 = dft_dtype == "bfloat16"
    dft_cos = dft_sin = dft_packed = factored = None
    dft_packed_scale = 0.0
    if method == "dft_factored":
        factored = _build_factored_operands(n, norm, dev)
    elif method == "dft":
        if int8_mode and n % 2:
            raise ValueError("the int8 folded engine needs even n")
        cos_out, sin_out, packed = _build_dft_operands(n, num_bins, w, norm, int8_mode, dft_dtype)
        dft_cos, dft_sin = _to_tensor(cos_out, bf16, dev), _to_tensor(sin_out, bf16, dev)
        if packed is not None:
            dft_packed = _to_tensor(packed, bf16 and not int8_mode, dev)
            if int8_mode:
                dft_packed_scale = norm / (63.5 * 63.0)
    return SpectrumOps(
        n=n,
        num_bins=num_bins,
        window=torch.from_numpy(w.astype(np.float32)).to(dev),
        norm=float(norm),
        dft_cos=dft_cos,
        dft_sin=dft_sin,
        method=method,
        dft_dtype=torch.bfloat16 if bf16 else torch.float32,
        dft_packed=dft_packed,
        dft_packed_scale=dft_packed_scale,
        factored=factored,
        dft_packed_bf16=packed_bf16(dft_packed),
    )


def packed_bf16(dft_packed: torch.Tensor | None) -> torch.Tensor | None:
    """``SpectrumOps.dft_packed_bf16`` of a folded operand: the bf16 rounding
    of a float32 one (the reference's ``dft_packed.astype(bfloat16)``), else
    None."""
    if dft_packed is None or dft_packed.dtype != torch.float32:
        return None
    return dft_packed.to(torch.bfloat16)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with a float32 result and float32 accumulation, as the
    reference's ``preferred_element_type=float32`` dots.

    float32 operands run with TF32 off (``Precision.HIGHEST``). bf16 operands
    multiply exactly (a product of two bf16 values is exact in float32): on
    the card in one cuBLAS call with a float32 output (``out_dtype``), since a
    bf16 ``torch.matmul`` would round its result to bf16, which the
    reference does not; on the CPU through float32 copies. ``a`` and ``b``
    are both 2-D or both batched (3-D)."""
    with exact_f32_matmul():
        if a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16 and a.is_cuda:
            mm = torch.mm if a.dim() == 2 else torch.bmm
            return mm(a, b, out_dtype=torch.float32)
        return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def magnitude_spectrum(audio_tm: torch.Tensor, ops: SpectrumOps) -> torch.Tensor:
    """``(N, pop)`` audio -> ``(pop, num_bins)`` normalised magnitudes.

    ``"dft"``: the audio is rounded to the operand dtype first (bf16 in the
    bf16 and int8 configs, as the reference does) and contracted with float32
    accumulation. ``"dft_factored"``: ``magnitude_spectrum_factored``.
    ``"rfft"``: ``|rfft(w * a)| * norm`` in float32 (cuFFT on the card).
    """
    if ops.method == "rfft":
        windowed = audio_tm.to(torch.float32) * ops.window[:, None]
        spec = torch.fft.rfft(windowed, dim=0)[: ops.num_bins]  # (bins, pop)
        return (torch.abs(spec) * float(np.float32(ops.norm))).T
    if ops.method == "dft_factored":
        return magnitude_spectrum_factored(audio_tm, ops)
    a = audio_tm.to(ops.dft_dtype)
    re = matmul_f32(a.T, ops.dft_cos)
    im = matmul_f32(a.T, ops.dft_sin)
    return torch.sqrt(re * re + im * im)


def magnitude_spectrum_folded(audio_tm: torch.Tensor, ops: SpectrumOps) -> torch.Tensor:
    """Normalised magnitude spectrum ``(pop, num_bins)`` of unfused ``(N, pop)``
    audio through the FOLDED operand (the reference's ``xla_folded_dft``
    engine): ``a+/-[m] = x[m] +- x[N-m]`` (``a+/-[0] = x[0]``), each contracted
    against its half of ``dft_packed``, and the ``x[N/2]`` edge term.

    int8 operand (``ops.dft_packed_scale > 0``): each candidate's a+/- and
    edge are quantised at 127 LSB to its folded peak (round half to even),
    the sums are exact in int32 (``prefolded_uv``: ``torch._int_mm`` on the
    card), the edge enters as ``127 (-1)^k`` times the quantised edge and
    the magnitude is rescaled by ``norm / 63.5 * peak / 127``. bf16 operand:
    a+/- rounded to bf16, float32 sums of exact products, edge coefficient
    ``2 norm (-1)^k``."""
    if ops.dft_packed is None:
        raise ValueError("the folded path needs SpectrumOps.dft_packed (even n)")
    n, k = ops.n, ops.num_bins
    half = n // 2
    x = audio_tm.to(torch.float32)
    xr = torch.cat([x[0:1], x[1:].flip(0)])[:half]
    # candidate-major (pop, N/2): prefolded_uv's operand layout
    a_plus = (x[:half] + xr).T.contiguous()
    a_minus = (x[:half] - xr).T.contiguous()
    edge = x[half]
    kpar = 1.0 - 2.0 * (torch.arange(k, device=x.device) % 2).to(torch.float32)
    if ops.dft_packed_scale > 0.0:
        peak = torch.maximum(
            a_plus.abs().amax(dim=1),
            torch.maximum(a_minus.abs().amax(dim=1), edge.abs()),
        )
        scale = torch.full_like(peak, 127.0) / torch.clamp_min(peak, 1e-30)
        qp = torch.round(a_plus * scale[:, None]).to(torch.int8)
        qm = torch.round(a_minus * scale[:, None]).to(torch.int8)
        u, v = prefolded_uv(qp.T, qm.T, ops)
        u, v = u.to(torch.float32), v.to(torch.float32)
        eq = torch.round(edge * scale)
        u = u + eq[:, None] * (127.0 * kpar)[None, :]
        rescale = (float(np.float32(ops.norm / 63.5)) * peak) / torch.full_like(peak, 127.0)
        return torch.sqrt(u * u + v * v) * rescale[:, None]
    qp, qm = a_plus.to(torch.bfloat16), a_minus.to(torch.bfloat16)
    packed = ops.dft_packed
    u = matmul_f32(qp, packed[:k].T)
    v = matmul_f32(qm, packed[k:].T)
    u = u + edge[:, None] * (2.0 * float(np.float32(ops.norm)) * kpar)[None, :]
    return torch.sqrt(u * u + v * v)


# working-set budget of one factored-DFT population chunk (the reference's:
# ~7 float32 arrays of N values per candidate)
FACTORED_CHUNK_BYTES = 1 << 31


def _factored_chunk(n: int, pop: int) -> int:
    per_cand = 28 * n  # x + A_re/im + B_re/im + 4 stage-2 temps, f32
    c = max(128, FACTORED_CHUNK_BYTES // per_cand)
    c = 1 << (c.bit_length() - 1)
    while pop % c:
        c //= 2
    return max(c, 1)


def magnitude_spectrum_factored(
    audio_tm: torch.Tensor, ops: SpectrumOps, *, prewindowed: bool = False
) -> torch.Tensor:
    """Normalised magnitude spectrum ``(pop, num_bins)`` of ``(N, pop)`` audio
    by the four-step factored DFT (``FactoredOps``).

    With a float32 ``ops.dft_dtype`` every stage runs in float32 with TF32
    off (the reference's ``Precision.HIGHEST``). Otherwise (bf16 and int8
    configs) the operands, the audio and the stage-1 and twiddle
    intermediates are bf16, as the reference casts them, and each matrix
    product accumulates in float32. ``prewindowed`` skips the window multiply
    (the synth_stream kernel, B4, applies it). The population is processed in
    chunks that bound the intermediates to ``FACTORED_CHUNK_BYTES``.
    """
    f = ops.factored
    if f is None:
        raise ValueError("magnitude_spectrum_factored needs SpectrumOps.factored")
    n1, n2 = f.n1, f.n2
    n, pop = audio_tm.shape
    cd = torch.float32 if ops.dft_dtype == torch.float32 else torch.bfloat16
    c1t, s1nt = f.c1.T.contiguous().to(cd), f.s1n.T.contiguous().to(cd)
    tw_re, tw_imn = f.tw_re.to(cd)[:, :, None], f.tw_imn.to(cd)[:, :, None]
    # stage 2's operands, one copy per k1 made once per call: bmm takes no
    # broadcast batch
    c2t, s2nt = (m.T.to(cd).expand(n1, n2 // 2, n2).contiguous() for m in (f.c2, f.s2n))
    if prewindowed:
        x = audio_tm.to(cd)
    else:
        x = (audio_tm.to(torch.float32) * ops.window[:, None]).to(cd)

    def one(chunk):  # (N, pc) -> (pc, num_bins)
        pc = chunk.shape[1]
        y = chunk.reshape(n1, n2 * pc)
        a_re = matmul_f32(c1t, y).reshape(n1, n2, pc).to(cd)  # (k1, n2, pc)
        a_im = matmul_f32(s1nt, y).reshape(n1, n2, pc).to(cd)
        b_re = a_re * tw_re - a_im * tw_imn
        b_im = a_re * tw_imn + a_im * tw_re
        # contract n2: (k1, N2/2, N2) @ (k1, N2, pc) -> (k1, N2/2, pc)
        x_re = matmul_f32(c2t, b_re) - matmul_f32(s2nt, b_im)
        x_im = matmul_f32(c2t, b_im) + matmul_f32(s2nt, b_re)
        mag = torch.sqrt(x_re * x_re + x_im * x_im)  # (k1, k2, pc)
        # k = k2*N1 + k1: to (pc, k2, k1) and flatten the band
        return mag.permute(2, 1, 0).reshape(pc, (n2 // 2) * n1)[:, : ops.num_bins]

    chunk = _factored_chunk(n, pop)
    if chunk >= pop:
        return one(x)
    return torch.cat([one(x[:, i : i + chunk]) for i in range(0, pop, chunk)])


def prefolded_uv(a_plus: torch.Tensor, a_minus: torch.Tensor, ops: SpectrumOps):
    """The folded DFT's two half-length contractions ``U = cos-half @ a+``,
    ``V = sin-half @ a-``, returned transposed: each (P, K), the spectra's
    own layout.

    The products run as ``a+^T @ cos-half^T``: with the synth_fold kernel's
    candidate-major a's (``a_plus.T`` is a contiguous (P, N/2) tensor) and
    the operand's transposed view, neither side is copied.

    int8 (``ops.dft_packed_scale > 0``): int32 sums, exact, bit-equal to the
    reference's (|U| reaches N/2 * 127 * 126, beyond float32's 2^24 from
    n = 4096 on). On the card ``torch._int_mm`` (int8 x int8 -> int32; it
    takes more than 16 rows, so a population of 16 or fewer is padded with
    zero rows); on the CPU a float64 product, exact at these sizes.
    Otherwise float32 sums of exact products against the bf16 operand: the
    reference's ``ops.dft_packed.astype(a_plus.dtype)``, which rounds the
    true-f32 operand of the refine tail to bf16 (``ops.dft_packed_bf16``,
    rounded once when the ops were built).
    """
    k = ops.num_bins
    packed = ops.dft_packed
    ap, am = a_plus.T, a_minus.T  # (P, N/2)
    if ops.dft_packed_scale > 0.0:
        cos_t, sin_t = packed[:k].T, packed[k:].T  # (N/2, K) views
        if ap.is_cuda:
            pop = ap.shape[0]
            pad = max(0, 17 - pop)
            if pad:
                ap = torch.nn.functional.pad(ap, (0, 0, 0, pad))
                am = torch.nn.functional.pad(am, (0, 0, 0, pad))
            return torch._int_mm(ap, cos_t)[:pop], torch._int_mm(am, sin_t)[:pop]
        f64 = torch.float64
        u = ap.to(f64) @ cos_t.to(f64)
        v = am.to(f64) @ sin_t.to(f64)
        return u.to(torch.int32), v.to(torch.int32)
    if packed.dtype == torch.float32:
        packed = ops.dft_packed_bf16
    return matmul_f32(ap, packed[:k].T), matmul_f32(am, packed[k:].T)


def magnitude_spectrum_prefolded(
    a_plus: torch.Tensor,
    a_minus: torch.Tensor,
    edge: torch.Tensor,
    mag_scale: torch.Tensor,
    ops: SpectrumOps,
) -> torch.Tensor:
    """Spectrum ``(pop, num_bins)`` from the synth_fold kernel's (B3) folded
    audio: ``prefolded_uv``, the x[N/2] edge term (``127 (-1)^k`` in int8
    mode, ``2 norm (-1)^k`` otherwise), magnitude, per-candidate rescale.
    The element-wise steps run in place on U and V, in the reference's
    order of roundings."""
    k = ops.num_bins
    u, v = prefolded_uv(a_plus, a_minus, ops)
    u, v = u.to(torch.float32), v.to(torch.float32)
    kpar = 1.0 - 2.0 * (torch.arange(k, device=u.device) % 2).to(torch.float32)
    edge_norm = 127.0 if ops.dft_packed_scale > 0.0 else 2.0 * float(ops.norm)
    u += edge[:, None] * (edge_norm * kpar)[None, :]
    u.mul_(u)
    v.mul_(v)
    return u.add_(v).sqrt_().mul_(mag_scale[:, None])


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


# Multi-frame STFT fitness (the reference's BASELINE.json config 2): a
# candidate synthesises F N continuous samples and is scored against the
# target's framewise magnitude spectra with one parameter set, where
# match_audio starts a fresh population for each chunk.


def magnitude_spectrum_frames(audio_tm: torch.Tensor, ops: SpectrumOps) -> torch.Tensor:
    """Framewise spectra of ``(F N, pop)`` audio -> ``(F, pop, num_bins)``:
    frame f (samples [f N, (f + 1) N)) through ``magnitude_spectrum`` in the
    spectrum method's own way (the matmul DFT and rfft take every frame in
    one call, the factored DFT frame by frame)."""
    total, pop = audio_tm.shape
    frames = total // ops.n
    a = audio_tm[: frames * ops.n].reshape(frames, ops.n, pop)
    if ops.method == "dft_factored":
        return torch.stack([magnitude_spectrum_factored(a[f], ops) for f in range(frames)])
    # (N, F pop): column f pop + p is frame f of candidate p
    cols = a.permute(1, 0, 2).reshape(ops.n, frames * pop)
    return magnitude_spectrum(cols, ops).reshape(frames, pop, -1)


def target_spectrum_frames(target_audio: torch.Tensor, ops: SpectrumOps) -> torch.Tensor:
    """``(F N,)`` target -> ``(F, num_bins)`` framewise spectra."""
    return magnitude_spectrum_frames(target_audio[:, None], ops)[:, 0, :]


def stft_fitness(audio_tm: torch.Tensor, target_frames: torch.Tensor, ops: SpectrumOps) -> torch.Tensor:
    """Summed framewise L2 spectral error: ``(F N, pop), (F, bins) -> (pop,)``."""
    spectra = magnitude_spectrum_frames(audio_tm, ops)  # (F, pop, bins)
    d = spectra - target_frames[:, None, :]
    return torch.sum(d * d, dim=(0, 2))
