"""The true-f32 mode of the port's kernels B1 (fused_synth_fitness) and B2
(fused_generation), in their plain PyTorch versions on the CPU, against the
pmfm_tpu Pallas kernels in interpret mode with the float32 folded operand
and ``dft_scale=0`` (the refine tail's engine, ``_evaluate_block``'s
``audio_f32``).

Tolerances (``_assert_fitness_close``). Fitness: relative error at most
1e-3 (max) and 1e-5 (median) for every candidate whose fitness is above
1e-3 of the population's median; below that (the planted truth, a residue
of 4e-6 against a median of ~4 for fm2) a relative error measures float32
noise, so there the absolute error is held to 1e-6 of the median. Neither
side quantises the audio here, so the gap is the phase prefix sums' float32
summation order (a triangular matmul in the reference, a running sum in the
port) plus the f32 contractions' own order. Measured on this file's inputs:
at most 3.4e-5 relative above the floor, medians 1.1e-7 to 1.2e-6, and
1.9e-7 of the median absolute on the truth. B2 offspring values and steps
under the same injected draws are exact.

The kernels' FFT route (power-of-two frames, csrc ``fused_f32.cu::
f32_fft_kernel``) has no plain version of its own: its function is the plain
version's, in another summation order. ``_fft_emulation`` here runs the
kernel's order in numpy float32 (the same Stockham passes, twiddle table,
window, real split and epilogue; every kernel operation is a single
rounding, no FMA), and is held against the plain version within the card's
f32 gates (1e-5 max, 1e-6 median relative: the same audio on both sides),
against the reference as ``test_b1_f32_plain_matches_reference`` holds the
plain version, and against a float64 evaluation of the same audio by C1's
rule: no further than 1.5x the plain version.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmfm_tpu.es import ESConfig as JConfig
from pmfm_tpu.kernels import synth_fitness as jsf
from pmfm_tpu.kernels.generation import fused_generation as j_fused_generation
from pmfm_tpu.ops import spectral as jspec
from pmfm_tpu.ops import synthesis as jsyn
from pmfm_tpu_torch.kernels import generation as tgen
from pmfm_tpu_torch.kernels import synth_fitness as tsf
from pmfm_tpu_torch.ops import spectral as tspec

FIT_MAX_REL, FIT_MEDIAN_REL = 1e-3, 1e-5
F32_FIT_MAX_REL, F32_FIT_MEDIAN_REL = 1e-5, 1e-6  # the card's kernel-vs-plain gates
REL_FLOOR, ABS_OF_MEDIAN = 1e-3, 1e-6
POP, PB = 16, 8
TRUTH = {
    "fm2": (3078.0, 2.0, 3015.0, 1.5),
    "fm3_series": (3078.0, 2.0, 3015.0, 1.5, 3141.0, 1.0),
    "fm3_parallel": (3076.48, 2.0, 3016.64, 0.9, 1936.0, 2.4, 2182.4, 0.8, 1500.0, 1.0,
                     1200.0, 0.5),
}
MAXS = {"fm2": (3520.0, 8.0) * 2, "fm3_series": (3520.0, 8.0) * 3,
        "fm3_parallel": (3520.0, 8.0, 3520.0, 1.0) * 3}


def _operands(n):
    return (jspec.make_spectrum_ops(n, dft_dtype=jnp.float32),
            tspec.make_spectrum_ops(n, dft_dtype="float32", device="cpu"))


def _target(topology, n, so):
    audio = np.asarray(jsyn.synthesize_single(jnp.asarray(TRUTH[topology]), n, topology))
    return np.array(jspec.target_spectrum(jnp.asarray(audio), so))


def _assert_fitness_close(got, ref):
    med = np.median(np.abs(ref))
    rel = np.abs(got - ref) / np.abs(ref)
    big = np.abs(ref) > REL_FLOOR * med
    assert rel[big].max() <= FIT_MAX_REL and np.median(rel) <= FIT_MEDIAN_REL, (
        rel[big].max(), np.median(rel))
    assert np.all(np.abs(got - ref)[~big] <= ABS_OF_MEDIAN * med)


def test_operand_is_the_references():
    so, to = _operands(256)
    assert to.dft_packed.dtype == torch.float32 and to.dft_packed_scale == 0.0
    np.testing.assert_array_equal(to.dft_packed.numpy(), np.asarray(so.dft_packed))
    assert tsf.edge_norm(256, False) == np.float32(2.0 / (256 * jspec.window_factor(256)))


@pytest.mark.parametrize("n", [256, 1024])
@pytest.mark.parametrize("topology", ["fm2", "fm3_series"])
@pytest.mark.parametrize("sine_order", [7, 9])
def test_b1_f32_plain_matches_reference(n, topology, sine_order):
    so, to = _operands(n)
    tgt = _target(topology, n, so)
    rng = np.random.default_rng(sine_order + n)
    params = (rng.random((POP, len(TRUTH[topology]))) * np.asarray(MAXS[topology])).astype(np.float32)
    params[0] = TRUTH[topology]
    ref = np.asarray(jsf.fused_synth_fitness(
        jnp.asarray(params), so.dft_cos, so.dft_sin, jnp.asarray(tgt), topology=topology, n=n,
        pop_block=PB, interpret=True, dft_packed=so.dft_packed, dft_scale=0.0,
        sine_order=sine_order,
    ))
    before = tsf.fused_synth_fitness.launches
    got = tsf.fused_synth_fitness(
        torch.from_numpy(params), torch.from_numpy(tgt), dft_packed=to.dft_packed, dft_scale=0.0,
        topology=topology, n=n, pop_block=PB, sine_order=sine_order,
    ).numpy()
    assert tsf.fused_synth_fitness.launches == before  # CPU tensors: the plain version
    assert got.shape == (POP,) and np.isfinite(got).all()
    _assert_fitness_close(got, ref)
    assert np.argmin(ref) == 0 and np.argmin(got) == 0  # the truth ranks first in both


def test_f32_fold_and_dft_fitness_definitions():
    """The f32 fold keeps x[n] +- x[N-n] unrounded but for the sum itself;
    dft_fitness_plain has no magnitude rescale and the 2 norm edge term."""
    n, k = 256, 128
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((n, 2)).astype(np.float32))
    ap, am, edge = tsf.fold(x)
    assert ap.dtype == torch.float32 and torch.equal(edge, x[n // 2])
    assert torch.equal(ap[0], x[0]) and torch.equal(am[0], x[0])
    assert torch.equal(ap[5], x[5] + x[n - 5]) and torch.equal(am[5], x[5] - x[n - 5])
    _, to = _operands(n)
    tgt = torch.zeros(k)
    fit = tsf.dft_fitness_plain(ap, am, edge, None, to.dft_packed, 0.0, tgt)
    xw = x.double() * torch.from_numpy(tspec.hann_window(n))[:, None] * to.norm
    mag = torch.fft.rfft(xw, dim=0)[:k].abs()
    np.testing.assert_allclose(fit.numpy(), (mag ** 2).sum(0).numpy(), rtol=1e-5)


@pytest.mark.parametrize("topology", ["fm2", "fm3_series"])
def test_b2_f32_plain_injected_draws_match_reference(topology):
    """All-zero draws (the Pallas interpreter's): offspring values and steps
    bit-equal, fitness within the B1 f32 tolerance."""
    n, d, mu = 256, len(TRUTH[topology]), 4
    cfg = JConfig(num_parents=mu, num_offspring=POP - mu, num_dimensions=d, topology=topology,
                  param_mins=(0.0,) * d, param_maxs=MAXS[topology], min_step=1e-4,
                  mutation_noise="clt12_neutral")
    so, to = _operands(n)
    tgt = _target(topology, n, so)
    rng = np.random.default_rng(d)
    pv = rng.random((mu, d)).astype(np.float32)
    ps = rng.uniform(0.01, 0.4, (mu, d)).astype(np.float32)
    kw = dict(pop=POP, param_mins=cfg.param_mins, param_maxs=cfg.param_maxs, topology=topology,
              n=n, pop_block=PB, alpha=cfg.alpha, beta=cfg.beta, beta_scale=cfg.beta_scale,
              root_two_over_pi=cfg.root_two_over_pi, clamp_values=False, min_step=1e-4,
              sine_order=9)
    fit_r, val_r, step_r = j_fused_generation(
        jnp.asarray(7, jnp.int32), jnp.asarray(pv), jnp.asarray(ps), so.dft_cos, so.dft_sin,
        jnp.asarray(tgt), interpret=True, dft_packed=so.dft_packed, dft_scale=0.0, **kw,
    )
    val_r, step_r = np.asarray(val_r)[:d].T, np.asarray(step_r)[:d].T
    draws = (np.zeros((POP, d), np.int64), np.zeros((POP, d), np.int64),
             np.zeros((12, POP, d), np.float32))
    fit, val, step = tgen.fused_generation(
        7, torch.from_numpy(pv), torch.from_numpy(ps), torch.from_numpy(tgt),
        dft_packed=to.dft_packed, dft_scale=0.0, draws=draws, **kw,
    )
    np.testing.assert_array_equal(val.numpy(), val_r)
    np.testing.assert_array_equal(step.numpy(), step_r)
    _assert_fitness_close(fit.numpy(), np.asarray(fit_r))


def test_b2_f32_plain_is_b1_f32_of_its_offspring():
    n, topology, d, mu = 256, "fm3_series", 6, 8
    _, to = _operands(n)
    tgt = torch.rand(to.num_bins, generator=torch.Generator().manual_seed(0)) * 10
    pv = torch.rand((mu, d), generator=torch.Generator().manual_seed(1))
    ps = torch.full((mu, d), 0.05)
    kw = dict(pop=POP, param_mins=(0.0,) * d, param_maxs=MAXS[topology], topology=topology,
              n=n, pop_block=PB, dft_packed=to.dft_packed, dft_scale=0.0, sine_order=9)
    fit, val, _ = tgen.fused_generation(123, pv, ps, tgt, **kw)
    scaled = tgen.scale_rows(val, kw["param_mins"], kw["param_maxs"])
    b1 = tsf.fused_synth_fitness(scaled, tgt, dft_packed=to.dft_packed, dft_scale=0.0,
                                 topology=topology, n=n, pop_block=PB, sine_order=9)
    assert torch.equal(fit, b1)


@pytest.mark.parametrize("n,f32,fits", [(1024, True, True), (3584, True, True),
                                        (3840, True, False), (3584, False, True),
                                        (4096, False, False)])
def test_shared_memory_limit(n, f32, fits):
    """One definition of the fused kernels' size limit, in the int8 and f32
    modes (the operand's dtype; bf16: tests/test_torch_bf16.py): the stated
    frame limit, and each mode's block within shared memory."""
    dtype = torch.float32 if f32 else torch.int8
    assert tsf.fits_shared_memory(n, dtype) is fits
    assert tsf.shared_bytes(n, dtype) == (92160 if f32 else 32 * n)
    assert tsf.shared_bytes(n, dtype) <= tsf.MAX_SHARED_BYTES


@pytest.mark.parametrize("n", list(range(256, 3585, 256)) + [3840, 4096, 8192])
def test_int8_frame_limit(n):
    """The int8 B1/B2 (32 candidates a block), which B5 runs, take every
    frame the router sends them, multiples of 256 up to 3584, under the one
    limit."""
    assert tsf.fits_shared_memory(n, torch.int8) is (n <= 3584)
    assert tsf.shared_bytes(n, torch.int8) == 32 * n
    assert tsf.CUDA_BLOCK == 32 and tsf.MAX_FUSED_N == 3584


@pytest.mark.parametrize("n", list(range(256, 4097, 256)) + [8192])
def test_f32_frame_limit(n):
    """The true-f32 B1/B2 keep a+/a- in scratch, but the router's limit stays
    the stated frame limit: n <= 3584, exactly."""
    assert tsf.fits_shared_memory(n, torch.float32) is (n <= 3584)


@pytest.mark.parametrize("pop,n,k,want", [
    # the shipped refine tail: the FFT, 16 frames a block; one thread a
    # candidate (256 blocks of 4 warps: 7.8 warps an SM); the DFT's grids
    # for the exact matches, one pass, one segment
    (1 << 15, 1024, 512, dict(pop_pad=1 << 15, route="fft", layout="one_thread",
                              synth=(256, 128), fft=(2048, 256), exact=(128, 256),
                              fold=(256, 256), dft=(2048, 128), sum=(128, 256), passes=1,
                              segments=1)),
    # audio_match.json's refine tail: 8 frames a block; time-parallel (32
    # one-thread blocks: 1 warp an SM), 128 blocks of 8 warps; the DFT's
    # 16 tiles a group, two passes, 8 segments of 128
    (4096, 2048, 1024, dict(pop_pad=4096, route="fft", layout="time_parallel",
                            synth=(128, 256), fft=(512, 256), exact=(16, 256), fold=(32, 256),
                            dft=(256, 128), sum=(16, 256), passes=2, segments=8)),
    # ragged: the last row block's 128 rows hold 33 candidates
    (4001, 2048, 1024, dict(pop_pad=4096, route="fft", layout="time_parallel",
                            synth=(128, 256), fft=(512, 256), exact=(16, 256), fold=(32, 256),
                            dft=(256, 128), sum=(16, 256), passes=2, segments=8)),
    # 25 bins of 8 (K 200): the FFT's epilogue stops at K; the DFT's groups
    # of 3 and 4 tiles, one partial pass
    (1024, 1024, 200, dict(pop_pad=1024, route="fft", layout="time_parallel",
                           synth=(32, 256), fft=(64, 256), exact=(4, 256), fold=(8, 256),
                           dft=(64, 128), sum=(4, 256), passes=1, segments=1)),
    (1, 256, 128, dict(pop_pad=128, route="fft", layout="time_parallel", synth=(4, 64),
                       fft=(2, 256), exact=(1, 256), fold=(1, 256), dft=(8, 128),
                       sum=(1, 256), passes=1, segments=1)),
    # 1792 samples a bin, the DFT: 14 segments of 128, a fold block per 128 rows
    (129, 3584, 1792, dict(pop_pad=256, route="dft", layout="time_parallel", synth=(8, 256),
                           fold=(2, 256), dft=(16, 128), sum=(1, 256), passes=4,
                           segments=14)),
    # N/2 = 640 (not a power of two: the DFT), above the split's threshold,
    # 5 segments of 128
    (1, 1280, 640, dict(pop_pad=128, route="dft", layout="time_parallel", synth=(4, 256),
                        fold=(1, 256), dft=(8, 128), sum=(1, 256), passes=2, segments=5)),
    # an operand of 8 bins (chip_smoke's split): the FFT's epilogue takes 8
    (1 << 15, 1024, 8, dict(pop_pad=1 << 15, route="fft", layout="one_thread",
                            synth=(256, 128), fft=(2048, 256), exact=(128, 256),
                            fold=(256, 256), dft=(2048, 128), sum=(128, 256), passes=1,
                            segments=1)),
])
def test_f32_scratch_and_geometry(pop, n, k, want):
    """The f32 wrapper's scratch (the samples, n floats a padded candidate's
    row; the DFT's a+, a-, edge and 8 double group sums per padded
    candidate and, where the DFT splits the samples, 4 levels of running
    tiles of 128 floats for each of the 8 group blocks' threads; on the FFT
    route then a frame value, a list slot and a count a row) and the
    kernels' grids (csrc fused_f32.cu launch_f32, fused_f32_tp.cu), at
    fm3_series."""
    geo = tsf.f32_geometry(pop, n, k)
    pad = want["pop_pad"]
    assert {key: geo[key] for key in want} == want
    run = 8 * 4 * 128 * pad if want["segments"] > 1 else 0
    floats = pad * n + pad * n // 2 * 2 + pad + 2 * 8 * pad + run
    floats += 3 * pad if want["route"] == "fft" else 0
    assert tsf.f32_scratch_floats(pop, n) == floats
    assert geo["scratch_bytes"] == 4 * tsf.f32_scratch_floats(pop, n)


# ---- the FFT route (power-of-two frames) -----------------------------------------

def _cmul(ar, ai, br, bi):
    """The kernel's complex product: four products and two sums, each rounded."""
    return ar * br - ai * bi, ar * bi + ai * br


def _fft_emulation(x, n):
    """Bins 0 .. N/2-1 (real, imaginary parts) of frames ``x`` (rows, n)
    float32 in csrc ``f32_fft_kernel``'s order: the window (w norm, rounded
    once) times each sample, the complex FFT of N/2 points z[i] = y[2i] + i
    y[2i+1] by Stockham passes of radix 4 (then 2 where log2(N/2) is odd),
    point r of butterfly j multiplied by the table's W_N^{(j % ns) r N / (ns
    R)} before the butterfly, output r stored at (j / ns) ns R + j % ns + r
    ns; then the real split X[k] = E[k] + W_N^k O[k]."""
    tab = tspec.fft_tables(n)
    wn, twr, twi = tab[:n], tab[n::2], tab[n + 1 :: 2]
    m = n // 2
    y = x * wn
    zr, zi = y[:, 0::2].copy(), y[:, 1::2].copy()
    ns, left = 1, m.bit_length() - 1
    while ns < m:
        radix = 4 if left >= 2 else 2
        j = np.arange(m // radix)
        kk = j % ns
        vr = [zr[:, j + r * (m // radix)] for r in range(radix)]
        vi = [zi[:, j + r * (m // radix)] for r in range(radix)]
        for r in range(1, radix if ns > 1 else 1):
            t = (kk * r) * (n // (ns * radix))
            vr[r], vi[r] = _cmul(vr[r], vi[r], twr[t], twi[t])
        if radix == 4:
            a0r, a0i, a1r, a1i = vr[0] + vr[2], vi[0] + vi[2], vr[0] - vr[2], vi[0] - vi[2]
            a2r, a2i = vr[1] + vr[3], vi[1] + vi[3]
            a3r, a3i = vi[1] - vi[3], -(vr[1] - vr[3])  # (v1 - v3) (-i)
            out = [(a0r + a2r, a0i + a2i), (a1r + a3r, a1i + a3i), (a0r - a2r, a0i - a2i),
                   (a1r - a3r, a1i - a3i)]
        else:
            out = [(vr[0] + vr[1], vi[0] + vi[1]), (vr[0] - vr[1], vi[0] - vi[1])]
        dst = (j // ns) * ns * radix + kk
        for r in range(radix):
            zr[:, dst + r * ns], zi[:, dst + r * ns] = out[r]
        ns *= radix
        left -= 2 if radix == 4 else 1
    k = np.arange(m)
    ar, ai, br, bi = zr[:, k], zi[:, k], zr[:, (m - k) % m], zi[:, (m - k) % m]
    half = np.float32(0.5)
    er, ei, orr, oi = half * (ar + br), half * (ai - bi), half * (ai + bi), -half * (ar - br)
    xr = er + (twr[k] * orr - twi[k] * oi)
    xi = ei + (twr[k] * oi + twi[k] * orr)
    return xr, xi


EXACT_BELOW = 1e-3  # csrc fused_f32.cu FFT_EXACT_BELOW


def _folded_sum_emulation(op, a):
    """csrc ``folded_sum``: each row of ``op`` (K, M) against each column of
    ``a`` (M, P) as an ascending chain of fused multiply-adds from 0 (each
    step in float64, then rounded to float32), in 128-sample segments added
    pairwise where M > 512; (K, P) float32."""
    m = op.shape[1]
    segs = m // 128 if m > 512 else 1
    part = []
    for g in range(segs):
        acc = np.zeros((op.shape[0], a.shape[1]), np.float32)
        for i in range(g * (m // segs), (g + 1) * (m // segs)):
            acc = (op[:, i, None].astype(np.float64) * a[i].astype(np.float64)
                   + acc).astype(np.float32)
        part.append(acc)
    w = 1
    while w < segs:
        for g in range(0, segs - w, 2 * w):
            part[g] = part[g] + part[g + w]
        w *= 2
    return part[0]


def _fft_fitness(x, target, n, frames, dft_packed=None):
    """The FFT route's fitness of audio ``x`` (F n, P) against ``target`` (F,
    K): each frame's terms in float32, summed in double, rounded once; a
    frame below EXACT_BELOW x its target's energy scored again by the
    direct sums against ``dft_packed`` (the folded operand, (2K, N/2)) with
    the f32 DFT's epilogue; the frames added in float32 in frame order."""
    out = None
    k = target.shape[-1]
    for f in range(frames):
        xf = x[f * n : (f + 1) * n]
        xr, xi = _fft_emulation(np.ascontiguousarray(xf.T), n)
        dd = np.sqrt(xr * xr + xi * xi)[:, :k] - target[f]
        fit = (dd * dd).astype(np.float64).sum(axis=1)
        exact = fit < EXACT_BELOW * (target[f].astype(np.float64) ** 2).sum()
        if exact.any():
            half = n // 2
            a = xf[:, exact]
            ap, am = a[:half].copy(), a[:half].copy()
            ap[1:] += a[half + 1 :][::-1]
            am[1:] -= a[half + 1 :][::-1]
            ap[0] += np.float32(0.0)
            en = np.float32(tsf.edge_norm(n, False))
            ec = np.where(np.arange(k) % 2 == 0, en, -en).astype(np.float32)
            u = _folded_sum_emulation(dft_packed[:k], ap) + ec[:, None] * a[half][None, :]
            v = _folded_sum_emulation(dft_packed[k:], am)
            dd = np.sqrt(u * u + v * v) - target[f][:, None]
            fit[exact] = (dd * dd).astype(np.float64).sum(axis=0)
        fit = fit.astype(np.float32)
        out = fit if out is None else out + fit
    return out


def _fitness_f64(x, target, n, frames):
    """The fitness of the same float32 audio with every later step in float64."""
    w = tspec.hann_window(n) / (n * tspec.window_factor(n))
    k = target.shape[-1]
    fit = 0.0
    for f in range(frames):
        spec = np.fft.rfft(x[f * n : (f + 1) * n].astype(np.float64).T * w, axis=1)[:, :k]
        fit = fit + ((np.abs(spec) - target[f]) ** 2).sum(axis=1)
    return fit


@pytest.mark.parametrize("frames", [1, 2])
@pytest.mark.parametrize("topology", ["fm3_series", "fm3_parallel"])
@pytest.mark.parametrize("n", [256, 1024, 2048])
def test_f32_fft_emulation_holds_plain_reference_and_float64(n, topology, frames):
    """The kernel's FFT order in float32 (``_fft_emulation``) on the plain
    version's audio: within the card's f32 gates of the plain version, within
    ``_assert_fitness_close`` of the reference's interpret kernel (whose
    synthesis sums its phases in another order), and no further from a
    float64 evaluation of the same audio than 1.5x the plain version (C1's
    rule), at the median and at the largest error."""
    so, to = _operands(n)
    d = len(TRUTH[topology])
    rng = np.random.default_rng(n + frames + d)
    params = (rng.random((POP, d)) * np.asarray(MAXS[topology])).astype(np.float32)
    params[0] = TRUTH[topology]
    tgt = rng.uniform(0.0, 50.0, (frames, n // 2)).astype(np.float32)
    target = tgt if frames > 1 else tgt[0]
    x = tsf.synth_f32_plain(torch.from_numpy(params), topology=topology, n=frames * n,
                            inv_sr=tsf.inv_sample_rate(tsf.DEFAULT_WAVETABLE_SIZE,
                                                       tsf.DEFAULT_SAMPLE_RATE),
                            sine_order=9).numpy()
    got = _fft_fitness(x, tgt, n, frames, to.dft_packed.numpy())
    plain = tsf.fused_synth_fitness_plain(
        torch.from_numpy(params), torch.from_numpy(target), dft_packed=to.dft_packed,
        dft_scale=0.0, topology=topology, n=n, pop_block=PB, num_frames=frames,
        sine_order=9).numpy()
    rel = np.abs(got - plain) / np.abs(plain)
    assert rel.max() <= F32_FIT_MAX_REL and np.median(rel) <= F32_FIT_MEDIAN_REL, rel
    ref = np.asarray(jsf.fused_synth_fitness(
        jnp.asarray(params), so.dft_cos, so.dft_sin, jnp.asarray(target), topology=topology,
        n=n, pop_block=PB, interpret=True, dft_packed=so.dft_packed, dft_scale=0.0,
        sine_order=9, num_frames=frames))
    _assert_fitness_close(got, ref)
    f64 = _fitness_f64(x, tgt, n, frames)
    e_fft, e_plain = np.abs(got - f64) / f64, np.abs(plain - f64) / f64
    assert np.median(e_fft) <= 1.5 * np.median(e_plain), (np.median(e_fft), np.median(e_plain))
    assert e_fft.max() <= 1.5 * e_plain.max(), (e_fft.max(), e_plain.max())


@pytest.mark.parametrize("n", [256, 512, 1024, 2048])
def test_fft_tables_are_float64_rounded_once(n):
    """The FFT's window (w norm) and twiddles W_N^k, k < N: numpy's float64
    values, each rounded once to float32; the norm is the operand's."""
    tab = tspec.fft_tables(n)
    assert tab.dtype == np.float32 and tab.shape == (3 * n,)
    norm = tspec.make_spectrum_ops(n, dft_dtype="float32", device="cpu").norm
    np.testing.assert_array_equal(tab[:n], (tspec.hann_window(n) * norm).astype(np.float32))
    ang = 2.0 * math.pi * np.arange(n, dtype=np.float64) / n
    np.testing.assert_array_equal(tab[n::2], np.cos(ang).astype(np.float32))
    np.testing.assert_array_equal(tab[n + 1 :: 2], (-np.sin(ang)).astype(np.float32))


@pytest.mark.parametrize("n", list(range(256, 3585, 256)))
def test_f32_route_is_one_test_on_n(n, monkeypatch):
    """Every power-of-two frame of the f32 grid takes the FFT, every other
    (n 3584 among them) the DFT, at every topology; ``F32_FFT`` False sends
    all to the DFT. The FFT's tile is 64 KB, within the DFT's stages'
    ``shared_bytes``."""
    pow2 = n & (n - 1) == 0
    assert tsf.f32_route(n) == ("fft" if pow2 else "dft")
    assert (n in tsf.F32_FFT_N) is pow2
    for topology in ("fm2", "fm3_series", "fm17_series", "fm3_parallel"):
        assert tsf.f32_geometry(129, n, n // 2, topology=topology)["route"] == tsf.f32_route(n)
    assert tsf.F32_FFT_SHARED_BYTES == 65536 < tsf.shared_bytes(n, torch.float32)
    monkeypatch.setattr(tsf, "F32_FFT", False)
    assert tsf.f32_route(n) == "dft"


@pytest.mark.parametrize("topology,takes", [
    ("fm2", True), ("fm3_series", True), ("fm8_series", True), ("fm9_series", False),
    ("fm2_parallel", True), ("fm5_parallel", True), ("fm6_parallel", False),
    ("fm17_series", False),
])
def test_f32_time_parallel_takes_the_fixed_codes(topology, takes):
    """The true-f32 time-parallel synthesis takes the fixed chains and banks
    (csrc ``fused_f32_tp.cu``), never the wide or long codes; where it takes
    a shape at n 2048, the rule picks it for a small grid and never for a
    full one."""
    assert tsf.f32_tp_takes(2048, topology) is takes
    small, big = 128, 1 << 16
    assert tsf.f32_time_parallel(2048, topology, small) is takes
    assert not tsf.f32_time_parallel(2048, topology, big)
    assert not tsf.f32_time_parallel(2048, topology, small, runs=1 << 10)
    assert not tsf.f32_tp_takes(1280, topology) or takes


@pytest.mark.parametrize("n,topology,frames,want", [
    (2048, "fm3_series", 8, 4 * (8 * 32 * 20 + 2 * 16 * 32 + 32 * 6 + 32 * 3)),
    (2048, "fm8_series", 2, 37888),
    (1024, "fm5_parallel", 1, 4 * (8 * 32 * 20 + 5 * 8 * 32 + 32 * 20)),
    (256, "fm2", 1, 4 * (2 * 32 * 20 + 1 * 2 * 32 + 32 * 4)),
])
def test_f32_time_parallel_shared_memory(n, topology, frames, want):
    """The time-parallel synthesis block's shared memory (csrc
    ``f32_tp_smem``): staging buffers, level totals, genes, carries."""
    assert tsf.shared_bytes_f32_tp(n, topology, frames) == want <= tsf.MAX_SHARED_BYTES


# (topology, n, runs, pop, the faster layout on the card): points of
# tools/torch_f32_probe.py's sweep (NVIDIA H100 80GB HBM3), the ratio
# one-thread / time-parallel beside each; the rule must pick the faster
F32_LAYOUT_POINTS = [
    ("fm2", 2048, 1, 16384, True),  # 1.070
    ("fm2", 2048, 1, 1 << 15, False),  # 0.935
    ("fm3_series", 2048, 1, 8192, True),  # 1.307
    ("fm3_series", 2048, 1, 16384, False),  # 0.960
    ("fm3_series", 2048, 1, 4096, True),  # 1.989, cell (h); at F 8 2.152, cell (m)
    ("fm3_series", 2048, 8, 4096, False),  # 0.817, cell (n)
    ("fm3_series", 1024, 1, 1 << 15, False),  # 0.812, the shipped tail
    ("fm3_series", 256, 1, 8192, True),  # 1.159
    ("fm3_series", 256, 1, 16384, False),  # 0.957
    ("fm4_series", 1024, 1, 8192, True),  # 1.096
    ("fm4_series", 1024, 1, 16384, False),  # 0.785
    ("fm4_series", 256, 1, 1024, False),  # F 8: 0.934
    ("fm8_series", 2048, 1, 4096, True),  # 1.347
    ("fm8_series", 2048, 1, 8192, False),  # 0.858
    ("fm8_series", 256, 1, 512, False),  # 0.696
    ("fm5_parallel", 1024, 1, 16384, True),  # 1.354
    ("fm5_parallel", 1024, 1, 1 << 15, False),  # 0.868
    ("fm2_parallel", 256, 1, 16384, True),  # 1.043
]


@pytest.mark.parametrize("topology,n,runs,pop,want", F32_LAYOUT_POINTS)
def test_f32_layout_rule_picks_the_cards_faster(topology, n, runs, pop, want):
    """``f32_time_parallel`` (``f32_tp_faster``'s rule) on points the card
    timed: the layout it picks was the faster there."""
    assert tsf.f32_time_parallel(n, topology, pop, runs) is want


@pytest.mark.parametrize("topology,n", [("fm3_parallel", 1024), ("fm3_parallel", 2048),
                                        ("fm2", 256)])
def test_f32_fft_exact_matches_take_the_folded_sums(topology, n):
    """A known-params truth against its own target spectrum (the fitness a
    difference of roundings, ~1e-9 of a random candidate's) falls below
    EXACT_BELOW x the target's energy and is scored by the direct sums in
    the f32 DFT's order; the random candidates stay on the FFT, within the
    card's f32 gates of the plain version. At the truth the plain version's
    sums here (the CPU's matrix product, in another order than the card's,
    which the direct sums reproduce: tests/test_torch_gpu.py) lie 3e-5 to
    2e-4 from float64, so the truth is held by C1's rule: no further from a
    float64 evaluation of the same samples than 1.5x the plain version."""
    from pmfm_tpu_torch.ops import synthesize_single, target_spectrum

    _, to = _operands(n)
    truth = TRUTH[topology]
    tgt = target_spectrum(synthesize_single(torch.tensor(truth), n, topology), to).numpy()
    rng = np.random.default_rng(n)
    params = (rng.random((POP, len(truth))) * np.asarray(MAXS[topology])).astype(np.float32)
    params[0] = truth
    x = tsf.synth_f32_plain(torch.from_numpy(params), topology=topology, n=n, sine_order=9,
                            inv_sr=tsf.inv_sample_rate(tsf.DEFAULT_WAVETABLE_SIZE,
                                                       tsf.DEFAULT_SAMPLE_RATE)).numpy()
    got = _fft_fitness(x, tgt[None], n, 1, to.dft_packed.numpy())
    plain = tsf.fused_synth_fitness_plain(
        torch.from_numpy(params), torch.from_numpy(tgt), dft_packed=to.dft_packed, dft_scale=0.0,
        topology=topology, n=n, pop_block=PB, sine_order=9).numpy()
    energy = (tgt.astype(np.float64) ** 2).sum()
    assert got[0] < EXACT_BELOW * energy and np.all(got[1:] > EXACT_BELOW * energy)
    np.testing.assert_array_equal(got[1:], _fft_fitness(x[:, 1:], tgt[None], n, 1))
    rel = np.abs(got[1:] - plain[1:]) / np.abs(plain[1:])
    assert rel.max() <= F32_FIT_MAX_REL and np.median(rel) <= F32_FIT_MEDIAN_REL, rel
    f64 = _fitness_f64(x[:, :1], tgt[None], n, 1)[0]
    assert abs(got[0] - f64) <= 1.5 * abs(plain[0] - f64), (got[0], plain[0], f64)
