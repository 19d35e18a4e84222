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
"""
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
REL_FLOOR, ABS_OF_MEDIAN = 1e-3, 1e-6
POP, PB = 16, 8
TRUTH = {
    "fm2": (3078.0, 2.0, 3015.0, 1.5),
    "fm3_series": (3078.0, 2.0, 3015.0, 1.5, 3141.0, 1.0),
}
MAXS = {"fm2": (3520.0, 8.0) * 2, "fm3_series": (3520.0, 8.0) * 3}


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
    # the shipped refine tail: 256 candidate blocks, 8 groups of 8 tiles, one pass
    (1 << 15, 1024, 512, dict(pop_pad=1 << 15, synth=(256, 128), dft=(2048, 128),
                              sum=(128, 256), passes=1, segments=1)),
    # audio_match.json's refine tail: 16 tiles a group, two passes; the
    # samples split into 8 segments of 128
    (4096, 2048, 1024, dict(pop_pad=4096, synth=(32, 128), dft=(256, 128), sum=(16, 256),
                            passes=2, segments=8)),
    # ragged: the last block of 128 holds 33 candidates
    (4001, 2048, 1024, dict(pop_pad=4096, synth=(32, 128), dft=(256, 128), sum=(16, 256),
                            passes=2, segments=8)),
    # 25 tiles: group 0 has 4, groups 1-7 have 3; one partial pass
    (1024, 1024, 200, dict(pop_pad=1024, synth=(8, 128), dft=(64, 128), sum=(4, 256),
                           passes=1, segments=1)),
    (1, 256, 128, dict(pop_pad=128, synth=(1, 128), dft=(8, 128), sum=(1, 256), passes=1,
                       segments=1)),
    # 1792 samples a bin: 14 segments of 128
    (129, 3584, 1792, dict(pop_pad=256, synth=(2, 128), dft=(16, 128), sum=(1, 256), passes=4,
                           segments=14)),
    # N/2 = 640: above the split's threshold, 5 segments of 128
    (1, 1280, 640, dict(pop_pad=128, synth=(1, 128), dft=(8, 128), sum=(1, 256), passes=2,
                        segments=5)),
    # an operand of 8 bins (chip_smoke's split): one tile, groups 1-7 empty
    (1 << 15, 1024, 8, dict(pop_pad=1 << 15, synth=(256, 128), dft=(2048, 128),
                            sum=(128, 256), passes=1, segments=1)),
])
def test_f32_scratch_and_geometry(pop, n, k, want):
    """The f32 wrapper's scratch (a+, a-, edge and 8 double group sums per
    padded candidate, and where the DFT splits the samples 4 levels of
    running tiles of 128 floats for each of the 8 group blocks' threads) and
    the three kernels' grids (csrc fused_f32.cu launch_f32)."""
    geo = tsf.f32_geometry(pop, n, k)
    pad = want["pop_pad"]
    assert {key: geo[key] for key in want} == want
    run = 8 * 4 * 128 * pad if want["segments"] > 1 else 0
    assert tsf.f32_scratch_floats(pop, n) == pad * n // 2 * 2 + pad + 2 * 8 * pad + run
    assert geo["scratch_bytes"] == 4 * tsf.f32_scratch_floats(pop, n)

