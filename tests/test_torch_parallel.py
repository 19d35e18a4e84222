"""The ``fm{k}_parallel`` mode of the port's kernels B1 (fused_synth_fitness)
and B2 (fused_generation), k = 2..4, and 20 genes (fm5_parallel, the wide
chain fm10_series), in their plain PyTorch versions on the CPU, against the
pmfm_tpu Pallas kernels in interpret mode (as tests/test_torch_kernels.py
and tests/test_torch_f32.py run them), in the int8 and the true-f32 mode;
B3, B4 and B5 on a bank and above 32 genes; and the raise for a topology
the kernels do not know.

Tolerances. int8: max relative 1e-3, median 1e-5 (test_torch_kernels.py's:
the two sides' phase prefix sums differ in order, which can flip an int8
sample by one step). True f32: for candidates above 1e-3 of the median
fitness, max relative 3.4e-5 and median 1.2e-6 (the largest errors
test_torch_f32.py measured on the series chains); below that floor (the
planted truth) the absolute error within 1e-6 of the median. Measured here:
int8 at most 1.3e-4 / 1.1e-7, f32 2.9e-6 / 4.4e-7. B2 offspring values
under the Pallas interpreter's all-zero draws are exact; their steps within
1e-6 relative (chip_smoke.py's STEP_MAX_REL): with every draw zero, every
step takes one of two values of ``Es ** (1/D)``, and at D = 16 XLA's and
torch's float32 pow round one of them an ulp apart.
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
from pmfm_tpu_torch.kernels import evolve as tev
from pmfm_tpu_torch.kernels import generation as tgen
from pmfm_tpu_torch.kernels import synth_fitness as tsf
from pmfm_tpu_torch.kernels import synth_fold as tsfo
from pmfm_tpu_torch.kernels import synth_stream as tss
from pmfm_tpu_torch.ops import spectral as tspec

N, POP, PB = 256, 16, 8
LIMITS = {"int8": (1e-3, 1e-5), "float32": (3.4e-5, 1.2e-6)}
REL_FLOOR, ABS_OF_MEDIAN = 1e-3, 1e-6
STEP_MAX_REL = 1e-6
# examples/fm4_parallel_match.json's truth; fm{k}_parallel takes its first k pairs
PAIRS = (3076.48, 2.0, 3016.64, 0.9, 1936.0, 2.4, 2182.4, 0.8,
         2499.2, 1.6, 1584.0, 0.7, 1161.6, 3.2, 985.6, 0.6)
TOPOLOGIES = ("fm2_parallel", "fm3_parallel", "fm4_parallel")


def _k(topology):
    return int(topology[2])


def _truth(topology):
    return PAIRS[: 4 * _k(topology)]


def _maxs(topology):
    return (3520.0, 8.0, 3520.0, 1.0) * _k(topology)


def _operands(dtype, n=N):
    jdt = jnp.int8 if dtype == "int8" else jnp.float32
    return (jspec.make_spectrum_ops(n, dft_dtype=jdt),
            tspec.make_spectrum_ops(n, dft_dtype=dtype, device="cpu"))


def _target(topology, n, so):
    audio = np.asarray(jsyn.synthesize_single(jnp.asarray(_truth(topology)), n, topology))
    return np.array(jspec.target_spectrum(jnp.asarray(audio), so))


def _assert_fitness_close(got, ref, dtype, median=True):
    max_rel, median_rel = LIMITS[dtype]
    if not median:  # one candidate repeated: its error is the median too
        median_rel = max_rel
    med = np.median(np.abs(ref))
    rel = np.abs(got - ref) / np.abs(ref)
    big = np.abs(ref) > REL_FLOOR * med
    assert rel[big].max() <= max_rel and np.median(rel) <= median_rel, (
        rel[big].max(), np.median(rel))
    assert np.all(np.abs(got - ref)[~big] <= ABS_OF_MEDIAN * med)


@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("sine_order", [7, 9])
@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_b1_parallel_plain_matches_reference(topology, sine_order, dtype):
    so, to = _operands(dtype)
    tgt = _target(topology, N, so)
    rng = np.random.default_rng(sine_order + _k(topology))
    params = (rng.random((POP, 4 * _k(topology))) * np.asarray(_maxs(topology))).astype(np.float32)
    params[0] = _truth(topology)
    ref = np.asarray(jsf.fused_synth_fitness(
        jnp.asarray(params), so.dft_cos, so.dft_sin, jnp.asarray(tgt), topology=topology, n=N,
        pop_block=PB, interpret=True, dft_packed=so.dft_packed, dft_scale=so.dft_packed_scale,
        sine_order=sine_order,
    ))
    before = tsf.fused_synth_fitness.launches
    got = tsf.fused_synth_fitness(
        torch.from_numpy(params), torch.from_numpy(tgt), dft_packed=to.dft_packed,
        dft_scale=to.dft_packed_scale, topology=topology, n=N, pop_block=PB,
        sine_order=sine_order,
    ).numpy()
    assert tsf.fused_synth_fitness.launches == before  # CPU tensors: the plain version
    assert got.shape == (POP,) and np.isfinite(got).all()
    _assert_fitness_close(got, ref, dtype)
    assert np.argmin(ref) == 0 and np.argmin(got) == 0  # the truth ranks first in both


@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_b2_parallel_plain_zero_draws_match_reference(topology, dtype):
    """All-zero draws (the Pallas interpreter's): offspring values
    bit-equal, steps within an ulp of pow, fitness within the B1 limits of
    the mode. Every gene then copies parent 0 with the same step, so all
    offspring are one candidate and the max limit holds for each."""
    d, mu = 4 * _k(topology), 4
    cfg = JConfig(num_parents=mu, num_offspring=POP - mu, num_dimensions=d, topology=topology,
                  param_mins=(0.0,) * d, param_maxs=_maxs(topology), min_step=1e-4,
                  mutation_noise="clt12_neutral")
    so, to = _operands(dtype)
    tgt = _target(topology, N, so)
    rng = np.random.default_rng(d)
    pv = rng.random((mu, d)).astype(np.float32)
    ps = rng.uniform(0.01, 0.4, (mu, d)).astype(np.float32)
    kw = dict(pop=POP, param_mins=cfg.param_mins, param_maxs=cfg.param_maxs, topology=topology,
              n=N, pop_block=PB, alpha=cfg.alpha, beta=cfg.beta, beta_scale=cfg.beta_scale,
              root_two_over_pi=cfg.root_two_over_pi, clamp_values=False, min_step=1e-4,
              sine_order=9)
    fit_r, val_r, step_r = j_fused_generation(
        jnp.asarray(7, jnp.int32), jnp.asarray(pv), jnp.asarray(ps), so.dft_cos, so.dft_sin,
        jnp.asarray(tgt), interpret=True, dft_packed=so.dft_packed,
        dft_scale=so.dft_packed_scale, **kw,
    )
    val_r, step_r = np.asarray(val_r)[:d].T, np.asarray(step_r)[:d].T
    draws = (np.zeros((POP, d), np.int64), np.zeros((POP, d), np.int64),
             np.zeros((12, POP, d), np.float32))
    fit, val, step = tgen.fused_generation(
        7, torch.from_numpy(pv), torch.from_numpy(ps), torch.from_numpy(tgt),
        dft_packed=to.dft_packed, dft_scale=to.dft_packed_scale, draws=draws, **kw,
    )
    assert val.shape == (POP, d) and step.shape == (POP, d)
    np.testing.assert_array_equal(val.numpy(), val_r)
    np.testing.assert_allclose(step.numpy(), step_r, rtol=STEP_MAX_REL, atol=0)
    assert len(np.unique(val_r, axis=0)) == 1
    _assert_fitness_close(fit.numpy(), np.asarray(fit_r), dtype, median=False)


@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_b2_parallel_plain_is_b1_of_its_offspring(dtype):
    """B2's fitness in the parallel mode is B1 of its scaled offspring, bit
    for bit; the Philox draws are deterministic."""
    topology, d, mu = "fm4_parallel", 16, 8
    _, to = _operands(dtype)
    tgt = torch.rand(to.num_bins, generator=torch.Generator().manual_seed(0)) * 10
    pv = torch.rand((mu, d), generator=torch.Generator().manual_seed(1))
    ps = torch.full((mu, d), 0.05)
    kw = dict(pop=POP, param_mins=(0.0,) * d, param_maxs=_maxs(topology), topology=topology,
              n=N, pop_block=PB, dft_packed=to.dft_packed, dft_scale=to.dft_packed_scale,
              sine_order=9)
    fit, val, _ = tgen.fused_generation(123, pv, ps, tgt, **kw)
    fit2, val2, _ = tgen.fused_generation(123, pv, ps, tgt, **kw)
    assert torch.equal(val, val2) and torch.equal(fit, fit2)
    scaled = tgen.scale_rows(val, kw["param_mins"], kw["param_maxs"])
    b1 = tsf.fused_synth_fitness(scaled, tgt, dft_packed=to.dft_packed,
                                 dft_scale=to.dft_packed_scale, topology=topology, n=N,
                                 pop_block=PB, sine_order=9)
    assert torch.equal(fit, b1)


def test_bank_gains_and_amplitude():
    """The int8 bank factors out s = mean |amp_j| (in pair order) and gives
    gain_j = amp_j * 63 / (k s + 1e-30), correctly rounded; the f32 bank
    keeps the amplitudes and 1. The kernels' SynthParams carry the pairs."""
    amps = [torch.tensor([0.9, -0.3, 0.0]), torch.tensor([0.8, 0.2, 0.0]),
            torch.tensor([0.7, 0.5, 0.0])]
    gains, s = tsf.bank_gains(amps, True)
    f = np.float32
    for c in range(3):
        want_s = f(f(f(abs(f(amps[0][c]))) + f(abs(f(amps[1][c])))) + f(abs(f(amps[2][c])))) / f(3)
        assert float(s[c]) == want_s
        inv_s = f(63.0) / f(f(3.0) * f(want_s) + f(1e-30))
        for j in range(3):
            assert float(gains[j][c]) == f(f(amps[j][c]) * inv_s)
    g32, one = tsf.bank_gains(amps, False)
    assert all(torch.equal(a, b) for a, b in zip(g32, amps)) and torch.equal(one, torch.ones(3))
    p = torch.tensor([_truth("fm3_parallel")])
    assert torch.equal(tsf.bank_amp(p, "fm3_parallel", True),
                       tsf.bank_gains([p[:, 3], p[:, 7], p[:, 11]], True)[1])
    assert torch.equal(tsf.bank_amp(p, "fm3_parallel", False), torch.ones(1))
    sp = tsf.synth_params_struct(topology="fm3_parallel", n=N, k=128, d=12, inv_sr=1e-4,
                                 dft_scale=0.0, sine_order=9)
    assert (sp.npair, sp.kn, sp.fm2) == (3, 2, 0)
    sp = tsf.synth_params_struct(topology="fm3_series", n=N, k=128, d=6, inv_sr=1e-4,
                                 dft_scale=0.0, sine_order=9)
    assert (sp.npair, sp.kn) == (0, 3)


def test_parallel_mode_raises_outside_b1_b2():
    """B3, B4 and B5 take fm{k}_parallel (on the CPU, their plain versions):
    B3's a+/- and B4's audio of a bank are finite and its mag_scale is the
    bank's s times dft_scale, B5 keeps its survivors; above 32 genes
    (fm9_parallel, 36 genes: the long code) every kernel runs too, with the
    same shapes, and every kernel raises for a topology that is neither fm2,
    fm{k}_series nor fm{k}_parallel."""
    d = 12
    rng = np.random.default_rng(3)
    p = torch.from_numpy((rng.random((4, d)) * np.asarray(_maxs("fm3_parallel")))
                         .astype(np.float32))
    ap, am, edge, ms = tsfo.fused_synth_fold(p, topology="fm3_parallel", n=4096, dft_scale=1e-5)
    assert ap.shape == (2048, 4) and ap.dtype == torch.int8 and torch.isfinite(edge).all()
    assert torch.equal(ms, tsf.bank_amp(p, "fm3_parallel", True) * torch.tensor(1e-5))
    audio = tss.fused_synth_stream(p, torch.ones(32768), topology="fm3_parallel", n=32768)
    assert audio.shape == (32768, 4) and torch.isfinite(audio.float()).all()
    _, to = _operands("int8")
    kw = dict(pop=8, param_mins=(0.0,) * d, param_maxs=(1.0,) * d, dft_packed=to.dft_packed,
              dft_scale=to.dft_packed_scale, n=N)
    pv = torch.from_numpy(rng.random((4, d)).astype(np.float32))
    out = tev.fused_evolve([1, 2], pv, torch.full((4, d), 0.1), pv[0],
                           torch.tensor(float("inf")), torch.rand(to.num_bins) * 10,
                           topology="fm3_parallel", **kw)
    assert out[0].shape == (4, d) and torch.isfinite(out[5]).all()
    wide = torch.from_numpy((rng.random((4, 36)) * np.asarray((3520.0, 8.0, 3520.0, 1.0) * 9))
                            .astype(np.float32))
    ap, am, edge, ms = tsfo.fused_synth_fold(wide, topology="fm9_parallel", n=4096, dft_scale=1.0)
    assert ap.shape == (2048, 4) and ap.dtype == torch.int8 and torch.isfinite(edge).all()
    audio = tss.fused_synth_stream(wide, torch.ones(4096), topology="fm9_parallel", n=4096)
    assert audio.shape == (4096, 4) and torch.isfinite(audio.float()).all()
    kw36 = dict(kw, param_mins=(0.0,) * 36, param_maxs=(1.0,) * 36)
    out = tev.fused_evolve([1], torch.rand((4, 36)), torch.full((4, 36), 0.1), torch.zeros(36),
                           torch.tensor(float("inf")), torch.rand(to.num_bins) * 10, **kw36,
                           topology="fm9_parallel")
    assert out[0].shape == (4, 36) and torch.isfinite(out[5]).all()
    fit = tsf.fused_synth_fitness(wide, torch.zeros(to.num_bins), dft_packed=to.dft_packed,
                                  dft_scale=to.dft_packed_scale, topology="fm9_parallel", n=N)
    assert fit.shape == (4,) and torch.isfinite(fit).all()
    odd = torch.zeros((4, 12))
    match = "only fm2, fm{k}_series and fm{k}_parallel are ported"
    with pytest.raises(NotImplementedError, match=match):
        tsfo.fused_synth_fold(odd, topology="fm3_cascade", n=4096, dft_scale=1.0)
    with pytest.raises(NotImplementedError, match=match):
        tss.fused_synth_stream(odd, torch.ones(32768), topology="fm3_cascade", n=32768)
    with pytest.raises(NotImplementedError, match=match):
        tev.fused_evolve([1], odd, odd, torch.zeros(12), torch.tensor(float("inf")),
                         torch.zeros(to.num_bins), **kw, topology="fm3_cascade")
    with pytest.raises(NotImplementedError, match=match):
        tsf.fused_synth_fitness(odd, torch.zeros(to.num_bins), dft_packed=to.dft_packed,
                                dft_scale=to.dft_packed_scale, topology="fm3_cascade", n=N)


# -- 20 to 32 genes: fm5_parallel (compile-time bank), fm10_series (the wide chain) --

WIDE_TRUTH = {
    # examples/fm4_parallel_match.json's four pairs and the fifth of
    # benchmarks/pursuit_fm5_parallel.json (its true_genes[16:20] times the maxima)
    "fm5_parallel": PAIRS + (2182.4, 1.2, 3273.6, 0.5),
    # a chain of ten with mild indices (see _wide_candidates)
    "fm10_series": (3078.0, 0.4, 3015.0, 0.3, 3141.0, 0.2, 2500.0, 0.35, 1800.0, 0.25,
                    1200.0, 0.3, 900.0, 0.45, 2200.0, 0.2, 1500.0, 0.4, 2800.0, 0.3),
}


def _wide_maxs(topology):
    return _maxs(topology) if "parallel" in topology else (3520.0, 8.0) * 10


def _wide_candidates(topology, seed):
    """POP random candidates of ``topology``. A chain of ten with indices up
    to 8 is chaotic: the two sides' phase-sum orders (sample order here, a
    triangular matmul in the reference) then part by 7% of a fitness, where
    the 20 genes of a bank stay within LIMITS; the chain's candidates keep
    their indices below 0.5, as tests/test_torch_large_frame.py's mild
    scanless ones, and so does the truth (with larger ones its audio from
    ``synthesize_single`` and the kernels' lie far apart)."""
    rng = np.random.default_rng(seed)
    maxs = np.asarray(_wide_maxs(topology), np.float32)
    if "series" in topology:
        maxs[1::2] = 0.5
    return (rng.random((POP, 20)) * maxs).astype(np.float32)


@pytest.mark.parametrize("topology", list(WIDE_TRUTH))
@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_b1_wide_plain_matches_reference(topology, dtype):
    """B1's plain version at 20 genes, a bank of five pairs and a chain of
    ten operators (``_wide_candidates``), against the reference's interpret
    kernel within LIMITS (n 256), the truth first in both."""
    so, to = _operands(dtype)
    truth = WIDE_TRUTH[topology]
    audio = np.asarray(jsyn.synthesize_single(jnp.asarray(truth), N, topology))
    tgt = np.array(jspec.target_spectrum(jnp.asarray(audio), so))
    params = _wide_candidates(topology, len(topology))
    params[0] = truth
    ref = np.asarray(jsf.fused_synth_fitness(
        jnp.asarray(params), so.dft_cos, so.dft_sin, jnp.asarray(tgt), topology=topology, n=N,
        pop_block=PB, interpret=True, dft_packed=so.dft_packed, dft_scale=so.dft_packed_scale,
        sine_order=9,
    ))
    got = tsf.fused_synth_fitness(
        torch.from_numpy(params), torch.from_numpy(tgt), dft_packed=to.dft_packed,
        dft_scale=to.dft_packed_scale, topology=topology, n=N, pop_block=PB, sine_order=9,
    ).numpy()
    assert got.shape == (POP,) and np.isfinite(got).all()
    _assert_fitness_close(got, ref, dtype)
    assert np.argmin(ref) == 0 and np.argmin(got) == 0


@pytest.mark.parametrize("topology", list(WIDE_TRUTH))
@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_b2_wide_plain_zero_draws_match_reference(topology, dtype):
    """B2's plain version at 20 genes under the Pallas interpreter's
    all-zero draws: offspring values bit-equal, steps within an ulp of pow,
    fitness within the B1 limits (every offspring is one candidate)."""
    d, mu = 20, 4
    cfg = JConfig(num_parents=mu, num_offspring=POP - mu, num_dimensions=d, topology=topology,
                  param_mins=(0.0,) * d, param_maxs=_wide_maxs(topology), min_step=1e-4,
                  mutation_noise="clt12_neutral")
    so, to = _operands(dtype)
    audio = np.asarray(jsyn.synthesize_single(jnp.asarray(WIDE_TRUTH[topology]), N, topology))
    tgt = np.array(jspec.target_spectrum(jnp.asarray(audio), so))
    rng = np.random.default_rng(d + len(topology))
    pv = rng.random((mu, d)).astype(np.float32)
    ps = rng.uniform(0.01, 0.4, (mu, d)).astype(np.float32)
    kw = dict(pop=POP, param_mins=cfg.param_mins, param_maxs=cfg.param_maxs, topology=topology,
              n=N, pop_block=PB, alpha=cfg.alpha, beta=cfg.beta, beta_scale=cfg.beta_scale,
              root_two_over_pi=cfg.root_two_over_pi, clamp_values=False, min_step=1e-4,
              sine_order=9)
    fit_r, val_r, step_r = j_fused_generation(
        jnp.asarray(7, jnp.int32), jnp.asarray(pv), jnp.asarray(ps), so.dft_cos, so.dft_sin,
        jnp.asarray(tgt), interpret=True, dft_packed=so.dft_packed,
        dft_scale=so.dft_packed_scale, **kw,
    )
    val_r, step_r = np.asarray(val_r)[:d].T, np.asarray(step_r)[:d].T
    draws = (np.zeros((POP, d), np.int64), np.zeros((POP, d), np.int64),
             np.zeros((12, POP, d), np.float32))
    fit, val, step = tgen.fused_generation(
        7, torch.from_numpy(pv), torch.from_numpy(ps), torch.from_numpy(tgt),
        dft_packed=to.dft_packed, dft_scale=to.dft_packed_scale, draws=draws, **kw,
    )
    np.testing.assert_array_equal(val.numpy(), val_r)
    np.testing.assert_allclose(step.numpy(), step_r, rtol=STEP_MAX_REL, atol=0)
    _assert_fitness_close(fit.numpy(), np.asarray(fit_r), dtype, median=False)
