"""Topologies above 32 genes (the long synthesis code; ROADMAP Queue B item
3) in pmfm_tpu_torch, on the CPU, against pmfm_tpu on the same inputs made
with numpy from fixed seeds: B1's and B2's plain versions against the
reference's Pallas kernels in interpret mode at fm9_parallel (36 genes),
fm16_parallel (64) and fm17_series (34), in the int8, bf16 and true-f32
modes; B3's plain version at n 4096 and B4's at the reference kernel's
smallest frame; B5's plain version as the loop
of B2's; the scan synthesis's plain loop at fm33_series and fm33_parallel
against the reference's scan; and the long code's host-side geometry (a B1/B2
block's staged parameters in shared memory, the scratch rows, the routes).

Tolerances, stated with each test:
* B1/B2 fitness: max relative 1e-3, median 1e-5 (the int8 gate of
  tests/test_torch_kernels.py, and the same limits in tests/test_torch_f32.py
  and tests/test_torch_bf16.py) above 1e-3 of the median fitness, the
  absolute error within 1e-6 of the median below it (the planted truth).
  Measured on these inputs over every mode, topology and sine order: max
  8.9e-4 (an int8 sample flipped by the phase sums' order, the gap
  tests/test_torch_kernels.py admits), median up to 5.7e-7. A
  chain of 17 with indices up to 8 is chaotic, as a chain of ten is
  (tests/test_torch_parallel.py::_wide_candidates); at indices up to 0.5
  B2's fitness still parts by 3e-3 at n 256, and at 0.15 B3's int8 a+/- by
  up to 15 steps at n 4096 (measured), so the chain's candidates keep their
  indices below 0.05 (0 and 1 steps there) and its truth below 0.1125.
* B2's offspring under the Pallas interpreter's all-zero draws: values
  bit-equal, steps within 1e-6 relative (an ulp of pow at another D).
* B3: int8 a+/- at most 1 apart on under 1% of samples, the edge sample
  within 1, mag_scale within one float32 ulp (a bank's: the reference's
  mean of |amp_j| is not always the correctly rounded one); bf16 a+/- rows
  within 1e-3 (median) and 1e-2 (all) relative, mag_scale 1
  (tests/test_torch_large_frame.py's limits).
* B4: f32 audio within 1e-3 of the amplitude (tests/test_torch_large_frame.py).
* B5: bit-equal to the loop of B2's plain version with the stable selection.
* the scan: the plain loop within 1e-3 of the amplitude of the reference's
  scan (tests/test_torch_unfused.py's oracle bound: a sine ulp that moves
  a floor() by one table step).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmfm_tpu.es import ESConfig as JConfig
from pmfm_tpu.kernels import synth_fitness as jsf
from pmfm_tpu.kernels.generation import fused_generation as j_fused_generation
from pmfm_tpu.kernels.synth_fold import fused_synth_fold as j_fold
from pmfm_tpu.kernels.synth_stream import fused_synth_stream as j_stream
from pmfm_tpu.ops import spectral as jspec
from pmfm_tpu.ops import synthesis as jsyn
from pmfm_tpu_torch.es import kernel_seed
from pmfm_tpu_torch.es import strategy as tstrategy
from pmfm_tpu_torch.kernels import evolve as tev
from pmfm_tpu_torch.kernels import generation as tgen
from pmfm_tpu_torch.kernels import scan as tscan
from pmfm_tpu_torch.kernels import synth_fitness as tsf
from pmfm_tpu_torch.kernels import synth_fold as tfold
from pmfm_tpu_torch.kernels import synth_stream as tstream
from pmfm_tpu_torch.ops import spectral as tspec

N, POP, PB = 256, 128, 128
B2_POP = 16
CHAIN_INDEX = 0.05  # a chain's candidates' indices (see the tolerances)
LIMITS = (1e-3, 1e-5)
REL_FLOOR, ABS_OF_MEDIAN = 1e-3, 1e-6
STEP_MAX_REL = 1e-6
DTYPES = {"int8": jnp.int8, "bfloat16": jnp.bfloat16, "float32": jnp.float32}

# the truths: examples/fm4_parallel_match.json's four pairs, the fifth of
# benchmarks/pursuit_fm5_parallel.json, then pairs of the same ranges; a
# chain of 17 operators with the mild indices of chip_smoke.py's fm16_series
PAIRS = ((3076.48, 2.0, 3016.64, 0.9), (1936.0, 2.4, 2182.4, 0.8), (2499.2, 1.6, 1584.0, 0.7),
         (1161.6, 3.2, 985.6, 0.6), (2182.4, 1.2, 3273.6, 0.5), (1320.0, 1.8, 2640.0, 0.4),
         (880.0, 2.2, 1760.0, 0.3), (3300.0, 0.9, 1650.0, 0.35), (2750.0, 1.4, 1375.0, 0.45),
         (1045.0, 2.6, 2090.0, 0.25), (1567.0, 1.1, 3134.0, 0.3), (2349.0, 0.8, 1174.5, 0.4),
         (660.0, 3.0, 1980.0, 0.2), (1396.0, 1.7, 2793.0, 0.3), (1865.0, 2.1, 932.5, 0.35),
         (2960.0, 0.7, 1480.0, 0.25))
CHAIN = ((3078.0, 0.1), (3015.0, 0.075), (3141.0, 0.05), (2500.0, 0.0875), (1800.0, 0.0625),
         (1200.0, 0.075), (900.0, 0.1125), (2200.0, 0.05), (1500.0, 0.1), (2800.0, 0.075),
         (2000.0, 0.0625), (1100.0, 0.075), (2600.0, 0.05), (1700.0, 0.0875), (3300.0, 0.075),
         (2400.0, 0.1125), (1900.0, 0.08))
TRUTH = {
    "fm9_parallel": sum(PAIRS[:9], ()),
    "fm16_parallel": sum(PAIRS, ()),
    "fm17_series": sum(CHAIN, ()),
}
TOPOLOGIES = tuple(TRUTH)


def _maxs(topology):
    d = jsyn.topology_dims(topology)
    return (3520.0, 8.0, 3520.0, 1.0) * (d // 4) if "parallel" in topology else (3520.0, 8.0) * (
        d // 2)


def _candidates(topology, pop, seed):
    """``pop`` candidates of ``topology`` uniform in its ranges, a chain's
    indices below CHAIN_INDEX (a chain of 17 with larger ones is chaotic)."""
    maxs = np.asarray(_maxs(topology), np.float32)
    if "series" in topology:
        maxs[1::2] = CHAIN_INDEX
    return (np.random.default_rng(seed).random((pop, len(maxs))) * maxs).astype(np.float32)


def _operands(dtype, n=N):
    return (jspec.make_spectrum_ops(n, dft_dtype=DTYPES[dtype]),
            tspec.make_spectrum_ops(n, dft_dtype=dtype, device="cpu"))


def _target(topology, n, so):
    """The reference's spectrum of the truth synthesised by its scanless
    engine (turns-domain phases, as the kernels': the scan's wavetable floor
    parts a chain of 17 from the kernels' synthesis of its own truth by more
    than a random candidate's fitness)."""
    audio = jsyn.synthesize_single(jnp.asarray(TRUTH[topology]), n, topology, engine="scanless")
    return np.array(jspec.target_spectrum(audio, so))


def _assert_close(got, ref, median=True):
    max_rel, median_rel = LIMITS
    rel = np.abs(got - ref) / np.abs(ref)
    if not median:  # one candidate repeated: its error is the median too
        assert rel.max() <= max_rel, rel.max()
        return
    med = np.median(np.abs(ref))
    big = np.abs(ref) > REL_FLOOR * med
    assert rel[big].max() <= max_rel and np.median(rel) <= median_rel, (
        rel[big].max(), np.median(rel))
    assert np.all(np.abs(got - ref)[~big] <= ABS_OF_MEDIAN * med)


# -- B1, B2 -----------------------------------------------------------------------

@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("sine_order", [7, 9])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_b1_long_plain_matches_reference(topology, sine_order, dtype):
    """B1's plain version above 32 genes against the reference's kernel in
    interpret mode (n 256, P 128), the truth planted first and ranked first
    in both, within LIMITS."""
    so, to = _operands(dtype)
    tgt = _target(topology, N, so)
    params = _candidates(topology, POP, sine_order + len(topology))
    params[0] = TRUTH[topology]
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
    _assert_close(got, ref)
    assert np.argmin(ref) == 0 and np.argmin(got) == 0


@pytest.mark.parametrize("topology,dtype", [("fm9_parallel", "int8"),
                                            ("fm16_parallel", "bfloat16"),
                                            ("fm17_series", "float32")])
def test_b2_long_plain_zero_draws_match_reference(topology, dtype):
    """B2's plain version above 32 genes under the Pallas interpreter's
    all-zero draws, each topology in one of the three modes (B1's test holds
    every mode at each): offspring values bit-equal, steps within an ulp of
    pow, fitness within LIMITS (every offspring is one candidate)."""
    d, mu = jsyn.topology_dims(topology), 4
    cfg = JConfig(num_parents=mu, num_offspring=B2_POP - mu, num_dimensions=d,
                  topology=topology, param_mins=(0.0,) * d, param_maxs=_maxs(topology),
                  min_step=1e-4, mutation_noise="clt12_neutral")
    so, to = _operands(dtype)
    tgt = _target(topology, N, so)
    rng = np.random.default_rng(d)
    pv = rng.random((mu, d)).astype(np.float32)
    if "series" in topology:
        pv[:, 1::2] *= CHAIN_INDEX / 8.0  # the indices below CHAIN_INDEX, as _candidates
    ps = rng.uniform(0.01, 0.4, (mu, d)).astype(np.float32)
    kw = dict(pop=B2_POP, param_mins=cfg.param_mins, param_maxs=cfg.param_maxs,
              topology=topology, n=N, pop_block=B2_POP, alpha=cfg.alpha, beta=cfg.beta,
              beta_scale=cfg.beta_scale, root_two_over_pi=cfg.root_two_over_pi,
              clamp_values=False, min_step=1e-4, sine_order=9)
    fit_r, val_r, step_r = j_fused_generation(
        jnp.asarray(7, jnp.int32), jnp.asarray(pv), jnp.asarray(ps), so.dft_cos, so.dft_sin,
        jnp.asarray(tgt), interpret=True, dft_packed=so.dft_packed,
        dft_scale=so.dft_packed_scale, **kw,
    )
    val_r, step_r = np.asarray(val_r)[:d].T, np.asarray(step_r)[:d].T
    draws = (np.zeros((B2_POP, d), np.int64), np.zeros((B2_POP, d), np.int64),
             np.zeros((12, B2_POP, d), np.float32))
    fit, val, step = tgen.fused_generation(
        7, torch.from_numpy(pv), torch.from_numpy(ps), torch.from_numpy(tgt),
        dft_packed=to.dft_packed, dft_scale=to.dft_packed_scale, draws=draws, **kw,
    )
    assert val.shape == (B2_POP, d) and step.shape == (B2_POP, d)
    np.testing.assert_array_equal(val.numpy(), val_r)
    np.testing.assert_allclose(step.numpy(), step_r, rtol=STEP_MAX_REL, atol=0)
    _assert_close(fit.numpy(), np.asarray(fit_r), median=False)


# -- B3, B4, B5 ---------------------------------------------------------------------

@pytest.mark.parametrize("topology", ["fm9_parallel", "fm17_series"])
@pytest.mark.parametrize("int8", [True, False])
def test_b3_long_plain_matches_reference(topology, int8):
    """B3's plain version above 32 genes at n 4096 against the reference's
    kernel in interpret mode (its looped time walk, the one it takes above
    n 8192: the unrolled one takes ~25 s to trace at n 4096), int8 and bf16,
    at B3's limits."""
    n, pop = 4096, 8
    jso = jspec.make_spectrum_ops(n, dft_dtype=jnp.int8)
    scale = jso.dft_packed_scale if int8 else 0.0
    p = _candidates(topology, pop, 41)
    ref = [np.array(x) for x in j_fold(jnp.asarray(p), topology=topology, n=n, pop_block=pop,
                                       interpret=True, dft_scale=scale, sine_order=9,
                                       looped=True)]
    before = tfold.fused_synth_fold.launches
    ap, am, edge, ms = tfold.fused_synth_fold(torch.from_numpy(p), topology=topology, n=n,
                                              dft_scale=scale, sine_order=9)
    assert tfold.fused_synth_fold.launches == before  # CPU tensors: the plain version
    assert ap.shape == (n // 2, pop) and ap.T.is_contiguous() and edge.shape == (pop,)
    if int8:
        assert ap.dtype == torch.int8
        for got, want in ((ap, ref[0]), (am, ref[1])):
            d = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() < 0.01
        assert np.abs(edge.numpy() - ref[2]).max() <= 1.0
        np.testing.assert_allclose(ms.numpy(), ref[3], rtol=2.0**-23, atol=0)
    else:
        assert ap.dtype == torch.bfloat16 and np.all(ms.numpy() == 1.0)
        for got, want in ((ap, ref[0]), (am, ref[1])):
            g, w = got.float().numpy().T, np.asarray(want, np.float32).T
            rel = np.linalg.norm(g - w, axis=1) / (np.linalg.norm(w, axis=1) + 1e-30)
            assert np.median(rel) < 1e-3 and np.linalg.norm(g - w) < 1e-2 * np.linalg.norm(w)


@pytest.mark.parametrize("topology", ["fm9_parallel", "fm17_series"])
def test_b4_long_plain_matches_reference_f32(topology):
    """B4's plain version above 32 genes against the reference's kernel in
    interpret mode at its smallest frame (one time block; B1-B3's tests
    carry the phases across blocks and frames), f32 audio within 1e-3 of the
    amplitude."""
    n = 128
    jso = jspec.make_spectrum_ops(n, method="dft_factored", dft_dtype=jnp.float32)
    tso = tspec.make_spectrum_ops(n, method="dft_factored", device="cpu")
    p = _candidates(topology, 8, 43)
    want = np.asarray(j_stream(jnp.asarray(p), jso.window, topology=topology, n=n,
                               pop_block=8, interpret=True, audio_f32=True))
    before = tstream.fused_synth_stream.launches
    got = tstream.fused_synth_stream(torch.from_numpy(p), tso.window, topology=topology, n=n,
                                     audio_f32=True)
    assert tstream.fused_synth_stream.launches == before
    assert got.dtype == torch.float32 and got.shape == (n, 8)
    amp = np.abs(tsf.bank_amp(torch.from_numpy(p), topology, False).numpy())
    assert (np.abs(got.numpy() - want).max(axis=0) / amp).max() < 1e-3


@pytest.mark.parametrize("topology", ["fm9_parallel", "fm17_series"])
def test_b5_long_plain_is_the_b2_loop(topology):
    """B5 above 32 genes, generation by generation bit-equal to B2's plain
    version for the generation's seed with the stable (fitness, index) top-mu
    and best-ever on a strict improvement."""
    d, mu, pop, maxs = jsyn.topology_dims(topology), 4, 16, _maxs(topology)
    _, to = _operands("int8")
    tgt = torch.from_numpy(_target(topology, N, _operands("int8")[0]))
    kw = dict(pop=pop, param_mins=(0.0,) * d, param_maxs=maxs, dft_packed=to.dft_packed,
              dft_scale=to.dft_packed_scale, topology=topology, n=N, pop_block=16, sine_order=9)
    g = torch.Generator().manual_seed(2)
    pv0, ps0 = torch.rand((mu, d), generator=g), torch.full((mu, d), 0.05)
    seeds = [kernel_seed(5, i) for i in range(3)]
    before = tev.fused_evolve.launches
    pv, ps, pf, bv, bf, traj = tev.fused_evolve(seeds, pv0, ps0, pv0[0],
                                                torch.tensor(float("inf")), tgt, **kw)
    assert tev.fused_evolve.launches == before  # CPU tensors: the plain version
    qv, qs, best = pv0, ps0, float("inf")
    for i, seed in enumerate(seeds):
        fit, val, stp = tgen.fused_generation_plain(seed, qv, qs, tgt, **kw)
        order = sorted(range(pop), key=lambda j: (float(fit[j]), j))[:mu]
        qv, qs, qf = val[order], stp[order], fit[order]
        best = min(best, float(qf[0]))
        assert float(traj[i]) == best
    assert torch.equal(pv, qv) and torch.equal(ps, qs) and torch.equal(pf, qf)
    assert pv.shape == (mu, d) and float(bf) == float(traj[-1]) and torch.isfinite(traj).all()


# -- the scan synthesis ---------------------------------------------------------------

@pytest.mark.parametrize("topology", ["fm33_series", "fm33_parallel"])
def test_scan_plain_matches_reference_past_32(topology):
    """The scan kernel's plain loop at 33 oscillators or pairs against the
    reference's scan (pmfm_tpu/ops/synthesis.py) at n 1024, mild indices,
    within 1e-3 of the amplitude; the kernel's launch reads the length at
    run time and asks for its state's scratch."""
    n, pop = 1024, 8
    d = jsyn.topology_dims(topology)
    maxs = np.asarray((2000.0, 2.0, 2000.0, 1.0) * (d // 4) if "parallel" in topology
                      else (2000.0, 0.1) * (d // 2), np.float32)
    p = (np.random.default_rng(47).random((pop, d)) * maxs).astype(np.float32)
    want = np.asarray(jsyn.synthesize(jnp.asarray(p), n, topology))
    got = tscan.scan_synth_plain(torch.from_numpy(p), n, topology).numpy()
    assert got.shape == (n, pop) and np.isfinite(got).all()
    assert (np.abs(got - want).max(axis=0) / (np.abs(want).max(axis=0) + 1e-6)).max() <= 1e-3
    la = tscan.scan_launch(pop, n, topology, "floor", torch.float32)
    assert la["k"] == 33 and la["state_floats"] == (3 if "series" in topology else 6) * 33 * pop


# -- host-side geometry ---------------------------------------------------------------

@pytest.mark.parametrize("d,want", [(0, 8192), (32, 8192), (64, 8192), (65, 8320),
                                    (256, 32768)])
def test_staged_parameters_size_the_shared_memory(d, want):
    """A B1/B2 int8 block at n 256 stages its 32 candidates' d parameters in
    the shared memory the synthesis then overwrites with a+/- (32 x 256
    bytes): the block asks for the larger of the two (csrc tc_eval.cuh's
    tc_smem), equal at 64 genes, the parameters' above."""
    assert tsf.shared_bytes(256, torch.int8, d) == want
    assert tsf.shared_bytes(256, torch.bfloat16, d) == max(16384, 128 * d)
    assert tsf.shared_bytes(256, torch.float32, d) == tsf.F32_DFT_SHARED_BYTES
    assert tsf.fits_shared_memory(256, torch.int8, d)


def test_a_block_past_shared_memory_raises_naming_the_bytes():
    """Where a block's staged parameters pass its 232,448 bytes (1817 genes
    at n 256), the wrappers raise ValueError naming the bytes, and the router
    takes the fused kernels no longer."""
    _, to = _operands("int8")
    d = 4 * 455  # fm455_parallel: 1820 genes, 232,960 bytes staged
    with pytest.raises(ValueError, match=r"needs 232960 bytes of shared memory, has 232448"):
        tsf.fused_synth_fitness(torch.zeros((4, d)), torch.zeros(to.num_bins),
                                dft_packed=to.dft_packed, dft_scale=to.dft_packed_scale,
                                topology="fm455_parallel", n=N)
    assert not tsf.fits_shared_memory(N, torch.int8, d)
    cfg = tstrategy.ESConfig(num_dimensions=d, topology="fm455_parallel", audio_length_log2=8,
                             param_mins=(0.0,) * d, param_maxs=(1.0,) * d, fused_kernel=True)
    assert not tstrategy._fused_ok(cfg, to)


def test_long_code_routes_and_rows():
    """The long code above 32 genes (fm2 never), its scratch rows (each run's
    population padded to 128), B3's single pass at every population and B4's
    thread a candidate."""
    assert [tsf.uses_long_code(t) for t in ("fm2", "fm16_series", "fm8_parallel", "fm17_series",
                                            "fm9_parallel")] == [False, False, False, True, True]
    assert tsf.long_rows(1) == 128 and tsf.long_rows(4001, 3) == 3 * 4096
    assert tsf.long_rows(1 << 15) == 1 << 15
    assert not tfold.fold_geometry(2048, 8192, True, "fm9_parallel")["time_parallel"]
    assert tfold.fold_geometry(2048, 8192, True, "fm8_parallel")["time_parallel"]
    geo = tstream.stream_geometry(100, 65536, "fm17_series")
    assert (geo["blocks"], geo["threads"], geo["shared_bytes"], geo["scratch_floats"]) == (
        4, 32, 0, 0)
    sp = tsf.synth_params_struct(topology="fm9_parallel", n=N, k=128, d=36, inv_sr=1e-4,
                                 dft_scale=0.0, sine_order=9)
    assert (sp.npair, sp.long_code, sp.lrows) == (9, 0, 0)
    assert tsf.long_scratch(sp, "fm8_parallel", 128, "cpu") is None and sp.long_code == 0
    scratch = tsf.long_scratch(sp, "fm9_parallel", 256, "cpu")
    assert scratch.numel() == 2 * 36 * 256 and (sp.long_code, sp.lrows) == (1, 256)
    assert sp.lscr == scratch.data_ptr()
    tsf.check_supported_topology("fm40_series")
    with pytest.raises(NotImplementedError, match="only fm2"):
        tsf.check_supported_topology("fm3_cascade")
