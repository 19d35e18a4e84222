"""The port's kernels B1 (fused_synth_fitness) and B2 (fused_generation), in
their plain PyTorch versions on the CPU, against the pmfm_tpu Pallas kernels
in interpret mode (as tests/test_fused_kernel.py and
tests/test_fused_generation.py run them).

Tolerances. B1 fitness: max relative error 1e-3, median 1e-5. Both sides
make int8 audio by the same turns-domain recurrence, but the reference sums
each block's phase increments with a triangular matmul and the port with a
running sum; float32 rounding of the two orders can flip a few int8 samples
by one step, which moves a few candidates' fitness well inside 1e-3 and
leaves the median at float32 rounding. B2 offspring under all-zero draws
(the Pallas interpreter draws zero bits) are exact.
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
from pmfm_tpu_torch.ops import synthesis as tsyn

FIT_MAX_REL, FIT_MEDIAN_REL = 1e-3, 1e-5
N, POP, PB = 256, 16, 8
TRUTH = {
    "fm2": (3078.0, 2.0, 3015.0, 1.5),
    "fm3_series": (3078.0, 2.0, 3015.0, 1.5, 3141.0, 1.0),
}
MAXS = {"fm2": (3520.0, 8.0) * 2, "fm3_series": (3520.0, 8.0) * 3}


def _operands(n=N):
    return (jspec.make_spectrum_ops(n, dft_dtype=jnp.int8),
            tspec.make_spectrum_ops(n, dft_dtype="int8", device="cpu"))


def _target(topology, n, so):
    audio = np.asarray(jsyn.synthesize_single(jnp.asarray(TRUTH[topology]), n, topology))
    return np.array(jspec.target_spectrum(jnp.asarray(audio), so))


def _rel(got, ref):
    return np.abs(got - ref) / np.abs(ref)


@pytest.mark.parametrize("topology", ["fm2", "fm3_series"])
@pytest.mark.parametrize("sine_order", [7, 9])
def test_b1_plain_matches_reference(topology, sine_order):
    so, to = _operands()
    tgt = _target(topology, N, so)
    rng = np.random.default_rng(sine_order)
    params = (rng.random((POP, len(TRUTH[topology]))) * np.asarray(MAXS[topology])).astype(np.float32)
    params[0] = TRUTH[topology]
    ref = np.asarray(jsf.fused_synth_fitness(
        jnp.asarray(params), so.dft_cos, so.dft_sin, jnp.asarray(tgt), topology=topology, n=N,
        pop_block=PB, interpret=True, dft_packed=so.dft_packed, dft_scale=so.dft_packed_scale,
        sine_order=sine_order,
    ))
    before = tsf.fused_synth_fitness.launches
    got = tsf.fused_synth_fitness(
        torch.from_numpy(params), torch.from_numpy(tgt), dft_packed=to.dft_packed,
        dft_scale=to.dft_packed_scale, topology=topology, n=N, pop_block=PB, sine_order=sine_order,
    ).numpy()
    assert tsf.fused_synth_fitness.launches == before  # CPU tensors: the plain version
    assert got.shape == (POP,) and np.isfinite(got).all()
    rel = _rel(got, ref)
    assert rel.max() <= FIT_MAX_REL and np.median(rel) <= FIT_MEDIAN_REL
    assert np.argmin(ref) == 0 and np.argmin(got) == 0  # the truth ranks first in both


def _b2_kwargs(cfg, n=N):
    return dict(
        pop=cfg.population_size, param_mins=cfg.param_mins, param_maxs=cfg.param_maxs,
        topology=cfg.topology, n=n, pop_block=PB, alpha=cfg.alpha, beta=cfg.beta,
        beta_scale=cfg.beta_scale, root_two_over_pi=cfg.root_two_over_pi,
        clamp_values=cfg.clamp_values, min_step=cfg.min_step, sine_order=7,
    )


@pytest.mark.parametrize("topology", ["fm2", "fm3_series"])
@pytest.mark.parametrize("extra", [dict(), dict(min_step=0.05, clamp_values=True)])
def test_b2_plain_zero_draws_matches_reference(topology, extra):
    """All-zero draws: parent 0 for every gene, Ek = alpha, g = -1 (retried
    to +0.5 where x leaves [0, 1]); values and steps bit-equal."""
    d = len(TRUTH[topology])
    mu = 4
    cfg = JConfig(num_parents=mu, num_offspring=POP - mu, num_dimensions=d, topology=topology,
                  param_mins=(0.0,) * d, param_maxs=MAXS[topology], **extra)
    so, to = _operands()
    tgt = _target(topology, N, so)
    rng = np.random.default_rng(d)
    pv = rng.random((mu, d)).astype(np.float32)
    ps = rng.uniform(0.01, 0.4, (mu, d)).astype(np.float32)
    kw = _b2_kwargs(cfg)
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
    np.testing.assert_array_equal(step.numpy(), step_r)
    rel = _rel(fit.numpy(), np.asarray(fit_r))
    assert rel.max() <= FIT_MAX_REL and np.median(rel) <= FIT_MEDIAN_REL


def test_b2_plain_is_b1_of_its_offspring():
    """B2's fitness is B1 of its scaled offspring; its genes are exact parent
    copies when steps are zero; the Philox draws are deterministic."""
    topology, d, mu = "fm3_series", 6, 8
    _, to = _operands()
    tgt = torch.rand(to.num_bins, generator=torch.Generator().manual_seed(0)) * 10
    pv = torch.rand((mu, d), generator=torch.Generator().manual_seed(1))
    kw = dict(pop=POP, param_mins=(0.0,) * d, param_maxs=MAXS[topology], topology=topology,
              n=N, pop_block=PB, dft_packed=to.dft_packed, dft_scale=to.dft_packed_scale,
              sine_order=7)
    fit, val, step = tgen.fused_generation(123, pv, torch.zeros_like(pv), tgt, **kw)
    for j in range(d):
        assert torch.isin(val[:, j], pv[:, j]).all()
    assert (step == 0).all()
    fit2, val2, _ = tgen.fused_generation(123, pv, torch.zeros_like(pv), tgt, **kw)
    assert torch.equal(val, val2) and torch.equal(fit, fit2)
    scaled = tgen.scale_rows(val, kw["param_mins"], kw["param_maxs"])
    b1 = tsf.fused_synth_fitness(scaled, tgt, dft_packed=to.dft_packed, dft_scale=to.dft_packed_scale,
                                 topology=topology, n=N, pop_block=PB, sine_order=7)
    assert torch.equal(fit, b1)
    _, val3, _ = tgen.fused_generation(124, pv, torch.zeros_like(pv), tgt, **kw)
    assert not torch.equal(val, val3)


def test_philox_known_answer():
    """Random123's published vector for Philox4x32-10 at counter 0, key 0."""
    z = torch.zeros(1, dtype=torch.int64)
    words = [int(w) for w in tgen.philox4x32(z, z, z, z, 0)]
    assert words == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]


def test_philox_draw_statistics():
    seed, pop, d, mu = 99, 4096, 6, 64
    ib, cb, uw = tgen.philox_draws(seed, pop, d, "cpu")
    u = tgen.uniform01(uw)
    assert u.min() >= 0 and u.max() < 1
    m = pop * d
    g = (u * 2 - 1).sum(0) / 12
    assert abs(float(g.mean())) < 6 * (1 / 36 / m) ** 0.5
    assert abs(float(g.var()) - 1 / 36) < 6 * (1 / 36) * (2 / m) ** 0.5
    assert abs(float((cb & 1).double().mean()) - 0.5) < 6 * 0.5 / m**0.5
    counts = torch.bincount(((ib & 0x7FFFFFFF) % mu).reshape(-1), minlength=mu).double()
    e = m / mu
    assert float(((counts - e) ** 2 / e).sum()) < (mu - 1) + 6 * (2 * (mu - 1)) ** 0.5


def test_sine_coefficients_and_pop_block_match_reference():
    for order in (5, 7, 9):
        assert tsf._sin_turn_coeffs(order) == jsf._sin_turn_coeffs(order)
    for pop, pb in [(32768, 1024), (16, 8), (48, 32), (100, 512), (96, 64)]:
        assert tsf.resolve_pop_block(pop, pb) == jsf.resolve_pop_block(pop, pb)


def test_fold_definition():
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.integers(-63, 64, (16, 3)).astype(np.int8))
    ap, am, edge = tsf.fold(q)
    for r in range(8):
        want_p = int(q[r, 0]) + (int(q[16 - r, 0]) if r else 0)
        want_m = int(q[r, 0]) - (int(q[16 - r, 0]) if r else 0)
        assert int(ap[r, 0]) == want_p and int(am[r, 0]) == want_m
    assert torch.equal(edge, q[8].to(torch.int32))


@pytest.mark.parametrize("case", [
    dict(dft_scale=0.0),  # the bf16 engine: scale 0 without the float32 operand
    dict(topology="fm5_parallel"),
    dict(num_frames=2),  # multi-frame fitness: ported (ROADMAP Queue B item 8), so it runs
    dict(topology="fm9_series"),
])
def test_unported_variants_raise(case):
    """The variants B1/B2 do not take raise; the multi-frame mode, once among
    them, runs: fitness (P,) against an (F, K) target, and B2's offspring."""
    _, to = _operands()
    topology = case.get("topology", "fm3_series")
    d = tsyn.topology_dims(topology)
    kw = dict(dft_packed=to.dft_packed, dft_scale=to.dft_packed_scale, topology=topology, n=N)
    kw.update(case)
    if case.get("num_frames", 1) > 1:
        tgt = torch.ones((case["num_frames"], to.num_bins))
        fit = tsf.fused_synth_fitness(torch.full((8, d), 100.0), tgt, **kw)
        gen = tgen.fused_generation(0, torch.rand((4, d)), torch.full((4, d), 0.1), tgt, pop=8,
                                    param_mins=(0.0,) * d, param_maxs=(1000.0,) * d, **kw)
        assert fit.shape == (8,) and torch.isfinite(fit).all()
        assert gen[1].shape == (8, d) and torch.isfinite(gen[0]).all()
        return
    match = "item 3" if "parallel" in topology else None
    with pytest.raises(NotImplementedError, match=match):
        tsf.fused_synth_fitness(torch.zeros((8, d)), torch.zeros(to.num_bins), **kw)
    with pytest.raises(NotImplementedError, match=match):
        tgen.fused_generation(0, torch.zeros((4, d)), torch.zeros((4, d)), torch.zeros(to.num_bins),
                              pop=8, param_mins=(0.0,) * d, param_maxs=(1.0,) * d, **kw)


def test_wrapper_rejects_bad_operands():
    _, to = _operands()
    p = torch.zeros((8, 6))
    with pytest.raises(ValueError):  # unfolded / wrong-dtype operand
        tsf.fused_synth_fitness(p, torch.zeros(to.num_bins), dft_packed=to.dft_packed.float(),
                                dft_scale=to.dft_packed_scale, n=N)
    with pytest.raises(ValueError):  # n not a multiple of 2 * 128
        tsf.fused_synth_fitness(p, torch.zeros(to.num_bins), dft_packed=to.dft_packed,
                                dft_scale=to.dft_packed_scale, n=384)
    with pytest.raises(NotImplementedError):  # above the fused kernels' frame limit
        big = tspec.make_spectrum_ops(4096, dft_dtype="int8", device="cpu")
        tsf.fused_synth_fitness(p, torch.zeros(big.num_bins), dft_packed=big.dft_packed,
                                dft_scale=big.dft_packed_scale, n=4096)
