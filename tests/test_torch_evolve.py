"""The whole-run kernel B5 (fused_evolve) of the port, in its plain PyTorch
version on the CPU, against pmfm_tpu/kernels/evolve.py (as
tests/test_fused_evolve.py runs it, in interpret mode), and the ES path
through it (``es.pipeline._evolve_mega``).

The exact rank merge is compared value for value with the reference's
``_merge_topmu``; the whole kernel by the reference's own invariants
(re-evaluating the returned parents through B1 reproduces their fitness
exactly; best-ever is monotone and ends at ``best_fitness``) and, since the
two packages draw different random bits, by outcome: over four seeds the
median final best fitness of the port lies within a factor of 4 of the
reference's, as tests/test_torch_es.py compares ``evolve``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmfm_tpu import ops as jops
from pmfm_tpu.es import ESConfig as JConfig
from pmfm_tpu.es import init_state as j_init_state
from pmfm_tpu.es.pipeline import _evolve_mega as j_evolve_mega
from pmfm_tpu.es.pipeline import make_spectrum_ops as j_make_spectrum_ops
from pmfm_tpu.kernels.evolve import _merge_topmu
from pmfm_tpu.kernels.evolve import fused_evolve as j_fused_evolve
from pmfm_tpu_torch.es import ESConfig, evolve, init_state, kernel_seed, make_spectrum_ops
from pmfm_tpu_torch.es import pipeline as tpipeline
from pmfm_tpu_torch.kernels import evolve as tev
from pmfm_tpu_torch.kernels import generation as tgen
from pmfm_tpu_torch.kernels import synth_fitness as tsf
from pmfm_tpu_torch.ops import synthesize_single, target_spectrum
from pmfm_tpu_torch.ops.synthesis import topology_dims

N, POP, MU, D = 256, 64, 8, 4
MAXS = (3520.0, 8.0, 3520.0, 1.0)
TRUE = (880.0, 2.0, 1760.0, 0.9)
GENS = 10
SEEDS = range(4)
EVOLVE_FACTOR = 4.0


# the cases of tests/test_fused_evolve.py::TestMergeTopMu
@pytest.mark.parametrize("mu,pb", [(8, 32), (16, 16), (3, 40)])
def test_merge_topmu_matches_reference(mu, pb):
    rng = np.random.default_rng(mu * 100 + pb)
    r = 2 * 3 + 1
    pool = rng.standard_normal((r, mu)).astype(np.float32)
    pool[-1] = rng.uniform(0, 10, mu)
    block = rng.standard_normal((r, pb)).astype(np.float32)
    block[-1] = rng.uniform(0, 10, pb)
    ref = np.asarray(_merge_topmu(jnp.asarray(pool), jnp.asarray(block), mu))
    got = tev.merge_topmu_plain(torch.from_numpy(pool), torch.from_numpy(block), mu).numpy()
    np.testing.assert_array_equal(got, ref)


def test_merge_topmu_nan_and_inf_lose():
    rng = np.random.default_rng(0)
    pool = rng.standard_normal((3, 4)).astype(np.float32)
    pool[-1] = [1.0, 2.0, np.nan, np.inf]
    block = rng.standard_normal((3, 8)).astype(np.float32)
    block[-1] = np.arange(3.0, 11.0, dtype=np.float32)
    ref = np.asarray(_merge_topmu(jnp.asarray(pool), jnp.asarray(block), 4))
    got = tev.merge_topmu_plain(torch.from_numpy(pool), torch.from_numpy(block), 4).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[-1], [1.0, 2.0, 3.0, 4.0])
    # past every finite value come +inf, then NaN, each keeping its own
    # fitness (the reference writes both as its 3e38 sentinel, in index order)
    full = tev.merge_topmu_plain(torch.from_numpy(pool), torch.from_numpy(block), 12).numpy()
    assert np.isinf(full[-1, -2]) and np.isnan(full[-1, -1])
    np.testing.assert_array_equal(full[:-1, -2], pool[:-1, 3])
    np.testing.assert_array_equal(full[:-1, -1], pool[:-1, 2])


def test_merge_topmu_ties_broken_by_index():
    pool = np.zeros((3, 4), np.float32)
    pool[0] = [10, 20, 30, 40]
    pool[-1] = 5.0
    block = np.zeros((3, 8), np.float32)
    block[0] = np.arange(8.0) + 100.0
    block[-1] = 5.0
    ref = np.asarray(_merge_topmu(jnp.asarray(pool), jnp.asarray(block), 6))
    got = tev.merge_topmu_plain(torch.from_numpy(pool), torch.from_numpy(block), 6).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[0], [10, 20, 30, 40, 100, 101])


def test_select_stable_orders_ties_and_nan():
    f = torch.tensor([3.0, float("nan"), 1.0, 3.0, float("inf"), -0.0, 0.0])
    v = torch.arange(7.0)[:, None]
    sv, _, sf_ = tev.select_stable(v, v, f, 7)
    assert sv[:, 0].tolist() == [5.0, 6.0, 2.0, 0.0, 3.0, 4.0, 1.0]
    assert torch.isnan(sf_[-1])


@pytest.fixture(scope="module")
def setup():
    so = make_spectrum_ops(ESConfig(audio_length_log2=8, dft_dtype="int8", num_dimensions=4,
                                    topology="fm2", param_mins=(0.0,) * 4, param_maxs=MAXS),
                           device="cpu")
    tgt = target_spectrum(synthesize_single(torch.tensor(TRUE), N, "fm2", engine="scanless"), so)
    return so, tgt


def _kw(so, **extra):
    return dict(pop=POP, param_mins=(0.0,) * D, param_maxs=MAXS, dft_packed=so.dft_packed,
                dft_scale=so.dft_packed_scale, topology="fm2", n=N, pop_block=8, sine_order=7,
                **extra)


def _run(so, tgt, gens=GENS, seed=7):
    g = torch.Generator().manual_seed(0)
    pv = torch.rand((MU, D), generator=g)
    ps = torch.full((MU, D), 0.1)
    seeds = [kernel_seed(seed, i) for i in range(gens)]
    return tev.fused_evolve(seeds, pv, ps, pv[0], torch.tensor(float("inf")), tgt, **_kw(so))


def test_fused_evolve_invariants(setup):
    so, tgt = setup
    before = tev.fused_evolve.launches
    pv, ps, pf, bv, bf, traj = _run(*setup)
    assert tev.fused_evolve.launches == before  # CPU tensors: the plain version
    assert pv.shape == (MU, D) and ps.shape == (MU, D) and traj.shape == (GENS,)
    assert (pf[1:] >= pf[:-1]).all()  # parents best first
    assert (traj[1:] <= traj[:-1]).all()  # best-ever monotone
    assert float(bf) == float(traj[-1]) and float(bf) <= float(pf[0])
    assert torch.isfinite(pf).all()
    # re-evaluating the parents through B1 reproduces their fitness exactly
    scaled = tgen.scale_rows(pv, (0.0,) * D, MAXS)
    fit = tsf.fused_synth_fitness(scaled, tgt, dft_packed=so.dft_packed,
                                  dft_scale=so.dft_packed_scale, topology="fm2", n=N,
                                  pop_block=8, sine_order=7)
    assert torch.equal(fit, pf)
    best = tsf.fused_synth_fitness(tgen.scale_rows(bv[None], (0.0,) * D, MAXS), tgt,
                                   dft_packed=so.dft_packed, dft_scale=so.dft_packed_scale,
                                   topology="fm2", n=N, pop_block=1, sine_order=7)
    assert float(best[0]) == float(bf)


def test_fused_evolve_is_b2_with_stable_selection(setup):
    """Generation by generation: B2's offspring for the generation's seed,
    the stable (fitness, index) top-mu, best-ever on a strict improvement."""
    so, tgt = setup
    pv, ps, pf, bv, bf, traj = _run(so, tgt, gens=3)
    g = torch.Generator().manual_seed(0)
    qv = torch.rand((MU, D), generator=g)
    qs = torch.full((MU, D), 0.1)
    best = float("inf")
    for i in range(3):
        fit, val, stp = tgen.fused_generation(kernel_seed(7, i), qv, qs, tgt, **_kw(so))
        order = sorted(range(POP), key=lambda j: (float(fit[j]), j))[:MU]
        qv, qs, qf = val[order], stp[order], fit[order]
        best = min(best, float(qf[0]))
        assert float(traj[i]) == best
    assert torch.equal(pv, qv) and torch.equal(ps, qs) and torch.equal(pf, qf)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_fused_evolve_bank_is_b2_with_stable_selection(dtype):
    """B5 on an fm3_parallel bank (ported: ROADMAP Queue B item 3), in each
    mode, generation by generation bit-equal to B2's plain version for the
    generation's seed with the stable (fitness, index) top-mu and best-ever
    on a strict improvement."""
    topology, d, maxs = "fm3_parallel", 12, (3520.0, 8.0, 3520.0, 1.0) * 3
    so = make_spectrum_ops(ESConfig(audio_length_log2=8, dft_dtype=dtype, num_dimensions=d,
                                    topology=topology, param_mins=(0.0,) * d, param_maxs=maxs),
                           device="cpu")
    tgt = target_spectrum(synthesize_single(torch.tensor(TRUE * 3), N, topology,
                                            engine="scanless"), so)
    kw = dict(pop=POP, param_mins=(0.0,) * d, param_maxs=maxs, dft_packed=so.dft_packed,
              dft_scale=so.dft_packed_scale, topology=topology, n=N, pop_block=16, sine_order=9)
    g = torch.Generator().manual_seed(1)
    pv0, ps0 = torch.rand((MU, d), generator=g), torch.full((MU, d), 0.1)
    seeds = [kernel_seed(9, i) for i in range(3)]
    before = tev.fused_evolve.launches
    pv, ps, pf, bv, bf, traj = tev.fused_evolve(seeds, pv0, ps0, pv0[0],
                                                torch.tensor(float("inf")), tgt, **kw)
    assert tev.fused_evolve.launches == before  # CPU tensors: the plain version
    qv, qs, best = pv0, ps0, float("inf")
    for i, seed in enumerate(seeds):
        fit, val, stp = tgen.fused_generation_plain(seed, qv, qs, tgt, **kw)
        order = sorted(range(POP), key=lambda j: (float(fit[j]), j))[:MU]
        qv, qs, qf = val[order], stp[order], fit[order]
        best = min(best, float(qf[0]))
        assert float(traj[i]) == best
    assert torch.equal(pv, qv) and torch.equal(ps, qs) and torch.equal(pf, qf)
    assert float(bf) == float(traj[-1]) and torch.isfinite(traj).all()


def test_fused_evolve_resume_improves_or_holds(setup):
    so, tgt = setup
    pv, ps, pf, bv, bf, _ = _run(so, tgt, gens=5)
    out = tev.fused_evolve([kernel_seed(99, i) for i in range(5)], pv, ps, bv, bf, tgt,
                           **_kw(so))
    assert float(out[4]) <= float(bf)


def test_fused_evolve_f32_mode(setup):
    """The true-f32 mode (the refine tail's operand) through the same loop."""
    so32 = make_spectrum_ops(ESConfig(audio_length_log2=8, dft_dtype="float32", num_dimensions=4,
                                      topology="fm2", param_mins=(0.0,) * 4, param_maxs=MAXS),
                             device="cpu")
    tgt = target_spectrum(synthesize_single(torch.tensor(TRUE), N, "fm2", engine="scanless"),
                          so32)
    pv, ps, pf, bv, bf, traj = _run(so32, tgt, gens=4)
    assert (traj[1:] <= traj[:-1]).all() and float(bf) == float(traj[-1])
    fit = tsf.fused_synth_fitness(tgen.scale_rows(pv, (0.0,) * D, MAXS), tgt,
                                  dft_packed=so32.dft_packed, dft_scale=0.0, topology="fm2",
                                  n=N, pop_block=8, sine_order=7)
    assert torch.equal(fit, pf)


def test_fused_evolve_matches_reference_outcome(setup):
    """Over four seeds, the median final best-ever of the port's B5 lies
    within a factor of 4 of the reference's fused_evolve (interpret mode)."""
    so, tgt = setup
    jso = jops.make_spectrum_ops(N, method="dft", dft_dtype=jnp.int8)
    jtgt = jops.magnitude_spectrum(
        jops.synthesize(jnp.asarray(TRUE)[None], N, "fm2", engine="scanless"), jso)[0]
    np.testing.assert_allclose(tgt.numpy(), np.asarray(jtgt), rtol=1e-5, atol=1e-6)
    ref, got = [], []
    for s in SEEDS:
        pv = jax.random.uniform(jax.random.PRNGKey(s), (MU, D))
        ps = jnp.full((MU, D), 0.1)
        out = j_fused_evolve(
            jnp.int32(s + 1), pv, ps, pv[0], jnp.float32(np.inf), jso.dft_packed, jtgt,
            gens=GENS, pop=POP, param_mins=(0.0,) * D, param_maxs=MAXS, topology="fm2", n=N,
            pop_block=8, interpret=True, dft_scale=jso.dft_packed_scale, sine_order=7,
        )
        ref.append(np.asarray(out[5]))
        tpv = torch.from_numpy(np.array(pv))
        tout = tev.fused_evolve([kernel_seed(s + 1, i) for i in range(GENS)], tpv,
                                torch.from_numpy(np.array(ps)), tpv[0],
                                torch.tensor(float("inf")), tgt, **_kw(so))
        got.append(tout[5].numpy())
    ref, got = np.stack(ref), np.stack(got)
    assert np.all(np.diff(ref, axis=1) <= 1e-7) and np.all(np.diff(got, axis=1) <= 0)
    ref_med, got_med = np.median(ref[:, -1]), np.median(got[:, -1])
    assert ref_med / EVOLVE_FACTOR <= got_med <= ref_med * EVOLVE_FACTOR, (got_med, ref_med)
    assert got_med < np.median(got[:, 0]) and ref_med < np.median(ref[:, 0])


def _mega_cfg(**extra):
    return dict(num_parents=MU, num_offspring=POP - MU, num_dimensions=D, topology="fm2",
                param_mins=(0.0,) * D, param_maxs=MAXS, audio_length_log2=8,
                spectrum_method="dft", dft_dtype="int8", fused_kernel=True,
                fused_generation=True, fused_evolve=True, pop_block=8, sine_order=7, **extra)


def test_evolve_mega_bookkeeping_matches_reference(setup):
    """As tests/test_fused_evolve.py::TestEvolveMegaWrapper: generation,
    trajectory shape, stall range, best == trajectory end; and the stall
    the port recovers from the trajectory equals the loop's own count."""
    so, tgt = setup
    jc = JConfig(**_mega_cfg())
    jso = j_make_spectrum_ops(jc)
    jtgt = jops.target_spectrum(jops.synthesize_single(jnp.asarray(TRUE), N, "fm2"), jso)
    jfinal, jtraj = j_evolve_mega(j_init_state(jax.random.PRNGKey(3), jc), jtgt, 6, jso, jc,
                                  True, interpret=True)
    cfg = ESConfig(**_mega_cfg())
    state = init_state(3, cfg, device="cpu")
    final, traj = tpipeline._evolve_mega(state, tgt, 6, so, cfg, True)
    for f, t in ((jfinal, np.asarray(jtraj)), (final, traj.numpy())):
        assert int(f.generation) == 6 and t.shape == (6,)
        assert 0 <= int(f.stall) <= 6 and float(f.best_fitness) == float(t[-1])
    # the per-generation loop on the same seeds gives the same trajectory and stall
    # (its selection is torch.topk: ties aside, the same survivors)
    loop, ltraj = evolve(init_state(3, cfg.replace(fused_evolve=False), device="cpu"), tgt, 6,
                         so, cfg.replace(fused_evolve=False), record_trajectory=True)
    assert torch.equal(ltraj, traj) and int(loop.stall) == int(final.stall)
    assert torch.equal(loop.best_values, final.best_values)
    none = tpipeline._evolve_mega(final, tgt, 0, so, cfg, False)
    assert none[0] is final and none[1] is None


def test_evolve_routes_to_b5_only_on_a_card(setup):
    so, _ = setup
    cfg = ESConfig(**_mega_cfg())
    assert not tpipeline._fused_evolve_ok(cfg, so, torch.device("cpu"))
    assert tpipeline._fused_evolve_ok(cfg, so, torch.device("cuda"))
    for extra in (dict(restart_patience=5), dict(fitness_threshold=1.0),
                  dict(fused_evolve=False), dict(mutation_noise="normal_unit")):
        assert not tpipeline._fused_evolve_ok(ESConfig(**{**_mega_cfg(), **extra}), so,
                                              torch.device("cuda"))


# identical candidates (every parent equal, steps 0, min_step 0) at
# fm3_series: every offspring and every fitness of a generation is equal, so
# the selection's ties decide alone and the survivors are candidates 0..mu-1
TIE_N, TIE_POP, TIE_MU, TIE_GENS = 256, 128, 16, 3
TIE_MAXS = (3520.0, 8.0) * 3
TIE_TRUE = (3078.0, 2.0, 3015.0, 1.5, 3141.0, 1.0)
TIE_FIT_REL = 1e-3  # B1's tolerance against the reference (test_torch_kernels.py)


def test_fused_evolve_identical_candidates_match_reference():
    """B5's plain version and the reference's fused_evolve (interpret mode)
    on the all-ties input: the same parent values, equal finite fitness (no
    3e38 sentinel), and each generation's survivors are candidates 0..mu-1
    in index order."""
    d = len(TIE_TRUE)
    cfg = ESConfig(audio_length_log2=8, dft_dtype="int8", num_dimensions=d,
                   topology="fm3_series", param_mins=(0.0,) * d, param_maxs=TIE_MAXS)
    so = make_spectrum_ops(cfg, device="cpu")
    tgt = target_spectrum(synthesize_single(torch.tensor(TIE_TRUE), TIE_N, "fm3_series",
                                            engine="scanless"), so)
    jso = jops.make_spectrum_ops(TIE_N, method="dft", dft_dtype=jnp.int8)
    np.testing.assert_array_equal(so.dft_packed.numpy(), np.asarray(jso.dft_packed))
    jtgt = jnp.asarray(tgt.numpy())  # one target for both
    row = np.random.default_rng(5).random(d).astype(np.float32)
    pv = np.tile(row, (TIE_MU, 1))
    ps = np.zeros((TIE_MU, d), np.float32)
    kw = dict(pop=TIE_POP, param_mins=(0.0,) * d, param_maxs=TIE_MAXS, topology="fm3_series",
              n=TIE_N, pop_block=32, dft_scale=so.dft_packed_scale, sine_order=7, min_step=0.0)
    ref = j_fused_evolve(jnp.int32(5), jnp.asarray(pv), jnp.asarray(ps), jnp.asarray(pv[0]),
                         jnp.float32(np.inf), jso.dft_packed, jtgt, gens=TIE_GENS,
                         interpret=True, **kw)
    seeds = [kernel_seed(5, i) for i in range(TIE_GENS)]
    tpv, tps = torch.from_numpy(pv), torch.from_numpy(ps)
    got = tev.fused_evolve(seeds, tpv, tps, tpv[0], torch.tensor(float("inf")), tgt,
                           dft_packed=so.dft_packed, **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[0].numpy(), pv)
    np.testing.assert_array_equal(got[1].numpy(), ps)
    jf, tf = np.asarray(ref[2]), got[2].numpy()
    assert np.isfinite(jf).all() and np.all(jf == jf[0]) and np.all(tf == tf[0])
    assert abs(tf[0] - jf[0]) <= TIE_FIT_REL * abs(jf[0]), (tf[0], jf[0])
    np.testing.assert_allclose(got[5].numpy(), np.asarray(ref[5]), rtol=TIE_FIT_REL)
    for seed in seeds:  # the selection's view of each generation
        fit, val, _ = tgen.fused_generation(seed, tpv, tps, tgt, dft_packed=so.dft_packed, **kw)
        assert torch.all(fit == fit[0]) and torch.isfinite(fit).all()
        assert torch.equal(tev.stable_order(fit)[:TIE_MU], torch.arange(TIE_MU))
        assert torch.equal(val, tpv[:1].expand(TIE_POP, d))


@pytest.mark.parametrize("pop,mu,in_shared,smem_bytes", [
    # the bench config: 2^15 keys in shared memory beside the histograms
    (1 << 15, 256, True, 4 * (8516 + 3 * 256 + (1 << 15))),
    # the last population whose keys fit at mu 256, and the first that streams
    (48828, 256, True, 232448),
    (48829, 256, False, 4 * (8516 + 3 * 256)),
    (1 << 16, 256, False, 4 * (8516 + 3 * 256)),
    # a ragged population: its keys padded to 16 bytes
    (4001, 64, True, 4 * (8516 + 3 * 64 + 4004)),
    # mu so large that even the survivors do not fit: the wrapper raises
    (1 << 16, 16600, False, 4 * (8516 + 3 * 16600)),
])
def test_select_geometry(pop, mu, in_shared, smem_bytes):
    """The selection kernel's shared memory (csrc evolve.cu
    select_smem_bytes: 32 warps' 256-bin histograms, the bin totals, the
    warps' counts, a broadcast, 3 x mu survivor words, and the P keys,
    padded to 16 bytes, when they fit one block's 232,448 bytes)."""
    geo = tev.select_geometry(pop, mu)
    assert geo == dict(keys_in_shared=in_shared, smem_bytes=smem_bytes)
    assert (geo["smem_bytes"] <= tsf.MAX_SHARED_BYTES) is (mu < 16600)


# ---- B5's layout in int8 and bf16: B2's wrapper's at the same arguments ------------

B5_LAYOUT_SHAPES = [  # (mode, topology, n, frames, runs, pop, key): None = tp_faster's say
    pytest.param("int8", "fm3_series", 1024, 1, None, 1 << 15, "one_warp", id="bench-int8"),
    pytest.param("int8", "fm3_parallel", 1024, 1, None, 8192, "time_parallel",
                 id="bank-polish-P8192"),
    pytest.param("int8", "fm3_series", 2048, 8, None, 4096, "time_parallel", id="stft-F8"),
    pytest.param("int8", "fm3_series", 2048, 1, 8, 4096, "time_parallel", id="runs-8xP4096"),
    pytest.param("bf16", "fm3_series", 1024, 1, None, 1 << 15, "bf16_time_parallel",
                 id="bench-bf16"),
    # the long code (above 32 genes) and a wide code: the one-warp layout only
    pytest.param("int8", "fm9_parallel", 1024, 1, None, 8192, "one_warp", id="long-int8"),
    pytest.param("bf16", "fm9_parallel", 1024, 1, None, 8192, "bf16_one_warp", id="long-bf16"),
    pytest.param("int8", "fm10_series", 1024, 1, None, 4096, "one_warp", id="wide-int8"),
    pytest.param("bf16", "fm10_series", 1024, 8, None, 1024, "bf16_one_warp", id="wide-bf16"),
    # a frame whose time-parallel block exceeds one block's shared memory
    pytest.param("int8", "fm3_series", 3584, 1, None, 4096, "one_warp", id="n3584-int8"),
    pytest.param("bf16", "fm3_series", 3584, 1, None, 4096, "bf16_one_warp", id="n3584-bf16"),
    # n 768 in bf16 (six warps a block): as tp_faster says
    pytest.param("bf16", "fm3_series", 768, 1, None, 1 << 11, None, id="n768-P2048"),
    pytest.param("bf16", "fm3_series", 768, 1, None, 1 << 15, None, id="n768-P32768"),
    pytest.param("bf16", "fm3_parallel", 768, 2, 4, 1 << 13, None, id="n768-bank-4x8192-F2"),
]


def _layout_call(mode, topology, n, frames, runs, pop):
    """Parents and the keyword arguments of a B2 or B5 call at the shape,
    with an operand of the mode's dtype and (2 K, n / 2) shape, the two
    things of it the layout reads."""
    d = topology_dims(topology)
    lead = () if runs is None else (runs,)
    pv = torch.zeros((*lead, 16, d))
    operand = torch.empty((n, n // 2), dtype=torch.int8 if mode == "int8" else torch.bfloat16)
    kw = dict(pop=pop, param_mins=(0.0,) * d, param_maxs=(1.0,) * d, dft_packed=operand,
              dft_scale=1.0 if mode == "int8" else 0.0, topology=topology, n=n,
              pop_block=pop, num_frames=frames, sine_order=9)
    return pv, kw


@pytest.mark.parametrize("mode,topology,n,frames,runs,pop,key", B5_LAYOUT_SHAPES)
def test_b5_layout_is_b2s(mode, topology, n, frames, runs, pop, key):
    """The layout B5's generations run in on the card (``fused_evolve``
    passes ``generation.takes_time_parallel`` of its own arguments to the
    C loop and counts the call under its ``layout_key``) at each named
    shape: the time-parallel layout where B2's rule picks it (the pursuit's
    polish bank, --mode stft's eight frames, the run axis, bf16 at the bench
    config), the one-warp one where the rule keeps it (int8 at the bench
    config) and wherever no time-parallel kernel takes the shape (the long
    and wide codes, n 3584); at n 768 in bf16 what ``tp_faster`` says. The
    choice is ``fused_generation``'s at the same arguments."""
    d, k = topology_dims(topology), n // 2
    if key is None:
        key = tgen.layout_key(mode, tgen.tp_faster(n, topology, pop, runs or 1, mode))
    pv, kw = _layout_call(mode, topology, n, frames, runs, pop)
    b5 = tgen.layout_key(mode, tev.takes_time_parallel(pv, **kw, gens_per_step=1))
    b2 = tgen.layout_key(mode, tgen.time_parallel(n, k, d, topology, mode, frames, pop,
                                                  runs or 1))
    assert tev.takes_time_parallel is tgen.takes_time_parallel
    assert b5 == b2 == key


@pytest.mark.parametrize("switch", [False, True])
def test_b5_layout_follows_tp_faster(monkeypatch, switch):
    """B5's layout follows ``generation.tp_faster`` as it stands at the call
    (what the card checks patch to hold B5's layouts against each other),
    where a time-parallel kernel takes the shape, in int8 and bf16; the
    long code stays one-warp whatever the rule says."""
    monkeypatch.setattr(tgen, "tp_faster", lambda *a, **k: switch)
    for mode in ("int8", "bf16"):
        for topology in ("fm2", "fm5_series", "fm8_series", "fm2_parallel", "fm5_parallel"):
            pv, kw = _layout_call(mode, topology, 1024, 1, None, 4096)
            assert tev.takes_time_parallel(pv, **kw) is switch
        pv, kw = _layout_call(mode, "fm9_parallel", 1024, 1, None, 4096)
        assert tev.takes_time_parallel(pv, **kw) is False


def test_b5_layout_f32_is_no_b2_layout():
    """True f32 names no B2 layout (its route and synthesis layout are
    ``f32_launch``'s), so B5 passes the one-warp code to the C loop."""
    pv = torch.zeros((16, 6))
    kw = dict(pop=4096, dft_packed=torch.empty((1024, 512)), dft_scale=0.0, n=1024)
    assert tev.takes_time_parallel(pv, **kw) is False


@pytest.mark.parametrize("switch", [False, True])
def test_b5_wrapper_plain_on_cpu_whatever_the_layout(setup, monkeypatch, switch):
    """On CPU tensors B5 runs its plain version whichever layout it would
    take on the card, and counts no launch, by mode or by layout."""
    so, tgt = setup
    monkeypatch.setattr(tgen, "tp_faster", lambda *a, **k: switch)
    rng = np.random.default_rng(21)
    pv = torch.from_numpy(rng.random((MU, D)).astype(np.float32))
    ps = torch.from_numpy(rng.uniform(0.02, 0.3, (MU, D)).astype(np.float32))
    kw = dict(pop=POP, param_mins=(0.0,) * D, param_maxs=MAXS, dft_packed=so.dft_packed,
              dft_scale=so.dft_packed_scale, topology="fm2", n=N, sine_order=9)
    assert tev.takes_time_parallel(pv, **kw) is switch
    seeds = [kernel_seed(5, g) for g in range(3)]
    args = (pv, ps, pv[0].clone(), torch.tensor(float("inf")), tgt)
    counts = (tev.fused_evolve.launches, dict(tev.fused_evolve.launches_by_layout))
    out = tev.fused_evolve(seeds, *args, **kw)
    assert (tev.fused_evolve.launches, dict(tev.fused_evolve.launches_by_layout)) == counts
    want = tev.fused_evolve_plain(seeds, *args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(out, want))
