"""The slice as a whole on the CPU: pmfm_tpu_torch's ES loop against
pmfm_tpu's, plus the pieces whose values must agree bit for bit (kernel
seeds, selection, state carried across by ``interop``).

The two ES runs draw from different generators (threefry and the TPU PRNG
in the reference; torch.Generator and Philox in the port — ROADMAP Queue C),
so whole runs are compared by outcome: over four seeds each, the median
best fitness of the port must lie within a factor of 4 of the reference's,
and both must improve on the first generation's best.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmfm_tpu.es import ESConfig as JConfig
from pmfm_tpu.es import init_state as j_init_state
from pmfm_tpu.es import make_spectrum_ops as j_make_spectrum_ops
from pmfm_tpu.es import select as j_select
from pmfm_tpu.es.pipeline import evolve as j_evolve
from pmfm_tpu.es.pipeline import kernel_seed as j_kernel_seed
from pmfm_tpu.ops import synthesize_single as j_synth
from pmfm_tpu.ops import target_spectrum as j_target
from pmfm_tpu_torch import interop
from pmfm_tpu_torch.es import ESConfig, active_engine, evolve, generation_step, init_state
from pmfm_tpu_torch.es import kernel_seed, make_spectrum_ops, mutate, select
from pmfm_tpu_torch.es import strategy as tstrategy
from pmfm_tpu_torch.ops import synthesize_single, target_spectrum

EVOLVE_FACTOR = 4.0
GENS = 40
SEEDS = range(4)
TRUTH = (3078.0, 2.0, 3015.0, 1.5)
SLICE = dict(num_parents=4, num_offspring=12, num_dimensions=4, topology="fm2",
             param_mins=(0.0,) * 4, param_maxs=(3520.0, 8.0) * 2, audio_length_log2=8,
             synthesis_engine="scanless", dft_dtype="int8", sine_order=7, fused_kernel=True,
             fused_generation=True, pop_block=8)


def test_kernel_seed_bit_equal():
    for word in (0, 1, 12345, 0x7FFFFFFF, 0x80000000, 0xDEADBEEF, 0xFFFFFFFF):
        key = jnp.asarray([word, 7], jnp.uint32)
        seed = interop.seed_from_key(np.asarray(key))
        for g in (0, 1, 2, 77, 999, 123456, 2**31 - 1):
            want = int(j_kernel_seed(key, jnp.asarray(g, jnp.int32)))
            assert kernel_seed(seed, g) == want, (word, g)
            want_s = int(j_kernel_seed(key, jnp.asarray(g, jnp.int32), shard=jnp.asarray(3)))
            assert kernel_seed(seed, g, shard=3) == want_s


def test_state_from_reference_keeps_kernel_seeds():
    cfg = JConfig(**SLICE)
    s = j_init_state(jax.random.PRNGKey(5), cfg)
    t = interop.state_from_numpy(
        s.parent_values, s.parent_steps, s.parent_fitness, s.best_values, s.best_fitness,
        jax.random.key_data(s.key) if jnp.issubdtype(s.key.dtype, jax.dtypes.prng_key) else s.key,
        s.generation, s.stall, device="cpu",
    )
    np.testing.assert_array_equal(t.parent_values.numpy(), np.asarray(s.parent_values))
    assert t.generation == 0 and int(t.stall) == 0 and torch.isinf(t.best_fitness)
    for g in (0, 5, 40):
        assert kernel_seed(t.seed, g) == int(j_kernel_seed(s.key, jnp.asarray(g)))


def test_spectrum_ops_and_target_from_reference():
    jc = JConfig(**SLICE)
    so = j_make_spectrum_ops(jc)
    t = interop.spectrum_ops_from_numpy(
        n=so.n, num_bins=so.num_bins, window=so.window, norm=so.norm, dft_cos=so.dft_cos,
        dft_sin=so.dft_sin, dft_packed=so.dft_packed, dft_packed_scale=so.dft_packed_scale,
        device="cpu",
    )
    mine = make_spectrum_ops(ESConfig(**SLICE), device="cpu")
    assert torch.equal(t.dft_packed, mine.dft_packed) and torch.equal(t.dft_cos, mine.dft_cos)
    assert t.dft_cos.dtype == torch.bfloat16 and t.dft_packed_scale == mine.dft_packed_scale
    tgt = interop.target_from_numpy(np.arange(so.num_bins), device="cpu")
    assert tgt.dtype == torch.float32 and tgt.shape == (so.num_bins,)


def test_select_matches_reference():
    rng = np.random.default_rng(2)
    v, s = rng.random((32, 6)).astype(np.float32), rng.random((32, 6)).astype(np.float32)
    f = rng.permutation(32).astype(np.float32) * 1.5
    rv, rs, rf = j_select(jnp.asarray(v), jnp.asarray(s), jnp.asarray(f), 8)
    tv, ts, tf = select(torch.from_numpy(v), torch.from_numpy(s), torch.from_numpy(f), 8)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(rf))


def _targets():
    jc = JConfig(**SLICE)
    jso = j_make_spectrum_ops(jc)
    jt = j_target(j_synth(jnp.asarray(TRUTH), jc.n_samples, jc.topology), jso)
    tc = ESConfig(**SLICE)
    tso = make_spectrum_ops(tc, device="cpu")
    tt = target_spectrum(synthesize_single(torch.tensor(TRUTH), tc.n_samples, tc.topology), tso)
    return jc, jso, jt, tc, tso, tt


@pytest.mark.parametrize("fused_generation", [True, False], ids=["a_B2", "b_B1"])
def test_evolve_matches_reference_outcome(fused_generation):
    jc, jso, jt, tc, tso, tt = _targets()
    tc = tc.replace(fused_generation=fused_generation)
    assert active_engine(tc, tso) == ("fused_generation" if fused_generation else "fused_kernel")

    @jax.jit
    def run(key):
        final, traj = j_evolve(j_init_state(key, jc), jt, GENS, jso, jc, record_trajectory=True)
        return traj

    ref = np.stack([np.asarray(run(jax.random.PRNGKey(s))) for s in SEEDS])
    got = []
    for s in SEEDS:
        final, traj = evolve(init_state(s, tc, device="cpu"), tt, GENS, tso, tc,
                             record_trajectory=True)
        assert traj.shape == (GENS,) and torch.isfinite(traj).all()
        assert (traj[1:] <= traj[:-1]).all()  # best-ever is monotone
        assert final.generation == GENS
        assert float(final.best_fitness) == float(traj[-1])
        got.append(traj.numpy())
    got = np.stack(got)
    ref_med, got_med = np.median(ref[:, -1]), np.median(got[:, -1])
    assert ref_med / EVOLVE_FACTOR <= got_med <= ref_med * EVOLVE_FACTOR, (got_med, ref_med)
    assert got_med < np.median(got[:, 0]) and ref_med < np.median(ref[:, 0])


def test_early_stop_and_restarts():
    _, _, _, tc, tso, tt = _targets()
    state = init_state(0, tc, device="cpu")
    _, traj = evolve(state, tt, 10, tso, tc, record_trajectory=True)
    thr = float(traj[4])  # reached by generation 5
    cfg = tc.replace(fitness_threshold=thr)
    final, none = evolve(init_state(0, tc, device="cpu"), tt, 10, tso, cfg)
    assert none is None and final.generation <= 5 and float(final.best_fitness) <= thr
    cfg = tc.replace(restart_patience=1)
    s = init_state(0, cfg, device="cpu")
    for _ in range(6):
        prev_best = float(s.best_fitness)
        s = generation_step(s, tt, tso, cfg)
        if float(s.best_fitness) >= prev_best:  # stalled once -> restarted
            assert int(s.stall) == 0 and torch.isinf(s.parent_fitness).all()
            assert (s.parent_steps == 0.1).all()
    assert float(s.best_fitness) < float("inf")


@pytest.mark.parametrize("mode,sigma", [("clt12", 1 / 6), ("clt12_neutral", 1 / 6),
                                        ("normal", 1 / 6), ("normal_unit", 1.0)])
def test_mutation_noise_modes(mode, sigma):
    gen = torch.Generator().manual_seed(0)
    g = tstrategy._gauss(gen, (20000,), mode, "cpu")
    assert abs(float(g.std()) - sigma) < 0.03 * sigma and abs(float(g.mean())) < 0.03 * sigma
    cfg = ESConfig(mutation_noise=mode, min_step=1e-3)
    x = torch.full((4000, 6), 0.5)
    nx, ns = mutate(gen, x, torch.full((4000, 6), 0.1), cfg)
    assert torch.isfinite(nx).all() and (ns >= 1e-3).all()
    assert not torch.equal(nx, x)


def test_entry_points_need_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ESConfig(**SLICE)
    with pytest.raises(RuntimeError, match="cuda"):
        init_state(0, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        make_spectrum_ops(cfg)
    assert init_state(0, cfg, device="cpu").parent_values.device.type == "cpu"


def test_unported_engines_raise():
    cfg = ESConfig(**{**SLICE, "fused_kernel": False, "fused_generation": False})
    so = make_spectrum_ops(cfg, device="cpu")
    with pytest.raises(NotImplementedError):
        active_engine(cfg, so)
    with pytest.raises(NotImplementedError):
        tstrategy.recombine(torch.Generator(), torch.zeros((4, 4)), torch.zeros((4, 4)),
                            cfg.replace(recombine_mode="compat_shuffle"))
