"""The port's staged (pursuit) solvers (pmfm_tpu_torch/es/staged.py) on the
CPU against pmfm_tpu.es.staged: the pure pieces exactly (alias proposals,
config mappers, block topologies and the derived configs), the block
stages' embedded evaluation within the unfused f32 engine's limits, and the
rest in behaviour, since torch cannot reproduce JAX's PRNG: the
multi-start wrapper with stub attempts, the series solver's f32-elitist
guard, independent stacked tries, and the reference's end-to-end checks
(tests/test_staged.py) at its sizes.
"""
import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmfm_tpu.es import ESConfig as JConfig
from pmfm_tpu.es import make_spectrum_ops as j_make_spectrum_ops
from pmfm_tpu.es import staged as jst
from pmfm_tpu.es.strategy import evaluate as j_evaluate
from pmfm_tpu.io.config import load_config as j_load_config
from pmfm_tpu.ops import synthesis as jsyn
from pmfm_tpu_torch.es import ESConfig, PursuitResult, evaluate, make_spectrum_ops
from pmfm_tpu_torch.es import staged as tst
from pmfm_tpu_torch.io import load_config
from pmfm_tpu_torch.ops import synthesize_single, target_spectrum
from pmfm_tpu_torch.ops.synthesis import scale_params

REPO = Path(__file__).resolve().parent.parent
PURSUIT = ("fm3_parallel_match.json", "fm4_parallel_match.json", "fm4_series_match.json",
           "fm5_series_match.json", "huge_frame_match.json")
# the unfused f32 engine against the reference's, max / median relative:
# its stated limits; a 4-operator chain carries the float32 difference of
# the two packages' phase sums further (measured on the scanless synthesis
# 2.9e-4 / 6.6e-6, and 1.8e-4 / 1.2e-6 on the scan)
F32_LIMITS = (3e-4, 1e-6)
CHAIN4_SCANLESS_LIMITS = (1e-3, 1e-5)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_alias_variants_match_reference(k):
    rng = np.random.default_rng(k)
    scale = np.asarray((3520.0, 8.0, 3520.0, 1.0) * k, np.float32)
    for _ in range(20):
        est = rng.random(4 * k).astype(np.float32)
        got, want = tst.alias_variants(est, k, scale), jst.alias_variants(est, k, scale)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_kwargs_mappers_match_reference():
    items = (("aliasRounds", 3), ("peelTries", 2), ("jointStep", 0.02), ("repairRounds", 3),
             ("targetRel", 0.01), ("maxAttempts", 4), ("stagePopulation", 512))
    assert tst.pursuit_kwargs_from_config(items) == jst.pursuit_kwargs_from_config(items)
    s_items = (("coreTries", 3), ("growGenerations", 7), ("jointSpread", 0.5),
               ("targetRel", 0.04), ("maxAttempts", 2))
    assert (tst.series_pursuit_kwargs_from_config(s_items)
            == jst.series_pursuit_kwargs_from_config(s_items))
    assert tst.CONFIG_KEY_MAP == jst.CONFIG_KEY_MAP
    assert tst.SERIES_CONFIG_KEY_MAP == jst.SERIES_CONFIG_KEY_MAP
    for name in PURSUIT:
        items = load_config(str(REPO / "examples" / name)).pursuit
        assert items == j_load_config(str(REPO / "examples" / name)).pursuit
        mapper = "series_pursuit_kwargs_from_config" if "series" in name else \
            "pursuit_kwargs_from_config"
        assert getattr(tst, mapper)(items) == getattr(jst, mapper)(items)
    for mapper in ("pursuit_kwargs_from_config", "series_pursuit_kwargs_from_config"):
        for mod in (tst, jst):
            with pytest.raises(ValueError, match="unknown tpu.pursuit key"):
                getattr(mod, mapper)((("sweeps", 1),))
    with pytest.raises(ValueError, match="unknown tpu.pursuit key"):
        tst.pursuit_kwargs_from_config((("coreTries", 1),))


def test_block_topology_matches_reference():
    for d in range(1, 41):
        try:
            want = jst._block_topology(d)
        except ValueError:
            with pytest.raises(ValueError):
                tst._block_topology(d)
            continue
        assert tst._block_topology(d) == want


def _common_fields(tcfg, jcfg):
    t, j = dataclasses.asdict(tcfg), dataclasses.asdict(jcfg)
    keys = sorted(set(t) & set(j))
    assert len(keys) >= 30
    return {k: t[k] for k in keys}, {k: j[k] for k in keys}


@pytest.mark.parametrize("name", PURSUIT)
def test_block_and_eval_configs_match_reference(name):
    """Every field the two ESConfigs share is equal in the block stages'
    and the scoring engine's configs, for each pursuit example's blocks."""
    tcfg = load_config(str(REPO / "examples" / name)).es
    jcfg = j_load_config(str(REPO / "examples" / name)).es
    assert _common_fields(tcfg, jcfg)[0] == _common_fields(tcfg, jcfg)[1]
    t, j = _common_fields(tst._eval_cfg(tcfg), jst._eval_cfg(jcfg))
    assert t == j
    d = tcfg.num_dimensions
    blocks = [tuple(range(4)), tuple(range(d - 8, d)) if d >= 8 else tuple(range(d)),
              tuple(range(d - 6, d)) if d >= 6 else tuple(range(d))]
    for block in blocks:
        for pop in (128, 8192):
            t, j = _common_fields(tst._block_cfg(tcfg, block, pop),
                                  jst._block_cfg(jcfg, block, pop))
            assert t == j


@pytest.mark.parametrize("topology,block,synth,limits", [
    ("fm3_parallel", (4, 5, 6, 7), "scanless", F32_LIMITS),
    ("fm3_parallel", tuple(range(4, 12)), "scanless", F32_LIMITS),
    ("fm4_series", (2, 3, 4, 5, 6, 7), "scanless", CHAIN4_SCANLESS_LIMITS),
])
def test_block_evaluation_matches_reference(topology, block, synth, limits):
    """A block stage's candidates embedded into the frozen genes and scored
    by the f32 engine, against the reference's ``.at[:, idx].set`` and
    ``evaluate`` on the same values, frozen genes and target, as
    tests/test_torch_unfused.py holds the engine: mild-index ranges (full
    range chains are chaotic: a float32 ulp of phase then moves the audio by
    more than the spectra's rounding) and a random target. The embedding
    itself is exact."""
    d = jsyn.topology_dims(topology)
    maxs = (2000.0, 2.0, 2000.0, 1.0) * (d // 4) if "parallel" in topology else (2000.0, 2.0) * (
        d // 2)
    kw = dict(num_parents=8, num_offspring=56, num_dimensions=d, topology=topology,
              param_mins=(0.0,) * d, param_maxs=maxs, audio_length_log2=10,
              synthesis_engine=synth, dft_dtype="int8", fused_kernel=True,
              fused_generation=True)
    tcfg, jcfg = tst._eval_cfg(ESConfig(**kw)), jst._eval_cfg(JConfig(**kw))
    rng = np.random.default_rng(len(block))
    frozen = rng.random(d).astype(np.float32)
    values = rng.random((64, len(block))).astype(np.float32)
    target = (rng.random(512) * 5.0).astype(np.float32)
    full = jnp.broadcast_to(jnp.asarray(frozen), (64, d)).at[:, jnp.asarray(block)].set(
        jnp.asarray(values))
    want = np.asarray(j_evaluate(full, jnp.asarray(target), j_make_spectrum_ops(jcfg), jcfg))
    embedded = tst._embed(torch.from_numpy(frozen), block, torch.from_numpy(values))
    np.testing.assert_array_equal(embedded.numpy(), np.asarray(full))
    got = evaluate(embedded, torch.from_numpy(target), make_spectrum_ops(tcfg, device="cpu"),
                   tcfg).numpy()
    assert got.shape == (64,) and np.isfinite(got).all()
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    assert rel.max() <= limits[0] and np.median(rel) <= limits[1], (rel.max(), np.median(rel))


def _stub_result(fitness, values):
    return PursuitResult(best_values=np.asarray(values, np.float32), best_fitness=fitness,
                         stage_fitness=np.zeros(1, np.float32), alias_fitness=np.zeros(0),
                         generations_used=10, seconds={"block": 1.0})


def _fm2_target(cfg, genes=(0.62, 0.3, 0.48, 0.8)):
    g = torch.tensor([genes])
    scaled = scale_params(g, torch.tensor(cfg.param_mins), torch.tensor(cfg.param_maxs))[0]
    return synthesize_single(scaled, cfg.n_samples, cfg.topology).numpy()


def test_multi_start_counts_accepts_and_keeps_the_best():
    """Stub attempts: attempt 0 gets the caller's seed and later ones fresh
    seeds; acceptance and the comparison run on the f32 engine's score, not
    the attempt's own fitness; the best attempt is returned with the
    attempts, generations and seconds summed."""
    cfg = ESConfig(num_parents=4, num_offspring=12, num_dimensions=4, topology="fm2",
                   param_mins=(0.0,) * 4, param_maxs=(3520.0, 8.0, 3520.0, 1.0),
                   audio_length_log2=9, synthesis_engine="scanless")
    audio = _fm2_target(cfg)
    truth = np.asarray([0.62, 0.3, 0.48, 0.8], np.float32)
    silent = np.asarray([0.62, 0.3, 0.48, 0.0], np.float32)
    seeds = []

    def attempts(plan):
        def fn(target_audio, c, seed, *, device, **kw):
            seeds.append(seed)
            # the self-reported fitness says the opposite of the f32 score
            good = plan[len(seeds) - 1]
            return _stub_result(1e9 if good else 0.0, truth if good else silent)
        return fn

    r = tst._multi_start(attempts([False, False, True, False]), audio, cfg, 7, device="cpu",
                         target_rel=0.01, max_attempts=4)
    assert seeds[0] == 7 and len(set(seeds)) == 3 and r.attempts == 3
    np.testing.assert_array_equal(r.best_values, truth)
    assert r.generations_used == 30 and r.seconds["block"] == 3.0
    seeds.clear()
    r = tst._multi_start(attempts([False, True, False]), audio, cfg, 7, device="cpu",
                         target_rel=1e-12, max_attempts=3)
    assert r.attempts == 3 and len(seeds) == 3  # never accepted: every attempt, the best kept
    np.testing.assert_array_equal(r.best_values, truth)
    seeds.clear()
    r = tst._multi_start(attempts([False, True]), audio, cfg, 7, device="cpu", target_rel=0.0,
                         max_attempts=5)
    assert r.attempts == 1 and seeds == [7]  # no target: one attempt


def test_series_guard_keeps_the_staged_estimate(monkeypatch):
    """A polish whose result rescores worse under f32 than the staged
    estimate is dropped (the f32-elitist guard)."""
    cfg = _series_cfg(4)
    audio = _series_target(cfg)
    real = tst._Stages.final_polish

    def bad_polish(self, *a, **kw):
        final = real(self, *a, **kw)
        return final._replace(best_values=torch.full_like(final.best_values, 0.97))

    monkeypatch.setattr(tst._Stages, "final_polish", bad_polish)
    r = tst.match_series_pursuit(audio, cfg, 0, device="cpu", stage_population=128,
                                 core_generations=6, core_tries=1, grow_generations=4,
                                 grow_tries=1, repair_rounds=0, joint_generations=2)
    assert r.best_fitness == r.stage_fitness[-1]
    assert not np.all(r.best_values == np.float32(0.97))


def test_stacked_tries_read_only_their_own_parents():
    """Stacked tries recombine from their own parents only: try 0's parents
    are 0 and try 1's are 1, so each try's offspring keep its value."""
    cfg = _toy_cfg(2)
    bcfg = tst._block_cfg(cfg, tuple(range(8)), 64)
    pv = torch.stack([torch.zeros(bcfg.num_parents, 8), torch.ones(bcfg.num_parents, 8)])
    gen = torch.Generator().manual_seed(0)
    for mode in ("gather", "off"):
        v, s = tst._recombine_batch(gen, pv, pv + 2, bcfg.replace(recombine_mode=mode))
        assert v.shape == (2, 64, 8)
        assert (v[0] == 0).all() and (v[1] == 1).all() and (s[1] == 3).all()


def test_block_runner_is_elitist():
    """One try (``_block_runner``) never ends above its incumbent's
    fitness, and genes outside the block never move."""
    cfg = _toy_cfg(2)
    audio = _target_of(cfg, [0.6, 0.25, 0.5, 0.9, 0.35, 0.3, 0.7, 0.7])
    ecfg = tst._eval_cfg(cfg)
    so = make_spectrum_ops(ecfg, device="cpu")
    tspec = target_spectrum(torch.from_numpy(audio), so)
    frozen = torch.tensor([0.6, 0.25, 0.5, 0.9, 0.3, 0.3, 0.6, 0.6])
    block = (4, 5, 6, 7)
    start = float(evaluate(frozen[None], tspec, so, ecfg)[0])
    bv, bf = tst._block_runner(cfg, block, 64, 6)(11, frozen, frozen[list(block)], tspec)
    assert bv.shape == (4,) and float(bf) <= start
    full = tst._embed(frozen, block, bv[None])[0]
    assert torch.equal(full[:4], frozen[:4])
    assert float(evaluate(full[None], tspec, so, ecfg)[0]) == pytest.approx(float(bf), rel=1e-5)


def test_batch_width_cap():
    assert tst._batch_width_cap(1024, 8192, "cpu") == min(8, (6 << 30) // (48 * 1024 * 8192))
    assert tst._batch_width_cap(1 << 16, 8192, "cpu") == 1
    assert tst._batch_width_cap(512, 256, "cpu") == 8


# ---- the reference's end-to-end checks (tests/test_staged.py), ported ------------

def _toy_cfg(k=2):
    d = 4 * k
    return ESConfig(
        num_parents=16, num_offspring=240, num_dimensions=d, topology=f"fm{k}_parallel",
        param_mins=(0.0,) * d, param_maxs=(3520.0, 8.0, 3520.0, 1.0) * k,
        audio_length_log2=9, synthesis_engine="scanless", spectrum_method="dft",
        dft_dtype="float32",
    )


def _silence(audio, cfg):
    so = make_spectrum_ops(cfg, device="cpu")
    return float(torch.sum(target_spectrum(torch.from_numpy(audio), so).double() ** 2))


def _target_of(cfg, genes):
    g = torch.tensor([genes], dtype=torch.float32)
    scaled = scale_params(g, torch.tensor(cfg.param_mins), torch.tensor(cfg.param_maxs))[0]
    return synthesize_single(scaled, cfg.n_samples, cfg.topology, engine="scanless").numpy()


def test_pursuit_smoke_and_improves_over_silence():
    cfg = _toy_cfg(k=2)
    audio = _target_of(cfg, [0.6, 0.25, 0.5, 0.9, 0.35, 0.3, 0.7, 0.7])
    r = tst.match_parallel_pursuit(
        audio, cfg, 0, device="cpu", stage_population=256, peel_generations=10, peel_tries=1,
        tail_generations=20, tail_tries=1, alias_rounds=1, alias_generations=5,
        joint_generations=10,
    )
    assert r.best_values.shape == (8,)
    assert np.all((r.best_values >= 0) & (r.best_values <= 1))
    assert 0 <= r.best_fitness <= _silence(audio, cfg)
    assert r.stage_fitness.shape == (1,)  # k=2: no peel stages, one tail stage
    assert r.alias_fitness.shape[0] >= 1
    assert r.generations_used >= 20 + 5 + 10
    assert set(r.seconds) == {"block", "alias", "final", "score"}


def test_pursuit_rejects_non_parallel_topology():
    cfg = ESConfig(num_parents=4, num_offspring=12, num_dimensions=6, topology="fm3_series",
                   audio_length_log2=9)
    with pytest.raises(ValueError, match="fm{k}_parallel"):
        tst.match_parallel_pursuit(np.zeros(512, np.float32), cfg, device="cpu")
    with pytest.raises(ValueError, match="one frame"):
        tst.match_parallel_pursuit(np.zeros(100, np.float32), _toy_cfg(2), device="cpu")


def test_fm2_routes_as_one_pair_bank():
    cfg = ESConfig(
        num_parents=4, num_offspring=124, num_dimensions=4, topology="fm2",
        audio_length_log2=9, param_mins=(0.0,) * 4, param_maxs=(3520.0, 8.0, 3520.0, 1.0),
        synthesis_engine="scanless", refine_generations=0,
    )
    audio = _target_of(cfg, [0.62, 0.3, 0.48, 0.8])
    r = tst.match_parallel_pursuit(
        audio, cfg, 0, device="cpu", stage_population=256, tail_generations=20, tail_tries=1,
        alias_rounds=1, alias_generations=5, joint_generations=10,
    )
    assert r.best_values.shape == (4,)
    assert 0 <= r.best_fitness <= _silence(audio, cfg)
    assert r.stage_fitness.shape == (1,)  # k=1: tail only, no peel


def test_k3_runs_peel_then_tail():
    cfg = _toy_cfg(k=3)
    audio = _target_of(cfg, [0.87, 0.25, 0.86, 0.9, 0.55, 0.3, 0.62, 0.8,
                             0.71, 0.2, 0.45, 0.7])
    r = tst.match_parallel_pursuit(
        audio, cfg, 1, device="cpu", stage_population=256, peel_generations=8, peel_tries=1,
        tail_generations=8, tail_tries=2, alias_rounds=0, alias_generations=5,
        joint_generations=5,
    )
    assert r.stage_fitness.shape == (2,)  # one peel + one tail
    # elitism: the tail keeps the peel's estimate as its incumbent
    assert r.stage_fitness[1] <= r.stage_fitness[0] + 1e-6
    assert r.alias_fitness.shape == (0,)
    assert r.generations_used >= 8 + 2 * 8 + 5


def test_k4_repair_rounds_refit_pairs_of_blocks():
    """k = 4: two peels, the tail, then a repair round of the six pairs of
    pair blocks; the stage fitness never increases beyond the f32 engine's
    rescoring of the incumbent alone rather than in a population (a
    different matrix-product order on the CPU: a few float32 ulps)."""
    cfg = _toy_cfg(k=4)
    audio = _target_of(cfg, [0.87, 0.25, 0.86, 0.9, 0.55, 0.3, 0.62, 0.8,
                             0.71, 0.2, 0.45, 0.7, 0.33, 0.4, 0.28, 0.6])
    r = tst.match_parallel_pursuit(
        audio, cfg, 2, device="cpu", stage_population=128, peel_generations=3, peel_tries=1,
        tail_generations=3, tail_tries=1, repair_rounds=1, repair_generations=2,
        alias_rounds=0, joint_generations=2,
    )
    assert r.stage_fitness.shape == (3 + 6,)
    sf = np.asarray(r.stage_fitness)
    assert np.all(sf[1:] <= sf[:-1] * (1 + 1e-5))
    assert r.generations_used == 2 * 3 + 3 + 6 * 2 + 2


def test_k5_pursuit_polishes_on_b2_at_20_genes(monkeypatch):
    """k = 5 (20 genes, the family of benchmarks/pursuit_fm5_parallel.json,
    whose truth this is): three peels, the tail, a repair round over the ten
    pairs of pair blocks, then the alias and final polishes on the
    configured engine, here B2 int8 (its plain version on the CPU) at D 20.
    The stage fitness never increases beyond float32 rescoring, the result
    is better than silence, and every B2 call is fm5_parallel's."""
    from pmfm_tpu_torch.kernels import generation as tgen

    calls = []
    plain = tgen.fused_generation_plain

    def counted(*args, **kw):
        calls.append(kw["topology"])
        return plain(*args, **kw)

    monkeypatch.setattr(tgen, "fused_generation_plain", counted)
    cfg = _toy_cfg(k=5).replace(dft_dtype="int8", fused_kernel=True, fused_generation=True,
                                mutation_noise="clt12_neutral", min_step=1e-4)
    audio = _target_of(cfg, [0.87, 0.25, 0.86, 0.9, 0.55, 0.3, 0.62, 0.8, 0.71, 0.2,
                             0.45, 0.7, 0.33, 0.4, 0.28, 0.6, 0.62, 0.15, 0.93, 0.5])
    r = tst.match_parallel_pursuit(
        audio, cfg, 3, device="cpu", stage_population=128, peel_generations=3, peel_tries=1,
        tail_generations=3, tail_tries=1, repair_rounds=1, repair_generations=2,
        alias_rounds=1, alias_generations=2, joint_generations=2,
    )
    assert r.best_values.shape == (20,) and np.all((r.best_values >= 0) & (r.best_values <= 1))
    assert r.stage_fitness.shape == (4 + 10,)
    sf = np.asarray(r.stage_fitness)
    assert np.all(sf[1:] <= sf[:-1] * (1 + 1e-5))
    assert 0 <= r.best_fitness <= _silence(audio, cfg)
    assert r.alias_fitness.shape[0] == 1
    assert r.generations_used >= 3 * 3 + 3 + 10 * 2 + 2
    assert calls and set(calls) == {"fm5_parallel"}


def _series_cfg(k=4):
    d = 2 * k
    return ESConfig(
        num_parents=16, num_offspring=240, num_dimensions=d, topology=f"fm{k}_series",
        param_mins=(0.0,) * d, param_maxs=(3520.0, 8.0) * k, audio_length_log2=9,
        synthesis_engine="scanless", spectrum_method="dft", dft_dtype="float32",
        mutation_noise="clt12_neutral", min_step=1e-4, restart_patience=50,
    )


def _series_target(cfg):
    return _target_of(cfg, [0.87, 0.25, 0.86, 0.19, 0.89, 0.15, 0.85, 0.13])


def test_series_smoke_stage_structure():
    cfg = _series_cfg(k=4)
    audio = _series_target(cfg)
    r = tst.match_series_pursuit(
        audio, cfg, 0, device="cpu", stage_population=256, core_generations=10, core_tries=1,
        grow_generations=8, grow_tries=1, repair_rounds=1, repair_generations=6,
        joint_generations=10,
    )
    assert r.best_values.shape == (8,)
    assert np.all((r.best_values >= 0) & (r.best_values <= 1))
    # the f32-elitist guard makes the result monotone against silence
    assert 0 <= r.best_fitness <= _silence(audio, cfg)
    assert len(r.stage_fitness) == 5, r.stage_fitness  # 1 core + 1 grow + 3 repair windows
    sf = np.asarray(r.stage_fitness)
    assert np.all(sf[1:] <= sf[:-1] * (1 + 1e-6))
    assert r.generations_used == 10 + 8 + 3 * 6 + 10


def test_series_rejects_small_k_and_non_series():
    with pytest.raises(ValueError, match="k >= 4"):
        tst.match_series_pursuit(
            np.zeros(512, np.float32),
            ESConfig(num_parents=4, num_offspring=12, num_dimensions=6, topology="fm3_series",
                     audio_length_log2=9), device="cpu")
    with pytest.raises(ValueError, match="k >= 4"):
        tst.match_series_pursuit(
            np.zeros(512, np.float32),
            ESConfig(num_parents=4, num_offspring=12, num_dimensions=8, topology="fm2_parallel",
                     audio_length_log2=9, param_mins=(0.0,) * 8,
                     param_maxs=(3520.0, 8.0, 3520.0, 1.0) * 2), device="cpu")


def test_series_multi_start_consumes_attempts():
    """A target_rel tighter than a tiny-budget run can reach: every attempt
    consumed, the best returned."""
    cfg = _series_cfg(k=4)
    audio = _target_of(cfg, [0.5, 0.3, 0.6, 0.2, 0.7, 0.25, 0.4, 0.5])
    r = tst.match_series_pursuit(
        audio, cfg, 2, device="cpu", target_rel=1e-9, max_attempts=2, stage_population=128,
        core_generations=6, core_tries=1, grow_generations=4, grow_tries=1, repair_rounds=0,
        joint_generations=6,
    )
    assert r.attempts == 2 and r.generations_used == 2 * (6 + 4 + 6)
    assert np.isfinite(r.best_fitness)


def test_examples_route_to_their_solver():
    """The pursuit examples parse in both packages to the same solver block
    and topology family: the series homotopy for fm{k>=4}_series, the pair
    pursuit for fm{k}_parallel and fm2."""
    for name in PURSUIT:
        run = json.loads((REPO / "examples" / name).read_text())
        rc = load_config(str(REPO / "examples" / name))
        assert rc.solver == "pursuit" == run["tpu"]["solver"]
        topo = rc.es.topology
        assert topo == "fm2" or "parallel" in topo or int(topo[2]) >= 4
