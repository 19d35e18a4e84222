"""Population sharding (A10) in this process: pmfm_tpu_torch.parallel against
pmfm_tpu.parallel and against the port's own unsharded runs.

A world of one (``make_mesh((1,))``: a gloo world of one rank in this
process, ended after each test) runs the fused path bit for bit as
``evolve`` does: shard 0's kernel seed is the unsharded one, the merge of a
rank's sorted top mu keeps its order and the restarts draw from the same
generator. Several ranks are ``tests/test_torch_multiprocess.py``'s.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from pmfm_tpu.es import ESConfig as JConfig
from pmfm_tpu.es import strategy as jstrategy
from pmfm_tpu.ops import spectral as jspec
from pmfm_tpu.parallel import sharded as jsharded
from pmfm_tpu_torch import cli
from pmfm_tpu_torch.es import ESConfig, evolve, evolve_checkpointed, init_state
from pmfm_tpu_torch.es import make_spectrum_ops, match_audio, match_audio_stft, match_many
from pmfm_tpu_torch.ops import synthesize_single, target_spectrum
from pmfm_tpu_torch.parallel import evolve_sharded, initialize_multihost, make_mesh
from pmfm_tpu_torch.parallel import sharded
from pmfm_tpu_torch.utils import checkpoint

REPO = Path(__file__).resolve().parent.parent
UNFUSED_LIMITS = (1e-3, 1e-6)  # max / median relative, the unfused engines' (test_torch_stft.py)
TRUTH = (3078.0, 2.0, 3015.0, 1.5)
SLICE = dict(num_parents=4, num_offspring=12, num_dimensions=4, topology="fm2",
             param_mins=(0.0,) * 4, param_maxs=(3520.0, 8.0) * 2, audio_length_log2=8,
             synthesis_engine="scanless", dft_dtype="int8", sine_order=7, fused_kernel=True,
             fused_generation=True, pop_block=8)
GENS = 12


@pytest.fixture
def world1():
    """A mesh of one rank on the CPU; the world is ended after the test."""
    mesh = make_mesh((1,), device="cpu")
    yield mesh
    dist.destroy_process_group()


def _target(cfg, frames=1):
    so = make_spectrum_ops(cfg, device="cpu")
    audio = synthesize_single(torch.tensor(TRUTH), cfg.n_samples * frames, cfg.topology)
    return so, audio


def _states_equal(a, b) -> bool:
    return (a.generation == b.generation and a.seed == b.seed and all(
        torch.equal(getattr(a, f), getattr(b, f)) for f in (
            "parent_values", "parent_steps", "parent_fitness", "best_values", "best_fitness",
            "stall")))


# ---- the merge ----------------------------------------------------------------------


@pytest.mark.parametrize("shards,ties", [(1, False), (2, False), (4, False), (2, True),
                                         (4, True)])
def test_merge_matches_reference_select(shards, ties):
    """The replicated merge of the gathered shards (each a rank's sorted
    top mu) against the reference's ``select`` on the same seeded numpy
    arrays, bit for bit; with ties (fitness on a coarse grid) the lower
    index wins in both."""
    mu, d = 8, 6
    rng = np.random.default_rng(shards * 10 + ties)
    parts_v, parts_s, parts_f = [], [], []
    for _ in range(shards):
        f = rng.integers(0, 5, 32).astype(np.float32) if ties else rng.random(32, np.float32)
        order = np.argsort(f, kind="stable")[:mu]
        parts_v.append(rng.random((32, d), np.float32)[order])
        parts_s.append(rng.random((32, d), np.float32)[order])
        parts_f.append(f[order])
    v, s, f = (np.concatenate(p) for p in (parts_v, parts_s, parts_f))
    want = jstrategy.select(jnp.asarray(v), jnp.asarray(s), jnp.asarray(f), mu)
    got = sharded.merge(torch.from_numpy(v), torch.from_numpy(s), torch.from_numpy(f), mu)
    for g, w in zip(got, want):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()


# ---- a world of one -----------------------------------------------------------------


@pytest.mark.parametrize("variant", ["B2", "B2 with restarts", "run axis", "early stop"])
def test_world_of_one_bit_equal_to_evolve(world1, variant):
    """On the fused path a world of one computes ``evolve``'s run bit for
    bit: the trajectory and the whole final state (a state of 3 runs for
    the run axis; under early stop, the generation it stopped at)."""
    cfg = ESConfig(**SLICE)
    so, audio = _target(cfg)
    t = target_spectrum(audio, so)
    seed, record = 3, True
    if variant == "B2 with restarts":
        cfg = cfg.replace(restart_patience=2)
    if variant == "run axis":
        seed, t = [3, 4, 5], torch.stack([t] * 3)
    if variant == "early stop":
        _, traj = evolve(init_state(3, cfg, device="cpu"), t, GENS, so, cfg,
                         record_trajectory=True)
        cfg, record = cfg.replace(fitness_threshold=float(traj[4])), False
    a, ta = evolve(init_state(seed, cfg, device="cpu"), t, GENS, so, cfg, record)
    b, tb = evolve_sharded(init_state(seed, cfg, device="cpu"), t, GENS, so, cfg, world1, record)
    assert _states_equal(a, b)
    if record:
        assert torch.equal(ta, tb)
    else:
        assert a.generation == b.generation <= 5


@pytest.mark.parametrize("matcher", ["match_audio", "match_audio_stft", "match_many"])
def test_matchers_take_a_mesh(world1, matcher):
    """``match_audio`` (with the refine tail), ``match_audio_stft`` (two
    frames) and ``match_many`` (two targets: the run axis kept, each run's
    population sharded) over a world of one give what they give without a
    mesh, bit for bit."""
    cfg = ESConfig(**SLICE, refine_generations=2)
    so, audio = _target(cfg, frames=2)
    target = audio.numpy()

    def run(**k):
        if matcher == "match_many":
            return match_many(np.stack([target, target[::-1].copy()]), cfg, seed=5,
                              num_generations=6, device="cpu", **k)
        fn = match_audio if matcher == "match_audio" else match_audio_stft
        return [fn(target, cfg, seed=5, num_generations=6, record_trajectory=True, device="cpu",
                   **k)]

    for a, b in zip(run(), run(mesh=world1)):
        assert a.output_audio.tobytes() == b.output_audio.tobytes()
        for ca, cb in zip(a.chunks, b.chunks):
            assert ca.best_fitness == cb.best_fitness and ca.generations_run == cb.generations_run
            assert ca.best_params_norm.tobytes() == cb.best_params_norm.tobytes()
            assert ca.refine_start_fitness == cb.refine_start_fitness
            if ca.trajectory is not None:
                assert ca.trajectory.tobytes() == cb.trajectory.tobytes()


def test_checkpointed_resume_under_a_mesh(world1, tmp_path, monkeypatch):
    """``evolve_checkpointed(mesh=)`` stopped right after its second save
    (of every 3 generations, restarts every 2 stalls) and rerun resumes
    from it to the same state and trajectory as one ``evolve_sharded``."""
    cfg = ESConfig(**SLICE, restart_patience=2)
    so, audio = _target(cfg)
    t = target_spectrum(audio, so)
    want, want_traj = evolve_sharded(init_state(2, cfg, device="cpu"), t, 9, so, cfg, world1,
                                     record_trajectory=True)
    saves, save = [0], checkpoint.save_checkpoint

    def stop_after_two(*a, **k):
        save(*a, **k)
        saves[0] += 1
        if saves[0] == 2:
            raise KeyboardInterrupt("stopped")

    monkeypatch.setattr(checkpoint, "save_checkpoint", stop_after_two)
    with pytest.raises(KeyboardInterrupt):
        evolve_checkpointed(init_state(2, cfg, device="cpu"), t, 9, so, cfg, tmp_path, every=3,
                            mesh=world1, record_trajectory=True)
    monkeypatch.setattr(checkpoint, "save_checkpoint", save)
    got, traj = evolve_checkpointed(init_state(2, cfg, device="cpu"), t, 9, so, cfg, tmp_path,
                                    every=3, mesh=world1, record_trajectory=True)
    assert saves[0] == 2 and _states_equal(got, want)
    np.testing.assert_array_equal(traj, want_traj.numpy())


# ---- the ValueErrors ----------------------------------------------------------------


@pytest.mark.parametrize("case", ["population not divisible", "local population below mu",
                                  "frames not divisible"])
def test_sharding_raises_where_the_reference_does(case):
    """``_local_cfg`` and the frame axis refuse what the reference's
    ``sharded.py`` refuses, on the same settings (its messages)."""
    kw = dict(num_parents=8, num_offspring=56, num_dimensions=4, topology="fm2",
              param_mins=(0.0,) * 4, param_maxs=(3520.0, 8.0) * 2, audio_length_log2=8)
    if case == "population not divisible":
        kw["num_offspring"], shards, match = 53, 8, "not divisible by mesh size"
    elif case == "local population below mu":
        kw.update(num_parents=16, num_offspring=16)
        shards, match = 8, "smaller than num_parents"
    else:
        kw["num_frames"], shards, match = 3, 2, "num_frames 3 not divisible"
    tc, jc = ESConfig(**kw), JConfig(**kw)
    if case == "frames not divisible":
        with pytest.raises(ValueError, match=match):
            sharded._frames_local(tc, shards)
        return
    with pytest.raises(ValueError, match=match):
        sharded._local_cfg(tc, shards)
    with pytest.raises(ValueError, match=match):
        jsharded._local_cfg(jc, shards)


def test_make_mesh_needs_enough_ranks():
    """A mesh larger than the world raises ``ValueError`` (the reference's
    ``make_mesh(shape=(1024,))``), before any world is started; the CLI's
    ``--mesh 2`` in a world of one raises it too."""
    with pytest.raises(ValueError, match="needs 1024 ranks, the world has 1"):
        make_mesh((1024,))
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match=r"mesh shape \(2,\) needs 2 ranks"):
        cli.main(["-j", str(REPO / "parameters.json"), "--platform", "cpu", "--generations",
                  "1", "--mesh", "2", "--quiet"])
    assert not dist.is_initialized()


def test_initialize_multihost_without_a_launcher_does_nothing(monkeypatch):
    """Without ``torch.distributed.run``'s environment and with no mesh of
    one asked for, nothing starts (the reference's no-op without a
    coordinator); a mesh of one starts a world of one on gloo."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_multihost(device="cpu") is False and not dist.is_initialized()
    assert initialize_multihost(mesh_size=2, device="cpu") is False
    try:
        assert initialize_multihost(mesh_size=1, device="cpu") is True
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        assert initialize_multihost(mesh_size=1, device="cpu") is False  # started already
    finally:
        dist.destroy_process_group()


def test_mesh_defaults_to_the_card(monkeypatch):
    """Without a ``device`` the mesh and the world are on this rank's card,
    and without one they raise as ``resolve_device`` does, before any world
    is started."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: make_mesh((1,)), lambda: initialize_multihost(mesh_size=1)):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            call()
        assert not dist.is_initialized()


@pytest.mark.parametrize("device,error", [("cuda", RuntimeError), ("meta", ValueError)])
@pytest.mark.parametrize("matcher", ["match_audio", "match_audio_stft", "match_many"])
def test_matchers_refuse_a_device_that_is_not_the_mesh_s(world1, monkeypatch, matcher,
                                                         device, error):
    """A matcher over a mesh runs on the mesh's device: the default card
    without one raises (``resolve_device``), and another device than the
    mesh's raises ``ValueError``; neither falls back to the mesh's CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ESConfig(**SLICE)
    _, audio = _target(cfg)
    target = audio.numpy()
    fn = dict(match_audio=match_audio, match_audio_stft=match_audio_stft,
              match_many=lambda t, *a, **k: match_many(t[None], *a, **k))[matcher]
    with pytest.raises(error, match="is_available" if error is RuntimeError
                       else "is not the mesh's device cpu"):
        fn(target, cfg, seed=0, num_generations=1, mesh=world1, device=device)


# ---- the frame axis -----------------------------------------------------------------


@pytest.mark.parametrize("frames,shards", [(4, 2), (4, 4), (6, 3)])
def test_frame_windows_sum_to_reference_multiframe_fitness(frames, shards):
    """The frame windows' fitness (each rank's ``_evaluate_frames_local``),
    summed as the frame all-reduce sums them, against the reference's
    unsharded multi-frame ``evaluate`` (``xla_stft``) on the same values,
    within the unfused engines' limits."""
    kw = dict(num_parents=8, num_offspring=56, num_dimensions=4, topology="fm2",
              param_mins=(0.0,) * 4, param_maxs=(2000.0, 2.0, 2000.0, 1.0), audio_length_log2=8,
              synthesis_engine="scanless", spectrum_method="dft", dft_dtype="float32",
              num_frames=frames)
    tc, jc = ESConfig(**kw), JConfig(**kw)
    tso = make_spectrum_ops(tc, device="cpu")
    jso = jspec.make_spectrum_ops(tc.n_samples, dft_dtype=jnp.float32)
    rng = np.random.default_rng(frames * 7 + shards)
    values = rng.random((64, 4)).astype(np.float32)
    target = (rng.random((frames, tc.n_samples // 2)) * 5.0).astype(np.float32)
    want = np.asarray(jstrategy.evaluate(jnp.asarray(values), jnp.asarray(target), jso, jc))
    local = frames // shards
    got = sum(sharded._evaluate_frames_local(torch.from_numpy(values), torch.from_numpy(target),
                                             tso, tc, local, i) for i in range(shards)).numpy()
    assert got.shape == want.shape == (64,) and np.isfinite(got).all()
    e = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    assert e.max() <= UNFUSED_LIMITS[0] and np.median(e) <= UNFUSED_LIMITS[1], (e.max(),
                                                                               np.median(e))
