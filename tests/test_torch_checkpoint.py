"""Checkpoint and resume in pmfm_tpu_torch (ROADMAP Queue A item 9) against
pmfm_tpu on the CPU: ``utils/checkpoint.py``, ``utils/chunk_store.py``,
``es/pipeline.py::evolve_checkpointed``, the resumable matchers and the
population readback.

A resumed run must be bit-equal to one that was not stopped; a stop is
simulated by a save that raises right after it has written (the state in
memory is then lost, and the rerun starts from a fresh state). The file
names and keys are held against those the reference writes for the same
call, and the fingerprint against the reference's on the repo's configs.
"""
import dataclasses
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmfm_tpu.es import ESConfig as JConfig
from pmfm_tpu.es import init_state as j_init_state
from pmfm_tpu.es import make_spectrum_ops as j_make_spectrum_ops
from pmfm_tpu.es import match_audio as j_match_audio
from pmfm_tpu.es import match_audio_stft as j_match_audio_stft
from pmfm_tpu.es import strategy as jstrategy
from pmfm_tpu.io import load_config as j_load_config
from pmfm_tpu.utils import checkpoint as jckpt
from pmfm_tpu_torch.es import (
    ESConfig,
    evolve,
    evolve_checkpointed,
    init_state,
    make_spectrum_ops,
    match_audio,
    match_audio_stft,
    pipeline,
)
from pmfm_tpu_torch.io import load_config
from pmfm_tpu_torch.ops import synthesize_single, target_spectrum
from pmfm_tpu_torch.utils import checkpoint, chunk_store

REPO = Path(__file__).resolve().parent.parent
TRUTH = (880.0, 2.0, 2500.0, 0.9)
SMALL = dict(num_parents=4, num_offspring=12, num_dimensions=4, topology="fm2",
             param_mins=(0.0,) * 4, param_maxs=(3520.0, 8.0, 3520.0, 1.0), audio_length_log2=8)
# engines of the resume tests: B2's plain version (int8), and the unfused
# f32 engine with stall-triggered restarts, which draw from the generator
ENGINES = {
    "fused_generation": dict(synthesis_engine="scanless", dft_dtype="int8", sine_order=7,
                             fused_kernel=True, fused_generation=True, pop_block=16),
    "unfused_restarts": dict(restart_patience=2),
}
STATE_FIELDS = ("parent_values", "parent_steps", "parent_fitness", "best_values",
                "best_fitness", "stall")
# Population.fitness of the unfused f32 engine against the reference's
# evaluate on the same values and target: max / median relative (the unfused
# engines' limits, tests/test_torch_unfused.py)
POP_TOL = (1e-3, 1e-6)


class Preempted(Exception):
    pass


def _preempt_after(monkeypatch, saves):
    """Make the ``saves``-th checkpoint or chunk write complete and then
    raise ``Preempted``."""
    count = [0]

    def wrap(fn):
        def save(*a, **k):
            out = fn(*a, **k)
            count[0] += 1
            if count[0] == saves:
                raise Preempted
            return out
        return save

    monkeypatch.setattr(checkpoint, "save_checkpoint", wrap(checkpoint.save_checkpoint))
    monkeypatch.setattr(chunk_store, "save_chunk", wrap(chunk_store.save_chunk))


def _target(cfg, truth=TRUTH, n=None):
    audio = synthesize_single(torch.tensor(truth), n or cfg.n_samples, cfg.topology)
    return audio.numpy()


def _tspec(cfg):
    so = make_spectrum_ops(cfg, device="cpu")
    return so, target_spectrum(torch.from_numpy(_target(cfg)), so)


def _states_equal(a, b):
    return (all(torch.equal(getattr(a, f), getattr(b, f)) for f in STATE_FIELDS)
            and a.seed == b.seed and a.generation == b.generation
            and torch.equal(a.generator.get_state(), b.generator.get_state()))


@pytest.mark.parametrize("config", ["parameters.json", "examples/params_match.json",
                                    "examples/audio_match.json"])
def test_config_fingerprint_is_the_reference(config):
    path = str(REPO / config)
    mine, ref = load_config(path).es, j_load_config(path).es
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert checkpoint.config_fingerprint(mine) == jckpt.config_fingerprint(ref)
    other = mine.replace(num_parents=mine.num_parents + 1)
    assert checkpoint.config_fingerprint(other) != jckpt.config_fingerprint(ref)


def test_state_round_trip(tmp_path):
    cfg = ESConfig(**SMALL)
    s = init_state(3, cfg, device="cpu")
    s = s._replace(generation=17, stall=torch.tensor(5, dtype=torch.int32))
    torch.rand(3, generator=s.generator)  # a generator past its seed
    checkpoint.save_checkpoint(tmp_path, s, cfg, chunk_index=3)
    s2, ci, traj = checkpoint.load_checkpoint(tmp_path, cfg, device="cpu")
    assert ci == 3 and traj is None and _states_equal(s, s2)
    assert type(s2.seed) is int and type(s2.generation) is int
    assert s2.stall.dtype == torch.int32 and s2.best_fitness.shape == ()
    # the generator goes on where it was
    assert torch.equal(torch.rand(4, generator=s.generator), torch.rand(4, generator=s2.generator))
    assert checkpoint.load_checkpoint(tmp_path, cfg.replace(num_parents=8), device="cpu") is None
    assert checkpoint.load_checkpoint(tmp_path, cfg, tag="absent", device="cpu") is None


def test_state_of_runs_round_trip(tmp_path):
    cfg = ESConfig(**SMALL)
    s = init_state([1, 2, 3], cfg, device="cpu")
    s = s._replace(generation=(4, 5, 6))
    checkpoint.save_checkpoint(tmp_path, s, cfg, chunk_index=0, tag="runs",
                               trajectory=np.arange(3 * 6, dtype=np.float32).reshape(3, 6))
    s2, _, traj = checkpoint.load_checkpoint(tmp_path, cfg, tag="runs", device="cpu")
    assert s2.seed == s.seed and s2.generation == (4, 5, 6)
    assert all(type(x) is int for x in s2.seed + s2.generation)
    assert traj.shape == (3, 6)
    for g, g2 in zip(s.generator, s2.generator):
        assert torch.equal(g.get_state(), g2.get_state())
    assert all(torch.equal(getattr(s, f), getattr(s2, f)) for f in STATE_FIELDS)


def test_reference_checkpoint_is_refused(tmp_path):
    """A checkpoint of pmfm_tpu for the same config passes the fingerprint
    check (the two fingerprints are one) but holds a PRNG key and no seed:
    it loads as None, not as a misread state."""
    jcfg, cfg = JConfig(**SMALL), ESConfig(**SMALL)
    assert jckpt.config_fingerprint(jcfg) == checkpoint.config_fingerprint(cfg)
    jckpt.save_checkpoint(tmp_path, j_init_state(jax.random.PRNGKey(0), jcfg), jcfg, 2)
    assert checkpoint.load_checkpoint(tmp_path, cfg, device="cpu") is None


def test_checkpoint_file_and_keys_are_the_reference(tmp_path):
    """``evolve_checkpointed`` writes ``gen_chunk{i}.npz`` as the reference
    does, with the reference's keys but for the state's host fields (a seed
    and the generator's state in place of the PRNG key)."""
    jcfg, cfg = JConfig(**SMALL), ESConfig(**SMALL)
    from pmfm_tpu.es.pipeline import evolve_checkpointed as j_evolve_checkpointed

    jso = j_make_spectrum_ops(jcfg)
    j_evolve_checkpointed(j_init_state(jax.random.PRNGKey(0), jcfg),
                          jnp.ones((jso.num_bins,), jnp.float32), 4, jso, jcfg,
                          str(tmp_path / "ref"), every=2, chunk_index=1, record_trajectory=True)
    so = make_spectrum_ops(cfg, device="cpu")
    evolve_checkpointed(init_state(0, cfg, device="cpu"), torch.ones(so.num_bins), 4, so, cfg,
                        tmp_path / "port", every=2, chunk_index=1, record_trajectory=True)
    assert os.listdir(tmp_path / "ref") == os.listdir(tmp_path / "port") == ["gen_chunk1.npz"]
    with np.load(tmp_path / "ref" / "gen_chunk1.npz") as zr, \
            np.load(tmp_path / "port" / "gen_chunk1.npz") as zp:
        ref_keys, port_keys = set(zr.files), set(zp.files)
        assert int(zr["chunk_index"]) == int(zp["chunk_index"]) == 1
        assert zr["fingerprint"].item() == zp["fingerprint"].item()
        assert zr["trajectory"].shape == zp["trajectory"].shape == (4,)
    assert port_keys == (ref_keys - {"state_key"}) | {"state_seed", "state_generator"}


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_evolve_checkpointed_resume_is_bit_equal(tmp_path, monkeypatch, engine):
    """Segments of 3, stopped after the second save and resumed from a
    fresh state, against one ``evolve`` (the analog of
    tests/test_es.py::TestGenerationCheckpointing); then a rerun with a
    larger count goes on, and one with the same count runs nothing."""
    cfg = ESConfig(**SMALL, **ENGINES[engine])
    so, t = _tspec(cfg)
    want, want_traj = evolve(init_state(5, cfg, device="cpu"), t, 10, so, cfg,
                             record_trajectory=True)
    if engine == "unfused_restarts":  # a restart fires inside the run: 2 stalls in a row
        same = (want_traj[1:] == want_traj[:-1]).numpy()
        assert (same[1:] & same[:-1]).any()
    with monkeypatch.context() as m:
        _preempt_after(m, 2)
        with pytest.raises(Preempted):
            evolve_checkpointed(init_state(5, cfg, device="cpu"), t, 10, so, cfg, tmp_path,
                                every=3, record_trajectory=True)
    saved = checkpoint.load_checkpoint(tmp_path, cfg, tag="gen_chunk0", device="cpu")[0]
    got, traj = evolve_checkpointed(init_state(5, cfg, device="cpu"), t, 10, so, cfg, tmp_path,
                                    every=3, record_trajectory=True)
    assert saved.generation == 6 and _states_equal(got, want)
    np.testing.assert_array_equal(traj, want_traj.numpy())
    more, traj = evolve_checkpointed(init_state(5, cfg, device="cpu"), t, 13, so, cfg, tmp_path,
                                     every=3, record_trajectory=True)
    want13, want_traj13 = evolve(want, t, 3, so, cfg, record_trajectory=True)
    assert more.generation == 13 and _states_equal(more, want13)
    np.testing.assert_array_equal(traj, np.concatenate([want_traj, want_traj13.numpy()]))
    calls = []
    monkeypatch.setattr(pipeline, "evolve", lambda *a, **k: calls.append(1))
    same, traj = evolve_checkpointed(init_state(5, cfg, device="cpu"), t, 13, so, cfg, tmp_path,
                                     every=3, record_trajectory=True)
    assert not calls and _states_equal(same, more) and traj.shape == (13,)


def test_evolve_checkpointed_b5_segments_are_one_call(tmp_path, monkeypatch):
    """Under ``fused_evolve`` each segment is one B5 call (its plain version
    here, ``_fused_evolve_ok`` opened to the CPU): seeds from the state's
    generation, stall from the trajectory, so segments of 4 equal one
    call of 10 bit for bit."""
    cfg = ESConfig(**SMALL, **ENGINES["fused_generation"]).replace(fused_evolve=True)
    so, t = _tspec(cfg)
    gate = pipeline._fused_evolve_ok
    monkeypatch.setattr(pipeline, "_fused_evolve_ok",
                        lambda c, s, dev: gate(c, s, torch.device("cuda")))
    calls = []
    mega = pipeline._evolve_mega
    monkeypatch.setattr(pipeline, "_evolve_mega", lambda *a: calls.append(a[2]) or mega(*a))
    want, want_traj = evolve(init_state(6, cfg, device="cpu"), t, 10, so, cfg,
                             record_trajectory=True)
    with monkeypatch.context() as m:
        _preempt_after(m, 1)
        with pytest.raises(Preempted):
            evolve_checkpointed(init_state(6, cfg, device="cpu"), t, 10, so, cfg, tmp_path,
                                every=4, record_trajectory=True)
    got, traj = evolve_checkpointed(init_state(6, cfg, device="cpu"), t, 10, so, cfg, tmp_path,
                                    every=4, record_trajectory=True)
    assert calls == [10, 4, 4, 2]
    assert _states_equal(got, want)
    np.testing.assert_array_equal(traj, want_traj.numpy())


def test_evolve_checkpointed_early_stop_counts_from_the_state(tmp_path):
    """Under ``fitness_threshold`` early stop ``evolve``'s count is relative
    to the input state: a segment that starts at generation 3 runs at most
    its own count, and the loop stops once the threshold is met."""
    cfg = ESConfig(**SMALL, fitness_threshold=1e30)  # met by the first generation
    so, t = _tspec(cfg)
    final, _ = evolve_checkpointed(init_state(1, cfg, device="cpu"), t, 9, so, cfg, tmp_path,
                                   every=3)
    assert final.generation == 1
    s3 = init_state(1, cfg.replace(fitness_threshold=0.0), device="cpu")._replace(generation=3)
    s, _ = evolve(s3, t, 2, so, cfg.replace(fitness_threshold=1e-30))
    assert s.generation == 5
    # over a mesh (a world of one here) the count is relative to the state too
    import torch.distributed as dist

    from pmfm_tpu_torch.parallel import make_mesh

    try:
        mesh = make_mesh((1,), device="cpu")
        final, _ = evolve_checkpointed(init_state(1, cfg, device="cpu"), t, 9, so, cfg,
                                       tmp_path / "m", every=3, mesh=mesh)
        assert final.generation == 1
    finally:
        dist.destroy_process_group()


def test_chunk_resume_is_bit_equal(tmp_path, monkeypatch):
    """``match_audio(checkpoint_dir=)`` over 4 chunks with a refine tail:
    stopped after 2 chunks (a target cut to them), then resumed on the
    whole target, against an uninterrupted run (the analog of
    tests/test_misc.py's chunk resume); the files are the reference's
    ``chunk_NNNN.npz``, with the reference's keys but ``next_key`` (the
    seeds and the refine start in its place)."""
    cfg = ESConfig(**SMALL, **ENGINES["fused_generation"]).replace(refine_generations=2)
    tgt = np.random.default_rng(1).standard_normal(4 * 256).astype(np.float32)
    want = match_audio(tgt, cfg, seed=5, num_generations=5, record_trajectory=True, device="cpu")
    part = match_audio(tgt[:512], cfg, seed=5, num_generations=5, record_trajectory=True,
                       checkpoint_dir=tmp_path, device="cpu")
    assert len(part.chunks) == 2
    with monkeypatch.context() as m:
        _preempt_after(m, 1)  # chunk 2 written, then stopped
        with pytest.raises(Preempted):
            match_audio(tgt, cfg, seed=5, num_generations=5, record_trajectory=True,
                        checkpoint_dir=tmp_path, device="cpu")
    got = match_audio(tgt, cfg, seed=5, num_generations=5, record_trajectory=True,
                      checkpoint_dir=tmp_path, device="cpu")
    assert len(got.chunks) == 4
    for a, b in zip(got.chunks, want.chunks):
        for f in a._fields:
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None and y is None) or np.array_equal(x, y), f
    np.testing.assert_array_equal(got.output_audio, want.output_audio)
    jcfg = JConfig(**SMALL)
    j_match_audio(tgt, jcfg, key=5, num_generations=2, checkpoint_dir=str(tmp_path / "ref"))
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names == [f"chunk_{i:04d}.npz" for i in range(4)]
    assert sorted(p for p in os.listdir(tmp_path) if p.endswith(".npz")) == names
    with np.load(tmp_path / "ref" / names[0]) as zr, np.load(tmp_path / names[0]) as zp:
        assert set(zp.files) == (set(zr.files) - {"next_key"}) | {
            "seed", "chunk_seed", "refine_start_fitness"}
        assert int(zp["chunk_seed"]) == pipeline._chunk_seed(5, 0) and int(zp["seed"]) == 5


def test_chunk_resume_stops_at_another_config(tmp_path):
    """A chunk of another config ends the resume there (the chunks after it
    are matched again); a rerun with another seed goes on with the stored
    run's seed, as the reference goes on with its stored key."""
    cfg = ESConfig(**SMALL)
    tgt = np.random.default_rng(2).standard_normal(3 * 256).astype(np.float32)
    want = match_audio(tgt, cfg, seed=7, num_generations=3, device="cpu")
    match_audio(tgt, cfg, seed=7, num_generations=3, checkpoint_dir=tmp_path, device="cpu")
    other = cfg.replace(num_parents=5)
    res = match_audio(tgt[:256], other, seed=7, num_generations=3, device="cpu")
    chunk_store.save_chunk(tmp_path, other, 1, res.chunks[0], res.output_audio, 7,
                           pipeline._chunk_seed(7, 1))
    start, results, _, seed = chunk_store.resume(tmp_path, cfg, 99)
    assert start == 1 and len(results) == 1 and seed == 7
    got = match_audio(tgt, cfg, seed=99, num_generations=3, checkpoint_dir=tmp_path, device="cpu")
    np.testing.assert_array_equal(got.output_audio, want.output_audio)


def test_stft_resume_is_bit_equal(tmp_path, monkeypatch):
    """``match_audio_stft(checkpoint_dir=, checkpoint_every=)`` with a refine
    tail, stopped after its tail's first save and run again, against the
    run without checkpoints, trajectory included (the analog of
    tests/test_io_utils.py::TestCLICheckpointEvery). Without a tail it
    writes what the reference writes, ``gen_chunk0.npz``."""
    cfg = ESConfig(**SMALL, **ENGINES["fused_generation"]).replace(refine_generations=4)
    tgt = np.random.default_rng(3).standard_normal(3 * 256).astype(np.float32)
    want = match_audio_stft(tgt, cfg, seed=4, num_generations=9, record_trajectory=True,
                            device="cpu")
    with monkeypatch.context() as m:
        _preempt_after(m, 3)  # the fast part's two saves, then the tail's first
        with pytest.raises(Preempted):
            match_audio_stft(tgt, cfg, seed=4, num_generations=9, record_trajectory=True,
                             checkpoint_dir=tmp_path, checkpoint_every=3, device="cpu")
    assert sorted(os.listdir(tmp_path)) == ["gen_chunk0.npz", "gen_chunk0_refine5.npz"]
    got = match_audio_stft(tgt, cfg, seed=4, num_generations=9, record_trajectory=True,
                           checkpoint_dir=tmp_path, checkpoint_every=3, device="cpu")
    a, b = got.chunks[0], want.chunks[0]
    for f in a._fields:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    np.testing.assert_array_equal(got.output_audio, want.output_audio)
    jcfg, plain = JConfig(**SMALL), ESConfig(**SMALL)
    j_match_audio_stft(tgt, jcfg, key=4, num_generations=4, checkpoint_dir=str(tmp_path / "r"),
                       checkpoint_every=2)
    match_audio_stft(tgt, plain, seed=4, num_generations=4, checkpoint_dir=tmp_path / "p",
                     checkpoint_every=2, device="cpu")
    assert os.listdir(tmp_path / "r") == os.listdir(tmp_path / "p") == ["gen_chunk0.npz"]


@pytest.mark.parametrize("engine", ["fused_generation", "xla_dft"])
def test_population_readback(engine):
    """``evolve(return_population=True)``: the last generation's offspring,
    sorted best first, its first mu rows the final parents, the evolve
    itself unchanged (the analog of tests/test_es.py's readback); under B2
    the P candidates of its launch. Its fitness lies within the unfused
    engines' limits of the reference's ``evaluate`` on the same values."""
    extra = ENGINES["fused_generation"] if engine == "fused_generation" else {}
    cfg = ESConfig(**SMALL, **extra)
    so, t = _tspec(cfg)
    final, traj, pop = evolve(init_state(11, cfg, device="cpu"), t, 4, so, cfg,
                              record_trajectory=True, return_population=True)
    p, d, mu = cfg.population_size, cfg.num_dimensions, cfg.num_parents
    assert pop.values.shape == pop.steps.shape == (p, d) and pop.fitness.shape == (p,)
    assert bool((pop.fitness[1:] >= pop.fitness[:-1]).all()) and traj.shape == (4,)
    assert torch.equal(pop.values[:mu], final.parent_values)
    assert torch.equal(pop.fitness[:mu], final.parent_fitness)
    plain, plain_traj = evolve(init_state(11, cfg, device="cpu"), t, 4, so, cfg,
                               record_trajectory=True)
    assert _states_equal(plain, final) and torch.equal(plain_traj, traj)
    if engine == "xla_dft":
        jcfg = JConfig(**SMALL)
        jso = j_make_spectrum_ops(jcfg)
        scaled_t = jnp.asarray(t.numpy())
        ref = np.asarray(jstrategy.evaluate(jnp.asarray(pop.values.numpy()), scaled_t, jso, jcfg))
        rel = np.abs(pop.fitness.numpy() - ref) / np.maximum(np.abs(ref), 1e-30)
        assert rel.max() <= POP_TOL[0] and np.median(rel) <= POP_TOL[1]
    with pytest.raises(ValueError):
        evolve(init_state(11, cfg, device="cpu"), t, 4, so, cfg.replace(fitness_threshold=1.0),
               return_population=True)
    with pytest.raises(ValueError):
        evolve(init_state(11, cfg, device="cpu"), t, 0, so, cfg, return_population=True)


def test_population_readback_refuses_b5(monkeypatch):
    cfg = ESConfig(**SMALL, **ENGINES["fused_generation"]).replace(fused_evolve=True)
    so, t = _tspec(cfg)
    monkeypatch.setattr(pipeline, "_fused_evolve_ok", lambda c, s, dev: True)
    with pytest.raises(ValueError, match="fused_evolve"):
        evolve(init_state(1, cfg, device="cpu"), t, 3, so, cfg, return_population=True)


@pytest.mark.parametrize("mode", ["chunks", "stft"])
def test_cli_resume_is_bit_equal(tmp_path, monkeypatch, mode):
    """``cli.main`` with ``--checkpoint-dir`` (chunks) or ``--mode stft
    --checkpoint-every`` on audio_match.json cut to a population of 16,
    stopped after a save and run again: the output WAV equals the run's
    without checkpoints (the analog of tests/test_io_utils.py's
    ``--checkpoint-every`` test)."""
    import json
    import shutil

    from pmfm_tpu_torch import cli
    from pmfm_tpu_torch.io import read_wav

    run = json.loads((REPO / "examples" / "audio_match.json").read_text())
    run["evolutionary"].update(numParents=4, numOffspring=12, numGenerations=6)
    run["tpu"]["refineGenerations"] = 2
    run["general"]["isBenchmarking"] = False
    path = tmp_path / "small.json"
    path.write_text(json.dumps(run))
    shutil.copytree(REPO / "input_audio", tmp_path / "input_audio")
    monkeypatch.chdir(tmp_path)
    wav = tmp_path / run["general"]["outputAudioPath"]
    base = ["-j", str(path), "--platform", "cpu", "--quiet", "--mode", mode]
    assert cli.main(base) == 0
    want, _ = read_wav(wav)
    wav.unlink()
    ckpt = base + ["--checkpoint-dir", "ck"] + (["--checkpoint-every", "3"] if mode == "stft"
                                                else [])
    with monkeypatch.context() as m:
        _preempt_after(m, 2)
        with pytest.raises(Preempted):
            cli.main(ckpt)
    assert not wav.exists()
    assert cli.main(ckpt) == 0
    got, _ = read_wav(wav)
    np.testing.assert_array_equal(got, want)
