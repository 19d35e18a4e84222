"""Chunked matching, configuration and WAV I/O of the port against the
reference, on the CPU.

``match_audio`` runs the large-frame route at n = 4096 (B3 synth_fold, in
its plain version here; the reference's Pallas kernel in interpret mode),
and at n = 1024 the fused kernels with the true-f32 refine tail.
The two packages draw from different generators (ROADMAP Queue C), so the
runs are compared by outcome, as tests/test_torch_es.py compares ``evolve``:
over four seeds, the median best fitness of the port must lie within a
factor of 4 of the reference's.
"""
import dataclasses
import glob
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmfm_tpu.es import ESConfig as JConfig
from pmfm_tpu.es.pipeline import match_audio as j_match_audio
from pmfm_tpu.io import config as jconfig
from pmfm_tpu.io import wav as jwav
from pmfm_tpu.ops import synthesize as j_synthesize
from pmfm_tpu_torch.es import ESConfig, match_audio
from pmfm_tpu_torch.es import pipeline as tpipeline
from pmfm_tpu_torch.io import config as tconfig
from pmfm_tpu_torch.io import wav as twav

REPO = Path(__file__).resolve().parent.parent
MATCH_FACTOR = 4.0
SEEDS = range(4)
GENS = 6
SLICE = dict(num_parents=8, num_offspring=120, num_dimensions=4, topology="fm2",
             param_mins=(0.0,) * 4, param_maxs=(3520.0, 8.0) * 2, audio_length_log2=12,
             synthesis_engine="scanless", dft_dtype="int8", sine_order=7, fused_kernel=True,
             fused_generation=True, pop_block=128)
CHUNK_PARAMS = [(3078.0, 2.0, 3015.0, 1.5), (1000.0, 1.0, 2000.0, 1.0)]


def _target():
    """Two 4096-sample chunks, each a known fm2 tone, plus a ragged tail."""
    audio = np.asarray(j_synthesize(jnp.asarray(CHUNK_PARAMS, jnp.float32), 4096, "fm2",
                                    engine="scanless"))
    return np.concatenate([audio.T.reshape(-1), np.zeros(100, np.float32)])


def test_match_audio_matches_reference_outcome():
    target = _target()
    jc, tc = JConfig(**SLICE), ESConfig(**SLICE)
    ref = [j_match_audio(target, jc, key=s, num_generations=GENS) for s in SEEDS]
    got = [match_audio(target, tc, seed=s, num_generations=GENS, device="cpu") for s in SEEDS]
    for r in got:
        assert len(r.chunks) == 2 and r.output_audio.shape == (8192,)
        assert np.isfinite(r.output_audio).all()
        for c in r.chunks:
            assert c.generations_run == GENS and np.isfinite(c.best_fitness)
            assert c.best_params_scaled.shape == (4,) and c.refine_start_fitness is None
    assert all(len(r.chunks) == 2 and r.output_audio.shape == (8192,) for r in ref)
    for i in range(2):
        ref_med = np.median([r.chunks[i].best_fitness for r in ref])
        got_med = np.median([r.chunks[i].best_fitness for r in got])
        assert ref_med / MATCH_FACTOR <= got_med <= ref_med * MATCH_FACTOR, (i, got_med, ref_med)


def test_match_audio_refine_tail():
    """The refine tail at n = 4096 runs B3's bf16 mode against the f32
    spectrum; best-ever never rises within it."""
    target = _target()
    cfg = ESConfig(**SLICE).replace(refine_generations=3)
    res = match_audio(target, cfg, seed=1, num_generations=GENS, record_trajectory=True,
                      device="cpu")
    for c in res.chunks:
        assert c.trajectory.shape == (GENS,)
        tail = c.trajectory[GENS - 3 :]
        assert np.all(np.diff(tail) <= 0)
        assert c.best_fitness <= c.refine_start_fitness
        assert c.best_fitness == tail[-1]


def _target_1024():
    """Two 1024-sample chunks, each a known fm2 tone."""
    audio = np.asarray(j_synthesize(jnp.asarray(CHUNK_PARAMS, jnp.float32), 1024, "fm2",
                                    engine="scanless"))
    return audio.T.reshape(-1)


def test_match_audio_refine_tail_at_small_frames_matches_reference():
    """n = 1024: the refine tail runs the true-f32 fused kernels (B2 f32, and
    B1 f32 for the boundary rescore). Outcome against the reference's
    match_audio over four seeds as above; within the port's tail best-ever
    never rises and ends no worse than its start."""
    target = _target_1024()
    small = {**SLICE, "audio_length_log2": 10, "num_offspring": 56, "pop_block": 64,
             "refine_generations": 3}
    jc, tc = JConfig(**small), ESConfig(**small)
    assert tpipeline.active_engine(tc.refine_config(), tpipeline.make_spectrum_ops(
        tc.refine_config(), device="cpu")) == "fused_generation"
    ref = [j_match_audio(target, jc, key=s, num_generations=GENS) for s in SEEDS]
    got = [match_audio(target, tc, seed=s, num_generations=GENS, record_trajectory=True,
                       device="cpu") for s in SEEDS]
    for r in got:
        assert len(r.chunks) == 2 and r.output_audio.shape == (2048,)
        for c in r.chunks:
            tail = c.trajectory[GENS - 3 :]
            assert np.all(np.diff(tail) <= 0) and c.best_fitness == tail[-1]
            assert c.best_fitness <= c.refine_start_fitness
    for i in range(2):
        ref_med = np.median([r.chunks[i].best_fitness for r in ref])
        got_med = np.median([r.chunks[i].best_fitness for r in got])
        assert ref_med / MATCH_FACTOR <= got_med <= ref_med * MATCH_FACTOR, (i, got_med, ref_med)


@pytest.mark.parametrize("name", ["params_match.json", "audio_match.json"])
def test_shipped_configs_route_to_the_fused_kernels(name):
    """Both configs run as written: the main engine and the refine tail's
    (true f32 at n <= 2048) are ported fused engines."""
    cfg = tconfig.load_config(REPO / "examples" / name).es
    assert cfg.refine_generations == 100
    for c in (cfg, cfg.refine_config()):
        so = tpipeline.make_spectrum_ops(c, device="cpu")
        assert tpipeline.active_engine(c, so) == "fused_generation"
    assert tpipeline.make_spectrum_ops(cfg.refine_config(), device="cpu").dft_packed.dtype == \
        torch.float32


# each config's (main, refine tail) engine; a tail of length 0 reruns the main one
ENGINES = {
    "audio_match.json": ("fused_generation", "fused_generation"),
    "early_stop_match.json": ("fused_generation", "fused_generation"),
    "fm3_parallel_match.json": ("fused_generation", "fused_generation"),
    "fm4_parallel_match.json": ("fused_generation", "fused_generation"),
    "fm4_series_match.json": ("fused_generation", "fused_generation"),
    "fm5_series_match.json": ("fused_generation", "fused_generation"),
    "huge_frame_match.json": ("synth_stream", "synth_stream"),
    "params_match.json": ("fused_generation", "fused_generation"),
}


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_example_configs_keep_their_engines(name):
    """The router picks the same engine for every shipped example's main and
    refine config whatever the fused kernels' design (the int8 block size,
    the f32 kernels' scratch and grid)."""
    cfg = tconfig.load_config(REPO / "examples" / name).es
    for c, want in zip((cfg, cfg.refine_config()), ENGINES[name]):
        assert tpipeline.active_engine(c, tpipeline.make_spectrum_ops(c, device="cpu")) == want
    assert sorted(ENGINES) == sorted(Path(f).name for f in glob.glob(str(REPO / "examples/*.json")))


def test_default_parameters_engine_not_ported():
    """parameters.json (no tpu block) asks for the unfused engine, not ported."""
    cfg = tconfig.load_config(REPO / "parameters.json").es
    for c in (cfg, cfg.refine_config()):
        with pytest.raises(NotImplementedError):
            tpipeline.active_engine(c, tpipeline.make_spectrum_ops(c, device="cpu"))


def test_match_audio_rejects_short_target():
    with pytest.raises(ValueError, match="shorter than one chunk"):
        match_audio(np.zeros(100, np.float32), ESConfig(**SLICE), device="cpu")


@pytest.mark.parametrize("path", sorted(glob.glob(str(REPO / "examples" / "*.json"))),
                         ids=lambda p: Path(p).name)
def test_parse_config_matches_reference(path):
    want = jconfig.load_config(path)
    got = tconfig.load_config(path)
    assert dataclasses.asdict(got.es) == dataclasses.asdict(want.es)
    for f in dataclasses.fields(want):
        if f.name != "es":
            assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_read_wav_matches_reference(tmp_path):
    path = REPO / "input_audio" / "input.wav"
    want, sr_want = jwav.read_wav(path)
    got, sr = twav.read_wav(path)
    assert sr == sr_want == 44100 and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    audio, _ = twav.read_audio(path)
    np.testing.assert_array_equal(audio, want)
    for depth in (16, 24, 32, 0):
        out = tmp_path / f"x{depth}.wav"
        twav.write_wav(out, want[:1000], sr, bit_depth=depth)
        back, sr_back = jwav.read_wav(out)
        assert sr_back == sr and np.abs(back - want[:1000]).max() <= 2.0 ** -14


def test_match_audio_output_is_a_tensor_free_result():
    """The results are numpy and plain floats, so a caller needs no device."""
    res = match_audio(_target()[:4096], ESConfig(**SLICE), seed=0, num_generations=2,
                      device="cpu")
    c = res.chunks[0]
    assert isinstance(c.best_fitness, float) and isinstance(c.best_params_norm, np.ndarray)
    assert res.best_chunk is c and not isinstance(res.output_audio, torch.Tensor)
