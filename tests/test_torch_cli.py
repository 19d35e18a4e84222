"""pmfm_tpu_torch's CLI and what its main path imports, on the CPU: the
models, ``resample``, the Benchmarker's CSV, the per-stage rows, the debug
NaN checks and the profiler trace, each against pmfm_tpu where the reference
has a counterpart; then ``cli.main`` on parameters.json and every example
config: the evolve examples at a small population, the pursuit examples
through the staged solver with a small population and short stages, and
the modes not ported yet.
"""
import dataclasses
import glob
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from pmfm_tpu.io import wav as jwav
from pmfm_tpu.models import fm as jfm
from pmfm_tpu.utils import benchmarker as jbench
from pmfm_tpu.utils import stage_bench as jstage
import pmfm_tpu_torch.io
from pmfm_tpu_torch import cli
from pmfm_tpu_torch.es import ESConfig, generation_step, init_state, make_spectrum_ops, staged
from pmfm_tpu_torch.io import wav as twav
from pmfm_tpu_torch.models import fm as tfm
from pmfm_tpu_torch.ops.synthesis import series_ops
from pmfm_tpu_torch.utils import benchmarker as tbench
from pmfm_tpu_torch.utils import debug, profiling, stage_bench

REPO = Path(__file__).resolve().parent.parent
# the examples, all of which the port runs through the CLI: the direct ES,
# and the staged solver (tpu.solver "pursuit")
EVOLVE = ("params_match.json", "audio_match.json", "early_stop_match.json")
PURSUIT = ("fm3_parallel_match.json", "fm4_parallel_match.json", "fm4_series_match.json",
           "fm5_series_match.json", "huge_frame_match.json")
RUNNABLE = EVOLVE + PURSUIT
CSV_ROWS = ["recombinePopulation", "mutatePopulation", "synthesisePopulationDoubleSeries",
            "applyWindowPopulation", "openCLFFT", "fitnessPopulation", "sortPopulation"]


@pytest.mark.parametrize("name", ["fm2", "fm3_series", "fm3_parallel", "fm4_series",
                                  "fm7_series", "fm5_parallel"])
def test_topologies_match_reference(name):
    want, got = jfm.get_topology(name), tfm.get_topology(name)
    for field in ("name", "num_dimensions", "param_names", "default_param_maxs", "description",
                  "default_param_mins"):
        assert getattr(got, field) == getattr(want, field), field
    p = torch.from_numpy((np.random.default_rng(1).random((2, got.num_dimensions))
                          * np.asarray(got.default_param_maxs) * 0.3).astype(np.float32))
    assert got.synthesize(p, 64).shape == (64, 2)
    with pytest.raises(ValueError):
        tfm.get_topology("fm1_series")


@pytest.mark.parametrize("sr_from,sr_to", [(48000, 44100), (22050, 44100), (44100, 44100),
                                           (44100, 16000)])
def test_resample_matches_reference(sr_from, sr_to):
    x = np.random.default_rng(sr_from).standard_normal(3000).astype(np.float32)
    np.testing.assert_array_equal(twav.resample(x, sr_from, sr_to), jwav.resample(x, sr_from, sr_to))


def test_benchmarker_csv_matches_reference(tmp_path):
    """The same timer feed gives the reference's file name and a CSV equal
    byte for byte: the 7 columns of the original schema, then Population and
    Generations."""
    name = tbench.Benchmarker.log_filename("gpu", 32, 1000, 2048)
    assert name == jbench.Benchmarker.log_filename("gpu", 32, 1000, 2048)
    assert name == "gpulog(pop=32gens=1000audioBlockSize=2048).csv"
    assert tbench.CSV_FIELDS == jbench.CSV_FIELDS and len(tbench.CSV_FIELDS) == 9
    paths = []
    for mod, sub in ((tbench, "port"), (jbench, "ref")):
        path = tmp_path / sub / name
        bm = mod.Benchmarker(csv_path=str(path), quiet=True, population=32, generations=1000)
        for ms in (1.5, 2.25, 1.75):
            bm.add_timer("openCLFFT", ms)
        bm.set_workload("chunk", population=64, generations=7)
        bm.add_timer("chunk", 10.0)
        bm.elapsed_timer("openCLFFT")
        bm.elapsed_timer("chunk")
        bm.elapsed_timer("rotatePopulation")
        bm.close()
        paths.append(path)
    assert paths[0].read_text() == paths[1].read_text()


@pytest.mark.parametrize("topology", ["fm2", "fm3_series", "fm3_parallel", "fm5_series"])
def test_stage_names_match_reference(topology):
    assert stage_bench.synthesis_stage_name(topology) == jstage.synthesis_stage_name(topology)


def test_record_stage_rows_writes_every_stage(tmp_path):
    cfg = ESConfig(num_parents=4, num_offspring=12, audio_length_log2=8)
    path = tmp_path / "stages.csv"
    bm = tbench.Benchmarker(csv_path=str(path), quiet=True)
    stage_bench.record_stage_rows(bm, cfg, device="cpu")
    bm.close()
    rows = [ln.split(",") for ln in path.read_text().splitlines()]
    assert [r[0] for r in rows[1:]] == CSV_ROWS + ["rotatePopulation"]
    assert all(float(r[1]) > 0.0 for r in rows[1:-1])


def test_debug_nans_checks_the_generation():
    """Inside debug_nans(True) a NaN fitness raises; outside it the
    generation runs and nothing is checked."""
    cfg = ESConfig(num_parents=4, num_offspring=12, num_dimensions=4, topology="fm2",
                   param_mins=(0.0,) * 4, param_maxs=(3520.0, 8.0, 3520.0, 1.0),
                   audio_length_log2=8, synthesis_engine="scanless")
    so = make_spectrum_ops(cfg, device="cpu")
    state = init_state(0, cfg, device="cpu")
    nan_target = torch.full((so.num_bins,), float("nan"))
    assert not debug.enabled()
    generation_step(state, nan_target, so, cfg)
    with debug.debug_nans(True):
        assert debug.enabled()
        with pytest.raises(FloatingPointError, match="fitness"):
            generation_step(state, nan_target, so, cfg)
        generation_step(state, torch.zeros(so.num_bins), so, cfg)
    assert not debug.enabled()


def test_profiler_trace(tmp_path):
    with profiling.maybe_trace(None):
        pass
    with profiling.maybe_trace(tmp_path / "trace"):
        torch.ones(8).sum()
    assert json.loads((tmp_path / "trace" / "trace.json").read_text())


def _run_cli(monkeypatch, tmp_path, config, *extra):
    """cli.main in a fresh directory holding input_audio/, as a user runs it
    from the root of a checkout."""
    monkeypatch.chdir(tmp_path)
    shutil.copytree(REPO / "input_audio", tmp_path / "input_audio", dirs_exist_ok=True)
    return cli.main(["-j", str(REPO / config), "--platform", "cpu", *extra])


def _check_outputs(tmp_path, config, pop, gens, n, out):
    run = json.loads((REPO / config).read_text())
    wav = tmp_path / run["general"]["outputAudioPath"]
    audio, sr = twav.read_wav(wav)
    assert sr == 44100 and len(audio) >= n and np.isfinite(audio).all()
    csv = tmp_path / f"gpulog(pop={pop}gens={gens}audioBlockSize={n}).csv"
    rows = [ln.split(",") for ln in csv.read_text().splitlines()]
    assert rows[0] == list(tbench.CSV_FIELDS)
    names = [r[0] for r in rows[1:]]
    assert names[-2:] == ["chunk", "Total Audio Analysis Time"] and "openCLFFT" in names
    assert all(len(r) == len(tbench.CSV_FIELDS) for r in rows)
    assert "Overall best parameters found" in out


def test_cli_parameters_json(monkeypatch, tmp_path, capsys):
    """The reference's default config, as written but 2 generations: the
    unfused xla_dft engine on the scan synthesis, the known-params target
    written to inputGenerated.wav, best parameters by name."""
    assert _run_cli(monkeypatch, tmp_path, "parameters.json", "--generations", "2") == 0
    out = capsys.readouterr().out
    assert "engine: xla_dft on cpu" in out
    assert "freq1=" in out and "index3=" in out
    assert (tmp_path / "inputGenerated.wav").exists()
    _check_outputs(tmp_path, "parameters.json", 32, 2, 2048, out)


@pytest.mark.parametrize("config", EVOLVE)
def test_cli_example_configs(monkeypatch, tmp_path, capsys, config):
    """Every evolve example, at a population of 64 and 3 generations (the
    refine tail takes what remains)."""
    rc = _run_cli(monkeypatch, tmp_path, f"examples/{config}", "--parents", "8", "--offspring",
                  "56", "--generations", "3")
    assert rc == 0
    out = capsys.readouterr().out
    assert "engine: fused_generation" in out
    n = 1 << json.loads((REPO / "examples" / config).read_text())["audio"]["audioLengthLog2"]
    _check_outputs(tmp_path, f"examples/{config}", 64, 3, n, out)


def test_every_example_is_covered():
    names = sorted(Path(p).name for p in glob.glob(str(REPO / "examples" / "*.json")))
    assert names == sorted(RUNNABLE)


def _small_pursuit(load):
    """``load_config`` with the pursuit cut for the CPU: 16 candidates, a
    stage population of 64, one generation a stage, one attempt and one
    alias round, a one-generation refine tail; n, D and the topology as
    written."""
    def wrapped(path):
        rc = load(path)
        es = rc.es.replace(num_parents=4, num_offspring=12,
                           refine_generations=min(rc.es.refine_generations, 1))
        series = (series_ops(es.topology) or 0) >= 4
        keys = staged.SERIES_CONFIG_KEY_MAP if series else staged.CONFIG_KEY_MAP
        p = dict(rc.pursuit, stagePopulation=64, maxAttempts=1)
        p.update({k: 1 for k in keys if k.endswith("Generations")})
        if not series:
            p["aliasRounds"] = 1
        return dataclasses.replace(rc, es=es, pursuit=tuple(sorted(p.items())))
    return wrapped


@pytest.mark.parametrize("config", PURSUIT)
def test_cli_pursuit_configs_name_their_item(monkeypatch, tmp_path, capsys, config):
    """Each pursuit example through ``cli.main`` on the CPU (``_small_pursuit``):
    exit 0, the solver's line for each chunk, the WAV and the CSV."""
    monkeypatch.setattr(pmfm_tpu_torch.io, "load_config",
                        _small_pursuit(pmfm_tpu_torch.io.load_config))
    assert _run_cli(monkeypatch, tmp_path, f"examples/{config}") == 0
    out = capsys.readouterr().out
    run = json.loads((REPO / "examples" / config).read_text())
    n = 1 << run["audio"]["audioLengthLog2"]
    assert "pursuit solver" in out and "pursuit chunk 0: attempts 1" in out
    assert out.count("pursuit chunk ") == max(2048, n) // n
    audio, sr = twav.read_wav(tmp_path / run["general"]["outputAudioPath"])
    assert sr == 44100 and len(audio) == max(2048, n) and np.isfinite(audio).all()
    gens = run["evolutionary"]["numGenerations"]
    csv = tmp_path / f"gpulog(pop=16gens={gens}audioBlockSize={n}).csv"
    rows = [ln.split(",") for ln in csv.read_text().splitlines()]
    assert rows[0] == list(tbench.CSV_FIELDS) and rows[-1][0] == "Total Audio Analysis Time"
    assert "Overall best parameters found" in out


def test_cli_pursuit_mode_needs_a_pursuit_topology(monkeypatch, tmp_path):
    """``--mode pursuit`` on parameters.json's fm3_series: neither solver
    takes it (the series one needs k >= 4), as in the reference."""
    with pytest.raises(ValueError, match=r"fm\{k\}_parallel \(or fm2\)"):
        _run_cli(monkeypatch, tmp_path, "parameters.json", "--mode", "pursuit")


@pytest.mark.parametrize("flags,item", [
    (["--batch", "a.wav"], "item 6"), (["--mode", "stft"], "item 6"),
    (["--mode", "parallel-chunks"], "item 6"),
    (["--export-aot", "m.bin"], "item 9"), (["--aot", "m.bin"], "item 9"),
    (["--checkpoint-dir", "ck"], "item 9"), (["--mesh", "1"], "item 10"),
])
def test_cli_modes_not_ported_name_their_item(monkeypatch, tmp_path, capsys, flags, item):
    """The modes of ROADMAP items 6, 9 and 10, each ported, run on
    parameters.json (a 2048-sample target: one chunk of 2048; ``a.wav`` its
    generated target, ``m.bin`` an artifact exported first): item 6's (A6:
    ``--batch``, ``--mode stft``, ``--mode parallel-chunks``), item 9's (A9:
    ``--export-aot``, ``--aot``, ``--checkpoint-dir``) and item 10's (A10:
    ``--mesh``, a world of one here; ``tests/test_torch_mesh.py`` has a
    larger mesh raise in it)."""
    if flags[0] == "--batch":
        assert _run_cli(monkeypatch, tmp_path, "parameters.json", "--generations", "2") == 0
        shutil.copy(tmp_path / "inputGenerated.wav", tmp_path / "a.wav")
    if flags[0] == "--aot":
        assert _run_cli(monkeypatch, tmp_path, "parameters.json", "--generations", "2",
                        "--export-aot", "m.bin") == 0
    assert _run_cli(monkeypatch, tmp_path, "parameters.json", "--generations", "2", *flags) == 0
    out = capsys.readouterr().out
    if flags[0] == "--export-aot":
        assert "exported AOT matcher" in out and (tmp_path / "m.bin").exists()
        return
    assert ("a.wav: fitness = " if flags[0] == "--batch" else "chunk 0: fitness = ") in out
    if flags[0] == "--checkpoint-dir":
        assert (tmp_path / "ck" / "chunk_0000.npz").exists()


def test_cli_usage_errors(monkeypatch, tmp_path, capsys):
    monkeypatch.chdir(tmp_path)
    assert cli.main(["-j", "missing.json", "--platform", "cpu"]) == 2
    assert cli.main(["-j", str(REPO / "parameters.json"), "--platform", "tpu"]) == 2
    assert cli.main(["--list-devices"]) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["pmfm", "-j", str(REPO / "parameters.json")])
    assert cli.run() == 1  # the default device is the card
    assert "cuda" in capsys.readouterr().err
