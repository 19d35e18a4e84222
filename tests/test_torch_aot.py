"""AOT artifacts of pmfm_tpu_torch (``utils/aot.py``, ROADMAP Queue A item 9)
and the CLI's ``--export-aot``/``--aot``, on the CPU, against pmfm_tpu's
``utils/aot.py`` (the header's config) and the port's live matcher (the
analogs of tests/test_aot.py).

A ``cpu`` artifact carries no library; a ``cuda`` one carries the built
kernel library. Here, without nvcc, a ``cuda`` artifact is made from a
stand-in library file (``_build.build`` replaced), which is enough to
check what ``load_matcher`` checks and where it places the library; that
the library then runs is checked on the card (chip_smoke.py phase 36,
tests/test_torch_gpu.py).
"""
import json
import shutil
import struct
from pathlib import Path

import numpy as np
import pytest

from pmfm_tpu.es import ESConfig as JConfig
from pmfm_tpu.utils import aot as jaot
from pmfm_tpu_torch import cli
from pmfm_tpu_torch.es import ESConfig, match_audio_stft
from pmfm_tpu_torch.io import read_wav
from pmfm_tpu_torch.kernels import _build
from pmfm_tpu_torch.utils import aot

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(num_parents=8, num_offspring=24, audio_length_log2=8)
CFG = ESConfig(**SMALL)


def _target(n=512, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


@pytest.fixture
def fake_cuda_build(tmp_path, monkeypatch):
    """A build directory of its own and a ``_build.build`` that returns a
    stand-in library file instead of running nvcc."""
    lib = tmp_path / "built.so"
    lib.write_bytes(b"\x7fELF stand-in library " * 64)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "build", lambda: {"path": str(lib), "seconds": 0.0, "log": "",
                                                  "built": True})
    return lib


def _header(blob: bytes) -> dict:
    (n,) = struct.unpack_from("<I", blob, 8)
    return json.loads(blob[12 : 12 + n].decode())


def test_header_config_is_the_reference():
    blob = aot.export_matcher(CFG, num_generations=5, target_samples=512, platforms=("cpu",))
    header = _header(blob)
    want = jaot.config_to_dict(JConfig(**SMALL).replace(num_frames=2))
    assert header["config"] == json.loads(json.dumps(want))
    assert header["num_generations"] == 5 and header["target_samples"] == 512
    assert header["platforms"] == ["cpu"] and header["mesh_devices"] == 1
    assert header["source_digest"] == _build.source_digest()
    assert aot.config_from_dict(aot.config_to_dict(CFG)) == CFG


def test_export_load_matches_live():
    target = _target()
    m = aot.load_matcher(aot.export_matcher(CFG, 15, 512, platforms=("cpu",)))
    out = m(3, target)
    live = match_audio_stft(target, CFG, seed=3, num_generations=15, device="cpu")
    c = live.chunks[0]
    assert out["best_fitness"] == np.float32(c.best_fitness)
    np.testing.assert_array_equal(out["best_params_scaled"], c.best_params_scaled)
    np.testing.assert_array_equal(out["best_params_norm"], c.best_params_norm)
    np.testing.assert_array_equal(out["best_audio"], live.output_audio)
    assert int(out["generations_run"]) == 15
    assert out["parent_values"].shape == (CFG.num_parents, CFG.num_dimensions)
    assert out["parent_fitness"].shape == (CFG.num_parents,)
    assert set(out) == {"best_params_scaled", "best_params_norm", "best_fitness",
                        "generations_run", "parent_values", "parent_fitness", "best_audio"}


def test_artifact_is_self_describing(tmp_path):
    p = tmp_path / "m.pmfm"
    aot.save_matcher(p, CFG, num_generations=5, target_samples=512, platforms=("cpu",))
    m = aot.load_matcher(p)
    assert m.cfg.num_parents == CFG.num_parents and m.cfg.num_frames == 2
    assert m.num_generations == 5 and m.target_samples == 512 and m.platforms == ["cpu"]


def test_bad_magic_rejected():
    with pytest.raises(ValueError, match="magic"):
        aot.load_matcher(b"NOTPMFM!" + b"\0" * 64)
    with pytest.raises(ValueError, match="magic"):  # the reference's artifact
        aot.load_matcher(b"PMFMAOT1" + b"\0" * 64)


def test_wrong_target_shape_rejected():
    m = aot.load_matcher(aot.export_matcher(CFG, 2, 256, platforms=("cpu",)))
    with pytest.raises(ValueError, match="shape"):
        m(0, _target(512))


def test_bad_target_samples_rejected():
    with pytest.raises(ValueError, match="multiple"):
        aot.export_matcher(CFG, 2, 300, platforms=("cpu",))
    with pytest.raises(ValueError, match="platforms"):
        aot.export_matcher(CFG, 2, 256, platforms=("tpu",))
    with pytest.raises(ValueError, match="mesh_devices"):
        aot.export_matcher(CFG, 2, 256, platforms=("cpu",), mesh_devices=0)


def test_foreign_sources_rejected(monkeypatch):
    blob = aot.export_matcher(CFG, 2, 256, platforms=("cpu",))
    monkeypatch.setattr(_build, "source_digest", lambda: "0123456789abcdef")
    with pytest.raises(ValueError, match="kernel sources"):
        aot.load_matcher(blob)


def test_cuda_artifact_places_its_library(fake_cuda_build, monkeypatch):
    """A cuda artifact carries the library's bytes; loading it writes them
    where ``_build`` looks for the current sources' library (and leaves a
    library already there alone) and never builds."""
    blob = aot.export_matcher(CFG, 2, 256)
    header = _header(blob)
    assert header["platforms"] == ["cuda"] and blob.endswith(fake_cuda_build.read_bytes())
    monkeypatch.setattr(_build, "build", lambda: pytest.fail("load_matcher built the kernels"))
    assert not _build.library_path().exists()
    m = aot.load_matcher(blob)
    assert m.platforms == ["cuda"]
    assert _build.library_path().read_bytes() == fake_cuda_build.read_bytes()
    _build.library_path().write_bytes(b"a library built here")
    aot.load_matcher(blob)
    assert _build.library_path().read_bytes() == b"a library built here"


def test_corrupted_payload_rejected(fake_cuda_build):
    blob = bytearray(aot.export_matcher(CFG, 2, 256))
    blob[-5] ^= 0xFF
    with pytest.raises(ValueError, match="sha256"):
        aot.load_matcher(bytes(blob))
    with pytest.raises(ValueError, match="sha256"):
        aot.load_matcher(bytes(blob[:-100]))
    assert not _build.library_path().exists()


def _small_config(tmp_path):
    """examples/audio_match.json at a population of 16, 6 generations and a
    refine tail of 2, in a directory holding input_audio/."""
    run = json.loads((REPO / "examples" / "audio_match.json").read_text())
    run["evolutionary"].update(numParents=4, numOffspring=12, numGenerations=6)
    run["tpu"]["refineGenerations"] = 2
    run["general"]["isBenchmarking"] = False
    path = tmp_path / "small.json"
    path.write_text(json.dumps(run))
    shutil.copytree(REPO / "input_audio", tmp_path / "input_audio")
    return path, run


def test_cli_export_then_run_matches_live(tmp_path, monkeypatch, capsys):
    """``--export-aot`` writes the artifact for the config and the target's
    length and exits; ``--aot`` runs it (its config, generations and
    platform) and writes what ``--mode stft`` writes without it."""
    path, run = _small_config(tmp_path)
    monkeypatch.chdir(tmp_path)
    art = tmp_path / "matcher.pmfm"
    base = ["-j", str(path), "--platform", "cpu"]
    assert cli.main(base + ["--export-aot", str(art)]) == 0
    out = capsys.readouterr().out
    assert "exported AOT matcher" in out and art.exists()
    header = _header(art.read_bytes())
    assert header["target_samples"] == 16384 and header["platforms"] == ["cpu"]
    wav = tmp_path / run["general"]["outputAudioPath"]
    assert cli.main(base + ["--mode", "stft"]) == 0
    live, _ = read_wav(wav)
    wav.unlink()
    assert cli.main(base + ["--aot", str(art), "--generations", "99"]) == 0
    out = capsys.readouterr().out
    assert "loaded AOT matcher" in out and "(6 generations)" in out
    served, _ = read_wav(wav)
    np.testing.assert_array_equal(served, live)


def test_cli_aot_platform_must_match(tmp_path, monkeypatch, fake_cuda_build):
    path, _ = _small_config(tmp_path)
    monkeypatch.chdir(tmp_path)
    art = tmp_path / "cuda.pmfm"
    aot.save_matcher(art, CFG.replace(audio_length_log2=11), 2, 16384)
    with pytest.raises(ValueError, match="the artifact is for cuda"):
        cli.main(["-j", str(path), "--platform", "cpu", "--aot", str(art)])
    # a mesh of 2 is recorded (the reference's cli.py:262-266), and a world
    # of one refuses to run it (the reference's aot.py:211-214)
    art2 = tmp_path / "mesh2.pmfm"
    assert cli.main(["-j", str(path), "--platform", "cpu", "--mesh", "2", "--export-aot",
                     str(art2)]) == 0
    m = aot.load_matcher(art2)
    assert m.mesh_devices == 2
    with pytest.raises(RuntimeError, match="2-rank mesh but the world has 1"):
        m(0, _target(m.target_samples))
