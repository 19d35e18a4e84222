"""The small utilities of pmfm_tpu_torch (ROADMAP Queue A item 11) on the
CPU, against pmfm_tpu's: ``utils/debug.py::checked_fitness``,
``utils/profiling.py::annotate`` and ``device_sync``,
``utils/provenance.py::seeding_fingerprint`` with its committed artifact
``pmfm_tpu_torch/gen_check.json``, and the WAV reader that stands in for the
reference's native runtime (``pmfm_tpu/native/``, which the port does not
carry: its pure-Python fallbacks are the port's ``io/wav.py`` and
``utils/csv_logger.py``).
"""
import ctypes
import json
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmfm_tpu.utils.debug import checked_fitness as j_checked_fitness
from pmfm_tpu_torch.io import read_wav
from pmfm_tpu_torch.utils import device_sync, provenance
from pmfm_tpu_torch.utils.debug import checked_fitness
from pmfm_tpu_torch.utils.profiling import annotate, maybe_trace

REPO = Path(__file__).resolve().parent.parent
# the draw statistics phase 4 of chip_smoke.py measures on the card and the
# artifact holds
GEN_CHECKS = ("parent_choice", "clt12", "coin")


@pytest.mark.parametrize("values", [[1.0, 2.0], [1.0, float("nan")], [float("inf"), 0.5],
                                    [-float("inf")]])
def test_checked_fitness_is_the_reference(values):
    """A finite output passes unchanged; NaN or infinity raises, in the port
    as in the reference."""
    x = np.asarray(values, np.float32)
    mine = checked_fitness(lambda t: t * 2.0)
    ref = j_checked_fitness(lambda t: t * 2.0)
    if np.isfinite(x).all():
        np.testing.assert_array_equal(mine(torch.from_numpy(x)).numpy(),
                                      np.asarray(ref(jnp.asarray(x))))
        return
    with pytest.raises(Exception):
        ref(jnp.asarray(x))
    with pytest.raises(FloatingPointError, match="non-finite fitness"):
        mine(torch.from_numpy(x))


def test_trace_with_annotation_writes_artifacts(tmp_path):
    """``annotate`` labels a region inside ``maybe_trace``'s trace (the
    analog of tests/test_misc.py::TestProfilingHooks)."""
    with maybe_trace(str(tmp_path)):
        with annotate("stage"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any(ev.get("name") == "stage" for ev in trace["traceEvents"])
    with maybe_trace(None), annotate("no trace"):
        pass


def test_device_sync_returns_its_argument(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: calls.append(dev))
    x = {"a": torch.ones(2), "b": (torch.zeros(1), [torch.arange(3)]), "c": 3}
    assert device_sync(x) is x and not calls  # CPU tensors: nothing to wait for
    t = torch.ones(1)
    assert device_sync(t) is t


def test_gen_check_artifact_is_fresh():
    """The committed draw statistics speak of the current sources: when the
    sources that fix the kernels' draws change, this fails until phase 4 of
    chip_smoke.py is run on the card and its ``gen_check.json`` committed."""
    report = json.loads(provenance.GEN_CHECK_ARTIFACT.read_text())
    assert report["fingerprint"] == provenance.seeding_fingerprint(), (
        "the draw sources changed since pmfm_tpu_torch/gen_check.json was measured: run "
        "chip_smoke.py on the card and commit its gen_check report")


def test_gen_check_artifact_holds_card_statistics():
    report = json.loads(provenance.GEN_CHECK_ARTIFACT.read_text())
    assert report["ok"] and "H100" in report["device"] and report["power_limit"]
    for name in GEN_CHECKS:
        assert report["checks"][name]["ok"], name
    clt = report["checks"]["clt12"]
    assert abs(clt["sigma"] - 1 / 6) < 1e-3 and abs(clt["mean"]) < 1e-3
    assert abs(clt["excess_kurtosis"] + 0.1) < 0.1
    assert abs(report["checks"]["coin"]["rate"] - 0.5) < 1e-2


@pytest.mark.parametrize("part", ["kernel_seed", "philox4x32", "generation.cuh"])
def test_seeding_fingerprint_follows_its_sources(monkeypatch, tmp_path, part):
    """A change to any part the fingerprint covers moves it."""
    from pmfm_tpu_torch.es import pipeline
    from pmfm_tpu_torch.kernels import generation

    before = provenance.seeding_fingerprint()
    if part == "kernel_seed":
        monkeypatch.setattr(pipeline, "kernel_seed", test_device_sync_returns_its_argument)
    elif part == "philox4x32":
        monkeypatch.setattr(generation, "philox4x32", test_gen_check_artifact_is_fresh)
    else:
        csrc = tmp_path / "csrc"
        shutil.copytree(REPO / "pmfm_tpu_torch" / "csrc", csrc)
        with open(csrc / "generation.cuh", "a") as f:
            f.write("\n// changed\n")
        monkeypatch.setattr(provenance, "_CSRC", csrc)
    assert provenance.seeding_fingerprint() != before


def test_wav_reader_is_the_native_runtime(tmp_path):
    """The port reads input_audio/input.wav as the reference's native reader
    (pmfm_tpu/native/src/pmfm_native.cpp, built here with g++) does."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the reference's native reader cannot be built")
    lib_path = tmp_path / "libpmfm_native.so"
    src = REPO / "pmfm_tpu" / "native" / "src" / "pmfm_native.cpp"
    proc = subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17", str(src), "-o",
                           str(lib_path)], capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        pytest.skip(f"g++ cannot build the reference's native reader: {proc.stderr[-300:]}")
    lib = ctypes.CDLL(str(lib_path))
    lib.pmfm_wav_read.restype = ctypes.c_int
    lib.pmfm_wav_read.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                                  ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)]
    lib.pmfm_free.argtypes = [ctypes.c_void_p]
    path = REPO / "input_audio" / "input.wav"
    out, n, sr = ctypes.POINTER(ctypes.c_float)(), ctypes.c_int64(), ctypes.c_int32()
    assert lib.pmfm_wav_read(str(path).encode(), ctypes.byref(out), ctypes.byref(n),
                             ctypes.byref(sr)) == 0
    try:
        native = np.ctypeslib.as_array(out, shape=(n.value,)).copy()
    finally:
        lib.pmfm_free(out)
    audio, rate = read_wav(path)
    assert rate == sr.value and audio.dtype == np.float32
    np.testing.assert_array_equal(audio, native)
