"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` (``fused_eval.cu``: B1, B2 int8; ``fused_bf16.cu``:
B1, B2 bf16, both on ``tc_eval.cuh``; ``fused_tp.cu`` and
``fused_tp_chain.cu``: B1 and B2 int8 in the time-parallel layout of
``fused_tp.cuh``, on the fixed banks of 2-5 pairs and the fixed chains;
``fused_tp_bf16.cu`` and ``fused_tp_bf16_chain.cu``: the same in bf16, on
``fused_tp_bf16.cuh``; ``fused_wide.cu``:
both modes at the wide synthesis codes, chains of 9-16 oscillators and banks of 6-8 pairs;
``fused_f32.cu``: B1, B2 true f32, and ``fused_f32_tp.cu`` their
time-parallel synthesis; ``evolve.cu``: B5, which runs B2's
kernels, in int8 and bf16 in either layout, through ``generation.cuh``; ``large_frame.cu``: B3, B4 on
``large_frame.cuh``, and ``large_frame_wide.cu`` their wide codes, every
bank among them; ``fused_long.cu`` and ``large_frame_long.cu``: B1/B2
int8 and bf16, and B3/B4, at the long code, the topologies above 32 genes
(B1/B2 f32 instantiate it in ``fused_f32.cu``); ``scan_synth.cu``: the
scan synthesis of the unfused engines, one thread a candidate or
time-parallel; ``evaluate.cuh``: B2's offspring genes and the dispatch of the
synthesis codes; ``synth_common.cuh``: the synthesis B1-B4 share and the
fold emitter of B1, B2 and B3) have a plain
C interface and include no PyTorch header, so ``nvcc`` compiles them, one
process per source started together, and links them into one shared
library, which ``ctypes`` loads. The library goes to
``build/pmfm_tpu_torch/`` at the root of the checkout, under a name that
carries a hash of every source, so an edited source is rebuilt and a
current build is reused. Nothing here runs at import: the first launch
builds.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pmfm_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]


def sources() -> list:
    """The ``.cu`` files compiled into the library, in a fixed order."""
    return sorted(CSRC.glob("*.cu"))


class SynthParams(ctypes.Structure):
    """Mirror of ``struct SynthParams`` in csrc/synth_common.cuh."""

    _fields_ = [
        ("sin_c", ctypes.c_float * 5),
        ("sin_c63", ctypes.c_float * 5),
        ("ncoef", ctypes.c_int),
        ("n", ctypes.c_int),
        ("k", ctypes.c_int),
        ("d", ctypes.c_int),
        ("kn", ctypes.c_int),
        ("fm2", ctypes.c_int),
        ("inv_sr", ctypes.c_float),
        ("dft_scale", ctypes.c_float),
        ("edge_norm", ctypes.c_float),
        ("npair", ctypes.c_int),
        ("frames", ctypes.c_int),
        ("long_code", ctypes.c_int),
        ("lrows", ctypes.c_int),
        ("lscr", ctypes.c_void_p),
        ("f32_tp", ctypes.c_int),
        ("fft", ctypes.c_void_p),
    ]


class MutateParams(ctypes.Structure):
    """Mirror of ``struct MutateParams`` in csrc/evaluate.cuh."""

    _fields_ = [
        ("mu", ctypes.c_int),
        ("clamp", ctypes.c_int),
        ("alpha", ctypes.c_float),
        ("inv_alpha", ctypes.c_float),
        ("ekb_alpha", ctypes.c_float),
        ("ekb_inv_alpha", ctypes.c_float),
        ("beta_scale", ctypes.c_float),
        ("root_two_over_pi", ctypes.c_float),
        ("min_step", ctypes.c_float),
        ("mins", ctypes.c_void_p),  # (d,) float32, device memory
        ("ranges", ctypes.c_void_p),  # (d,) float32, device memory
    ]


class ScanParams(ctypes.Structure):
    """Mirror of ``struct ScanParams`` in csrc/scan_synth.cu."""

    _fields_ = [
        ("n", ctypes.c_int),
        ("pop", ctypes.c_int),
        ("k", ctypes.c_int),
        ("w2sr", ctypes.c_float),
        ("size", ctypes.c_float),
        ("scale", ctypes.c_float),
        ("inv_k", ctypes.c_float),
        ("table_max", ctypes.c_int),
    ]


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on the PATH")


def source_digest() -> str:
    """16 hex digits of the sha256 of the arch flags and every source under
    ``csrc/``: what names the library and what an AOT artifact
    (``utils/aot.py``) is checked against."""
    h = hashlib.sha256(" ".join(ARCH_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode() + f.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libpmfm_fused_{source_digest()}.so"


def build() -> dict:
    """Compile the kernels unless a library of the current sources exists.

    Each source is compiled by its own ``nvcc`` process, all started
    together, and the objects are linked into one shared library. Returns
    ``{"path", "seconds", "log", "built"}``; ``log`` holds nvcc's
    ``-Xptxas -v`` report (registers, shared memory, spills per kernel) and
    a line ``nvcc <source>: <s>s`` a source, its wall time from the start.
    Raises ``RuntimeError`` with the compiler's output if nvcc fails.
    """
    out = library_path()
    if out.exists():
        return {"path": str(out), "seconds": 0.0, "log": "", "built": False}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    tmp = out.with_suffix(f".{tag}")
    nvcc = nvcc_path()
    common = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources()]
    t0 = time.perf_counter()
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for cmd in (
            [*common, "-Xptxas", "-v", "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources(), objs)
        )
    ]
    results = {}

    def drain(proc):  # each process's output read as it comes, so no pipe fills and stalls it
        results[id(proc)] = (proc.communicate()[0], time.perf_counter())

    readers = [threading.Thread(target=drain, args=(proc,)) for _, proc in procs]
    for r in readers:
        r.start()
    for r in readers:
        r.join()
    logs, failed = [], []
    for (cmd, proc), src in zip(procs, sources()):
        text, end = results[id(proc)]
        logs.append(text + f"nvcc {src.name}: {end - t0:.1f}s\n")  # its wall time from the start
        if proc.returncode != 0:
            failed.append((proc.returncode, " ".join(cmd), logs[-1]))
    if not failed:
        link = [*common, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append((proc.returncode, " ".join(link), logs[-1]))
    for obj in objs:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            "nvcc failed:\n" + "\n".join(f"({rc}) {cmd}\n{log}" for rc, cmd, log in failed))
    os.replace(tmp, out)  # atomic: a concurrent loader sees no half-written file
    return {"path": str(out), "seconds": seconds, "log": "".join(logs), "built": True}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use unless a library of the
    current sources is in place (a build, or one an AOT artifact placed),
    with every launcher's ``argtypes`` set (``c_void_p`` for each pointer
    and the stream, so no pointer is cut to 32 bits)."""
    path = library_path()
    lib = ctypes.CDLL(str(path) if path.exists() else build()["path"])
    vp, ci = ctypes.c_void_p, ctypes.c_int
    cll = ctypes.c_longlong
    u32 = ctypes.c_uint32
    lib.pmfm_fused_synth_fitness.argtypes = [vp, ci, ci, SynthParams, vp, vp, vp, vp]
    lib.pmfm_fused_synth_fitness.restype = ci
    lib.pmfm_fused_synth_fitness_tp.argtypes = lib.pmfm_fused_synth_fitness.argtypes
    lib.pmfm_fused_synth_fitness_tp.restype = ci
    lib.pmfm_fused_generation.argtypes = [
        u32, vp, vp, vp, ci, ci, SynthParams, MutateParams, vp, vp, vp, vp, vp, vp,
    ]
    lib.pmfm_fused_generation.restype = ci
    lib.pmfm_fused_generation_tp.argtypes = lib.pmfm_fused_generation.argtypes
    lib.pmfm_fused_generation_tp.restype = ci
    lib.pmfm_fused_synth_fitness_bf16.argtypes = lib.pmfm_fused_synth_fitness.argtypes
    lib.pmfm_fused_synth_fitness_bf16.restype = ci
    lib.pmfm_fused_generation_bf16.argtypes = lib.pmfm_fused_generation.argtypes
    lib.pmfm_fused_generation_bf16.restype = ci
    lib.pmfm_fused_synth_fitness_bf16_tp.argtypes = lib.pmfm_fused_synth_fitness.argtypes
    lib.pmfm_fused_synth_fitness_bf16_tp.restype = ci
    lib.pmfm_fused_generation_bf16_tp.argtypes = lib.pmfm_fused_generation.argtypes
    lib.pmfm_fused_generation_bf16_tp.restype = ci
    lib.pmfm_fused_synth_fitness_f32.argtypes = [vp, ci, ci, SynthParams, vp, vp, vp, vp, cll, vp]
    lib.pmfm_fused_synth_fitness_f32.restype = ci
    lib.pmfm_fused_generation_f32.argtypes = [
        u32, vp, vp, vp, ci, ci, SynthParams, MutateParams, vp, vp, vp, vp, vp, vp, cll, vp,
    ]
    lib.pmfm_fused_generation_f32.restype = ci
    lib.pmfm_fused_evolve.argtypes = [
        ctypes.POINTER(u32), vp, ci, ci, ci, SynthParams, MutateParams, vp, vp, vp, vp, vp, vp,
        vp, vp, vp, vp, vp, vp, cll, ci, ci, vp,
    ]
    lib.pmfm_fused_evolve.restype = ci
    lib.pmfm_synth_fold.argtypes = [vp, ci, SynthParams, vp, vp, vp, vp, ci, ci, vp]
    lib.pmfm_synth_fold.restype = ci
    lib.pmfm_synth_stream.argtypes = [vp, ci, SynthParams, vp, vp, ci, vp, cll, vp]
    lib.pmfm_synth_stream.restype = ci
    lib.pmfm_scan_synth.argtypes = [vp, ci, ci, ci, ScanParams, vp, vp, cll, vp, vp]
    lib.pmfm_scan_synth.restype = ci
    lib.pmfm_scan_synth_tp.argtypes = [vp, ci, ci, ci, ScanParams, vp, ci, ci, vp, vp]
    lib.pmfm_scan_synth_tp.restype = ci
    lib.pmfm_scan_chain_probe.argtypes = [vp, ci, ctypes.c_float, vp, vp]
    lib.pmfm_scan_chain_probe.restype = ci
    lib.pmfm_error_string.argtypes = [ci]
    lib.pmfm_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        msg = library().pmfm_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
