"""On-card smoke test of the PyTorch/CUDA port (pmfm_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels with one nvcc call, holds each kernel against
its plain PyTorch version at the shapes its path gives it, drives each path
through the entry points a user calls, and times each kernel:

* phases 3-6, the bench ES (population 2^15, mu 256, fm3_series, n 1024,
  K 512, int8 folded DFT, sine order 7) through ``evolve`` under
  fused_generation (kernel B2) and fused_kernel (kernel B1);
* phases 7-11, the large-frame paths: B3 (synth_fold, in both of its
  layouts) and B4 (synth_stream) bit-equal to their plain versions at the
  cells' settings and over grids of chains, sine orders, frames, modes and
  populations, ``evolve`` at n 8192 (pop 2^15, B3 + the folded int8 DFT)
  and at n 65536 (pop 2^13, B4 + the factored DFT), ``match_audio`` over
  ``input_audio/input.wav`` at n 8192 with the refine tail, and the
  kernels' and spectra's times (B3's layouts across populations);
* phases 12-16, the true-f32 mode of B1/B2 and the whole-run kernel B5:
  B1/B2 f32 against their plain versions at the shipped refine tail's
  settings (n 1024, pop 2^15) and at ``examples/audio_match.json``'s
  (n 2048, pop 4096), and over phase 4b's grid, and both against a float64
  evaluation of the same audio; B5 (B2's own kernels and a selection kernel
  a generation) against a loop of B2 launches with the exact stable
  selection (bit-equal, int8 and f32, also on ties: identical candidates,
  NaN fitness, and a population above the selection's shared-memory fast
  path) and against its plain version;
  ``evolve`` with ``fused_evolve`` at the bench config; the shipped path
  (``examples/params_match.json`` through ``_evolve_on_target``: 900
  generations of B2 in int8, 100 in f32) and ``match_audio`` running
  ``examples/audio_match.json`` as written; the f32 and B5 kernels' times,
  B5's split a generation (evaluation, selection, time not covered by
  kernels, from torch.profiler), the f32 split at both refine tails' shapes
  (with torch.profiler's time of each f32 kernel and cuBLAS SGEMM as the
  DFT half's yardstick), the port's bench (``pmfm_tpu_torch/bench.py``,
  one repetition) and the host time of the one-run operations the ES loop
  keeps beside their run-axis forms;
* phases 17-19, the unfused engines and the CLI: the scan synthesis kernel
  (``csrc/scan_synth.cu``) bit-equal to its plain loop over samples at the
  bench's and parameters.json's shapes and over chains, oscillators and
  output types; each unfused engine (``xla_dft``, ``xla_folded_dft`` int8
  and bf16, ``xla_rfft``; scan and scanless synthesis) at the bench shape,
  held against the same engine on the CPU, with the known-params truth
  first, and the rfft rung at n 8192 and 16384; ``python -m
  pmfm_tpu_torch.cli``'s ``main`` on parameters.json and
  examples/params_match.json as written;
* phases 20-21, the staged (pursuit) solver: B1/B2 in the fm{k}_parallel
  mode (int8 and true f32) against their plain versions at
  examples/fm3_parallel_match.json's shape and over phase 4b's grid with
  fm2/fm3/fm4_parallel, and their times beside fm3_series's; the block
  stages' f32 engine's peak memory; ``cli.main`` on the five pursuit
  examples (fm3_parallel_match.json as written, the others with each
  stage's generations cut to a tenth and one attempt).

* phases 22-25, multi-frame fitness and the run axis (A6): B1/B2 in the
  multi-frame mode against their plain versions at ``--mode stft``'s shape
  (``examples/audio_match.json``: n 2048, P 4096, 8 frames) and over
  chains x frames x frame sizes, int8 and f32; B1/B2/B5 launched for B runs
  bit-equal to lone launches, and B5 at 8 frames bit-equal to B2 launches
  with the stable selection; ``cli.main`` on ``audio_match.json`` with
  ``--mode stft``, ``--mode parallel-chunks`` and ``--batch`` over 4
  synthesised WAVs, and ``match_audio_stft``/``match_many`` under
  fused_kernel and fused_evolve; each new mode's kernel time beside its
  plain version's and its bound, and the reference suites' shapes
  (suite_stft_frames, suite_multi_target).

``python3 chip_smoke.py --only 20,21`` runs the device, build and inputs
phases and the named ones, and prints no result line.

One flushed line per phase, ending with its seconds; every time is printed
beside the card's name and power limit.

The second-to-last line is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``, printed only when every phase
passed. Without a CUDA device the script exits 2 and prints no result. A
watchdog ends a hung run with a traceback and a non-zero code.
"""
import contextlib
import faulthandler
import json
import re
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

WATCHDOG_S = 900
POP, MU, D, LOG2N = 1 << 15, 256, 6, 10
TOPOLOGY = "fm3_series"
TRUTH = (3078.0, 2.0, 3015.0, 1.5, 3141.0, 1.0)  # examples/params_match.json
GENERATIONS = 200
TIMED_LAUNCHES = 25
HOST_FORM_CALLS = 200  # phase 16's host time of the one-run forms a call
PLAIN_RUNS = 3
SPLIT_BINS = 8  # phase 6's synthesis-only B1: an operand and target of 8 bins
# phase 4b: B1/B2 int8 over every frame the router sends them (multiples of
# 256 up to 3584), the ported topologies, sine orders 5/7/9, and populations
# around the 32-candidate block and a ragged one (plus P 2^15 at n 1024)
GRID_N = (256, 1024, 2048, 3584)
GRID_TOPOLOGIES = ("fm2", "fm3_series", "fm8_series")
GRID_SINE_ORDERS = (5, 7, 9)
GRID_POPS = (1, 63, 64, 65, 4001)
GRID_ODD_BINS = (1024, 200)  # (n, K): K not a multiple of the kernel's 32-bin pass
# phase 12: phase 4b's grid for B1/B2 true f32, with populations around the f32
# DFT's 128-candidate block (its bin passes are 64 bins of one group: K 200
# leaves partial passes and groups of 3 and 4 tiles)
F32_GRID_POPS = (1, 127, 128, 129, 4001)
SEED = 20261017
# the large-frame cells: the reference's chunk-size rows (bench_suite.py)
FOLD_LOG2N, FOLD_POP, FOLD_GENERATIONS = 13, 1 << 15, 30  # (c) synth_fold, B3
STREAM_LOG2N, STREAM_POP, STREAM_GENERATIONS = 16, 1 << 13, 10  # (d) synth_stream, B4
# phases 7 and 8: B3/B4 bit-equal to their plain versions over the ported
# chains and sine orders, both modes (and both B3 layouts), populations
# around the 32-candidate blocks and a ragged one. The plain version walks
# the frame one block at a time (its cost grows with n and the chain's
# length, not with P), so it runs once a setting at the largest population
# (each candidate's output is its own) and the settings cover the axes
# rather than their product (tests/test_torch_gpu.py runs more of it):
LARGE_GRID_POPS = (1, 31, 33, 1000)
# B3: a Latin square, each (topology, sine order) once, each chain and each
# sine order at every frame of the route
FOLD_GRID = (("fm2", 5, 4096), ("fm3_series", 7, 4096), ("fm8_series", 9, 4096),
             ("fm2", 7, 8192), ("fm3_series", 9, 8192), ("fm8_series", 5, 8192),
             ("fm2", 9, 16384), ("fm3_series", 5, 16384), ("fm8_series", 7, 16384))
# B4: fm2 and fm3_series at each frame (131072: the level totals in device
# memory), fm8_series at the shortest; each sine order at 32768
STREAM_GRID = (("fm2", 5, 131072), ("fm3_series", 7, 131072), ("fm2", 7, 65536),
               ("fm3_series", 9, 65536), ("fm2", 9, 32768), ("fm3_series", 5, 32768),
               ("fm8_series", 7, 32768))
# phase 11: B3's two layouts across populations (the wrapper's
# FOLD_TP_BELOW_POP, by chain length and mode, sits between them): every
# ported chain in both modes at cell (c)'s frame and sine order, and cell
# (c)'s shape at the route's shortest and longest frames; (topology, sine
# order, n, int8)
FOLD_LAYOUT_SHAPES = tuple((t, 7, 8192, m) for t in ("fm2",) + tuple(
    f"fm{k}_series" for k in range(3, 9)) for m in (True, False)) + (
    ("fm3_series", 7, 4096, True), ("fm3_series", 7, 16384, True))
FOLD_LAYOUT_POPS = (2048, 4096, 8192, 16384, 1 << 15, 1 << 16)
MATCH_CONFIG, MATCH_LOG2N = "examples/audio_match.json", 13  # (e) match_audio
MATCH_GENERATIONS, MATCH_REFINE = 40, 10
# the third slice: B1/B2 f32 and B5
SHIPPED_CONFIG = "examples/params_match.json"  # n 1024, pop 2^15, 100-generation f32 tail
AUDIO_CONFIG = "examples/audio_match.json"  # n 2048, pop 4096, as written
AUDIO_GENERATIONS = 110  # per chunk: 10 of int8, then the config's 100 of f32
EVOLVE_CHECK_GENERATIONS, EVOLVE_PLAIN_GENERATIONS, EVOLVE_TIMED_GENERATIONS = 20, 2, 10
# a population whose last CUDA block is only partly filled: not a multiple
# of the f32 DFT's 128 candidates a block, the int8 mode's 32, or the 32
# lanes of B5's selection
RAGGED_POP = 4001
# B5 at a population whose selection keys do not fit shared memory (48,828
# at mu 256): every pass streams them from L2
BIG_POP = 1 << 16
PROFILED_B5_CALLS = 3
# JSON entries: a kernel, or B1/B2 in their true-f32 mode or their
# fm{k}_parallel mode (the same wrapper and counter; the f32 entries'
# launches are read on the refine tail, the parallel entries' in phase 21's
# fm3_parallel run, from the wrappers' launches_by)
# and the multi-frame (_frames) and run-axis (_runs) modes of B1/B2/B5, each
# with its launches from the path of phase 24 that runs it
KERNELS = ("fused_synth_fitness", "fused_generation", "fused_synth_fold", "fused_synth_stream",
           "fused_synth_fitness_f32", "fused_generation_f32", "fused_evolve", "scan_synth",
           "fused_synth_fitness_parallel", "fused_generation_parallel",
           "fused_synth_fitness_parallel_f32", "fused_generation_parallel_f32",
           "fused_synth_fitness_frames", "fused_generation_frames",
           "fused_synth_fitness_frames_f32", "fused_generation_frames_f32", "fused_evolve_frames",
           "fused_synth_fitness_runs", "fused_generation_runs", "fused_synth_fitness_runs_f32",
           "fused_generation_runs_f32", "fused_evolve_runs")

# B1 fitness: kernel and plain version make the same int8 audio and exact
# int32 DFT sums and differ only in the order of the float32 sum over bins,
# so errors should sit at float32 rounding (~1e-7). The bound also admits
# the rare int8 rounding flip that a different phase summation order would
# cause: the tolerance tests/test_torch_kernels.py holds against the
# reference.
FIT_MAX_REL, FIT_MEDIAN_REL = 1e-3, 1e-5
# B2 steps: exp/pow may differ by an ulp or two between libm builds.
STEP_MAX_REL = 1e-6
# B1/B2 true f32: the same f32 audio on both sides; the kernel's DFT sums
# each bin in sample order with exact-product FMAs, the plain version in a
# float32 matrix product's order, so every magnitude moves by float32
# rounding. Limits set from the first measurement of these kernels on an
# H100 (max 1.6e-6, median 1.04e-7 over both settings, the truth included),
# with ~6x and ~10x room; below the int8 gate above.
F32_FIT_MAX_REL, F32_FIT_MEDIAN_REL = 1e-5, 1e-6

# the CUDA kernels of the true-f32 B1/B2 (csrc/fused_f32.cu), timed apart by
# torch.profiler in the f32 split line; B5 runs them or the int8 B2 kernel
# for its evaluation, and its own selection kernel
F32_KERNELS = ("f32_synth_kernel", "f32_dft_kernel", "f32_sum_kernel")
B2_KERNELS = F32_KERNELS + ("fused_generation_int8_kernel",)
SELECT_KERNEL = "select_kernel"
PROFILED_LAUNCHES = 10

# phase 17: the scan kernel (csrc/scan_synth.cu) against its plain loop, bit
# for bit, at the bench's shape, parameters.json's (population 32, n 2048)
# and over chains x oscillators x output types at SCAN_GRID_POP, n 1024
SCAN_GRID = ("fm2", "fm3_series", "fm8_series", "fm3_parallel")
SCAN_GRID_POP = 4096
# sinf's fast path counted as f32 operations in the scan kernel's bound
# (a three-term reduction and two short polynomials)
SINF_OPS = 15
# phase 18: the unfused engines at the bench shape, UNFUSED_GENERATIONS
# generations each; each engine on the card against the same engine on the
# CPU on UNFUSED_CHECK_POP candidates of the CPU tests' mild-index ranges,
# within their tolerance (tests/test_torch_unfused.py); the rfft rung at
# RFFT_RUNG_LOG2N
UNFUSED_ENGINES = (("xla_dft", "dft", "float32"), ("xla_folded_dft", "dft", "int8"),
                   ("xla_folded_dft", "dft", "bfloat16"), ("xla_rfft", "rfft", "float32"))
UNFUSED_GENERATIONS = 5
UNFUSED_CHECK_POP = 1024
# (max, median) relative by the engine's dtype: tests/test_torch_unfused.py's TOL
UNFUSED_TOL = {"float32": (1e-3, 1e-6), "int8": (2e-3, 1e-6), "bfloat16": (2e-3, 1e-6)}
RFFT_RUNG_LOG2N = (13, 14)
# phase 19: the CLI as a user runs it, in a directory of the checkout
CLI_CONFIGS = ("parameters.json", "examples/params_match.json")
CLI_DIR = "build/chip_smoke_cli"
# phase 20: B1/B2 in the fm{k}_parallel mode (int8 and true f32) against
# their plain versions at PARALLEL_CONFIG's shape (P 8192, n 1024, sine
# order 9) with examples/fm4_parallel_match.json's truth (its first k pairs),
# then over phase 4b's grid (GRID_N, GRID_ODD_BINS, P 2^15 at n 1024) with
# the banks, two sine orders and PARALLEL_GRID_POPS; the kernels' times
# beside the series chain's (PARALLEL_TIMED) at that shape
PARALLEL_CONFIG = "examples/fm3_parallel_match.json"
PARALLEL_TRUTH = (3076.48, 2.0, 3016.64, 0.9, 1936.0, 2.4, 2182.4, 0.8,
                  2499.2, 1.6, 1584.0, 0.7, 1161.6, 3.2, 985.6, 0.6)
PARALLEL_TOPOLOGIES = ("fm2_parallel", "fm3_parallel", "fm4_parallel")
PARALLEL_SINE_ORDERS = (7, 9)
PARALLEL_GRID_POPS = (1, 63, 64, 65, 4001)
PARALLEL_TIMED = PARALLEL_TOPOLOGIES + ("fm3_series",)
# phase 21: the pursuit solver through cli.main in PURSUIT_DIR: the first
# example as written, its first chunk to a relative spectral error below
# PURSUIT_MAX_REL (the reference's direct ES stalls at 35-55% on this
# family), the others with each stage's generations cut by
# PURSUIT_GENERATION_CUT and one attempt. A params target is 2048 samples,
# so n 1024 makes two chunks; the second holds the same tones a frame
# later, whose phases the model (which starts every oscillator at phase 0)
# cannot take: the true parameters themselves lie ~23% from it (printed
# beside each chunk), so only the first chunk is held to the limit
PURSUIT_DIR = "build/chip_smoke_pursuit"
PURSUIT_AS_WRITTEN = "examples/fm3_parallel_match.json"
PURSUIT_CUT = ("examples/fm4_parallel_match.json", "examples/fm4_series_match.json",
               "examples/fm5_series_match.json", "examples/huge_frame_match.json")
PURSUIT_GENERATION_CUT = 10
PURSUIT_MAX_REL = 0.10

# phases 22-25: multi-frame fitness and the run axis (A6). Phase 22 holds
# B1/B2 in the multi-frame mode against their plain versions at
# examples/audio_match.json --mode stft's shape (input.wav's 16384 samples at
# n 2048: STFT_FRAMES frames, P 4096, sine order 9; int8 and its f32 tail,
# the truth planted first) and over FRAME_GRID_TOPOLOGIES x FRAME_GRID_F x
# FRAME_GRID_N at FRAME_GRID_POP (a ragged int8 warp and f32 DFT block);
# phase 23 holds the run axis at audio_match.json's shape: B1/B2 launched
# for RUN_SETTINGS (runs, frames, and a population of RAGGED_POP, whose
# runs' rows of fitness do not start on 16 bytes; one run, as match_many
# of one target launches it) bit-equal to lone
# launches, B5 likewise
# over RUN_B5_GENERATIONS generations, each batched kernel within its
# limits of its plain version, and B5 at STFT_FRAMES frames bit-equal to
# RUN_B5_GENERATIONS B2 launches with the stable selection
STFT_FRAMES = 8
FRAME_GRID_TOPOLOGIES = ("fm2", "fm3_series", "fm3_parallel")
FRAME_GRID_F = (1, 2, 8)
FRAME_GRID_N = (1024, 2048)
FRAME_GRID_POP = 129
RUN_SETTINGS = ((4, 1, None), (8, 1, None), (4, STFT_FRAMES, None), (3, 2, RAGGED_POP),
                (1, 1, None), (1, STFT_FRAMES, None))
RUN_B5_GENERATIONS = 4
# phase 24: cli.main on AUDIO_CONFIG with --mode stft, --mode parallel-chunks
# and --batch over the BATCH_TRUTHS synthesised into BATCH_SAMPLES-sample
# WAVs, run in A6_DIR; then the paths no example takes, at A6_GENERATIONS
# (the last A6_REFINE the f32 tail): match_audio_stft and match_many under
# fused_kernel (B1 a generation) and fused_evolve (one B5 call a part)
A6_DIR = "build/chip_smoke_a6"
BATCH_SAMPLES = 16384
BATCH_TRUTHS = ((3078.0, 2.0, 3015.0, 1.5, 3141.0, 1.0), (2400.0, 3.0, 1800.0, 2.0, 900.0, 4.0),
                (440.0, 6.0, 880.0, 1.2, 1760.0, 2.5), (3520.0, 1.0, 2637.0, 3.3, 1975.0, 0.8))
A6_GENERATIONS, A6_REFINE = 40, 10
# phase 25: the new modes' kernel times at the driven shapes (the plain
# versions PLAIN_RUNS_A6 times: at 8 frames one plain call takes seconds),
# B5 over RUN_B5_GENERATIONS; the reference suites' shapes: suite_stft_frames
# (P 2^13, mu 256, fm3_series, n 1024, int8 B2, F 1/2/4/8) and
# suite_multi_target (match_many, B 1 and 4 at P 2^13 and mu 64, B 32 at
# P 2^11 and mu 16, SUITE_GENERATIONS generations, int8 B2 at sine order 7)
PLAIN_RUNS_A6 = 1
SUITE_STFT_POP, SUITE_STFT_MU = 1 << 13, 256
SUITE_FRAMES = (1, 2, 4, 8)
SUITE_RUNS = ((1, 1 << 13, 64), (4, 1 << 13, 64), (32, 1 << 11, 16))
SUITE_GENERATIONS = 50

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, int8 ops/s, f32 FLOP/s
PEAK_BYTES, PEAK_INT8, PEAK_F32 = 3.35e12, 1979e12, 67e12

T0 = time.perf_counter()
CARD = {"name": "?", "power_limit": "?"}


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def card() -> str:
    return f"[{CARD['name']}, power limit {CARD['power_limit']}]"


def require(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, runs: int) -> float:
    """Median device time of ``runs`` calls of ``fn()`` (after one warm-up).

    The calls are enqueued back to back with an event between each two and
    one synchronise at the end, so the device does not wait on the host
    between them and each interval is one call's device time."""
    fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(runs + 1)]
    events[0].record()
    for e in events[1:]:
        fn()
        e.record()
    events[-1].synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in zip(events, events[1:]))


def kernel_times(fn, runs: int) -> dict:
    """Mean device ms per call of each CUDA kernel that ``runs`` calls of
    ``fn()`` launch, by name with its template arguments, from
    torch.profiler (after one warm-up call); empty when the trace holds no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        name = ev.key.split("(")[0].removeprefix("void ")
        if us and ev.device_type == torch.autograd.DeviceType.CUDA:
            out[name] = out.get(name, 0.0) + us / runs / 1e3
    return out


def kernel_breakdown(fn, runs: int) -> str:
    """The f32 kernels' rows of ``kernel_times`` as "name ms, ..."; "not
    measured" when the trace holds no device time."""
    rows = [f"{name} {ms:.4f} ms" for name, ms in kernel_times(fn, runs).items()
            if name.split("<")[0] in F32_KERNELS]
    return ", ".join(rows) or "not measured"


@contextlib.contextmanager
def fold_layout(sfo, time_parallel: bool):
    """B3's wrapper in one layout: its FOLD_TP_BELOW_POP set so that it takes
    the time-parallel one (where the frame fits shared memory) or the single
    pass at every chain, mode and population, and restored after."""
    saved = sfo.FOLD_TP_BELOW_POP
    sfo.FOLD_TP_BELOW_POP = dict.fromkeys(saved, 1 << 62 if time_parallel else 0)
    try:
        yield
    finally:
        sfo.FOLD_TP_BELOW_POP = saved


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit: NaN payloads and the sign of zero included."""
    a, b = a.reshape(-1).contiguous(), b.reshape(-1).contiguous()
    return a.dtype == b.dtype and torch.equal(a.view(torch.int32), b.view(torch.int32))


def fitness_f64(params, target, so, topology: str, n: int, sine_order: int,
                uv_f32: bool = False) -> torch.Tensor:
    """The true-f32 fitness of ``params`` from the plain version's float32
    audio with every later step in float64: the fold, the folded DFT against
    the float32 operand's values, the edge term, magnitudes and the L2 sum.
    ``uv_f32`` rounds U and V once to float32 after their float64 sums (every
    later step stays in float64, the result is rounded once to float32): the
    closest any evaluation with float32 U and V can come to float64."""
    from pmfm_tpu_torch.kernels import synth_fitness as sf
    from pmfm_tpu_torch.ops.wavetable import DEFAULT_SAMPLE_RATE, DEFAULT_WAVETABLE_SIZE

    x = sf.synth_f32_plain(params, topology=topology, n=n, sine_order=sine_order,
                           inv_sr=sf.inv_sample_rate(DEFAULT_WAVETABLE_SIZE,
                                                     DEFAULT_SAMPLE_RATE)).double()
    half = n // 2
    ap, am = x[:half].clone(), x[:half].clone()
    ap[1:] += x[half + 1 :].flip(0)
    am[1:] -= x[half + 1 :].flip(0)
    op = so.dft_packed.double()
    k = op.shape[0] // 2
    en = sf.edge_norm(n, False)
    ec = torch.where(torch.arange(k, device=op.device) % 2 == 0, en, -en).double()
    u, v = op[:k] @ ap, op[k:] @ am
    if uv_f32:
        u, v = u.float().double(), v.float().double()
    u = u + ec[:, None] * x[half][None, :]
    dd = torch.sqrt(u * u + v * v) - target.double()[:, None]
    fit = (dd * dd).sum(0)
    return fit.float().double() if uv_f32 else fit


def rel_err(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return (x - ref).abs() / ref.abs().clamp_min(1e-30)


def match_config():
    """The match_audio phase's run config and ESConfig: MATCH_CONFIG at
    MATCH_LOG2N with a MATCH_REFINE-generation refine tail."""
    from pmfm_tpu_torch.io import load_config

    rc = load_config(MATCH_CONFIG)
    return rc, rc.es.replace(audio_length_log2=MATCH_LOG2N, refine_generations=MATCH_REFINE)


def synth_ops_f32(pop: int, n: int, k: int, kn: int, ncoef: int) -> float:
    """float32 operations of the fused evaluation, counted from the kernel:
    per sample the phase (2), per modulating oscillator its sine
    (5 + 2*(ncoef-1)) plus gain, bias and two prefix adds (4), the output sine
    and rounding; per bin the edge term, magnitude, rescale and L2 (12)."""
    sine = 5 + 2 * (ncoef - 1)
    per_sample = 2 + (kn - 1) * (sine + 4) + sine + 1
    return float(pop) * (n * per_sample + 12 * k)


def param_maxs(topology: str) -> tuple:
    """The examples' parameter ranges: 3520 Hz and index 8 an operator, and
    amplitude 1 a pair of an fm{k}_parallel bank."""
    from pmfm_tpu_torch.ops.synthesis import parallel_pairs, topology_dims

    d = topology_dims(topology)
    if parallel_pairs(topology):
        return (3520.0, 8.0, 3520.0, 1.0) * (d // 4)
    return (3520.0, 8.0) * (d // 2)


def bank_ops_f32(pop: int, n: int, k: int, npair: int, ncoef: int) -> float:
    """float32 operations of the fused evaluation of an fm{k}_parallel bank,
    counted from the kernel: per sample and pair the phase (2), the
    modulator's sine (5 + 2*(ncoef-1)), gain and bias (2), the prefix adds
    (2), the output sine, its gain and the sum over pairs (2); per sample the
    division or rounding (1); per bin the epilogue (12)."""
    sine = 5 + 2 * (ncoef - 1)
    per_sample = npair * (2 + sine + 2 + 2 + sine + 2) + 1
    return float(pop) * (n * per_sample + 12 * k)


def ptxas_summary(log: str):
    """(kernel<template arguments>, registers, spill-store bytes) of each
    kernel instantiation in nvcc's ``-Xptxas -v`` report."""
    rows = []
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '_Z(\d+)(\w+)'", ln)
        if m:
            size, rest = int(m.group(1)), m.group(2)
            name, tail = rest[:size], rest[size:]
            if tail.startswith("I"):
                args = ",".join(re.findall(r"L[ib](\d+)E", tail[1:tail.find("EE") + 1]))
                name = f"{name}<{args}>"
            rows.append([name, "?", "?"])
        elif rows and rows[-1][1] == "?" and (r := re.search(r"Used (\d+) registers", ln)):
            rows[-1][1] = r.group(1)
        elif rows and rows[-1][2] == "?" and (r := re.search(r"(\d+) bytes spill stores", ln)):
            rows[-1][2] = r.group(1)
    return rows


def bound(bytes_moved: float, int8_ops: float, f32_ops: float):
    times = {
        "bytes": bytes_moved / PEAK_BYTES,
        "operations": max(int8_ops / PEAK_INT8, f32_ops / PEAK_F32),
    }
    by = max(times, key=times.get)
    return times[by] * 1e3, by


class Smoke:
    def __init__(self, device: str = "cuda", only=None):
        self.dev = torch.device(device)
        self.kernels = {}
        self.failed = []
        self.cell_ms = {}
        self.only = only  # phase numbers to run (with the device, build and inputs), or all

    def phase(self, name, fn):
        number = name.split()[0]
        if self.only is not None and number not in self.only and number not in ("1", "2", "inputs"):
            return
        log(f"phase {name}: start")
        t0 = time.perf_counter()
        try:
            fn()
            log(f"phase {name}: ok ({time.perf_counter() - t0:.1f}s)")
        except Exception:
            self.failed.append(name)
            log(f"phase {name}: FAILED")
            traceback.print_exc()
            sys.stdout.flush()

    # -- 1 ------------------------------------------------------------------
    def device(self):
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        line = out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
        print(line, flush=True)
        require(out.returncode == 0 and line, f"nvidia-smi failed: {out.stderr}")
        name, limit = [s.strip() for s in line.split(",", 1)]
        CARD.update(name=name, power_limit=limit)
        log(
            f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
            f"count {torch.cuda.device_count()}"
        )

    # -- 2 ------------------------------------------------------------------
    def build(self):
        from pmfm_tpu_torch.kernels import _build

        res = _build.build()
        log(f"nvcc: built={res['built']} in {res['seconds']:.1f}s -> {res['path']}")
        for name, regs, spill in ptxas_summary(res["log"]):
            print(f"  ptxas {name}: {regs} registers, {spill} bytes spill stores", flush=True)
        _build.library()

    # -- shared inputs --------------------------------------------------------
    def setup(self):
        from pmfm_tpu_torch.es import ESConfig, make_spectrum_ops
        from pmfm_tpu_torch.ops import synthesize_single, target_spectrum

        self.cfg = ESConfig(
            num_parents=MU, num_offspring=POP - MU, num_dimensions=D, topology=TOPOLOGY,
            audio_length_log2=LOG2N, synthesis_engine="scanless", spectrum_method="dft",
            dft_dtype="int8", mutation_noise="clt12", sine_order=7, fused_kernel=True,
            fused_generation=True, fused_evolve=False, pop_block=1024,
        )
        self.so = make_spectrum_ops(self.cfg, device=self.dev)
        audio = synthesize_single(torch.tensor(TRUTH), self.cfg.n_samples, TOPOLOGY)
        self.target = target_spectrum(audio.to(self.dev), self.so)
        self.mins = torch.tensor(self.cfg.param_mins, device=self.dev)
        self.maxs = torch.tensor(self.cfg.param_maxs, device=self.dev)
        rng = np.random.default_rng(SEED)
        cand = rng.random((POP, D)).astype(np.float32) * np.asarray(self.cfg.param_maxs, np.float32)
        cand[0] = TRUTH
        self.params = torch.from_numpy(cand).to(self.dev)
        self.parents_v = torch.from_numpy(rng.random((MU, D)).astype(np.float32)).to(self.dev)
        self.parents_s = torch.from_numpy(
            rng.uniform(0.02, 0.3, (MU, D)).astype(np.float32)
        ).to(self.dev)
        torch.cuda.synchronize()
        log(f"inputs: P={POP} D={D} n={self.cfg.n_samples} K={self.so.num_bins} "
            f"operand {tuple(self.so.dft_packed.shape)} {self.so.dft_packed.dtype}")

    def b1_kwargs(self, pop_block):
        c = self.cfg
        return dict(
            dft_packed=self.so.dft_packed, dft_scale=self.so.dft_packed_scale,
            topology=c.topology, n=c.n_samples, pop_block=pop_block, sine_order=c.sine_order,
        )

    def b2_kwargs(self, pop_block):
        from pmfm_tpu_torch.es.pipeline import fused_generation_kwargs

        return dict(fused_generation_kwargs(self.cfg, self.so), pop_block=pop_block)

    # -- 3 ------------------------------------------------------------------
    def b1_vs_plain(self):
        from pmfm_tpu_torch.kernels import synth_fitness as sf

        fk = sf.fused_synth_fitness(self.params, self.target, **self.b1_kwargs(POP))
        torch.cuda.synchronize()
        fp = sf.fused_synth_fitness_plain(self.params, self.target, **self.b1_kwargs(POP))
        require(fk.shape == (POP,) and torch.isfinite(fk).all(), "B1 fitness not finite")
        e = rel_err(fk, fp)
        mx, med = float(e.max()), float(e.median())
        rk, rp = int(torch.argmin(fk)), int(torch.argmin(fp))
        log(f"B1 vs plain: max rel {mx:.3e} median rel {med:.3e} (tolerance {FIT_MAX_REL:g} / "
            f"{FIT_MEDIAN_REL:g}); candidates > 1e-5: {int((e > 1e-5).sum())}; "
            f"truth rank kernel {rk} plain {rp}; truth fitness {float(fk[0]):.6g}")
        require(mx <= FIT_MAX_REL and med <= FIT_MEDIAN_REL, "B1 disagrees with its plain version")
        require(rk == 0 and rp == 0, "the known-params truth does not rank first")
        self.kernels["fused_synth_fitness"] = {"max_abs_err": float((fk - fp).abs().max())}

    # -- 4 ------------------------------------------------------------------
    def b2_vs_plain(self):
        from pmfm_tpu_torch.es import kernel_seed
        from pmfm_tpu_torch.kernels import generation as gn

        seed = kernel_seed(SEED, 0)
        fk, vk, sk = gn.fused_generation(seed, self.parents_v, self.parents_s, self.target,
                                         **self.b2_kwargs(POP))
        torch.cuda.synchronize()
        fp, vp, sp = gn.fused_generation_plain(
            seed, self.parents_v, self.parents_s, self.target, **self.b2_kwargs(POP)
        )
        require(vk.shape == (POP, D) and sk.shape == (POP, D), "B2 offspring shape")
        require(torch.isfinite(fk).all() and torch.isfinite(vk).all(), "B2 output not finite")
        v_diff = float((vk - vp).abs().max())
        s_rel = float(rel_err(sk, sp).max())
        e = rel_err(fk, fp)
        mx, med = float(e.max()), float(e.median())
        log(f"B2 vs plain: values max abs diff {v_diff:.3e} (must be 0), steps max rel "
            f"{s_rel:.3e} (tolerance {STEP_MAX_REL:g}), fitness max rel {mx:.3e} median rel "
            f"{med:.3e} (tolerance {FIT_MAX_REL:g} / {FIT_MEDIAN_REL:g})")
        require(v_diff == 0.0, "B2 offspring values are not bit-equal to the plain version")
        require(s_rel <= STEP_MAX_REL, "B2 offspring steps disagree with the plain version")
        require(mx <= FIT_MAX_REL and med <= FIT_MEDIAN_REL, "B2 fitness disagrees")
        # distribution of the draws both versions used (the counterpart of
        # the reference's hardware PRNG check)
        ib, cb, uw = gn.philox_draws(seed, POP, D, self.dev)
        u = gn.uniform01(uw)
        g = (u * 2.0 - 1.0).sum(0) / 12.0
        idx = (ib & 0x7FFFFFFF) % MU
        counts = torch.bincount(idx.reshape(-1), minlength=MU).to(torch.float64)
        expect = POP * D / MU
        chi2 = float(((counts - expect) ** 2 / expect).sum())
        coin = float((cb & 1).to(torch.float64).mean())
        gm, gv = float(g.mean()), float(g.var())
        log(f"B2 draws: CLT gaussian mean {gm:.3e} var {gv:.5f} (expect 0, {1 / 36:.5f}); "
            f"coin mean {coin:.4f}; parent-index chi2 {chi2:.1f} on {MU - 1} dof")
        m = POP * D  # draws of each kind; bounds at 6 standard errors
        require(abs(gm) < 6 * (1 / 36 / m) ** 0.5, "CLT draw mean off")
        require(abs(gv - 1 / 36) < 6 * (1 / 36) * (2 / m) ** 0.5, "CLT draw variance off")
        require(abs(coin - 0.5) < 6 * 0.5 / m**0.5, "coin not fair")
        require(chi2 < (MU - 1) + 6 * (2 * (MU - 1)) ** 0.5, "parent index not uniform")
        self.kernels["fused_generation"] = {"max_abs_err": float((fk - fp).abs().max())}

    # -- 4b -----------------------------------------------------------------
    def int8_settings(self):
        """(label, ESConfig) of each driven path besides the bench that runs
        B1/B2 in int8: the shipped config's int8 part (n 1024, sine order 9)
        and audio_match.json's (n 2048, pop 4096), the latter also at
        ``RAGGED_POP``."""
        from pmfm_tpu_torch.io import load_config

        audio = load_config(AUDIO_CONFIG).es
        return (("shipped int8 part", load_config(SHIPPED_CONFIG).es),
                ("audio_match int8 part", audio),
                ("audio_match int8 part, ragged P",
                 audio.replace(num_offspring=RAGGED_POP - audio.num_parents)))

    def fused_check(self, where, params, pv, ps, target, kw1, kw2, seed,
                   limits=(FIT_MAX_REL, FIT_MEDIAN_REL)):
        """B1 and B2 (int8, or true f32 with the f32 ``limits``) against their
        plain versions, B2's offspring values bit-equal and its fitness
        bit-equal to B1's on those offspring. The plain versions run as one
        batch: B2's plain offspring (``offspring_plain``, B2's plain prologue,
        with ``fused_generation_plain``'s defaults for what ``kw2`` leaves
        out) and ``params`` go through B1's plain version together, which is
        B1's and B2's plain fitness (its candidates are independent) at half
        the plain loop's launches. Returns the two fitness errors (max
        relative), the B1 fitness and the two max absolute errors."""
        import inspect

        from pmfm_tpu_torch.kernels import generation as gn
        from pmfm_tpu_torch.kernels import synth_fitness as sf

        pop = params.shape[0]
        fk = sf.fused_synth_fitness(params, target, **kw1)
        gk, vk, sk = gn.fused_generation(seed, pv, ps, target, **kw2)
        own = sf.fused_synth_fitness(gn.scale_rows(vk, kw2["param_mins"], kw2["param_maxs"]),
                                     target, **kw1)
        defaults = inspect.signature(gn.fused_generation_plain).parameters
        mutate = {k: kw2.get(k, defaults[k].default) for k in (
            "alpha", "beta", "beta_scale", "root_two_over_pi", "clamp_values", "min_step")}
        vp, sp = gn.offspring_plain(pv, ps, pop=kw2["pop"], seed=seed, **mutate)
        both = torch.cat([params, gn.scale_rows(vp, kw2["param_mins"], kw2["param_maxs"])])
        plain = sf.fused_synth_fitness_plain(both, target, **dict(kw1, pop_block=both.shape[0]))
        fp, gp = plain[:pop], plain[pop:]
        torch.cuda.synchronize()
        e1, e2 = rel_err(fk, fp), rel_err(gk, gp)
        s_rel = float(rel_err(sk, sp).max())
        max_rel, median_rel = limits
        ok = (bool(torch.isfinite(fk).all() and torch.isfinite(gk).all())
              and float(e1.max()) <= max_rel and float(e1.median()) <= median_rel
              and float(e2.max()) <= max_rel and float(e2.median()) <= median_rel
              and torch.equal(vk, vp) and s_rel <= STEP_MAX_REL and torch.equal(gk, own))
        if not ok:
            log(f"FAIL {where}: B1 max rel {float(e1.max()):.3e} median {float(e1.median()):.3e}; "
                f"B2 max rel {float(e2.max()):.3e} median {float(e2.median()):.3e}, values equal "
                f"{torch.equal(vk, vp)}, steps max rel {s_rel:.3e}, fitness equal to B1 on its "
                f"offspring {torch.equal(gk, own)}")
        require(ok, f"B1/B2 disagree ({where})")
        return (float(e1.max()), float(e2.max()), fk, float((fk - fp).abs().max()),
                float((gk - gp).abs().max()))

    def int8_grid(self):
        """B1/B2 int8 at the shipped and audio_match settings (the truth
        planted first), then over GRID_N x GRID_TOPOLOGIES x GRID_SINE_ORDERS
        x GRID_POPS (and P 2^15 at n 1024), and at GRID_ODD_BINS, against a
        random target."""
        from pmfm_tpu_torch.es import kernel_seed
        from pmfm_tpu_torch.ops import spectral
        from pmfm_tpu_torch.ops.synthesis import topology_dims

        for i, (label, cfg) in enumerate(self.int8_settings()):
            c = self.inputs(cfg, SEED + 40 + i)
            require(c["so"].dft_packed.dtype == torch.int8, f"{label}: not the int8 operand")
            where = (f"{label}: n={cfg.n_samples}, P={cfg.population_size}, sine order "
                     f"{cfg.sine_order}")
            e1, e2, fk, _, _ = self.fused_check(
                where, c["params"], c["pv"], c["ps"], c["target"], self.kw_b1(c), self.kw_b2(c),
                kernel_seed(SEED, 50 + i))
            log(f"B1/B2 int8 vs plain ({where}): fitness max rel B1 {e1:.3e} B2 {e2:.3e}; B2 "
                f"values bit-equal, B2 fitness bit-equal to B1 on its offspring; truth rank "
                f"{int(torch.argmin(fk))}")
            require(int(torch.argmin(fk)) == 0, "the known-params truth does not rank first")
        self.grid("int8", GRID_POPS, (FIT_MAX_REL, FIT_MEDIAN_REL), SEED + 30, 1000)

    def grid(self, dtype, grid_pops, limits, seed, seeds, topologies=GRID_TOPOLOGIES,
             orders=GRID_SINE_ORDERS):
        """B1/B2 in ``dtype`` ("int8" or "float32") over GRID_N x
        ``topologies`` x ``orders`` x ``grid_pops`` (and P 2^15 at n 1024),
        and at GRID_ODD_BINS, against a random target, within ``limits``; the
        data from ``seed``, the kernel seeds from ``seeds``."""
        from pmfm_tpu_torch.es import kernel_seed
        from pmfm_tpu_torch.ops import spectral
        from pmfm_tpu_torch.ops.synthesis import topology_dims

        rng = np.random.default_rng(seed)
        cases = 0
        for n, bins in [(n, None) for n in GRID_N] + [GRID_ODD_BINS]:
            so = spectral.make_spectrum_ops(n, bins, dft_dtype=dtype, device=self.dev)
            tgt = torch.from_numpy(rng.uniform(0.0, 50.0, so.num_bins).astype(np.float32)).to(
                self.dev)
            worst, count = [0.0, 0.0], 0
            pops = grid_pops + ((POP,) if n == 1 << LOG2N and bins is None else ())
            for topology in topologies:
                d = topology_dims(topology)
                mins, maxs = (0.0,) * d, param_maxs(topology)
                for order in orders:
                    for pop in pops:
                        params = torch.from_numpy(
                            (rng.random((pop, d)) * np.asarray(maxs)).astype(np.float32)
                        ).to(self.dev)
                        pv = torch.from_numpy(rng.random((MU, d)).astype(np.float32)).to(self.dev)
                        ps = torch.from_numpy(
                            rng.uniform(0.02, 0.3, (MU, d)).astype(np.float32)).to(self.dev)
                        kw1 = dict(dft_packed=so.dft_packed, dft_scale=so.dft_packed_scale,
                                   topology=topology, n=n, pop_block=pop, sine_order=order)
                        kw2 = dict(kw1, pop=pop, param_mins=mins, param_maxs=maxs)
                        where = f"{dtype}, {topology}, n={n}, P={pop}, sine order {order}"
                        e = self.fused_check(where, params, pv, ps, tgt, kw1, kw2,
                                            kernel_seed(SEED, seeds + cases), limits)
                        worst = [max(worst[0], e[0]), max(worst[1], e[1])]
                        count += 1
                        cases += 1
            log(f"B1/B2 {dtype} grid, n={n} (K={so.num_bins}): {count} settings ({topologies} "
                f"x sine orders {orders} x P {pops}) within {limits[0]:g} / "
                f"{limits[1]:g}, worst max rel B1 {worst[0]:.3e} B2 {worst[1]:.3e}; B2 values "
                f"bit-equal, B2 fitness bit-equal to B1 on its offspring")

    # -- 5 ------------------------------------------------------------------
    def evolve_run(self, cfg, name):
        from pmfm_tpu_torch.es import evolve, init_state

        evolve(init_state(1, cfg, device=self.dev), self.target, 2, self.so, cfg)  # warm-up
        state = init_state(7, cfg, device=self.dev)
        torch.cuda.synchronize()
        self.reset_counts()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        final, traj = evolve(state, self.target, GENERATIONS, self.so, cfg, record_trajectory=True)
        b.record()
        b.synchronize()
        launches = self.read_counts()
        ms = a.elapsed_time(b)
        traj = traj.cpu()
        best = (self.mins + final.best_values * (self.maxs - self.mins)).cpu().tolist()
        log(f"evolve ({name}): {GENERATIONS} generations {ms / GENERATIONS:.4f} ms/gen, "
            f"{POP * GENERATIONS / (ms / 1e3):.4g} candidate-evals/s {card()}; best fitness "
            f"first {float(traj[0]):.6g} final {float(traj[-1]):.6g}; recovered "
            f"{[round(x, 3) for x in best]}; launches {launches}")
        require(traj.shape == (GENERATIONS,) and torch.isfinite(traj).all(), "trajectory")
        require(bool((traj[1:] <= traj[:-1]).all()), "best-ever fitness must not increase")
        require(float(traj[-1]) < float(traj[0]), "evolve did not improve the best fitness")
        require(bool(torch.isfinite(final.best_values).all()), "best values not finite")
        return launches, ms / GENERATIONS

    def evolve_both(self):
        la, self.cell_ms["a"] = self.evolve_run(self.cfg, "a: fused_generation -> B2")
        require(la["fused_generation"] == GENERATIONS, "B2 launches != generations")
        require(sum(la.values()) == GENERATIONS, "setting (a) launched another kernel")
        cfg_b = self.cfg.replace(fused_generation=False)
        lb, _ = self.evolve_run(cfg_b, "b: fused_kernel -> torch offspring + B1")
        require(lb["fused_synth_fitness"] >= GENERATIONS, "B1 launches < generations")
        require(lb["fused_synth_fitness"] == sum(lb.values()), "setting (b) launched another kernel")
        self.kernels.setdefault("fused_generation", {})["launches"] = la["fused_generation"]
        self.kernels.setdefault("fused_synth_fitness", {})["launches"] = lb["fused_synth_fitness"]

    # -- 6 ------------------------------------------------------------------
    def timings(self):
        from pmfm_tpu_torch.es import kernel_seed
        from pmfm_tpu_torch.kernels import generation as gn
        from pmfm_tpu_torch.kernels import synth_fitness as sf

        n, k = self.cfg.n_samples, self.so.num_bins
        operand = 2 * k * (n // 2)
        f32_ops = synth_ops_f32(POP, n, k, kn=3, ncoef=4)
        int8_ops = 2.0 * 2 * k * (n // 2) * POP
        seed = kernel_seed(SEED, 1)
        b1 = lambda: sf.fused_synth_fitness(self.params, self.target, **self.b1_kwargs(POP))  # noqa: E731
        b1_plain = lambda: sf.fused_synth_fitness_plain(  # noqa: E731
            self.params, self.target, **self.b1_kwargs(POP))
        b2 = lambda: gn.fused_generation(seed, self.parents_v, self.parents_s, self.target,  # noqa: E731
                                         **self.b2_kwargs(POP))
        b2_plain = lambda: gn.fused_generation_plain(  # noqa: E731
            seed, self.parents_v, self.parents_s, self.target, **self.b2_kwargs(POP))
        rows = {
            "fused_synth_fitness": (
                b1, b1_plain, POP * D * 4 + operand + k * 4 + POP * 4, 0.0,
                "pmfm_tpu_torch/csrc/fused_eval.cu", "pmfm_tpu/kernels/synth_fitness.py:767",
            ),
            "fused_generation": (
                b2, b2_plain, 2 * MU * D * 4 + operand + k * 4 + POP * 4 + 2 * POP * D * 4,
                POP * D * 12 * 2.0,  # CLT sums and the mutation, f32
                "pmfm_tpu_torch/csrc/fused_eval.cu", "pmfm_tpu/kernels/generation.py:438",
            ),
        }
        for name, (fn, plain, nbytes, extra_f32, src, replaces) in rows.items():
            ms = cuda_ms(fn, TIMED_LAUNCHES)
            plain_ms = cuda_ms(plain, PLAIN_RUNS)
            bound_ms, by = bound(nbytes, int8_ops, f32_ops + extra_f32)
            log(f"{name}: kernel {ms:.4f} ms (median of {TIMED_LAUNCHES}), plain {plain_ms:.2f} ms "
                f"(median of {PLAIN_RUNS}), bound {bound_ms:.4f} ms by {by} "
                f"({nbytes / 1e6:.2f} MB, {int8_ops / 1e9:.1f} G int8 ops, "
                f"{(f32_ops + extra_f32) / 1e9:.2f} G f32 ops) {card()}")
            self.kernels.setdefault(name, {}).update(
                route="cuda", source=src, replaces=replaces, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, library_ms=None,
            )
        self.split()

    def split(self):
        """How B1/B2 int8 split at the bench shape: B1 and B2 with an operand
        and target of SPLIT_BINS bins (synthesis, fold, launch and, in B2, the
        offspring prologue: the DFT nearly gone), B2 - B1 (the prologue), and
        the DFT half alone as ``torch._int_mm`` of candidate-major a+/-
        against the operand's halves (a yardstick: the port never calls it)."""
        from pmfm_tpu_torch.es import kernel_seed
        from pmfm_tpu_torch.kernels import generation as gn
        from pmfm_tpu_torch.kernels import synth_fitness as sf

        n, k = self.cfg.n_samples, self.so.num_bins
        op = self.so.dft_packed
        op_s = torch.cat([op[:SPLIT_BINS], op[k : k + SPLIT_BINS]]).contiguous()
        tgt_s = self.target[:SPLIT_BINS].contiguous()
        kw1 = dict(self.b1_kwargs(POP), dft_packed=op_s)
        kw2 = dict(self.b2_kwargs(POP), dft_packed=op_s)
        seed = kernel_seed(SEED, 1)
        s1_ms = cuda_ms(lambda: sf.fused_synth_fitness(self.params, tgt_s, **kw1),
                        TIMED_LAUNCHES)
        s2_ms = cuda_ms(lambda: gn.fused_generation(seed, self.parents_v, self.parents_s, tgt_s,
                                                    **kw2), TIMED_LAUNCHES)
        b1_ms = self.kernels["fused_synth_fitness"]["ms"]
        b2_ms = self.kernels["fused_generation"]["ms"]
        g = torch.Generator(device=self.dev).manual_seed(SEED)
        ap, am = (torch.randint(-126, 127, (POP, n // 2), generator=g, device=self.dev,
                                dtype=torch.int8) for _ in range(2))
        cos_t, sin_t = op[:k].T, op[k:].T  # (N/2, K) views
        mm_ms = cuda_ms(lambda: (torch._int_mm(ap, cos_t), torch._int_mm(am, sin_t)),
                        TIMED_LAUNCHES)
        tops = 2.0 * 2 * k * (n // 2) * POP / (mm_ms * 1e-3) / 1e12
        log(f"B1/B2 int8 split (n={n}, K={k}, P={POP}): B1 {b1_ms:.4f} ms; B1 with {SPLIT_BINS} "
            f"bins (synthesis + fold + launch) {s1_ms:.4f} ms; B1 minus that (the DFT and its "
            f"epilogue) {b1_ms - s1_ms:.4f} ms; B2 - B1 (the offspring prologue) "
            f"{b2_ms - b1_ms:.4f} ms, with {SPLIT_BINS} bins {s2_ms - s1_ms:.4f} ms; yardstick "
            f"torch._int_mm U+V on candidate-major a+/- {mm_ms:.4f} ms ({tops:.1f} int8 TOP/s) "
            f"{card()}")

    # -- large frames: shared inputs -------------------------------------------
    @staticmethod
    def counters():
        from pmfm_tpu_torch import kernels

        return {name: getattr(kernels, name) for name in kernels.__all__}

    def reset_counts(self):
        for fn in self.counters().values():
            fn.launches = 0
            if hasattr(fn, "launches_by"):
                fn.launches_by.clear()

    def read_counts(self):
        return {name: fn.launches for name, fn in self.counters().items()}

    def large_setup(self):
        from pmfm_tpu_torch.es import make_spectrum_ops
        from pmfm_tpu_torch.ops import synthesize_single, target_spectrum

        self.cells = {}
        rng = np.random.default_rng(SEED + 1)
        for key, log2n, pop in (("fold", FOLD_LOG2N, FOLD_POP), ("stream", STREAM_LOG2N, STREAM_POP)):
            cfg = self.cfg.replace(audio_length_log2=log2n, num_offspring=pop - MU)
            t0 = time.perf_counter()
            so = make_spectrum_ops(cfg, device=self.dev)
            audio = synthesize_single(torch.tensor(TRUTH), cfg.n_samples, TOPOLOGY,
                                      engine="scanless")
            target = target_spectrum(audio.to(self.dev), so)
            cand = (rng.random((pop, D)) * np.asarray(cfg.param_maxs)).astype(np.float32)
            cand[0] = TRUTH
            params = torch.from_numpy(cand).to(self.dev)
            torch.cuda.synchronize()
            self.cells[key] = dict(cfg=cfg, so=so, target=target, params=params)
            log(f"inputs ({key}): n={cfg.n_samples} P={pop} K={so.num_bins} method {so.method}, "
                f"operands and target built in {time.perf_counter() - t0:.2f}s")

    def fold_spectrum(self, key, outs):
        from pmfm_tpu_torch.ops import spectral

        c = self.cells[key]
        return spectral.spectral_fitness(
            spectral.magnitude_spectrum_prefolded(*outs, c["so"]), c["target"])

    def stream_spectrum(self, key, audio):
        from pmfm_tpu_torch.ops import spectral

        c = self.cells[key]
        return spectral.spectral_fitness(
            spectral.magnitude_spectrum_factored(audio, c["so"], prewindowed=True), c["target"])

    # -- 7 ------------------------------------------------------------------
    def b3_vs_plain(self):
        """B3 at the settings of each path that runs it: cell (c), and
        match_audio's int8 engine and refine tail (bf16 mode, sine order 9),
        in the layout the wrapper picks and in the other one; then over the
        grid (``fold_grid``)."""
        from pmfm_tpu_torch.kernels import synth_fold as sfo

        c = self.cells["fold"]
        n, scale = c["cfg"].n_samples, c["so"].dft_packed_scale
        _, mcfg = match_config()
        rcfg = mcfg.refine_config()
        require(mcfg.n_samples == n, "the match phase's n differs from cell (c)'s")
        worst = 0.0
        for mode, cfg, dft_scale in (("int8, cell (c)", c["cfg"], scale),
                                     ("int8, match_audio", mcfg, scale),
                                     ("bf16, match_audio refine tail", rcfg, 0.0)):
            pop = cfg.population_size
            params = c["params"][:pop]
            kw = dict(topology=cfg.topology, n=n, sine_order=cfg.sine_order, dft_scale=dft_scale)
            k = sfo.fused_synth_fold(params, **kw)
            torch.cuda.synchronize()
            p = sfo.fused_synth_fold_plain(params, pop_block=pop, **kw)
            auto = sfo.fold_geometry(pop, n, dft_scale > 0, cfg.topology)["time_parallel"]
            with fold_layout(sfo, not auto):
                other = sfo.fused_synth_fold(params, **kw)
            diffs = [float((a.float() - b.float()).abs().max()) for a, b in zip(k, p)]
            diffs_other = [float((a.float() - b.float()).abs().max()) for a, b in zip(other, p)]
            log(f"B3 vs plain ({mode}: n={n}, P={pop}, sine order {cfg.sine_order}, "
                f"{'time-parallel' if auto else 'single-pass'} layout): max abs "
                f"diff a+ {diffs[0]} a- {diffs[1]} edge {diffs[2]} mag_scale {diffs[3]} "
                f"(must be 0); the other layout {max(diffs_other)}; a+/- {k[0].dtype} "
                f"{tuple(k[0].shape)}")
            require(k[0].dtype == (torch.int8 if dft_scale > 0 else torch.bfloat16), "B3 dtype")
            require(all(torch.isfinite(x.float()).all() for x in k), "B3 output not finite")
            require(all(d == 0.0 for d in diffs + diffs_other),
                    "B3 is not bit-equal to its plain version")
            worst = max(worst, *diffs, *diffs_other)
            del other
            if cfg is c["cfg"]:
                fit = self.fold_spectrum("fold", k)
                log(f"B3 + folded int8 DFT: truth rank {int(torch.argmin(fit))}, truth fitness "
                    f"{float(fit[0]):.6g}")
                require(int(torch.argmin(fit)) == 0, "the known-params truth does not rank first")
        self.kernels["fused_synth_fold"] = {"max_abs_err": worst}
        self.fold_grid()

    def fold_grid(self):
        """B3 bit-equal to its plain version over FOLD_GRID in both modes and
        both layouts, at each of LARGE_GRID_POPS."""
        from pmfm_tpu_torch.kernels import synth_fold as sfo

        t0, checked, big = time.perf_counter(), 0, max(LARGE_GRID_POPS)
        for topology, order, n in FOLD_GRID:
            t1 = time.perf_counter()
            params = self.grid_params(topology, big, n + order)
            for int8 in (True, False):
                kw = dict(topology=topology, n=n, sine_order=order, dft_scale=1e-5 if int8 else 0.0)
                want = sfo.fused_synth_fold_plain(params, pop_block=big, **kw)
                for pop in LARGE_GRID_POPS:
                    for tp in (True, False):
                        with fold_layout(sfo, tp):
                            got = sfo.fused_synth_fold(params[:pop], **kw)
                        ok = all(torch.equal(a, b[..., :pop] if a.dim() == 2 else b[:pop])
                                 for a, b in zip(got, want))
                        require(ok, f"B3 is not bit-equal to its plain version: {topology} n={n} "
                                    f"sine order {order} P={pop} {'int8' if int8 else 'bf16'} "
                                    f"time_parallel={tp}")
                        checked += 1
            log(f"B3 grid {topology}, sine order {order}, n={n}: int8 and bf16, both layouts, "
                f"bit-equal at P {LARGE_GRID_POPS} ({time.perf_counter() - t1:.1f}s)")
        log(f"B3 grid: {checked} settings bit-equal in {time.perf_counter() - t0:.1f}s")

    def fold_layouts(self):
        """B3's two layouts timed over FOLD_LAYOUT_SHAPES x FOLD_LAYOUT_POPS,
        each beside the one the wrapper takes."""
        from pmfm_tpu_torch.kernels import synth_fold as sfo

        big = max(FOLD_LAYOUT_POPS)
        for topology, order, n, int8 in FOLD_LAYOUT_SHAPES:
            params = self.grid_params(topology, big, n + order)
            kw = dict(topology=topology, n=n, sine_order=order, dft_scale=1e-5 if int8 else 0.0)
            for pop in FOLD_LAYOUT_POPS:
                p = params[:pop]
                t = {}
                for tp in (True, False):
                    with fold_layout(sfo, tp):
                        t[tp] = cuda_ms(lambda: sfo.fused_synth_fold(p, **kw), TIMED_LAUNCHES)
                pick = sfo.fold_geometry(pop, n, int8, topology)["time_parallel"]
                log(f"B3 layouts ({topology}, sine order {order}, n={n}, "
                    f"{'int8' if int8 else 'bf16'}, P={pop}): time-parallel {t[True]:.4f} ms, "
                    f"single pass {t[False]:.4f} ms; the wrapper takes the "
                    f"{'time-parallel' if pick else 'single-pass'} one, "
                    f"{100 * (t[pick] / min(t.values()) - 1):.1f}% over the faster {card()}")

    def grid_params(self, topology, pop, seed):
        """``pop`` candidates of ``topology`` uniform in (0, 3520 Hz) x (0, 8)
        pairs, from ``seed``, on the card."""
        from pmfm_tpu_torch.ops.synthesis import topology_dims

        d = topology_dims(topology)
        maxs = np.asarray((3520.0, 8.0) * (d // 2), np.float32)
        rng = np.random.default_rng(seed)
        return torch.from_numpy((rng.random((pop, d)) * maxs).astype(np.float32)).to(self.dev)

    # -- 8 ------------------------------------------------------------------
    def b4_vs_plain(self):
        """B4 at cell (d)'s settings (bf16 audio) and at its refine tail's
        (f32 audio, sine order 9)."""
        from pmfm_tpu_torch.kernels import synth_stream as sst

        c = self.cells["stream"]
        worst = 0.0
        for audio_f32, cfg in ((False, c["cfg"]), (True, c["cfg"].refine_config())):
            kw = dict(topology=cfg.topology, n=cfg.n_samples, sine_order=cfg.sine_order)
            k = sst.fused_synth_stream(c["params"], c["so"].window, audio_f32=audio_f32, **kw)
            torch.cuda.synchronize()
            p = sst.fused_synth_stream_plain(c["params"], c["so"].window, audio_f32=audio_f32,
                                             pop_block=STREAM_POP, **kw)
            diff = float((k.float() - p.float()).abs().max())
            log(f"B4 vs plain ({'f32' if audio_f32 else 'bf16'}: n={kw['n']}, P={STREAM_POP}, "
                f"sine order {cfg.sine_order}): max abs diff {diff} (must be 0); audio "
                f"{k.dtype} {tuple(k.shape)}")
            require(bool(torch.isfinite(k.float()).all()), "B4 audio not finite")
            require(diff == 0.0, "B4 is not bit-equal to its plain version")
            worst = max(worst, diff)
            if not audio_f32:
                fit = self.stream_spectrum("stream", k)
                log(f"B4 + factored DFT: truth rank {int(torch.argmin(fit))}, truth fitness "
                    f"{float(fit[0]):.6g}")
                require(int(torch.argmin(fit)) == 0, "the known-params truth does not rank first")
            del k, p
        self.kernels["fused_synth_stream"] = {"max_abs_err": worst}
        self.stream_grid()

    def stream_grid(self):
        """B4 bit-equal to its plain version over STREAM_GRID in both modes,
        at each of LARGE_GRID_POPS. The plain version runs once a setting in
        f32: its bf16 output is the same f32 audio rounded by ``.to`` (it
        writes ``audio.to(out.dtype)``), so the kernel's bf16 audio is held
        against that rounding."""
        from pmfm_tpu_torch.kernels import synth_stream as sst
        from pmfm_tpu_torch.ops import hann_window

        t0, checked, big = time.perf_counter(), 0, max(LARGE_GRID_POPS)
        for topology, order, n in STREAM_GRID:
            t1 = time.perf_counter()
            params = self.grid_params(topology, big, n + order)
            win = torch.from_numpy(hann_window(n).astype(np.float32)).to(self.dev)
            kw = dict(topology=topology, n=n, sine_order=order)
            want = sst.fused_synth_stream_plain(params, win, audio_f32=True, pop_block=big, **kw)
            for audio_f32 in (False, True):
                ref = want if audio_f32 else want.to(torch.bfloat16)
                for pop in LARGE_GRID_POPS:
                    got = sst.fused_synth_stream(params[:pop], win, audio_f32=audio_f32, **kw)
                    require(torch.equal(got, ref[:, :pop]),
                            f"B4 is not bit-equal to its plain version: {topology} n={n} sine "
                            f"order {order} P={pop} {'f32' if audio_f32 else 'bf16'}")
                    checked += 1
            log(f"B4 grid {topology}, sine order {order}, n={n}: bf16 and f32 bit-equal at P "
                f"{LARGE_GRID_POPS} ({time.perf_counter() - t1:.1f}s)")
            del want
        log(f"B4 grid: {checked} settings bit-equal in {time.perf_counter() - t0:.1f}s")

    # -- 9 ------------------------------------------------------------------
    def evolve_large(self):
        from pmfm_tpu_torch.es import active_engine, evolve, init_state
        from pmfm_tpu_torch.kernels import fused_synth_fold, fused_synth_stream

        cells = (("fold", "c", FOLD_GENERATIONS, "fused_synth_fold", "synth_fold"),
                 ("stream", "d", STREAM_GENERATIONS, "fused_synth_stream", "synth_stream"))
        for key, label, gens, kernel, engine in cells:
            c = self.cells[key]
            cfg, so, target = c["cfg"], c["so"], c["target"]
            require(active_engine(cfg, so) == engine, f"cell ({label}) routes to "
                    f"{active_engine(cfg, so)}, not {engine}")
            evolve(init_state(1, cfg, device=self.dev), target, 1, so, cfg)  # warm-up
            state = init_state(7, cfg, device=self.dev)
            torch.cuda.synchronize()
            self.reset_counts()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            final, traj = evolve(state, target, gens, so, cfg, record_trajectory=True)
            b.record()
            b.synchronize()
            counts = self.read_counts()
            ms = a.elapsed_time(b) / gens
            pop = cfg.population_size
            traj = traj.cpu()
            log(f"evolve ({label}: {engine}, n={cfg.n_samples}, P={pop}): {gens} generations "
                f"{ms:.4f} ms/gen, {pop * gens / (ms * gens / 1e3):.4g} candidate-evals/s "
                f"{card()}; best fitness first {float(traj[0]):.6g} final {float(traj[-1]):.6g}; "
                f"launches {counts}")
            require(counts[kernel] == gens, f"{kernel} launches != generations")
            require(all(v == 0 for n_, v in counts.items() if n_ != kernel),
                    f"cell ({label}) launched another kernel")
            require(traj.shape == (gens,) and torch.isfinite(traj).all(), "trajectory")
            require(bool((traj[1:] <= traj[:-1]).all()), "best-ever fitness must not increase")
            require(float(traj[-1]) < float(traj[0]), "evolve did not improve the best fitness")
            self.kernels[kernel]["launches"] = counts[kernel]
            self.cell_ms[key] = ms
            # where the time goes: the kernel and the spectrum + fitness at
            # this cell's shapes, each timed alone
            p = c["params"]
            if key == "fold":
                kern = lambda: fused_synth_fold(  # noqa: E731
                    p, topology=TOPOLOGY, n=cfg.n_samples, sine_order=cfg.sine_order,
                    dft_scale=so.dft_packed_scale)
                outs = kern()
                dft = lambda: self.fold_spectrum(key, outs)  # noqa: E731
            else:
                kern = lambda: fused_synth_stream(  # noqa: E731
                    p, so.window, topology=TOPOLOGY, n=cfg.n_samples, sine_order=cfg.sine_order)
                outs = kern()
                dft = lambda: self.stream_spectrum(key, outs)  # noqa: E731
            k_ms, d_ms = cuda_ms(kern, 5), cuda_ms(dft, 5)
            log(f"cell ({label}) per generation: kernel {k_ms:.4f} ms ({100 * k_ms / ms:.1f}%), "
                f"spectrum + fitness {d_ms:.4f} ms ({100 * d_ms / ms:.1f}%), rest "
                f"{ms - k_ms - d_ms:.4f} ms (offspring, select) {card()}")
            del outs

    # -- 10 -----------------------------------------------------------------
    def match(self):
        from pmfm_tpu_torch.es import match_audio
        from pmfm_tpu_torch.io import read_wav

        rc, cfg = match_config()
        audio, sr = read_wav(rc.input_audio_path)
        require(sr == cfg.sample_rate, f"{rc.input_audio_path}: {sr} Hz")
        n, g, r = cfg.n_samples, MATCH_GENERATIONS, MATCH_REFINE
        torch.cuda.synchronize()
        self.reset_counts()
        t0 = time.perf_counter()
        res = match_audio(audio, cfg, seed=SEED, num_generations=g, record_trajectory=True,
                          device=self.dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = self.read_counts()
        log(f"match_audio ({MATCH_CONFIG}, n={n}, P={cfg.population_size}, {g} generations, "
            f"the last {r} refine): {len(res.chunks)} chunks of {n} samples from a file of "
            f"{len(audio)} samples in {seconds:.2f}s {card()}; launches {counts}")
        require(len(res.chunks) == len(audio) // n == 2, "chunk count")
        require(res.output_audio.shape == (2 * n,) and np.isfinite(res.output_audio).all(),
                "output audio")
        for i, ch in enumerate(res.chunks):
            t = ch.trajectory
            log(f"chunk {i}: best fitness before refine {t[g - r - 1]:.6g} (int8 engine), "
                f"rescored at the refine boundary {ch.refine_start_fitness:.6g}, after refine "
                f"{ch.best_fitness:.6g} (f32 target); params "
                f"{[round(float(x), 3) for x in ch.best_params_scaled]}")
            require(t.shape == (g,) and np.isfinite(t).all(), "chunk trajectory")
            require(bool(np.all(np.diff(t[: g - r]) <= 0) and np.all(np.diff(t[g - r :]) <= 0)),
                    "best-ever fitness must not increase")
            require(ch.best_fitness <= ch.refine_start_fitness, "the refine tail made it worse")
        # per chunk: g - r int8 generations, one bf16 rescore, r bf16 generations
        require(counts["fused_synth_fold"] == 2 * (g + 1), "B3 launches")
        require(counts["fused_synth_fitness"] == counts["fused_generation"] ==
                counts["fused_synth_stream"] == counts["fused_evolve"] == 0,
                "match_audio launched another kernel")

    # -- 11 -----------------------------------------------------------------
    def large_timings(self):
        from pmfm_tpu_torch.kernels import synth_fold as sfo
        from pmfm_tpu_torch.kernels import synth_stream as sst
        from pmfm_tpu_torch.ops import spectral

        cf, cs = self.cells["fold"], self.cells["stream"]
        nf, ns = cf["cfg"].n_samples, cs["cfg"].n_samples
        kf = dict(topology=TOPOLOGY, n=nf, sine_order=7, dft_scale=cf["so"].dft_packed_scale)
        ks = dict(topology=TOPOLOGY, n=ns, sine_order=7)
        b3 = lambda: sfo.fused_synth_fold(cf["params"], **kf)  # noqa: E731
        b3_plain = lambda: sfo.fused_synth_fold_plain(cf["params"], pop_block=FOLD_POP, **kf)  # noqa: E731
        b4 = lambda: sst.fused_synth_stream(cs["params"], cs["so"].window, **ks)  # noqa: E731
        b4_plain = lambda: sst.fused_synth_stream_plain(  # noqa: E731
            cs["params"], cs["so"].window, pop_block=STREAM_POP, **ks)
        # 44 f32 operations a sample (B3: the int8 rounding last); B4 swaps the
        # rounding for the amplitude and window multiplies (45)
        rows = {
            "fused_synth_fold": (
                b3, b3_plain, FOLD_POP * D * 4 + nf * FOLD_POP + 8 * FOLD_POP,
                synth_ops_f32(FOLD_POP, nf, 0, kn=3, ncoef=4),
                "pmfm_tpu_torch/csrc/large_frame.cu", "pmfm_tpu/kernels/synth_fold.py:176",
            ),
            "fused_synth_stream": (
                b4, b4_plain, STREAM_POP * D * 4 + ns * 4 + ns * STREAM_POP * 2,
                synth_ops_f32(STREAM_POP, ns, 0, kn=3, ncoef=4) + float(STREAM_POP) * ns,
                "pmfm_tpu_torch/csrc/large_frame.cu", "pmfm_tpu/kernels/synth_stream.py:161",
            ),
        }
        for name, (fn, plain, nbytes, f32_ops, src, replaces) in rows.items():
            ms = cuda_ms(fn, TIMED_LAUNCHES)
            plain_ms = cuda_ms(plain, PLAIN_RUNS)
            bound_ms, by = bound(nbytes, 0.0, f32_ops)
            share = 100 * ms / self.cell_ms["fold" if "fold" in name else "stream"]
            log(f"{name}: kernel {ms:.4f} ms (median of {TIMED_LAUNCHES}), plain {plain_ms:.2f} ms "
                f"(median of {PLAIN_RUNS}), bound {bound_ms:.4f} ms by {by} "
                f"({nbytes / 1e6:.1f} MB, {f32_ops / 1e9:.2f} G f32 ops), {share:.1f}% of its "
                f"cell's generation {card()}")
            self.kernels.setdefault(name, {}).update(
                route="cuda", source=src, replaces=replaces, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, library_ms=None,
            )
        self.fold_layouts()
        # B3 at cell (e)'s shape (match_audio: pop 4096, its int8 engine and
        # bf16 refine tail)
        mcfg = match_config()[1]
        for label, cfg, scale in (("int8 engine", mcfg, cf["so"].dft_packed_scale),
                                  ("bf16 refine tail", mcfg.refine_config(), 0.0)):
            p = cf["params"][: cfg.population_size]
            ms = cuda_ms(lambda: sfo.fused_synth_fold(p, topology=cfg.topology, n=nf,
                                                      sine_order=cfg.sine_order, dft_scale=scale),
                         TIMED_LAUNCHES)
            log(f"B3 at cell (e)'s shape (match_audio {label}: n={nf}, P={cfg.population_size}, "
                f"sine order {cfg.sine_order}): {ms:.4f} ms {card()}")
        # the spectra outside the kernels, at the same shapes
        so_f, so_s = cf["so"], cs["so"]
        outs = b3()
        k = so_f.num_bins
        int8_ops = 2.0 * 2 * k * (nf // 2) * FOLD_POP
        ms = cuda_ms(lambda: spectral.prefolded_uv(outs[0], outs[1], so_f), 5)
        log(f"prefolded int8 DFT (torch._int_mm int8 x int8 -> int32, U and V as "
            f"a+^T @ cos^T on B3's candidate-major a+/-), n={nf} P={FOLD_POP}: {ms:.4f} ms, "
            f"{int8_ops / (ms * 1e-3) / 1e12:.1f} int8 TOP/s {card()}")
        tm = [x.contiguous() for x in outs[:2]]  # the time-major layout, for comparison
        ms_tm = cuda_ms(lambda: (torch._int_mm(so_f.dft_packed[:k], tm[0]),
                                 torch._int_mm(so_f.dft_packed[k:], tm[1])), 5)
        log(f"  the same product on time-major a+/- (cos @ a+): {ms_tm:.4f} ms, "
            f"{int8_ops / (ms_tm * 1e-3) / 1e12:.1f} int8 TOP/s {card()}")
        del tm
        ms = cuda_ms(lambda: self.fold_spectrum("fold", outs), 5)
        log(f"prefolded int8 spectrum + fitness (with the epilogue): {ms:.4f} ms {card()}")
        del outs
        rcfg = match_config()[1].refine_config()
        bf = sfo.fused_synth_fold(cf["params"][: rcfg.population_size], topology=rcfg.topology,
                                  n=nf, sine_order=rcfg.sine_order, dft_scale=0.0)
        so_r = spectral.make_spectrum_ops(nf, dft_dtype="float32", device=self.dev)
        ms = cuda_ms(lambda: spectral.magnitude_spectrum_prefolded(*bf, so_r), 5)
        log(f"prefolded bf16 spectrum (refine tail: f32 operand rounded to bf16 once, "
            f"torch.mm(out_dtype=float32): bf16 products, float32 sums), n={nf} "
            f"P={rcfg.population_size}: {ms:.4f} ms {card()}")
        del bf, so_r
        audio = b4()
        ms = cuda_ms(lambda: spectral.magnitude_spectrum_factored(audio, so_s, prewindowed=True), 3)
        log(f"factored DFT bf16 (torch.mm/bmm out_dtype=float32), n={ns} P={STREAM_POP}: "
            f"{ms:.4f} ms {card()}")
        # its stage-2 products at one population chunk, against operands
        # copied per k1 for each product or once per call (the port's form)
        f = so_s.factored
        pc = spectral._factored_chunk(ns, STREAM_POP)
        b = torch.randn(f.n1, f.n2, pc, device=self.dev).to(torch.bfloat16)
        a2 = f.c2.T.to(torch.bfloat16)
        a3 = a2.expand(f.n1, *a2.shape).contiguous()
        mm = spectral.matmul_f32
        ms_copy = cuda_ms(lambda: [mm(a2.expand(f.n1, *a2.shape).contiguous(), b)
                                   for _ in range(4)], 5)
        ms_once = cuda_ms(lambda: [mm(a3, b) for _ in range(4)], 5)
        log(f"factored DFT stage 2 (4 bmm, chunk {pc} of {STREAM_POP} candidates): operand "
            f"copied per product {ms_copy:.4f} ms, copied once {ms_once:.4f} ms "
            f"{card()}")
        del b, a3
        so32 = so_s._replace(dft_dtype=torch.float32)
        audio32 = sst.fused_synth_stream(cs["params"], so_s.window, audio_f32=True, **ks)
        ms = cuda_ms(lambda: spectral.magnitude_spectrum_factored(audio32, so32, prewindowed=True),
                     3)
        log(f"factored DFT f32 (TF32 off; the refine tail's engine), n={ns} P={STREAM_POP}: "
            f"{ms:.4f} ms {card()}")

    # -- third slice: shared inputs -----------------------------------------------
    def f32_settings(self):
        """(label, ESConfig) of each path that runs B1/B2 in f32: the shipped
        config's refine tail (n 1024, pop 2^15) and audio_match.json's
        (n 2048, pop 4096), and the latter at ``RAGGED_POP``."""
        from pmfm_tpu_torch.io import load_config

        audio = load_config(AUDIO_CONFIG).es.refine_config()
        ragged = audio.replace(num_offspring=RAGGED_POP - audio.num_parents)
        return (("shipped refine tail", load_config(SHIPPED_CONFIG).es.refine_config()),
                ("audio_match refine tail", audio),
                ("audio_match refine tail, ragged P", ragged))

    def inputs(self, cfg, seed, truth=TRUTH):
        """Operands, the known-params target, candidates (the truth first) and
        parents of ``cfg``, from ``seed``."""
        from pmfm_tpu_torch.es import make_spectrum_ops
        from pmfm_tpu_torch.ops import synthesize_single, target_spectrum

        d = cfg.num_dimensions
        so = make_spectrum_ops(cfg, device=self.dev)
        audio = synthesize_single(torch.tensor(truth), cfg.n_samples, cfg.topology)
        rng = np.random.default_rng(seed)
        pop, mu = cfg.population_size, cfg.num_parents
        cand = (rng.random((pop, d)) * np.asarray(cfg.param_maxs)).astype(np.float32)
        cand[0] = truth
        pv = rng.random((mu, d)).astype(np.float32)
        ps = rng.uniform(0.02, 0.3, (mu, d)).astype(np.float32)
        dev = lambda a: torch.from_numpy(a).to(self.dev)  # noqa: E731
        return dict(cfg=cfg, so=so, target=target_spectrum(audio.to(self.dev), so),
                    params=dev(cand), pv=dev(pv), ps=dev(ps))

    @staticmethod
    def kw_b1(c):
        cfg, so = c["cfg"], c["so"]
        return dict(dft_packed=so.dft_packed, dft_scale=so.dft_packed_scale, topology=cfg.topology,
                    n=cfg.n_samples, pop_block=cfg.population_size, sine_order=cfg.sine_order,
                    num_frames=cfg.num_frames)

    @staticmethod
    def kw_b2(c):
        from pmfm_tpu_torch.es.pipeline import fused_generation_kwargs

        return dict(fused_generation_kwargs(c["cfg"], c["so"]), pop_block=c["cfg"].population_size)

    # -- 12 -----------------------------------------------------------------
    def f32_vs_plain(self):
        """B1 and B2 in the true-f32 mode at each refine tail's settings (B2's
        fitness also bit-equal to B1's on its offspring), then over phase
        4b's grid with F32_GRID_POPS."""
        from pmfm_tpu_torch.es import kernel_seed
        from pmfm_tpu_torch.kernels import generation as gn
        from pmfm_tpu_torch.kernels import synth_fitness as sf

        self.f32 = {}
        worst = {"fused_synth_fitness_f32": 0.0, "fused_generation_f32": 0.0}
        for i, (label, cfg) in enumerate(self.f32_settings()):
            c = self.inputs(cfg, SEED + 10 + i)
            self.f32[label] = c
            require(c["so"].dft_packed.dtype == torch.float32 and c["so"].dft_packed_scale == 0.0,
                    "the refine tail's operand is not the float32 one")
            where = f"{label}: n={cfg.n_samples}, P={cfg.population_size}, sine order {cfg.sine_order}"
            fk = sf.fused_synth_fitness(c["params"], c["target"], **self.kw_b1(c))
            torch.cuda.synchronize()
            fp = sf.fused_synth_fitness_plain(c["params"], c["target"], **self.kw_b1(c))
            require(bool(torch.isfinite(fk).all()), "B1 f32 fitness not finite")
            e = rel_err(fk, fp)
            mx, med = float(e.max()), float(e.median())
            rk, rp = int(torch.argmin(fk)), int(torch.argmin(fp))
            log(f"B1 f32 vs plain ({where}): max rel {mx:.3e} median rel {med:.3e} (tolerance "
                f"{F32_FIT_MAX_REL:g} / {F32_FIT_MEDIAN_REL:g}); truth rank kernel {rk} plain {rp}; "
                f"truth fitness {float(fk[0]):.6g}")
            require(mx <= F32_FIT_MAX_REL and med <= F32_FIT_MEDIAN_REL,
                    "B1 f32 disagrees with its plain version")
            require(rk == 0 and rp == 0, "the known-params truth does not rank first")
            worst["fused_synth_fitness_f32"] = max(worst["fused_synth_fitness_f32"],
                                                   float((fk - fp).abs().max()))
            seed = kernel_seed(SEED, 5 + i)
            fk, vk, sk = gn.fused_generation(seed, c["pv"], c["ps"], c["target"], **self.kw_b2(c))
            torch.cuda.synchronize()
            fp, vp, sp = gn.fused_generation_plain(seed, c["pv"], c["ps"], c["target"],
                                                   **self.kw_b2(c))
            require(bool(torch.isfinite(fk).all() and torch.isfinite(vk).all()),
                    "B2 f32 output not finite")
            v_diff, s_rel = float((vk - vp).abs().max()), float(rel_err(sk, sp).max())
            e = rel_err(fk, fp)
            mx, med = float(e.max()), float(e.median())
            log(f"B2 f32 vs plain ({where}, min_step {cfg.min_step:g}): values max abs diff "
                f"{v_diff:.3e} (must be 0), steps max rel {s_rel:.3e} (tolerance "
                f"{STEP_MAX_REL:g}), fitness max rel {mx:.3e} median rel {med:.3e}")
            require(v_diff == 0.0, "B2 f32 offspring values are not bit-equal to the plain version")
            require(s_rel <= STEP_MAX_REL, "B2 f32 offspring steps disagree with the plain version")
            require(mx <= F32_FIT_MAX_REL and med <= F32_FIT_MEDIAN_REL, "B2 f32 fitness disagrees")
            own = sf.fused_synth_fitness(
                gn.scale_rows(vk, cfg.param_mins, cfg.param_maxs), c["target"], **self.kw_b1(c))
            log(f"B2 f32 fitness bit-equal to B1 f32 on its offspring ({where}): "
                f"{torch.equal(fk, own)}")
            require(torch.equal(fk, own), "B2 f32 fitness differs from B1 f32 on its offspring")
            worst["fused_generation_f32"] = max(worst["fused_generation_f32"],
                                                float((fk - fp).abs().max()))
        for name, err in worst.items():
            self.kernels[name] = {"max_abs_err": err}
        self.grid("float32", F32_GRID_POPS, (F32_FIT_MAX_REL, F32_FIT_MEDIAN_REL), SEED + 31, 5000)
        self.f32_vs_f64()

    def f32_vs_f64(self):
        """B1 f32 and its plain version against a float64 evaluation of the
        same audio (``fitness_f64``) at each frame of GRID_N, fm3_series, sine
        order 7, P 1 and RAGGED_POP, on the inputs of tests/test_torch_gpu.py's
        f32 grid: how far each float32 summation order lies from float64 per
        frame size, beside the closest float32 U and V allow (``uv_f32``). A
        measurement; the gate stays kernel against plain."""
        from pmfm_tpu_torch.kernels import synth_fitness as sf
        from pmfm_tpu_torch.ops import spectral

        topology, order, d = "fm3_series", 7, 6
        maxs = np.asarray((3520.0, 8.0) * (d // 2), np.float32)
        for n in GRID_N:
            so = spectral.make_spectrum_ops(n, None, dft_dtype="float32", device=self.dev)
            for pop in (1, RAGGED_POP):
                rng = np.random.default_rng(n + pop + order)
                tgt = torch.from_numpy(rng.uniform(0.0, 50.0, so.num_bins).astype(np.float32))
                tgt = tgt.to(self.dev)
                p = np.random.default_rng(order).random((pop, d)) * maxs
                p = torch.from_numpy(p.astype(np.float32)).to(self.dev)
                kw = dict(dft_packed=so.dft_packed, dft_scale=0.0, topology=topology, n=n,
                          pop_block=pop, sine_order=order)
                fk = sf.fused_synth_fitness(p, tgt, **kw).double()
                fp = sf.fused_synth_fitness_plain(p, tgt, **kw).double()
                f64 = fitness_f64(p, tgt, so, topology, n, order)
                fo = fitness_f64(p, tgt, so, topology, n, order, uv_f32=True)
                ek, ep, kp = rel_err(fk, f64), rel_err(fp, f64), rel_err(fk, fp)
                eo = rel_err(fo, f64)
                log(f"B1 f32 against float64 (n={n}, K={so.num_bins}, {topology}, sine order "
                    f"{order}, P={pop}): kernel max rel {float(ek.max()):.4e} median "
                    f"{float(ek.median()):.4e}; plain max rel {float(ep.max()):.4e} median "
                    f"{float(ep.median()):.4e}; kernel vs plain max rel {float(kp.max()):.4e} "
                    f"median {float(kp.median()):.4e}; U and V rounded once to float32, the "
                    f"rest in float64 max rel {float(eo.max()):.4e} median "
                    f"{float(eo.median()):.4e}")

    # -- 13 -----------------------------------------------------------------
    def b5_vs_b2(self):
        """B5 bit-equal to G launches of the B2 kernel with the exact stable
        selection, and within the B2 limits of its plain version. B5 runs
        B2's own kernels, so this holds its selection and its loop: at the
        driven settings (int8 at the bench config, f32 at the shipped refine
        tail and audio_match.json's, each also at ``RAGGED_POP``) and at
        three cases that stress the selection: identical candidates (every
        parent equal, steps 0, min_step 0: every fitness equal, so the
        survivors are candidates 0..mu-1 in order), a target holding NaN
        (every fitness NaN: survivors 0..mu-1, best-ever stays +inf), and
        ``BIG_POP``, whose keys do not fit the selection's shared memory."""
        from pmfm_tpu_torch.es import kernel_seed
        from pmfm_tpu_torch.kernels import evolve as ev
        from pmfm_tpu_torch.kernels import generation as gn

        names = ("parent values", "parent steps", "parent fitness", "best values",
                 "best fitness", "trajectory")
        bench = dict(cfg=self.cfg, so=self.so, target=self.target, pv=self.parents_v,
                     ps=self.parents_s)

        def args(c):
            best_f = torch.tensor(float("inf"), device=self.dev)
            return c["pv"], c["ps"], c["pv"][0].clone(), best_f, c["target"]

        ragged = self.inputs(self.cfg.replace(num_offspring=RAGGED_POP - MU), SEED + 20)
        same = dict(bench, pv=self.parents_v[:1].expand(MU, D).contiguous(),
                    ps=torch.zeros_like(self.parents_s))
        nan_target = self.target.clone()
        nan_target[3] = float("nan")
        big = self.inputs(self.cfg.replace(num_offspring=BIG_POP - MU), SEED + 21)
        shipped, audio = self.f32["shipped refine tail"], self.f32["audio_match refine tail"]
        for label, c, case in (
                ("int8, bench config", bench, "run"),
                ("int8, bench config, ragged P", ragged, "run"),
                ("f32, shipped refine tail", shipped, "run"),
                ("f32, audio_match refine tail", audio, "run"),
                ("f32, audio_match refine tail, ragged P",
                 self.f32["audio_match refine tail, ragged P"], "run"),
                ("int8, bench config, identical candidates", same, "same"),
                ("f32, shipped refine tail, identical candidates",
                 dict(shipped, pv=shipped["pv"][:1].expand_as(shipped["pv"]).contiguous(),
                      ps=torch.zeros_like(shipped["ps"])), "same"),
                ("int8, bench config, NaN in the target", dict(bench, target=nan_target), "nan"),
                (f"int8, bench config, P {BIG_POP}", big, "run")):
            cfg = c["cfg"]
            pop, mu = cfg.population_size, cfg.num_parents
            kw = dict(self.kw_b2(c), **({"min_step": 0.0} if case == "same" else {}))
            seeds = [kernel_seed(SEED, 100 + g) for g in range(EVOLVE_CHECK_GENERATIONS)]
            out = ev.fused_evolve(seeds, *args(c), **kw)
            torch.cuda.synchronize()
            loop = ev.fused_evolve_plain(seeds, *args(c), generation=gn.fused_generation, **kw)
            equal = all(bits_equal(a, b) for a, b in zip(out, loop))
            diffs = {nm: float((a - b).abs().nan_to_num().max())
                     for nm, a, b in zip(names, out, loop)}
            traj = out[5].cpu()
            shared = ev.select_geometry(pop, mu)["keys_in_shared"]
            log(f"B5 vs {len(seeds)} B2 launches + stable selection ({label}: n={cfg.n_samples}, "
                f"P={pop}, mu={mu}; selection keys in shared memory {shared}): bit-equal "
                f"{equal}; max abs diff {diffs}; best-ever first {float(traj[0]):.6g} last "
                f"{float(traj[-1]):.6g}")
            require(equal, "B5 is not bit-equal to the loop of B2 launches")
            require(shared is (pop < BIG_POP), "the selection's keys in shared memory")
            require(bool((traj[1:] <= traj[:-1]).all()), "B5 best-ever trajectory")
            require(float(out[4]) == float(traj[-1]), "B5 best fitness != trajectory end")
            if case == "run":
                require(bool(torch.isfinite(traj).all()), "B5 best-ever trajectory")
                continue
            # the ties: each generation's survivors are candidates 0..mu-1
            fit, val, _ = gn.fused_generation(seeds[0], c["pv"], c["ps"], c["target"], **kw)
            require(torch.equal(ev.stable_order(fit)[:mu].cpu(), torch.arange(mu)),
                    "the survivors of a tie are not candidates 0..mu-1")
            if case == "same":
                require(bool((fit == fit[0]).all() and torch.isfinite(fit).all()), "equal fitness")
                require(torch.equal(out[0], c["pv"]) and torch.equal(val[:mu], c["pv"]),
                        "identical candidates changed")
                require(bool(torch.isfinite(traj).all() and (traj == traj[0]).all()), "trajectory")
            else:
                require(bool(torch.isnan(fit).all() and torch.isnan(out[2]).all()), "NaN fitness")
                require(bool(torch.isinf(traj).all() and (traj > 0).all()), "best-ever stays +inf")
        seeds = [kernel_seed(SEED, 200 + g) for g in range(EVOLVE_PLAIN_GENERATIONS)]
        out = ev.fused_evolve(seeds, *args(bench), **self.kw_b2(bench))
        torch.cuda.synchronize()
        plain = ev.fused_evolve_plain(seeds, *args(bench), **self.kw_b2(bench))
        e_pf, e_tr = rel_err(out[2], plain[2]), rel_err(out[5], plain[5])
        log(f"B5 vs plain (int8, bench config, {len(seeds)} generations): parent fitness max rel "
            f"{float(e_pf.max()):.3e} median rel {float(e_pf.median()):.3e}, best-ever max rel "
            f"{float(e_tr.max()):.3e} (tolerance {FIT_MAX_REL:g} / {FIT_MEDIAN_REL:g}); parent "
            f"values equal {torch.equal(out[0], plain[0])}")
        require(float(e_pf.max()) <= FIT_MAX_REL and float(e_pf.median()) <= FIT_MEDIAN_REL
                and float(e_tr.max()) <= FIT_MAX_REL, "B5 disagrees with its plain version")
        self.kernels["fused_evolve"] = {"max_abs_err": float((out[2] - plain[2]).abs().max())}

    # -- 14 -----------------------------------------------------------------
    def evolve_fused(self):
        """``evolve`` with ``fused_evolve`` at the bench config: one B5 launch."""
        from pmfm_tpu_torch.es import evolve, init_state
        from pmfm_tpu_torch.es.pipeline import _fused_evolve_ok

        cfg = self.cfg.replace(fused_evolve=True)
        require(_fused_evolve_ok(cfg, self.so, self.dev), "fused_evolve does not route to B5")
        evolve(init_state(1, cfg, device=self.dev), self.target, 2, self.so, cfg)  # warm-up
        state = init_state(7, cfg, device=self.dev)
        torch.cuda.synchronize()
        self.reset_counts()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        final, traj = evolve(state, self.target, GENERATIONS, self.so, cfg, record_trajectory=True)
        b.record()
        b.synchronize()
        counts = self.read_counts()
        ms = a.elapsed_time(b) / GENERATIONS
        traj = traj.cpu()
        cell_a = self.cell_ms.get("a", float("nan"))
        log(f"evolve (fused_evolve -> B5, bench config): {GENERATIONS} generations {ms:.4f} ms/gen, "
            f"{POP / (ms / 1e3):.4g} candidate-evals/s (cell (a), B2 a generation: {cell_a:.4f} "
            f"ms/gen) {card()}; best fitness first {float(traj[0]):.6g} final "
            f"{float(traj[-1]):.6g}; stall {int(final.stall)}; launches {counts}")
        require(counts["fused_evolve"] == 1 and sum(counts.values()) == 1,
                "fused_evolve did not run as exactly one B5 launch")
        require(final.generation == GENERATIONS and traj.shape == (GENERATIONS,), "generations")
        require(bool(torch.isfinite(traj).all() and (traj[1:] <= traj[:-1]).all()), "trajectory")
        require(float(traj[-1]) < float(traj[0]), "evolve did not improve the best fitness")
        require(float(final.best_fitness) == float(traj[-1]), "best fitness != trajectory end")
        self.kernels.setdefault("fused_evolve", {})["launches"] = counts["fused_evolve"]
        self.cell_ms["fused_evolve"] = ms

    # -- 15 -----------------------------------------------------------------
    def shipped(self):
        """The shipped path (params_match.json through _evolve_on_target: the
        int8 B2 generations, the boundary rescore on B1 f32, the f32 B2 tail),
        then match_audio running audio_match.json as written."""
        from pmfm_tpu_torch import bench
        from pmfm_tpu_torch.es import init_state, make_spectrum_ops, match_audio, pipeline
        from pmfm_tpu_torch.io import load_config, read_wav
        from pmfm_tpu_torch.ops import synthesize_single

        cfg = load_config(SHIPPED_CONFIG).es
        gens, r = bench.GENS, cfg.refine_generations
        so = make_spectrum_ops(cfg, device=self.dev)
        cfg_r = cfg.refine_config()
        refine_ops = (cfg_r, make_spectrum_ops(cfg_r, device=self.dev))
        audio = synthesize_single(torch.tensor(TRUTH), cfg.n_samples, cfg.topology).to(self.dev)
        parts, real = [], pipeline.evolve

        def timed(*a, **k):  # each evolve call of _evolve_on_target: time and launches
            before = self.read_counts()
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev0.record()
            out = real(*a, **k)
            ev1.record()
            ev1.synchronize()
            after = self.read_counts()
            parts.append(dict(gens=a[2], ms=ev0.elapsed_time(ev1),
                              f32=a[3].dft_packed.dtype == torch.float32,
                              launches={n_: after[n_] - before[n_] for n_ in after}))
            return out

        state = init_state(SEED, cfg, device=self.dev)
        torch.cuda.synchronize()
        self.reset_counts()
        t0 = time.perf_counter()
        pipeline.evolve = timed
        try:
            final, traj, start = pipeline._evolve_on_target(state, audio, gens, so, cfg, True,
                                                            refine_ops)
        finally:
            pipeline.evolve = real
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = self.read_counts()
        require(len(parts) == 2 and not parts[0]["f32"] and parts[1]["f32"], "the two parts")
        p8, p32 = parts
        traj = traj.cpu()
        before, start, end = float(traj[gens - r - 1]), float(start), float(final.best_fitness)
        log(f"shipped path ({SHIPPED_CONFIG}: n={cfg.n_samples}, P={cfg.population_size}, {gens} "
            f"generations): int8 part {p8['gens']} generations {p8['ms'] / p8['gens']:.4f} ms/gen, "
            f"f32 tail {p32['gens']} generations {p32['ms'] / p32['gens']:.4f} ms/gen {card()}; "
            f"best fitness before the tail {before:.6g} (int8 engine), rescored at the boundary "
            f"{start:.6g} (f32 engine), end {end:.6g}; {seconds:.2f}s host clock; launches "
            f"{counts}, of them in the tail {p32['launches']}")
        require(traj.shape == (gens,) and bool(torch.isfinite(traj).all()), "trajectory")
        require(bool((traj[1 : gens - r] <= traj[: gens - r - 1]).all()
                     and (traj[gens - r + 1 :] <= traj[gens - r : -1]).all()),
                "best-ever fitness must not increase within a part")
        require(end <= start, "the refine tail ended worse than its start")
        require(counts["fused_generation"] == gens and counts["fused_synth_fitness"] == 1
                and sum(counts.values()) == gens + 1, "shipped path launches")
        require(p32["launches"]["fused_generation"] == r, "f32 tail launches")
        self.kernels.setdefault("fused_generation_f32", {})["launches"] = \
            p32["launches"]["fused_generation"]
        self.kernels.setdefault("fused_synth_fitness_f32", {})["launches"] = \
            counts["fused_synth_fitness"]
        self.cell_ms["shipped int8"] = p8["ms"] / p8["gens"]
        self.cell_ms["shipped f32"] = p32["ms"] / p32["gens"]

        rc = load_config(AUDIO_CONFIG)
        cfg = rc.es
        wav, sr = read_wav(rc.input_audio_path)
        n, g, r = cfg.n_samples, AUDIO_GENERATIONS, cfg.refine_generations
        require(sr == cfg.sample_rate and g > r, f"{rc.input_audio_path}: {sr} Hz")
        torch.cuda.synchronize()
        self.reset_counts()
        t0 = time.perf_counter()
        res = match_audio(wav, cfg, seed=SEED, num_generations=g, record_trajectory=True,
                          device=self.dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = self.read_counts()
        chunks = len(wav) // n
        log(f"match_audio ({AUDIO_CONFIG} as written: n={n}, P={cfg.population_size}, {g} "
            f"generations, the last {r} refine): {len(res.chunks)} chunks of {n} samples from a "
            f"file of {len(wav)} samples in {seconds:.2f}s {card()}; launches {counts}")
        require(len(res.chunks) == chunks >= 1, "chunk count")
        require(res.output_audio.shape == (chunks * n,) and np.isfinite(res.output_audio).all(),
                "output audio")
        for i, ch in enumerate(res.chunks):
            t = ch.trajectory
            log(f"chunk {i}: best fitness before refine {t[g - r - 1]:.6g} (int8 engine), "
                f"rescored at the boundary {ch.refine_start_fitness:.6g}, after refine "
                f"{ch.best_fitness:.6g} (f32 engine)")
            require(t.shape == (g,) and np.isfinite(t).all(), "chunk trajectory")
            require(bool(np.all(np.diff(t[: g - r]) <= 0) and np.all(np.diff(t[g - r :]) <= 0)),
                    "best-ever fitness must not increase within a part")
            require(ch.best_fitness <= ch.refine_start_fitness, "the refine tail made it worse")
        # per chunk: g B2 launches (int8, then f32) and one B1 f32 rescore
        require(counts["fused_generation"] == chunks * g
                and counts["fused_synth_fitness"] == chunks
                and sum(counts.values()) == chunks * (g + 1), "match_audio launches")

    # -- 16 -----------------------------------------------------------------
    def third_timings(self):
        """B1/B2 f32 at the shipped tail's shapes, B5 at the bench config,
        and the port's bench (one repetition after a warm-up), then the host
        time of the one-run forms the ES loop keeps (``host_forms``)."""
        from pmfm_tpu_torch import bench
        from pmfm_tpu_torch.es import kernel_seed
        from pmfm_tpu_torch.kernels import evolve as ev
        from pmfm_tpu_torch.kernels import generation as gn
        from pmfm_tpu_torch.kernels import synth_fitness as sf

        c = self.f32["shipped refine tail"]
        cfg = c["cfg"]
        pop, mu, n, k = cfg.population_size, cfg.num_parents, cfg.n_samples, c["so"].num_bins
        seed = kernel_seed(SEED, 9)
        # the f32 DFT: two (K, N/2) products a candidate, 2 operations a term
        f32_ops = synth_ops_f32(pop, n, k, kn=3, ncoef=5) + 2.0 * 2 * k * (n // 2) * pop
        operand = 2 * k * (n // 2) * 4
        kw1, kw2 = self.kw_b1(c), self.kw_b2(c)
        rows = {
            "fused_synth_fitness_f32": (
                lambda: sf.fused_synth_fitness(c["params"], c["target"], **kw1),
                lambda: sf.fused_synth_fitness_plain(c["params"], c["target"], **kw1),
                pop * D * 4 + operand + k * 4 + pop * 4, 0.0, f32_ops,
                "pmfm_tpu_torch/csrc/fused_f32.cu", "pmfm_tpu/kernels/synth_fitness.py:767",
            ),
            "fused_generation_f32": (
                lambda: gn.fused_generation(seed, c["pv"], c["ps"], c["target"], **kw2),
                lambda: gn.fused_generation_plain(seed, c["pv"], c["ps"], c["target"], **kw2),
                2 * mu * D * 4 + operand + k * 4 + pop * 4 + 2 * pop * D * 4, 0.0,
                f32_ops + pop * D * 12 * 2.0,
                "pmfm_tpu_torch/csrc/fused_f32.cu", "pmfm_tpu/kernels/generation.py:438",
            ),
        }
        # B5: one launch of EVOLVE_TIMED_GENERATIONS generations at the bench config
        g = EVOLVE_TIMED_GENERATIONS
        seeds = [kernel_seed(SEED, 300 + i) for i in range(g)]
        bcfg = self.cfg
        bc = dict(cfg=bcfg, so=self.so)
        bkw = self.kw_b2(bc)
        b5_args = (self.parents_v, self.parents_s, self.parents_v[0].clone(),
                   torch.tensor(float("inf"), device=self.dev), self.target)
        bn, bk = bcfg.n_samples, self.so.num_bins
        rows["fused_evolve"] = (
            lambda: ev.fused_evolve(seeds, *b5_args, **bkw),
            lambda: ev.fused_evolve_plain(seeds, *b5_args, **bkw),
            # parents and best-ever in and out, operand, target, trajectory
            4 * MU * D * 4 + 2 * (D + 1) * 4 + 2 * bk * (bn // 2) + bk * 4 + g * 4,
            g * 2.0 * 2 * bk * (bn // 2) * POP,
            g * (synth_ops_f32(POP, bn, bk, kn=3, ncoef=4) + POP * D * 12 * 2.0),
            "pmfm_tpu_torch/csrc/evolve.cu", "pmfm_tpu/kernels/evolve.py:366",
        )
        for name, (fn, plain, nbytes, int8_ops, f32, src, replaces) in rows.items():
            ms = cuda_ms(fn, TIMED_LAUNCHES if name != "fused_evolve" else 5)
            plain_ms = cuda_ms(plain, PLAIN_RUNS)
            bound_ms, by = bound(nbytes, int8_ops, f32)
            per = f", {ms / g:.4f} ms a generation" if name == "fused_evolve" else ""
            log(f"{name}: kernel {ms:.4f} ms{per}, plain {plain_ms:.2f} ms (median of "
                f"{PLAIN_RUNS}), bound {bound_ms:.4f} ms by {by} ({nbytes / 1e6:.2f} MB, "
                f"{int8_ops / 1e9:.1f} G int8 ops, {f32 / 1e9:.2f} G f32 ops) {card()}")
            self.kernels.setdefault(name, {}).update(
                route="cuda", source=src, replaces=replaces, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, library_ms=None,
            )
        self.b5_split("int8, bench config", lambda: ev.fused_evolve(seeds, *b5_args, **bkw), g,
                      self.kernels["fused_evolve"]["ms"], self.kernels["fused_generation"]["ms"])
        # B5 in f32 (B2's f32 kernels) at the shipped tail's shape
        f32_args = (c["pv"], c["ps"], c["pv"][0].clone(), torch.tensor(float("inf"), device=self.dev),
                    c["target"])
        f32_b5 = lambda: ev.fused_evolve(seeds, *f32_args, **kw2)  # noqa: E731
        ms = cuda_ms(f32_b5, 3)
        log(f"fused_evolve f32 (shipped refine tail: n={n}, K={k}, P={pop}): kernel {ms:.4f} ms "
            f"for {g} generations, {ms / g:.4f} ms a generation {card()}")
        self.b5_split("f32, shipped refine tail", f32_b5, g, ms,
                      self.kernels["fused_generation_f32"]["ms"])
        for label in ("shipped refine tail", "audio_match refine tail"):
            self.f32_split(label)
        b = bench.Bench(bench.GENS, device=self.dev)
        value_ms, shipped_ms = bench.best_ms(b.run_value, 1), bench.best_ms(b.run_shipped, 1)
        log(f"bench (pmfm_tpu_torch/bench.py, {bench.GENS} generations, one run after a warm-up): "
            f"value {b.evals_per_sec(value_ms):.1f} evals/s ({value_ms / bench.GENS:.4f} ms/gen), "
            f"value_shipped {b.evals_per_sec(shipped_ms):.1f} evals/s "
            f"({shipped_ms / bench.GENS:.4f} ms/gen) {card()}")
        self.host_forms()

    def host_forms(self):
        """The host time a call of the two forms of the one-run operations
        that ``es.strategy.select`` and ``es.pipeline.generation_step`` keep
        beside their run-axis forms, at the bench's shape: the selection's
        gathers (indexing against ``take_along_dim``) and the best-ever
        bookkeeping (plain indexing and 0-dim flags against ``...`` indexing
        and reshaped flags). Microseconds of the host clock a call, no
        synchronisation inside the timed calls."""
        dev = self.dev
        fit, val, stp = (torch.rand(POP, device=dev), torch.rand(POP, D, device=dev),
                         torch.rand(POP, D, device=dev))
        idx = torch.topk(-fit, MU)[1]
        pv, pf = val[idx], fit[idx]
        bv, bf = pv[0].clone(), torch.tensor(0.5, device=dev)

        def host_us(fn, calls=HOST_FORM_CALLS):
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            us = (time.perf_counter() - t0) / calls * 1e6
            torch.cuda.synchronize()
            return us

        take = idx[..., None]
        forms = {
            "gathers, indexing": lambda: (val[idx], stp[idx]),
            "gathers, take_along_dim": lambda: (torch.take_along_dim(val, take, dim=-2),
                                                torch.take_along_dim(stp, take, dim=-2)),
            "best-ever, plain": lambda: torch.where(pf[0] < bf, pv[0], bv),
            "best-ever, run-axis form": lambda: torch.where(
                (pf[..., 0] < bf).reshape(1), pv[..., 0, :], bv),
        }
        times = {name: statistics.median(host_us(fn) for _ in range(5))
                 for name, fn in forms.items()}
        log("one-run host forms at the bench shape (median of 5 x "
            f"{HOST_FORM_CALLS} calls, us of host time a call): "
            + ", ".join(f"{name} {us:.2f}" for name, us in times.items()) + f" {card()}")

    def b5_split(self, label, fn, g, ms, b2_ms):
        """Where a B5 generation goes: device time a call of ``fn`` (``g``
        generations) by kernel from torch.profiler, summed as the evaluation
        (B2's kernels), the selection and other kernels (the wrapper's
        copies), and the rest of ``ms`` (the call's CUDA-event time) not
        covered by kernels; beside B2 alone (``b2_ms``)."""
        times = kernel_times(fn, PROFILED_B5_CALLS)
        if not times:
            log(f"B5 split ({label}): not measured (no device time in the trace) {card()}")
            return
        base = {name: name.split("<")[0] for name in times}
        ev_ms = sum(v for nm, v in times.items() if base[nm] in B2_KERNELS)
        sel_ms = sum(v for nm, v in times.items() if base[nm] == SELECT_KERNEL)
        other = sum(times.values()) - ev_ms - sel_ms
        log(f"B5 split ({label}, {g} generations a call; torch.profiler, mean of "
            f"{PROFILED_B5_CALLS} calls): a generation {ms / g:.4f} ms = evaluation "
            f"{ev_ms / g:.4f} ms ({sorted({base[nm] for nm in times if base[nm] in B2_KERNELS})}) "
            f"+ selection {sel_ms / g:.4f} ms + other kernels {other / g:.4f} ms + not covered by "
            f"kernels {(ms - ev_ms - sel_ms - other) / g:.4f} ms; B2 alone {b2_ms:.4f} ms, B5 - B2 "
            f"{ms / g - b2_ms:.4f} ms a generation {card()}")

    def f32_split(self, label):
        """How B1/B2 f32 split at a refine tail's shape (phase 12's inputs for
        ``label``): B1 and B2, B1 and B2 with an operand and target of
        SPLIT_BINS bins (synthesis, fold, launch and, in B2, the prologue: the
        DFT nearly gone), B2 - B1 (the prologue), and the DFT half alone as
        ``torch.matmul`` of candidate-major f32 a+/- against the operand's
        halves with TF32 off (cuBLAS SGEMM, a yardstick: the port never
        calls it)."""
        from pmfm_tpu_torch.device import exact_f32_matmul
        from pmfm_tpu_torch.es import kernel_seed
        from pmfm_tpu_torch.kernels import generation as gn
        from pmfm_tpu_torch.kernels import synth_fitness as sf

        c = self.f32[label]
        pop, n, k = c["cfg"].population_size, c["cfg"].n_samples, c["so"].num_bins
        op = c["so"].dft_packed
        op_s = torch.cat([op[:SPLIT_BINS], op[k : k + SPLIT_BINS]]).contiguous()
        tgt_s = c["target"][:SPLIT_BINS].contiguous()
        kw1, kw2 = self.kw_b1(c), self.kw_b2(c)
        seed = kernel_seed(SEED, 2)
        b1 = lambda o, t: sf.fused_synth_fitness(  # noqa: E731
            c["params"], t, **dict(kw1, dft_packed=o))
        b2 = lambda o, t: gn.fused_generation(  # noqa: E731
            seed, c["pv"], c["ps"], t, **dict(kw2, dft_packed=o))
        b1_ms, b2_ms = (cuda_ms(lambda: f(op, c["target"]), TIMED_LAUNCHES) for f in (b1, b2))
        s1_ms, s2_ms = (cuda_ms(lambda: f(op_s, tgt_s), TIMED_LAUNCHES) for f in (b1, b2))
        g = torch.Generator(device=self.dev).manual_seed(SEED)
        ap, am = (torch.randn((pop, n // 2), generator=g, device=self.dev) for _ in range(2))
        cos_t, sin_t = op[:k].T, op[k:].T  # (N/2, K) views
        with exact_f32_matmul():
            mm_ms = cuda_ms(lambda: (torch.matmul(ap, cos_t), torch.matmul(am, sin_t)),
                            TIMED_LAUNCHES)
        flops = 2.0 * 2 * k * (n // 2) * pop
        log(f"B1/B2 f32 split ({label}: n={n}, K={k}, P={pop}): B1 {b1_ms:.4f} ms, B2 "
            f"{b2_ms:.4f} ms; B1 with {SPLIT_BINS} bins (synthesis + fold + launch) {s1_ms:.4f} "
            f"ms; B1 minus that (the DFT and its epilogue) {b1_ms - s1_ms:.4f} ms; B2 - B1 (the "
            f"offspring prologue) {b2_ms - b1_ms:.4f} ms, with {SPLIT_BINS} bins "
            f"{s2_ms - s1_ms:.4f} ms; yardstick for the DFT half, torch.matmul U+V with TF32 off "
            f"(cuBLAS SGEMM) on candidate-major a+/- {mm_ms:.4f} ms "
            f"({flops / (mm_ms * 1e-3) / 1e12:.1f} f32 TFLOP/s) {card()}")
        del ap, am
        log(f"  B2 f32 by kernel ({label}, torch.profiler, mean of {PROFILED_LAUNCHES} launches): "
            f"{kernel_breakdown(lambda: b2(op, c['target']), PROFILED_LAUNCHES)} {card()}")

    # -- 17 -----------------------------------------------------------------
    def scan_vs_plain(self):
        """The scan kernel bit-equal to its plain loop over samples: at the
        bench's shape (fm3_series, P 2^15, n 1024), at parameters.json's
        (its population, n 2048), and over SCAN_GRID x the three oscillators
        x float32 and bf16 output at SCAN_GRID_POP, n 1024; then its time
        beside the plain loop's at the first two."""
        from pmfm_tpu_torch.io import load_config
        from pmfm_tpu_torch.kernels import scan as ss
        from pmfm_tpu_torch.ops.synthesis import topology_dims

        pj = load_config("parameters.json").es
        shapes = (("bench", TOPOLOGY, POP, 1 << LOG2N, self.cfg.param_maxs),
                  ("parameters.json", pj.topology, pj.population_size, pj.n_samples,
                   pj.param_maxs))
        grid = [(f"grid {t}", t, SCAN_GRID_POP, 1024, None) for t in SCAN_GRID]
        worst, checked = 0.0, 0
        for label, topology, pop, n, maxs in shapes + tuple(grid):
            d = topology_dims(topology)
            if maxs is None:
                maxs = (3520.0, 8.0) * (d // 2) if "series" in topology else (3520.0, 8.0, 3520.0,
                                                                                1.0) * (d // 4)
            rng = np.random.default_rng(SEED + d + pop)
            p = torch.from_numpy((rng.random((pop, d)) * np.asarray(maxs)).astype(np.float32))
            p = p.to(self.dev)
            modes = ("floor", "exact", "table") if label.startswith("grid") else ("floor",)
            for osc in modes:
                for dt in (torch.float32, torch.bfloat16):
                    a = ss.scan_synth(p, n, topology, osc_mode=osc, out_dtype=dt)
                    b = ss.scan_synth_plain(p, n, topology, osc_mode=osc, out_dtype=dt)
                    torch.cuda.synchronize()
                    eq = bits_equal(a.float(), b.float())
                    worst = max(worst, float((a.float() - b.float()).abs().max()))
                    checked += 1
                    require(eq and a.shape == (n, pop), f"scan kernel differs from its plain "
                            f"version ({label}, {osc}, {dt})")
            if not label.startswith("grid"):
                ms = cuda_ms(lambda: ss.scan_synth(p, n, topology), TIMED_LAUNCHES)
                plain_ms = cuda_ms(lambda: ss.scan_synth_plain(p, n, topology), 1)
                kn = 2 if topology == "fm2" else int(topology[2:].split("_")[0])
                ops = float(pop) * n * kn * (SINF_OPS + 6)
                bound_ms, by = bound(n * pop * 4 + pop * d * 4, 0.0, ops)
                log(f"scan_synth ({label}: {topology}, P={pop}, n={n}, floor, float32): kernel "
                    f"{ms:.4f} ms (median of {TIMED_LAUNCHES}), plain loop {plain_ms:.2f} ms, "
                    f"bound {bound_ms:.4f} ms by {by} {card()}")
                if label == "bench":
                    self.kernels.setdefault("scan_synth", {}).update(
                        route="cuda", source="pmfm_tpu_torch/csrc/scan_synth.cu",
                        replaces="pmfm_tpu/ops/synthesis.py:220", ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=by, library_ms=None)
        log(f"scan kernel bit-equal to its plain loop in {checked} settings (chains {SCAN_GRID} x "
            f"floor/exact/table x float32/bf16 at P={SCAN_GRID_POP}, n=1024; the bench's and "
            f"parameters.json's shapes)")
        self.kernels.setdefault("scan_synth", {})["max_abs_err"] = worst

    # -- 18 -----------------------------------------------------------------
    def unfused(self):
        """Each unfused engine at the bench shape with scan and scanless
        synthesis: held against the same engine on the CPU (UNFUSED_CHECK_POP
        candidates of the CPU tests' mild-index ranges), the known-params
        truth first, and UNFUSED_GENERATIONS generations of ``evolve``
        (ms/gen, the engine, launches); then the rfft rung at
        RFFT_RUNG_LOG2N, P 2^15."""
        from pmfm_tpu_torch.es import active_engine, evaluate, evolve, init_state
        from pmfm_tpu_torch.es import generation_step, make_spectrum_ops
        from pmfm_tpu_torch.ops import synthesize_single, target_spectrum

        base = self.cfg.replace(fused_kernel=False, fused_generation=False,
                                mutation_noise="clt12_neutral")
        mild = (2000.0, 2.0) * 3
        rng = np.random.default_rng(SEED + 18)
        check_v = rng.random((UNFUSED_CHECK_POP, D)).astype(np.float32)
        check_t = (rng.random(base.n_samples // 2) * 5.0).astype(np.float32)
        truth_v = np.asarray(TRUTH, np.float32) / np.asarray(base.param_maxs, np.float32)
        values = rng.random((POP, D)).astype(np.float32)
        values[0] = truth_v
        values = torch.from_numpy(values).to(self.dev)
        for engine, method, dtype in UNFUSED_ENGINES:
            for synth in ("scan", "scanless"):
                cfg = base.replace(spectrum_method=method, dft_dtype=dtype, synthesis_engine=synth)
                so = make_spectrum_ops(cfg, device=self.dev)
                name = active_engine(cfg, so)
                require(name == engine, f"{engine}: the router names {name}")
                ck = cfg.replace(param_maxs=mild, num_offspring=UNFUSED_CHECK_POP - MU)
                cpu_so = make_spectrum_ops(ck, device="cpu")
                got = evaluate(torch.from_numpy(check_v).to(self.dev),
                               torch.from_numpy(check_t).to(self.dev), so, ck).cpu()
                want = evaluate(torch.from_numpy(check_v), torch.from_numpy(check_t), cpu_so, ck)
                e = rel_err(got.double(), want.double())
                max_rel, median_rel = UNFUSED_TOL[dtype]
                audio = synthesize_single(torch.tensor(TRUTH), cfg.n_samples, TOPOLOGY,
                                          engine=synth).to(self.dev)
                tgt = target_spectrum(audio, so)
                fit = evaluate(values, tgt, so, cfg)
                rank = int(torch.argmin(fit))
                state = init_state(SEED, cfg, device=self.dev)
                evolve(state, tgt, 1, so, cfg)  # warm-up
                torch.cuda.synchronize()
                self.reset_counts()
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                final, _ = evolve(state, tgt, UNFUSED_GENERATIONS, so, cfg)
                t1.record()
                t1.synchronize()
                ms = t0.elapsed_time(t1) / UNFUSED_GENERATIONS
                counts = self.read_counts()
                log(f"unfused {name} ({dtype}, {synth} synthesis; n={cfg.n_samples}, P={POP}): "
                    f"card vs CPU on {UNFUSED_CHECK_POP} candidates max rel {float(e.max()):.3e} "
                    f"median rel {float(e.median()):.3e} (tolerance {max_rel:g} / "
                    f"{median_rel:g}); truth rank {rank}; {UNFUSED_GENERATIONS} "
                    f"generations {ms:.4f} ms/gen, {POP / ms * 1e3:.4g} candidate-evals/s, best "
                    f"fitness {float(final.best_fitness):.6g}; launches {counts} {card()}")
                require(bool(torch.isfinite(fit).all()), f"{name}: fitness not finite")
                require(float(e.max()) <= max_rel and float(e.median()) <= median_rel,
                        f"{name} ({dtype}, {synth}): the card disagrees with the CPU")
                require(rank == 0, f"{name} ({dtype}, {synth}): the truth does not rank first")
                want_scan = UNFUSED_GENERATIONS if synth == "scan" else 0
                require(counts["scan_synth"] == want_scan and sum(counts.values()) == want_scan,
                        f"{name}: launches {counts}")
                self.cell_ms[f"unfused {name} {dtype} {synth}"] = ms
        for log2n in RFFT_RUNG_LOG2N:
            for synth in ("scanless", "scan"):
                cfg = base.replace(spectrum_method="rfft", dft_dtype="float32",
                                   audio_length_log2=log2n, synthesis_engine=synth)
                so = make_spectrum_ops(cfg, device=self.dev)
                state = init_state(SEED, cfg, device=self.dev)
                tgt = torch.rand((so.num_bins,), device=self.dev)
                ms = cuda_ms(lambda: generation_step(state, tgt, so, cfg), 3)
                ev_ms = cuda_ms(lambda: evaluate(values, tgt, so, cfg), 3)
                log(f"rfft rung ({active_engine(cfg, so)}, {synth} synthesis, n={cfg.n_samples}, "
                    f"P={POP}): a generation {ms:.4f} ms, evaluate {ev_ms:.4f} ms {card()}")
        torch.cuda.empty_cache()

    # -- 19 -----------------------------------------------------------------
    def cli(self):
        """``pmfm_tpu_torch.cli.main`` on each of CLI_CONFIGS as written, run
        from CLI_DIR as a user runs it: exit code 0, the engine named, the
        WAV and the CSV written, the best parameters printed by name; the
        launches of each run."""
        import io
        import os
        import shutil

        from pmfm_tpu_torch import cli
        from pmfm_tpu_torch.io import load_config

        root = os.getcwd()
        work = os.path.join(root, CLI_DIR)
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        try:
            for config in CLI_CONFIGS:
                rc = load_config(os.path.join(root, config))
                cfg = rc.es
                out = io.StringIO()
                os.chdir(work)
                torch.cuda.synchronize()
                self.reset_counts()
                t0 = time.perf_counter()
                try:
                    with contextlib.redirect_stdout(out):
                        code = cli.main(["-j", os.path.join(root, config)])
                finally:
                    os.chdir(root)
                seconds = time.perf_counter() - t0
                counts = self.read_counts()
                text = out.getvalue()
                engine = next((ln for ln in text.splitlines() if ln.startswith("engine: ")), "")
                best = text[text.find("Overall best parameters found"):].splitlines()[:3]
                gens = rc.num_generations
                csv = os.path.join(work, f"gpulog(pop={cfg.population_size}gens={gens}"
                                         f"audioBlockSize={cfg.n_samples}).csv")
                wav = os.path.join(work, rc.output_audio_path)
                evals = cfg.population_size * gens
                log(f"cli {config}: exit {code} in {seconds:.2f}s (stage rows included), "
                    f"{engine!r}; {evals / seconds:.4g} candidate evaluations a second over the "
                    f"whole command; {' / '.join(s.strip() for s in best)}; launches {counts} "
                    f"{card()}")
                for ln in text.splitlines():
                    if ln.startswith(("Total time to complete", "candidate evaluations", "chunk ")):
                        print(f"  {ln}", flush=True)
                require(code == 0 and engine, f"{config}: exit {code}")
                require(os.path.exists(wav) and os.path.exists(csv), f"{config}: no WAV or CSV")
                with open(csv) as f:
                    rows = [ln.split(",") for ln in f.read().splitlines()]
                require(len(rows[0]) == 9 and rows[-1][0] == "Total Audio Analysis Time",
                        f"{config}: CSV {rows[0]}")
                require("Overall best parameters found" in text, f"{config}: no best parameters")
                if config == "parameters.json":
                    # a launch a generation, the target's, the best's, and the stage rows'
                    require(counts["scan_synth"] >= gens + 2, f"{config}: launches {counts}")
                    self.kernels.setdefault("scan_synth", {})["launches"] = counts["scan_synth"]
                else:
                    require(counts["fused_generation"] >= gens, f"{config}: launches {counts}")
        finally:
            shutil.rmtree(work, ignore_errors=True)

    # -- 20 -----------------------------------------------------------------
    def parallel_kernels(self):
        """B1/B2 in the fm{k}_parallel mode, int8 and true f32, against their
        plain versions: at PARALLEL_CONFIG's shape with its truth planted
        first, then over phase 4b's grid with PARALLEL_TOPOLOGIES,
        PARALLEL_SINE_ORDERS and PARALLEL_GRID_POPS against a random target;
        then the four kernels' times at that shape beside the series
        chain's."""
        from pmfm_tpu_torch.es import kernel_seed
        from pmfm_tpu_torch.io import load_config

        base = load_config(PARALLEL_CONFIG).es
        self.parallel = {}
        limits = {"int8": (FIT_MAX_REL, FIT_MEDIAN_REL), "f32": (F32_FIT_MAX_REL, F32_FIT_MEDIAN_REL)}
        for i, (mode, cfg) in enumerate((("int8", base), ("f32", base.refine_config()))):
            c = self.inputs(cfg, SEED + 60 + i, PARALLEL_TRUTH[: cfg.num_dimensions])
            self.parallel[mode] = c
            where = (f"{mode}, {cfg.topology}, n={cfg.n_samples}, P={cfg.population_size}, "
                     f"sine order {cfg.sine_order}")
            e1, e2, fk, a1, a2 = self.fused_check(
                where, c["params"], c["pv"], c["ps"], c["target"], self.kw_b1(c), self.kw_b2(c),
                kernel_seed(SEED, 60 + i), limits[mode])
            rank = int(torch.argmin(fk))
            log(f"B1/B2 parallel {where}: fitness max rel B1 {e1:.3e} B2 {e2:.3e} (limits "
                f"{limits[mode][0]:g} / {limits[mode][1]:g}); B2 values bit-equal, B2 fitness "
                f"bit-equal to B1 on its offspring; truth rank {rank}")
            require(rank == 0, "the known-params truth does not rank first")
            sfx = "" if mode == "int8" else "_f32"
            self.kernels[f"fused_synth_fitness_parallel{sfx}"] = {"max_abs_err": a1}
            self.kernels[f"fused_generation_parallel{sfx}"] = {"max_abs_err": a2}
        for mode, dtype in (("int8", "int8"), ("f32", "float32")):
            self.grid(dtype, PARALLEL_GRID_POPS, limits[mode], SEED + 62, 6000,
                      PARALLEL_TOPOLOGIES, PARALLEL_SINE_ORDERS)
        self.parallel_timings()

    def parallel_timings(self):
        """The parallel mode's four kernels at PARALLEL_CONFIG's shape (the
        JSON rows: fm3_parallel), and B1/B2 of each of PARALLEL_TIMED at the
        same P, n and sine order (the series chain fm3_series beside the
        banks)."""
        from pmfm_tpu_torch.es import kernel_seed
        from pmfm_tpu_torch.kernels import generation as gn
        from pmfm_tpu_torch.kernels import synth_fitness as sf
        from pmfm_tpu_torch.ops.synthesis import parallel_pairs, topology_dims

        seed = kernel_seed(SEED, 70)
        for mode in ("int8", "f32"):
            c = self.parallel[mode]
            cfg = c["cfg"]
            pop, mu, n, k, d = (cfg.population_size, cfg.num_parents, cfg.n_samples,
                                c["so"].num_bins, cfg.num_dimensions)
            kw1, kw2 = self.kw_b1(c), self.kw_b2(c)
            dft_ops = 2.0 * 2 * k * (n // 2) * pop
            synth = bank_ops_f32(pop, n, k, parallel_pairs(cfg.topology), ncoef=5)
            operand = 2 * k * (n // 2) * (1 if mode == "int8" else 4)
            int8_ops, f32_ops = (dft_ops, synth) if mode == "int8" else (0.0, synth + dft_ops)
            sfx = "" if mode == "int8" else "_f32"
            rows = {
                f"fused_synth_fitness_parallel{sfx}": (
                    lambda: sf.fused_synth_fitness(c["params"], c["target"], **kw1),
                    lambda: sf.fused_synth_fitness_plain(c["params"], c["target"], **kw1),
                    pop * d * 4 + operand + k * 4 + pop * 4, int8_ops, f32_ops,
                    "pmfm_tpu/kernels/synth_fitness.py:767"),
                f"fused_generation_parallel{sfx}": (
                    lambda: gn.fused_generation(seed, c["pv"], c["ps"], c["target"], **kw2),
                    lambda: gn.fused_generation_plain(seed, c["pv"], c["ps"], c["target"], **kw2),
                    2 * mu * d * 4 + operand + k * 4 + pop * 4 + 2 * pop * d * 4, int8_ops,
                    f32_ops + pop * d * 12 * 2.0, "pmfm_tpu/kernels/generation.py:438"),
            }
            src = "pmfm_tpu_torch/csrc/fused_eval.cu" if mode == "int8" else \
                "pmfm_tpu_torch/csrc/fused_f32.cu"
            for name, (fn, plain, nbytes, i8, f32, replaces) in rows.items():
                ms = cuda_ms(fn, TIMED_LAUNCHES)
                plain_ms = cuda_ms(plain, PLAIN_RUNS)
                bound_ms, by = bound(nbytes, i8, f32)
                log(f"{name} ({cfg.topology}, n={n}, K={k}, P={pop}, sine order "
                    f"{cfg.sine_order}): kernel {ms:.4f} ms (median of {TIMED_LAUNCHES}), plain "
                    f"{plain_ms:.2f} ms (median of {PLAIN_RUNS}), bound {bound_ms:.4f} ms by {by} "
                    f"({nbytes / 1e6:.2f} MB, {i8 / 1e9:.1f} G int8 ops, {f32 / 1e9:.2f} G f32 "
                    f"ops) {card()}")
                self.kernels.setdefault(name, {}).update(
                    route="cuda", source=src, replaces=replaces, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=by, library_ms=None)
            line = []
            for topology in PARALLEL_TIMED:
                td, maxs = topology_dims(topology), param_maxs(topology)
                rng = np.random.default_rng(SEED + 71)
                t = lambda a: torch.from_numpy(a.astype(np.float32)).to(self.dev)  # noqa: E731
                params = t(rng.random((pop, td)) * np.asarray(maxs))
                pv, ps = t(rng.random((mu, td))), t(rng.uniform(0.02, 0.3, (mu, td)))
                k1 = dict(kw1, topology=topology)
                k2 = dict(kw2, topology=topology, param_mins=(0.0,) * td, param_maxs=maxs,
                          beta_scale=1.0 / td)
                b1 = cuda_ms(lambda: sf.fused_synth_fitness(params, c["target"], **k1),
                             TIMED_LAUNCHES)
                b2 = cuda_ms(lambda: gn.fused_generation(seed, pv, ps, c["target"], **k2),
                             TIMED_LAUNCHES)
                line.append(f"{topology} B1 {b1:.4f} ms B2 {b2:.4f} ms")
            log(f"B1/B2 {mode} at n={n}, K={k}, P={pop}, sine order {cfg.sine_order}: "
                f"{'; '.join(line)} {card()}")

    # -- 21 -----------------------------------------------------------------
    def pursuit(self):
        """``cli.main`` on each pursuit example in PURSUIT_DIR, as a user runs
        it: PURSUIT_AS_WRITTEN as written (exit 0, the WAV and the CSV, its
        first chunk's relative spectral error under the f32 engine below
        PURSUIT_MAX_REL), the others with each stage's generations cut by
        PURSUIT_GENERATION_CUT and one attempt through a wrapped
        ``load_config`` (exit 0, the WAV and the CSV, the final f32 fitness
        no worse than the silent estimate's, every chunk); each run's
        attempts, generations, seconds by part, launches, and how far the
        true parameters lie from each chunk under the same f32 engine (the
        best a phase-0 model can reach there, about). First the f32 engine's
        peak memory per candidate sample at the block stages' shapes, the
        calibration of ``es.staged._batch_width_cap``."""
        import dataclasses
        import inspect
        import io
        import os
        import shutil

        import pmfm_tpu_torch.io
        from pmfm_tpu_torch import cli
        from pmfm_tpu_torch.es import staged
        from pmfm_tpu_torch.kernels import generation as gn
        from pmfm_tpu_torch.kernels import synth_fitness as sf
        from pmfm_tpu_torch.ops.synthesis import series_ops

        self.engine_memory()
        root = os.getcwd()
        work = os.path.join(root, PURSUIT_DIR)
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        load = pmfm_tpu_torch.io.load_config

        def cut(path):  # each stage's generations / PURSUIT_GENERATION_CUT, one attempt
            rc = load(path)
            series = (series_ops(rc.es.topology) or 0) >= 4
            keys = staged.SERIES_CONFIG_KEY_MAP if series else staged.CONFIG_KEY_MAP
            defaults = inspect.signature(
                staged._series_attempt if series else staged._pursuit_attempt).parameters
            p = dict(rc.pursuit, maxAttempts=1)
            for key, snake in keys.items():
                if key.endswith("Generations"):
                    p[key] = max(1, int(p.get(key, defaults[snake].default))
                                 // PURSUIT_GENERATION_CUT)
            return dataclasses.replace(rc, pursuit=tuple(sorted(p.items())))

        try:
            for config in (PURSUIT_AS_WRITTEN,) + PURSUIT_CUT:
                as_written = config == PURSUIT_AS_WRITTEN
                pmfm_tpu_torch.io.load_config = load if as_written else cut
                rc = pmfm_tpu_torch.io.load_config(os.path.join(root, config))
                out = io.StringIO()
                os.chdir(work)
                torch.cuda.synchronize()
                self.reset_counts()
                t0 = time.perf_counter()
                try:
                    with contextlib.redirect_stdout(out):
                        code = cli.main(["-j", os.path.join(root, config)])
                finally:
                    os.chdir(root)
                    pmfm_tpu_torch.io.load_config = load
                seconds = time.perf_counter() - t0
                text = out.getvalue()
                counts = {k: v for k, v in self.read_counts().items() if v}
                modes = {"B1": dict(sf.fused_synth_fitness.launches_by),
                         "B2": dict(gn.fused_generation.launches_by)}
                lines = [ln for ln in text.splitlines() if ln.startswith("pursuit chunk ")]
                engine = next((ln for ln in text.splitlines() if ln.startswith("engine: ")), "")
                cfg = rc.es
                wav = os.path.join(work, rc.output_audio_path)
                csv = os.path.join(work, f"gpulog(pop={cfg.population_size}gens="
                                         f"{rc.num_generations}audioBlockSize={cfg.n_samples}).csv")
                how = "as written" if as_written else (
                    f"stage generations / {PURSUIT_GENERATION_CUT}, one attempt: "
                    f"{dict(rc.pursuit)}")
                log(f"pursuit {config} ({how}): exit {code} in {seconds:.2f}s (stage rows "
                    f"included), {engine!r}; launches {counts}, B1/B2 by mode {modes} {card()}")
                truth = self.truth_rel(rc)
                for i, ln in enumerate(lines):
                    print(f"  {ln}; the true parameters' own error on this chunk "
                          f"{truth[i]:.6g}", flush=True)
                require(code == 0 and lines, f"{config}: exit {code}")
                require(os.path.exists(wav) and os.path.exists(csv), f"{config}: no WAV or CSV")
                for i, ln in enumerate(lines):
                    m = re.search(r"f32 fitness (\S+), silent estimate (\S+), relative spectral "
                                  r"error (\S+)", ln)
                    f32, silent, rel = (float(x) for x in m.groups())
                    require(np.isfinite(f32) and f32 <= silent, f"{config}: worse than silence")
                    if as_written and i == 0:
                        require(rel < PURSUIT_MAX_REL,
                                f"{config}: relative spectral error {rel} >= {PURSUIT_MAX_REL}")
                if as_written:
                    require(modes["B2"].get("parallel_int8", 0) > 0
                            and modes["B2"].get("parallel_f32", 0) > 0
                            and modes["B1"].get("parallel_int8", 0) > 0
                            and modes["B1"].get("parallel_f32", 0) > 0,
                            f"{config}: the parallel kernels did not all run: {modes}")
                    for name, kern, mode in (
                            ("fused_synth_fitness_parallel", "B1", "parallel_int8"),
                            ("fused_generation_parallel", "B2", "parallel_int8"),
                            ("fused_synth_fitness_parallel_f32", "B1", "parallel_f32"),
                            ("fused_generation_parallel_f32", "B2", "parallel_f32")):
                        self.kernels.setdefault(name, {})["launches"] = modes[kern][mode]
                elif "huge_frame" in config:
                    require(counts.get("fused_synth_stream", 0) > 0, f"{config}: B4 not launched")
                else:
                    require(counts.get("fused_generation", 0) > 0, f"{config}: B2 not launched")
        finally:
            shutil.rmtree(work, ignore_errors=True)

    def truth_rel(self, rc):
        """The relative spectral error of a params config's true parameters
        on each chunk of its target (synthesised as the CLI synthesises it),
        under the block stages' f32 engine."""
        from pmfm_tpu_torch.es import evaluate, staged
        from pmfm_tpu_torch.ops import synthesize_single, target_spectrum

        cfg = rc.es
        n = cfg.n_samples
        params = torch.tensor(rc.input_params, dtype=torch.float32, device=self.dev)
        audio = synthesize_single(params, max(2048, n), cfg.topology,
                                  wavetable_size=cfg.wavetable_size, sample_rate=cfg.sample_rate,
                                  osc_mode=cfg.osc_mode)
        ecfg = staged._eval_cfg(cfg)
        so = staged._spectrum_ops(ecfg, self.dev)
        lo = torch.tensor(cfg.param_mins, device=self.dev)
        hi = torch.tensor(cfg.param_maxs, device=self.dev)
        norm = ((params - lo) / (hi - lo))[None]
        out = []
        for i in range(len(audio) // n):
            t = target_spectrum(audio[i * n : (i + 1) * n], so)
            fit = float(evaluate(norm, t, so, ecfg)[0])
            out.append((fit / float((t.double() ** 2).sum())) ** 0.5)
        return out

    def engine_memory(self):
        """Peak device memory of one evaluate() of the block stages' f32
        engine (``staged._eval_cfg``) per candidate sample, at the examples'
        stage population 8192: fm3_parallel at n 1024 and fm2 at n 65536."""
        from pmfm_tpu_torch.es import evaluate, staged
        from pmfm_tpu_torch.io import load_config

        for config in (PARALLEL_CONFIG, "examples/huge_frame_match.json"):
            cfg = staged._eval_cfg(load_config(config).es)
            so = staged._spectrum_ops(cfg, self.dev)
            pop = 1 << 13
            values = torch.rand((pop, cfg.num_dimensions), device=self.dev)
            target = torch.rand((so.num_bins,), device=self.dev)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            evaluate(values, target, so, cfg)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            per = peak / (pop * cfg.n_samples)
            log(f"block-stage f32 engine ({cfg.topology}, n={cfg.n_samples}, P={pop}): peak "
                f"{peak / 2**30:.3f} GiB above the inputs, {per:.1f} bytes a candidate sample "
                f"(es.staged.F32_ENGINE_BYTES_PER_SAMPLE = {staged.F32_ENGINE_BYTES_PER_SAMPLE}); "
                f"_batch_width_cap {staged._batch_width_cap(cfg.n_samples, pop, self.dev)} "
                f"{card()}")
            require(per <= staged.F32_ENGINE_BYTES_PER_SAMPLE,
                    "the f32 engine takes more memory than _batch_width_cap assumes")

    # -- 22 -----------------------------------------------------------------
    def stft_settings(self):
        """(mode, ESConfig) of ``--mode stft`` on AUDIO_CONFIG as written: its
        int8 generations and its f32 tail, at STFT_FRAMES frames."""
        from pmfm_tpu_torch.io import load_config

        cfg = load_config(AUDIO_CONFIG).es.replace(num_frames=STFT_FRAMES)
        return (("int8", cfg), ("f32", cfg.refine_config()))

    def frame_kernels(self):
        """B1/B2 in the multi-frame mode against their plain versions
        (``fused_check``): at ``--mode stft``'s shape with the truth planted
        first against the framewise spectra of the truth over STFT_FRAMES
        frames, then over FRAME_GRID_N x FRAME_GRID_F x FRAME_GRID_TOPOLOGIES
        at FRAME_GRID_POP against a random (F, K) target, int8 and f32."""
        from pmfm_tpu_torch.es import kernel_seed
        from pmfm_tpu_torch.ops import spectral, synthesize_single
        from pmfm_tpu_torch.ops.synthesis import topology_dims

        limits = {"int8": (FIT_MAX_REL, FIT_MEDIAN_REL), "f32": (F32_FIT_MAX_REL, F32_FIT_MEDIAN_REL)}
        self.frames = {}
        for i, (mode, cfg) in enumerate(self.stft_settings()):
            c = self.inputs(cfg, SEED + 80 + i)
            audio = synthesize_single(torch.tensor(TRUTH), cfg.n_samples * cfg.num_frames,
                                      cfg.topology).to(self.dev)
            c["target"] = spectral.target_spectrum_frames(audio, c["so"])
            self.frames[mode] = c
            where = (f"{mode}, {cfg.topology}, n={cfg.n_samples}, F={cfg.num_frames}, "
                     f"P={cfg.population_size}, sine order {cfg.sine_order}")
            e1, e2, fk, a1, a2 = self.fused_check(
                where, c["params"], c["pv"], c["ps"], c["target"], self.kw_b1(c), self.kw_b2(c),
                kernel_seed(SEED, 80 + i), limits[mode])
            rank = int(torch.argmin(fk))
            log(f"B1/B2 multi-frame {where}: fitness max rel B1 {e1:.3e} B2 {e2:.3e} (limits "
                f"{limits[mode][0]:g} / {limits[mode][1]:g}); B2 values bit-equal, B2 fitness "
                f"bit-equal to B1 on its offspring; truth rank {rank}")
            require(rank == 0, "the known-params truth does not rank first")
            sfx = "" if mode == "int8" else "_f32"
            self.kernels[f"fused_synth_fitness_frames{sfx}"] = {"max_abs_err": a1}
            self.kernels[f"fused_generation_frames{sfx}"] = {"max_abs_err": a2}
        rng = np.random.default_rng(SEED + 82)
        pop, cases = FRAME_GRID_POP, 0
        for mode, dtype in (("int8", "int8"), ("f32", "float32")):
            worst = [0.0, 0.0]
            for n in FRAME_GRID_N:
                so = spectral.make_spectrum_ops(n, None, dft_dtype=dtype, device=self.dev)
                for frames in FRAME_GRID_F:
                    tgt = torch.from_numpy(rng.uniform(0.0, 50.0, (frames, so.num_bins)).astype(
                        np.float32)).to(self.dev)
                    for topology in FRAME_GRID_TOPOLOGIES:
                        d = topology_dims(topology)
                        mins, maxs = (0.0,) * d, param_maxs(topology)
                        dev = lambda a: torch.from_numpy(a.astype(np.float32)).to(self.dev)  # noqa: E731
                        params = dev(rng.random((pop, d)) * np.asarray(maxs))
                        pv, ps = dev(rng.random((MU, d))), dev(rng.uniform(0.02, 0.3, (MU, d)))
                        kw1 = dict(dft_packed=so.dft_packed, dft_scale=so.dft_packed_scale,
                                   topology=topology, n=n, pop_block=pop, sine_order=9,
                                   num_frames=frames)
                        kw2 = dict(kw1, pop=pop, param_mins=mins, param_maxs=maxs)
                        where = f"{mode}, {topology}, n={n}, F={frames}, P={pop}"
                        e = self.fused_check(where, params, pv, ps, tgt, kw1, kw2,
                                            kernel_seed(SEED, 8000 + cases), limits[mode])
                        worst = [max(worst[0], e[0]), max(worst[1], e[1])]
                        cases += 1
            log(f"B1/B2 multi-frame {mode} grid: n {FRAME_GRID_N} x F {FRAME_GRID_F} x "
                f"{FRAME_GRID_TOPOLOGIES} at P {pop}, sine order 9, within {limits[mode][0]:g} / "
                f"{limits[mode][1]:g}: worst max rel B1 {worst[0]:.3e} B2 {worst[1]:.3e}; B2 "
                f"values bit-equal, B2 fitness bit-equal to B1 on its offspring")

    # -- 23 -----------------------------------------------------------------
    def run_inputs(self, cfg, so, runs, seed):
        """B runs' operands at ``cfg``'s shape from ``seed``: candidates (B, P,
        D), parents (B, mu, D) and a random target (B, F, K) a run."""
        rng = np.random.default_rng(seed)
        pop, mu, d, f = cfg.population_size, cfg.num_parents, cfg.num_dimensions, cfg.num_frames
        dev = lambda a: torch.from_numpy(a.astype(np.float32)).to(self.dev)  # noqa: E731
        return dict(params=dev(rng.random((runs, pop, d)) * np.asarray(cfg.param_maxs)),
                    pv=dev(rng.random((runs, mu, d))),
                    ps=dev(rng.uniform(0.02, 0.3, (runs, mu, d))),
                    target=dev(rng.uniform(0.0, 50.0, (runs, f, so.num_bins))))

    def run_kernels(self):
        """The run axis at AUDIO_CONFIG's shape, int8 and its f32 tail: B1, B2
        and B5 (RUN_B5_GENERATIONS generations) launched once for each of
        RUN_SETTINGS (runs, frames, population), bit-equal, run for run, to lone
        launches; at B 4, F 1 each batched kernel against its plain version
        (B1/B2 within their limits; B5 within B2's, two generations); and B5
        at STFT_FRAMES frames bit-equal to its generations' B2 launches with
        the stable selection."""
        from pmfm_tpu_torch.es import kernel_seed, make_spectrum_ops
        from pmfm_tpu_torch.io import load_config
        from pmfm_tpu_torch.kernels import evolve as ev
        from pmfm_tpu_torch.kernels import generation as gn
        from pmfm_tpu_torch.kernels import synth_fitness as sf

        limits = {"int8": (FIT_MAX_REL, FIT_MEDIAN_REL), "f32": (F32_FIT_MAX_REL, F32_FIT_MEDIAN_REL)}
        base = load_config(AUDIO_CONFIG).es
        g = RUN_B5_GENERATIONS
        for mi, (mode, cfg0) in enumerate((("int8", base), ("f32", base.refine_config()))):
            sfx = "" if mode == "int8" else "_f32"
            for si, (runs, frames, ragged) in enumerate(RUN_SETTINGS):
                cfg = cfg0.replace(num_frames=frames)
                if ragged:
                    cfg = cfg.replace(num_offspring=ragged - cfg.num_parents)
                so = make_spectrum_ops(cfg, device=self.dev)
                c = self.run_inputs(cfg, so, runs, SEED + 90 + 10 * mi + si)
                kw1 = self.kw_b1(dict(cfg=cfg, so=so))
                kw2 = self.kw_b2(dict(cfg=cfg, so=so))
                seeds = [kernel_seed(SEED, 900 + r) for r in range(runs)]
                fb = sf.fused_synth_fitness(c["params"], c["target"], **kw1)
                gb = gn.fused_generation(seeds, c["pv"], c["ps"], c["target"], **kw2)
                f1 = torch.stack([sf.fused_synth_fitness(c["params"][r], c["target"][r], **kw1)
                                  for r in range(runs)])
                g1 = [gn.fused_generation(seeds[r], c["pv"][r], c["ps"][r], c["target"][r], **kw2)
                      for r in range(runs)]
                eq1 = bits_equal(fb, f1)
                eq2 = all(bits_equal(gb[j], torch.stack([x[j] for x in g1])) for j in range(3))
                s5 = [[kernel_seed(SEED, 950 + r * g + i) for i in range(g)] for r in range(runs)]
                bv0 = c["pv"][:, 0].clone()
                bf0 = torch.full((runs,), float("inf"), device=self.dev)
                out = ev.fused_evolve(s5, c["pv"], c["ps"], bv0, bf0, c["target"], **kw2)
                lone = [ev.fused_evolve(s5[r], c["pv"][r], c["ps"][r], bv0[r], bf0[r],
                                        c["target"][r], **kw2) for r in range(runs)]
                eq5 = all(bits_equal(out[j], torch.stack([x[j] for x in lone])) for j in range(6))
                torch.cuda.synchronize()
                log(f"run axis ({mode}, B={runs}, F={frames}, n={cfg.n_samples}, "
                    f"P={cfg.population_size}): one launch bit-equal to {runs} lone launches: B1 "
                    f"{eq1}, B2 {eq2} (fitness, values, steps), B5 over {g} generations {eq5} "
                    f"(parents, best-ever, trajectory)")
                require(eq1 and eq2 and eq5, "a batched launch differs from the lone launches")
                if si:
                    continue
                fp = sf.fused_synth_fitness_plain(c["params"], c["target"], **kw1)
                gp = gn.fused_generation_plain(seeds, c["pv"], c["ps"], c["target"], **kw2)
                e1, e2 = rel_err(fb, fp), rel_err(gb[0], gp[0])
                ok = (float(e1.max()) <= limits[mode][0] and float(e1.median()) <= limits[mode][1]
                      and float(e2.max()) <= limits[mode][0]
                      and float(e2.median()) <= limits[mode][1] and torch.equal(gb[1], gp[1]))
                log(f"run axis vs plain ({mode}, B={runs}, F={frames}): B1 max rel "
                    f"{float(e1.max()):.3e} median {float(e1.median()):.3e}, B2 max rel "
                    f"{float(e2.max()):.3e} median {float(e2.median()):.3e}, B2 values equal "
                    f"{torch.equal(gb[1], gp[1])}")
                require(ok, "a batched kernel disagrees with its plain version")
                self.kernels[f"fused_synth_fitness_runs{sfx}"] = {
                    "max_abs_err": float((fb - fp).abs().max())}
                self.kernels[f"fused_generation_runs{sfx}"] = {
                    "max_abs_err": float((gb[0] - gp[0]).abs().max())}
                if mode == "int8":
                    s2 = [x[:2] for x in s5]
                    k5 = ev.fused_evolve(s2, c["pv"], c["ps"], bv0, bf0, c["target"], **kw2)
                    p5 = ev.fused_evolve_plain(s2, c["pv"], c["ps"], bv0, bf0, c["target"], **kw2)
                    e5 = rel_err(k5[2], p5[2])
                    log(f"B5 run axis vs plain (int8, B={runs}, 2 generations): parent fitness "
                        f"max rel {float(e5.max()):.3e} median {float(e5.median()):.3e}")
                    require(float(e5.max()) <= FIT_MAX_REL and float(e5.median()) <= FIT_MEDIAN_REL,
                            "batched B5 disagrees with its plain version")
                    self.kernels["fused_evolve_runs"] = {
                        "max_abs_err": float((k5[2] - p5[2]).abs().max())}
        names = ("parent values", "parent steps", "parent fitness", "best values", "best fitness",
                 "trajectory")
        for mode, cfg in self.stft_settings():
            so = make_spectrum_ops(cfg, device=self.dev)
            c = self.run_inputs(cfg, so, 1, SEED + 99)
            pv, ps, tgt = c["pv"][0], c["ps"][0], c["target"][0]
            kw2 = self.kw_b2(dict(cfg=cfg, so=so))
            seeds = [kernel_seed(SEED, 990 + i) for i in range(g)]
            args = (pv, ps, pv[0].clone(), torch.tensor(float("inf"), device=self.dev), tgt)
            out = ev.fused_evolve(seeds, *args, **kw2)
            loop = ev.fused_evolve_plain(seeds, *args, generation=gn.fused_generation, **kw2)
            torch.cuda.synchronize()
            equal = all(bits_equal(a, b) for a, b in zip(out, loop))
            diffs = {nm: float((a - b).abs().nan_to_num().max()) for nm, a, b in zip(names, out, loop)}
            log(f"B5 multi-frame vs {g} B2 launches + stable selection ({mode}, n={cfg.n_samples}, "
                f"F={cfg.num_frames}, P={cfg.population_size}): bit-equal {equal}; max abs diff "
                f"{diffs}")
            require(equal, "multi-frame B5 is not bit-equal to the loop of B2 launches")
            if mode == "int8":
                s2 = seeds[:2]
                pl = ev.fused_evolve_plain(s2, *args, **kw2)
                k5 = ev.fused_evolve(s2, *args, **kw2)
                e5 = rel_err(k5[2], pl[2])
                require(float(e5.max()) <= FIT_MAX_REL and float(e5.median()) <= FIT_MEDIAN_REL,
                        "multi-frame B5 disagrees with its plain version")
                self.kernels["fused_evolve_frames"] = {
                    "max_abs_err": float((k5[2] - pl[2]).abs().max())}

    # -- 24 -----------------------------------------------------------------
    def launches_by(self):
        """Each counted wrapper's launches by mode (``launch_mode``)."""
        return {name: dict(fn.launches_by) for name, fn in self.counters().items()
                if hasattr(fn, "launches_by") and fn.launches_by}

    def a6_cli(self, work, config, args, label):
        """``cli.main`` on ``config`` with ``args`` in ``work``: exit 0, its
        best fitness and parameters, the launches by mode; returns (the
        output, the launches by mode)."""
        import io
        import os

        from pmfm_tpu_torch import cli

        out = io.StringIO()
        root = os.getcwd()
        torch.cuda.synchronize()
        self.reset_counts()
        t0 = time.perf_counter()
        os.chdir(work)
        try:
            with contextlib.redirect_stdout(out):
                code = cli.main(["-j", os.path.join(root, config), *args])
        finally:
            os.chdir(root)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        text, by = out.getvalue(), self.launches_by()
        engine = next((ln for ln in text.splitlines() if ln.startswith("engine: ")), "")
        fits = [ln.strip() for ln in text.splitlines() if ": fitness = " in ln]
        log(f"cli {config} {label}: exit {code} in {seconds:.2f}s, {engine!r}; launches by mode "
            f"{by} {card()}")
        for ln in fits:
            print(f"  {ln}", flush=True)
        require(code == 0 and engine and fits, f"{label}: exit {code}")
        return text, by

    def a6_paths(self):
        """The A6 paths through the entry points a user calls: ``cli.main``
        on AUDIO_CONFIG as written with ``--mode stft`` (one run over
        input.wav's 8 frames: B2 int8 at F 8 a generation, the boundary
        rescore on B1 f32 and the f32 tail at F 8), ``--mode parallel-chunks``
        (8 runs of one chunk each: one B2 launch a generation for all runs)
        and ``--batch`` over 4 WAVs of BATCH_SAMPLES samples synthesised from
        BATCH_TRUTHS (4 runs x 8 frames); then ``match_audio_stft`` and
        ``match_many`` under fused_kernel (B1 at F 8, and with the run axis)
        and fused_evolve (B5 at F 8, and with the run axis, also of one
        target) at A6_GENERATIONS. Each run's seconds, best fitness and
        launches."""
        import os
        import shutil

        from pmfm_tpu_torch.es import match_audio_stft, match_many
        from pmfm_tpu_torch.io import load_config, read_wav, write_wav
        from pmfm_tpu_torch.ops import synthesize_single

        rc = load_config(AUDIO_CONFIG)
        cfg = rc.es
        gens, r = rc.num_generations, cfg.refine_generations
        root = os.getcwd()
        work = os.path.join(root, A6_DIR)
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        shutil.copytree(os.path.join(root, "input_audio"), os.path.join(work, "input_audio"))
        try:
            out_wav = os.path.join(work, rc.output_audio_path)
            _, by = self.a6_cli(work, AUDIO_CONFIG, ["--mode", "stft"], "--mode stft")
            audio, _ = read_wav(out_wav)
            g2, g1 = by.get("fused_generation", {}), by.get("fused_synth_fitness", {})
            require(len(audio) == BATCH_SAMPLES and np.isfinite(audio).all(), "stft output WAV")
            require(g2.get("int8_frames") == gens - r and g2.get("f32_frames") == r
                    and g1.get("f32_frames", 0) >= 1, f"--mode stft launches {by}")
            self.kernels.setdefault("fused_generation_frames", {})["launches"] = g2["int8_frames"]
            self.kernels.setdefault("fused_generation_frames_f32", {})["launches"] = \
                g2["f32_frames"]
            self.kernels.setdefault("fused_synth_fitness_frames_f32", {})["launches"] = \
                g1["f32_frames"]
            _, by = self.a6_cli(work, AUDIO_CONFIG, ["--mode", "parallel-chunks"],
                                "--mode parallel-chunks")
            audio, _ = read_wav(out_wav)
            g2, g1 = by.get("fused_generation", {}), by.get("fused_synth_fitness", {})
            require(len(audio) == BATCH_SAMPLES and np.isfinite(audio).all(),
                    "parallel-chunks output WAV")
            require(g2.get("int8_runs") == gens - r and g2.get("f32_runs") == r
                    and g1.get("f32_runs", 0) >= 1, f"--mode parallel-chunks launches {by}")
            self.kernels.setdefault("fused_generation_runs", {})["launches"] = g2["int8_runs"]
            self.kernels.setdefault("fused_generation_runs_f32", {})["launches"] = g2["f32_runs"]
            self.kernels.setdefault("fused_synth_fitness_runs_f32", {})["launches"] = \
                g1["f32_runs"]
            paths = []
            for i, truth in enumerate(BATCH_TRUTHS):
                a = synthesize_single(torch.tensor(truth), BATCH_SAMPLES, cfg.topology)
                a = a + 0.01 * torch.randn(a.shape, generator=torch.Generator().manual_seed(i))
                paths.append(os.path.join(work, f"target{i}.wav"))
                write_wav(paths[-1], a.numpy(), cfg.sample_rate)
            text, by = self.a6_cli(work, AUDIO_CONFIG, ["--batch", *paths],
                                   f"--batch over {len(paths)} WAVs of {BATCH_SAMPLES} samples")
            g2 = by.get("fused_generation", {})
            require(g2.get("int8_frames_runs") == gens - r and g2.get("f32_frames_runs") == r,
                    f"--batch launches {by}")
            stem = os.path.splitext(out_wav)[0]
            for i in range(len(paths)):
                audio, _ = read_wav(f"{stem}_target{i}.wav")
                require(len(audio) == BATCH_SAMPLES, "a --batch output WAV")
        finally:
            shutil.rmtree(work, ignore_errors=True)
        wav, _ = read_wav(rc.input_audio_path)
        chunks = wav[: len(wav) // cfg.n_samples * cfg.n_samples].reshape(-1, cfg.n_samples)
        short = cfg.replace(refine_generations=A6_REFINE)
        for label, c, key in (
                ("fused_kernel", short.replace(fused_generation=False), "fused_synth_fitness"),
                ("fused_evolve", short.replace(fused_evolve=True, restart_patience=0),
                 "fused_evolve")):
            for many in (None, chunks, chunks[:1]):  # one target: a run axis of one
                torch.cuda.synchronize()
                self.reset_counts()
                t0 = time.perf_counter()
                if many is not None:
                    res = match_many(many, c, seed=SEED, num_generations=A6_GENERATIONS,
                                     device=self.dev)
                else:
                    res = [match_audio_stft(wav, c, seed=SEED, num_generations=A6_GENERATIONS,
                                            device=self.dev)]
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                by = self.launches_by()
                mode = "int8_frames" if many is None else "int8_runs"
                fits = [round(x.chunks[0].best_fitness, 6) for x in res]
                log(f"{'match_audio_stft' if many is None else 'match_many'} ({label}, {A6_GENERATIONS} "
                    f"generations, the last {A6_REFINE} f32): {len(res)} run(s) in "
                    f"{seconds:.2f}s, best fitness {fits}; launches by mode {by} {card()}")
                require(all(np.isfinite(fits)), f"{label}: fitness not finite")
                got = by.get(key, {}).get(mode, 0)
                want = A6_GENERATIONS - A6_REFINE if key == "fused_synth_fitness" else 1
                require(got >= want, f"{label}: {key} {mode} launches {got} < {want}")
                if many is None or len(many) > 1:
                    sfx = "_frames" if many is None else "_runs"
                    self.kernels.setdefault(f"{key}{sfx}", {})["launches"] = got

    # -- 25 -----------------------------------------------------------------
    def a6_timings(self):
        """Each new mode's kernel time at its driven shape beside its plain
        version's and its bound (counting F and B): B1/B2 int8 and f32 at
        ``--mode stft``'s (F 8) and at ``--mode parallel-chunks``' (B 8),
        B5 at F 8 and at B 8 over RUN_B5_GENERATIONS; then the B2 kernel and
        ``evolve`` at suite_stft_frames' shapes and ``match_many`` at
        suite_multi_target's."""
        from pmfm_tpu_torch.es import ESConfig, evolve, init_state, kernel_seed, match_many
        from pmfm_tpu_torch.es import make_spectrum_ops
        from pmfm_tpu_torch.es.pipeline import fused_generation_kwargs
        from pmfm_tpu_torch.kernels import evolve as ev
        from pmfm_tpu_torch.kernels import generation as gn
        from pmfm_tpu_torch.kernels import synth_fitness as sf
        from pmfm_tpu_torch.ops import synthesize_single

        g = RUN_B5_GENERATIONS
        for mi, (mode, cfg0) in enumerate(self.stft_settings()):
            for runs, frames in ((None, STFT_FRAMES), (8, 1)):
                cfg = cfg0.replace(num_frames=frames)
                so = make_spectrum_ops(cfg, device=self.dev)
                b = runs or 1
                c = self.run_inputs(cfg, so, b, SEED + 120 + mi)
                if runs is None:
                    c = {key: v[0] for key, v in c.items()}
                kw1 = self.kw_b1(dict(cfg=cfg, so=so))
                kw2 = self.kw_b2(dict(cfg=cfg, so=so))
                seeds = [kernel_seed(SEED, 1200 + i) for i in range(b)]
                seed = seeds if runs else seeds[0]
                s5 = [[kernel_seed(SEED, 1300 + i * g + j) for j in range(g)] for i in range(b)]
                bv = c["pv"][..., 0, :].clone()
                bf = torch.full(bv.shape[:-1], float("inf"), device=self.dev)
                b5_seeds = s5 if runs else s5[0]
                pop, mu, n, k, d = (cfg.population_size, cfg.num_parents, cfg.n_samples,
                                    so.num_bins, cfg.num_dimensions)
                f32 = mode == "f32"
                operand = 2 * k * (n // 2) * (4 if f32 else 1)
                dft_ops = 2.0 * 2 * k * (n // 2) * pop * b * frames
                synth = synth_ops_f32(pop * b, n, k, kn=3, ncoef=5) * frames
                offspring = pop * b * d * 12 * 2.0
                io = operand + b * frames * k * 4 + b * pop * 4
                sfx = ("_frames" if runs is None else "_runs") + ("_f32" if f32 else "")
                rows = {
                    f"fused_synth_fitness{sfx}": (
                        lambda: sf.fused_synth_fitness(c["params"], c["target"], **kw1),
                        lambda: sf.fused_synth_fitness_plain(c["params"], c["target"], **kw1),
                        io + b * pop * d * 4, dft_ops, synth, 1,
                        "pmfm_tpu_torch/csrc/" + ("fused_f32.cu" if f32 else "fused_eval.cu"),
                        "pmfm_tpu/kernels/synth_fitness.py:767"),
                    f"fused_generation{sfx}": (
                        lambda: gn.fused_generation(seed, c["pv"], c["ps"], c["target"], **kw2),
                        lambda: gn.fused_generation_plain(seed, c["pv"], c["ps"], c["target"],
                                                          **kw2),
                        io + 2 * b * mu * d * 4 + 2 * b * pop * d * 4, dft_ops,
                        synth + offspring, 1,
                        "pmfm_tpu_torch/csrc/" + ("fused_f32.cu" if f32 else "fused_eval.cu"),
                        "pmfm_tpu/kernels/generation.py:438"),
                }
                if not f32:
                    rows[f"fused_evolve{sfx}"] = (
                        lambda: ev.fused_evolve(b5_seeds, c["pv"], c["ps"], bv, bf, c["target"],
                                                **kw2),
                        lambda: ev.fused_evolve_plain(b5_seeds, c["pv"], c["ps"], bv, bf,
                                                      c["target"], **kw2),
                        4 * b * mu * d * 4 + 2 * b * (d + 1) * 4 + operand + b * frames * k * 4
                        + b * g * 4, g * dft_ops, g * (synth + offspring), g,
                        "pmfm_tpu_torch/csrc/evolve.cu", "pmfm_tpu/kernels/evolve.py:366")
                for name, (fn, plain, nbytes, dops, fops, gens, src, replaces) in rows.items():
                    int8_ops, f32_ops = (0.0, dops + fops) if f32 else (dops, fops)
                    ms = cuda_ms(fn, TIMED_LAUNCHES if gens == 1 else 5)
                    plain_ms = cuda_ms(plain, PLAIN_RUNS_A6)
                    bound_ms, by = bound(nbytes, int8_ops, f32_ops)
                    per = f", {ms / gens:.4f} ms a generation" if gens > 1 else ""
                    log(f"{name} ({mode}, F={frames}, B={b}, n={n}, K={k}, P={pop}): kernel "
                        f"{ms:.4f} ms{per}, plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms by "
                        f"{by} ({nbytes / 1e6:.2f} MB, {int8_ops / 1e9:.1f} G int8 ops, "
                        f"{f32_ops / 1e9:.2f} G f32 ops); {ms / bound_ms:.1f}x the bound "
                        f"{card()}")
                    self.kernels.setdefault(name, {}).update(
                        route="cuda", source=src, replaces=replaces, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=by, library_ms=None)
                if mode == "f32" and runs is None:
                    geo = sf.f32_geometry(pop, n, k, frames, 1)
                    log(f"f32 scratch at --mode stft's shape (P={pop}, n={n}, F={frames}): "
                        f"{geo['scratch_bytes'] / 2**20:.1f} MiB; at --batch's (B=4): "
                        f"{sf.f32_geometry(pop, n, k, frames, 4)['scratch_bytes'] / 2**30:.2f} "
                        f"GiB")
        # suite_stft_frames: B2 and evolve at P 2^13, mu 256, n 1024, int8, F 1/2/4/8
        base = ESConfig(num_parents=SUITE_STFT_MU, num_offspring=SUITE_STFT_POP - SUITE_STFT_MU,
                        num_dimensions=6,
                        topology="fm3_series", audio_length_log2=10, synthesis_engine="scanless",
                        spectrum_method="dft", dft_dtype="int8", fused_kernel=True,
                        fused_generation=True, pop_block=1024)
        so = make_spectrum_ops(base, device=self.dev)
        line = []
        for frames in SUITE_FRAMES:
            cfg = base.replace(num_frames=frames)
            c = self.run_inputs(cfg, so, 1, SEED + 130 + frames)
            tgt = c["target"][0] if frames > 1 else c["target"][0, 0]
            kw2 = fused_generation_kwargs(cfg, so)
            seed = kernel_seed(SEED, 1400 + frames)
            ms = cuda_ms(lambda: gn.fused_generation(seed, c["pv"][0], c["ps"][0], tgt, **kw2),
                         TIMED_LAUNCHES)
            state = init_state(3, cfg, device=self.dev)
            evolve(state, tgt, 2, so, cfg)  # warm-up
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev0.record()
            evolve(state, tgt, SUITE_GENERATIONS, so, cfg)
            ev1.record()
            ev1.synchronize()
            gen_ms = ev0.elapsed_time(ev1) / SUITE_GENERATIONS
            pop, k = cfg.population_size, so.num_bins
            dops = 2.0 * 2 * k * 512 * pop * frames
            fops = synth_ops_f32(pop, 1024, k, kn=3, ncoef=5) * frames + pop * 6 * 24.0
            bound_ms, by = bound(2 * k * 512 + frames * k * 4 + pop * 4 + 2 * pop * 6 * 4
                                 + 2 * cfg.num_parents * 6 * 4, dops, fops)
            line.append(f"F={frames}: B2 {ms:.4f} ms (bound {bound_ms:.4f} ms by {by}), evolve "
                        f"{gen_ms:.4f} ms/gen, {pop / gen_ms / 1e3:.4g} M cand/s, "
                        f"{pop * frames / gen_ms / 1e3:.4g} M frame-evals/s")
        log(f"suite_stft_frames (P=2^13, mu 256, fm3_series, n=1024, int8 B2, sine order 9): "
            f"{'; '.join(line)} {card()}")
        # suite_multi_target: match_many at B 1/4 (P 2^13) and B 32 (P 2^11)
        targets = np.stack([synthesize_single(torch.tensor(t), 1024, "fm3_series").numpy()
                            for t in BATCH_TRUTHS])
        line = []
        for runs, pop, mu in SUITE_RUNS:
            cfg = base.replace(num_parents=mu, num_offspring=pop - mu, sine_order=7)
            tg = np.tile(targets, (-(-runs // len(targets)), 1))[:runs]
            match_many(tg, cfg, seed=0, num_generations=2, device=self.dev)  # warm-up
            torch.cuda.synchronize()
            self.reset_counts()
            t0 = time.perf_counter()
            match_many(tg, cfg, seed=1, num_generations=SUITE_GENERATIONS, device=self.dev)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = self.read_counts()["fused_generation"]
            so_r = make_spectrum_ops(cfg, device=self.dev)
            c = self.run_inputs(cfg, so_r, runs, SEED + 140 + runs)
            kw2 = fused_generation_kwargs(cfg, so_r)
            seeds = [kernel_seed(SEED, 1500 + i) for i in range(runs)]
            tg_k = c["target"][:, 0]
            ms = cuda_ms(lambda: gn.fused_generation(seeds, c["pv"], c["ps"], tg_k, **kw2),
                         TIMED_LAUNCHES)
            line.append(f"B={runs} P={pop}: {dt * 1e3:.1f} ms for {SUITE_GENERATIONS} "
                        f"generations ({runs * pop * SUITE_GENERATIONS / dt / 1e6:.2f} M "
                        f"evals/s aggregate, host clock; {launches} B2 launches), B2 for all "
                        f"runs {ms:.4f} ms ({runs * pop / ms / 1e3:.2f} M evals/s)")
            require(launches == SUITE_GENERATIONS, "match_many: not one B2 launch a generation")
        log(f"suite_multi_target (match_many, fm3_series, n=1024, int8 B2, sine order 7): "
            f"{'; '.join(line)} {card()}")

    def kernels_line(self):
        keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms")
        out = []
        for name in KERNELS:
            row = dict(self.kernels.get(name, {}), name=name)
            missing = [k for k in keys if k not in row]
            require(not missing, f"{name}: no {missing}")
            out.append({k: row[k] for k in keys})
        return {"kernels": out}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=None, metavar="N,N",
                    help="run only these phases (after the device, the build and the inputs) "
                         "and print no result line: a quick check while changing a kernel")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    import pmfm_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    s = Smoke(only=None if args.only is None else set(args.only.split(",")))
    s.phase("1 device", s.device)
    s.phase("2 build", s.build)
    if s.failed:
        log(f"FAILED: {s.failed}")
        return 1
    s.phase("inputs", s.setup)
    if s.failed:
        log(f"FAILED: {s.failed}")
        return 1
    s.phase("3 B1 vs plain", s.b1_vs_plain)
    s.phase("4 B2 vs plain", s.b2_vs_plain)
    s.phase("4b B1/B2 int8 settings and grid", s.int8_grid)
    s.phase("5 evolve", s.evolve_both)
    s.phase("6 kernel times", s.timings)
    s.phase("large inputs", s.large_setup)
    if "large inputs" not in s.failed:
        s.phase("7 B3 vs plain", s.b3_vs_plain)
        s.phase("8 B4 vs plain", s.b4_vs_plain)
        s.phase("9 evolve large frames", s.evolve_large)
        s.phase("10 match_audio", s.match)
        s.phase("11 large-frame times", s.large_timings)
    s.phase("12 B1/B2 f32 vs plain", s.f32_vs_plain)
    if "12 B1/B2 f32 vs plain" not in s.failed:
        s.phase("13 B5 vs B2 loop and plain", s.b5_vs_b2)
        s.phase("14 evolve fused_evolve", s.evolve_fused)
        s.phase("15 shipped path, audio_match", s.shipped)
        s.phase("16 f32 and B5 times, bench", s.third_timings)
    s.phase("17 scan kernel vs plain", s.scan_vs_plain)
    s.phase("18 unfused engines", s.unfused)
    s.phase("19 CLI", s.cli)
    s.phase("20 B1/B2 fm{k}_parallel vs plain", s.parallel_kernels)
    s.phase("21 pursuit solver through the CLI", s.pursuit)
    s.phase("22 B1/B2 multi-frame vs plain", s.frame_kernels)
    s.phase("23 run axis: B1/B2/B5 batched vs lone", s.run_kernels)
    s.phase("24 A6 paths: --mode stft, --mode parallel-chunks, --batch", s.a6_paths)
    s.phase("25 A6 kernel times and the reference suites' shapes", s.a6_timings)
    if s.only is not None:
        faulthandler.cancel_dump_traceback_later()
        log(f"phases {sorted(s.only)}: {'FAILED: ' + str(s.failed) if s.failed else 'passed'} "
            f"{card()}")
        return 1 if s.failed else 0
    line = None
    try:
        line = s.kernels_line()
    except AssertionError:
        s.failed.append("kernels line")
        traceback.print_exc()
    faulthandler.cancel_dump_traceback_later()
    if s.failed:
        log(f"FAILED: {s.failed}")
        return 1
    log(f"all phases passed {card()}")
    print(f"{CARD['name']}, {CARD['power_limit']}", flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
