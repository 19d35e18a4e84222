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
  ``examples/audio_match.json`` as written; the f32 and B5 kernels' times
  (the f32 ones in turns with the earlier design), B5's split a generation
  (evaluation, selection, time not covered by kernels, from
  torch.profiler), the port's bench (``pmfm_tpu_torch/bench.py``, one
  repetition) and the host time of the one-run operations the ES loop
  keeps beside their run-axis forms;
* phases 17-19, the unfused engines and the CLI: the scan synthesis
  (``csrc/scan_synth.cu``) in both layouts, one thread a candidate and
  time-parallel, each bit-equal to its plain loop over samples and to the
  other at the bench's and parameters.json's shapes and over chains,
  oscillators and output types, timed in turns beside the chain floor; each
  unfused engine (``xla_dft``, ``xla_folded_dft`` int8
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
  stage's generations cut to a twentieth and one attempt).

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
  (suite_stft_frames, suite_multi_target);
* phases 26-29, the bf16 mode of B1/B2/B5 (the reference's default fused
  engine) and the reference's benchmark suite: B1/B2 bf16 against their
  plain versions at the bench shape (the truth first), over phase 4b's
  grid with fm3_parallel, at 8 frames of ``examples/audio_match.json``'s
  shape and with a run axis of 4 (bit-equal to lone launches); B5 bf16
  bit-equal to its B2 launches with the stable selection, and ``evolve``
  with fused_evolve in bf16; the operand disk cache at n 16384 (build and
  load seconds, int8 and bf16) and ``python -m pmfm_tpu_torch.bench_suite``
  (``bench_suite.main``) over the reference's suites with ``--fused``, each
  row printed beside the card; the three bf16 kernels' times beside their
  plain versions, their bound and a bf16 GEMM yardstick for the DFT half.

* phases 30-35, fm{k}_parallel banks in B3, B4 and B5 and 20-32 genes in
  every kernel: B3 (both layouts) and B4 on banks and a chain of 12
  bit-equal to their plain versions; B5 on fm3_parallel bit-equal to its B2
  launches with the stable selection (int8, bf16, f32; 8 frames; a run axis
  of 4); B1/B2 at fm5_parallel, fm8_parallel, fm10_series and fm16_series
  against their plain versions, the truth first; the fm5_parallel pursuit
  through ``cli.main`` (examples/fm4_parallel_match.json with a fifth pair,
  cut as phase 21 cuts), ``evolve`` on fm3_parallel through fused_evolve,
  synth_fold and synth_stream; the new modes' times and B3's layouts on the
  banks; phase 35, only when ``--only`` names it, the fm5_parallel pursuit
  as written.

* phase 36, checkpoint, resume, AOT and the population readback (A9):
  ``evolve_checkpointed`` stopped after a save and resumed from disk,
  bit-equal to one ``evolve`` (B2, B2 with restarts, B5), the population
  readback against B1, ``match_audio(checkpoint_dir=)`` and ``cli.main
  --mode stft --checkpoint-every`` stopped and resumed, bit-equal to runs
  that were not stopped, and ``--export-aot`` then ``--aot`` in a
  subprocess on a copy of the package that cannot build the kernels;
  phase 4 also writes its draw statistics as ``build/gen_check.json`` and
  prints them (committed as ``pmfm_tpu_torch/gen_check.json``) and fails on a stale
  committed fingerprint; phases 37 and 38, only when ``--only`` names them
  (minutes each, a watchdog of their own), the fm5_parallel pursuit on
  ``benchmarks/pursuit_fm5_parallel.json``'s own settings, seeds 64-65
  and 66-67.

* phase 39, population sharding over a mesh of ranks (A10) at the bench
  shape: a world of one on NCCL, ``evolve_sharded`` bit-equal to
  ``evolve`` over 200 generations (B2 at P 2^15), with both one's ms a
  generation; two ranks sharing the card through gloo
  (``pmfm_tpu_torch.multiprocess_check.run`` on the bench shape: B2 at
  P 2^14 each, every rank's state byte-equal, each rank's B2 launches
  counted beside the engine it names, their ms a generation: contention on
  one card, not scaling), a (1 pop x 2 frame) world, which runs the
  frame-sharded unfused path and no B2, whose frame all-reduce is held
  against the unsharded multi-frame fitness, and ``python -m torch.distributed.run --nproc-per-node 2 -m
  pmfm_tpu_torch.cli -j examples/params_match.json --mesh 2``; phase 40,
  the ES-quality gate (A1: ``pmfm_tpu_torch.convergence_check``) at 2
  seeds and 50 generations, read back by the bench's readers.

* phase 41, topologies above 32 genes (the long synthesis code,
  ``csrc/synth_common.cuh::LongSynth``, in every kernel): the long code
  bit-equal to the fixed and wide codes where both run; B1/B2 in int8,
  bf16 and f32 at fm9_parallel, fm17_series and fm16_parallel (n 256: its
  staged genes fill the int8 block's shared memory) against their plain
  versions at the bench shape, at 8 frames and with a run axis of 4 of
  ``examples/audio_match.json``'s shape; B5 bit-equal to its B2 launches;
  B3 at n 8192 and B4 at n 65536 bit-equal to their plain versions; the
  scan kernel and the unfused ``xla_dft`` at fm33_series and
  fm33_parallel; ``evolve`` through each kernel and ``cli.main`` on an
  fm9_parallel config; the new instantiations' times. Phase 42, only when
  ``--only`` names it, the fm9_parallel pursuit through ``cli.main``, cut.

* phase 43, B2 int8 in its time-parallel layout (``csrc/fused_tp.cuh``;
  ``fused_tp.cu`` the banks, ``fused_tp_chain.cu`` the chains). The chains
  and the frames: fitness, values and steps bit-equal to the one-warp
  layout at fm2, fm3_series, fm4_series and fm8_series x F 1/2/8 and every
  fixed bank x F 2/8, each at n 1024 and 2048 (sine orders 5/7/9, P
  4095/4096 and runs 1/2 in turn); the new layout against its plain version
  at ``--mode stft``'s shape (fm3_series, F 8, P 4096, n 2048, the truth
  first); B5 bit-equal to its F 8 B2 launches in the layout the wrapper
  takes; both layouts' device times at cells (h), (m) and (n). The banks
  (fm2..fm5_parallel) at one frame: bit-equal over sine orders 5/7/9, P
  2048/8191/8192 and runs 1 and 2 at n 1024; against the plain version at
  fm5_parallel and B5 bit-equal to its time-parallel B2 launches; both
  layouts' device times over the populations 2048 .. 2^16 at n 256 to
  2048; the wrapper's host time a call; the cut fm5_parallel pursuit, its
  B2 launches in the layout the wrapper takes.

* phase 44, B2 true f32 at the shapes users' paths give it (cells (m),
  (n), (h) and the shipped tail): the earlier design (the folded DFT, one
  thread a candidate) and this one (the FFT at power-of-two frames, the
  synthesis layout of ``f32_time_parallel``) in turns in one process,
  each one's kernels from torch.profiler, the bounds with the FFT's and
  the DFT's operations, cuFFT and cuBLAS SGEMM as the spectrum stage's
  yardsticks, and the FFT kernel and the time-parallel synthesis as kernels
  of their own against their plain versions; phase 45, the f32 synthesis'
  two layouts bit-equal (every row of samples, read from the scratch) over
  the fixed chains and banks x frames x n, B2 in both layouts and B5 at
  F 8 bit-equal to its B2 launches.

* phase 46, B1 int8 in B2's time-parallel layout: bit-equal to the
  one-warp layout at the settings the driven paths give it (the pursuits'
  seed rescores at P 1, P 32 and 8192, --mode stft's F 8 and the run
  axis, the bench shape, which stays one-warp), B2's fitness bit-equal to
  B1's on its own offspring with both time-parallel, and the two layouts
  timed in turns.

* phase 48, B5 int8 and bf16 on B2's layouts: at PERF.md §6's B5 rows
  (--mode stft's F 8, --mode parallel-chunks' 8 runs, the pursuit's polish
  bank, bf16 and int8 at the bench config) every generation in the
  one-warp layout and in the wrapper's pick (B2's at the same arguments)
  alternated in one process, each with its split a generation; B5 counted
  under the layout B2's wrapper takes there, bit-equal in both. Phases 43
  and 47 require B5 to run where B2 runs (``fused_evolve.
  launches_by_layout``), and the B5 rows of the JSON line carry the layout
  their calls took.

``python3 chip_smoke.py --only 20,21`` runs the device, build and inputs
phases and the named ones, and prints no result line (``large`` names the
large-frame inputs that phases 7-11, 33, 34 and 41 need).

One flushed line per phase, ending with its seconds; every time is printed
beside the card's name and power limit.

The second-to-last line is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``, printed only when every phase
passed. Without a CUDA device the script exits 2 and prints no result. A
watchdog ends a hung run with a traceback and a non-zero code.
"""
import collections
import contextlib
import faulthandler
import json
import math
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
PLAIN_RUNS = 1  # the plain versions' timed runs (3 before: the whole run's time)
SPLIT_BINS = 8  # phase 6's synthesis-only B1: an operand and target of 8 bins
# phase 4b: B1/B2 int8 over every frame the router sends them (multiples of
# 256 up to 3584), the ported topologies, sine orders 5/7/9, and populations
# around the 32-candidate block and a ragged one (plus P 2^15 at n 1024)
GRID_N = (256, 1024, 2048, 3584)
GRID_TOPOLOGIES = ("fm2", "fm3_series", "fm8_series")
GRID_SINE_ORDERS = (5, 7, 9)
# two populations: 65 of tests/test_torch_gpu.py::test_b1_b2_int8_grid's
# five (which holds all five, P 1 and 4001 among them) and the ragged 513
# (a partly filled last block of 32 and of 128 candidates, as 4001's),
# taken in turn: a setting's time goes with n (the plain versions walk the
# frame), not with P, so each (topology, sine order) runs one of them, the
# next the other, and P 2^15 at n 1024 beside it (the card-only tests hold
# the product), so that the whole run stays under the watchdog on a slower
# host
GRID_POPS = (65, 513)
GRID_ODD_BINS = (1024, 200)  # (n, K): K not a multiple of the kernel's 32-bin pass
# phase 12: phase 4b's grid for B1/B2 true f32, with populations around the f32
# DFT's 128-candidate block (its bin passes are 64 bins of one group: K 200
# leaves partial passes and groups of 3 and 4 tiles)
F32_GRID_POPS = (129, 513)  # 129 of test_b1_b2_f32_grid's five, as GRID_POPS
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
# B4: fm2 at each frame (131072: the level totals in device memory),
# fm3_series at 65536 and 32768, fm8_series at the shortest; each sine order
# at 32768
STREAM_GRID = (("fm2", 5, 131072), ("fm2", 7, 65536),
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
# with its launches from the path of phase 24 that runs it; the bf16 mode;
# B3, B4 and B5 on a bank (_parallel, launches from phase 33's paths) and
# B1/B2 at 20 genes (_wide: fm5_parallel int8, launches from phase 33's
# pursuit); the long code above 32 genes (_long: fm9_parallel, B1/B2 in each
# mode, B5, B3, B4 and the scan kernel at fm33_series, launches from phase
# 41's paths). B2 int8 on fm3_parallel (_parallel) and fm5_parallel (_wide)
# is the kernel of the layout the wrapper takes there (generation.
# time_parallel: csrc/fused_tp.cu), its launches that layout's; so is B2 int8
# on fm3_series at the bench shape, at F 8 (_frames) and on the run axis
# (_runs: csrc/fused_tp_chain.cu where the wrapper takes the time-parallel
# layout)
KERNELS = ("fused_synth_fitness", "fused_generation", "fused_synth_fold", "fused_synth_stream",
           "fused_synth_fitness_f32", "fused_generation_f32", "fused_evolve", "scan_synth",
           "fused_synth_fitness_parallel", "fused_generation_parallel",
           "fused_synth_fitness_parallel_f32", "fused_generation_parallel_f32",
           "fused_synth_fitness_frames", "fused_generation_frames",
           "fused_synth_fitness_frames_f32", "fused_generation_frames_f32", "fused_evolve_frames",
           "fused_synth_fitness_runs", "fused_generation_runs", "fused_synth_fitness_runs_f32",
           "fused_generation_runs_f32", "fused_evolve_runs",
           "fused_synth_fitness_bf16", "fused_generation_bf16", "fused_evolve_bf16",
           "fused_synth_fitness_bf16_tp", "fused_generation_bf16_tp",
           "fused_synth_fold_parallel", "fused_synth_stream_parallel", "fused_evolve_parallel",
           "fused_synth_fitness_wide", "fused_generation_wide",
           "fused_synth_fitness_long", "fused_generation_long", "fused_synth_fitness_long_bf16",
           "fused_generation_long_bf16", "fused_synth_fitness_long_f32",
           "fused_generation_long_f32", "fused_evolve_long", "fused_synth_fold_long",
           "fused_synth_stream_long", "scan_synth_long", "fused_f32_fft", "fused_f32_synth_tp",
           "scan_synth_tp", "fused_synth_fitness_tp")

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
F32_KERNELS = ("f32_synth_kernel", "f32_synth_tp_kernel", "f32_fft_kernel", "f32_frames_kernel",
               "f32_fold_kernel", "f32_dft_kernel", "f32_sum_kernel")
B2_KERNELS = F32_KERNELS + ("fused_generation_int8_kernel", "fused_generation_bf16_kernel",
                            "fused_generation_int8_tp_kernel", "fused_generation_bf16_tp_kernel")
# phase 4's draw statistics: where they are written (also printed whole, on
# the line "gen_check report: {...}"; committed as
# pmfm_tpu_torch/gen_check.json) and the CLT-12 gaussian's excess kurtosis
# (a uniform's, -1.2, over 12 draws)
GEN_CHECK_OUT = "build/gen_check.json"
GEN_KURTOSIS = -0.1
SELECT_KERNEL = "select_kernel"
PROFILED_LAUNCHES = 10

# phase 17: the scan kernel (csrc/scan_synth.cu), both layouts, against its
# plain loop and each other, bit for bit, at the bench's shape,
# parameters.json's (population 32, n 2048) and over chains x oscillators x
# output types at SCAN_GRID_POP, SCAN_GRID_N (the plain loop's time grows
# with n; the card-only tests hold n 1000 and 2048)
SCAN_GRID = ("fm2", "fm3_series", "fm8_series", "fm3_parallel")
SCAN_GRID_POP = 2048
SCAN_GRID_N = 512
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
# (two populations, as GRID_POPS; tests/test_torch_gpu.py::
# test_b1_b2_parallel_grid holds five)
PARALLEL_GRID_POPS = (65, 513)
PARALLEL_TIMED = PARALLEL_TOPOLOGIES + ("fm3_series",)
# phase 21: the pursuit solver through cli.main in PURSUIT_DIR: the first
# example as written but for one attempt a chunk, its first chunk to a
# relative spectral error below
# PURSUIT_MAX_REL (the reference's direct ES stalls at 35-55% on this
# family), the others with each stage's generations cut by
# PURSUIT_GENERATION_CUT and one attempt. A params target is 2048 samples,
# so n 1024 makes two chunks; the second holds the same tones a frame
# later, whose phases the model (which starts every oscillator at phase 0)
# cannot take: the true parameters themselves lie ~23% from it (printed
# beside each chunk), so only the first chunk is held to the limit (and the
# second's further attempts, which cannot meet the config's targetRel,
# took three quarters of the run)
PURSUIT_DIR = "build/chip_smoke_pursuit"
PURSUIT_AS_WRITTEN = "examples/fm3_parallel_match.json"
PURSUIT_CUT = ("examples/fm4_parallel_match.json", "examples/fm4_series_match.json",
               "examples/fm5_series_match.json", "examples/huge_frame_match.json")
PURSUIT_GENERATION_CUT = 80
PURSUIT_MAX_REL = 0.10

# phases 22-25: multi-frame fitness and the run axis (A6). Phase 22 holds
# B1/B2 in the multi-frame mode against their plain versions at
# examples/audio_match.json --mode stft's shape (input.wav's 16384 samples at
# n 2048: STFT_FRAMES frames, P 4096, sine order 9; int8 and its f32 tail,
# the truth planted first) and over FRAME_GRID_TOPOLOGIES x FRAME_GRID_F,
# FRAME_GRID_N in turn, at FRAME_GRID_POP (a ragged int8 warp and f32 DFT
# block);
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
RUN_B5_GENERATIONS = 2
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
SUITE_GENERATIONS = 25

# phases 26-29: the bf16 mode of B1/B2/B5 and the reference's benchmark
# suite. Phase 26 holds B1/B2 bf16 against their plain versions (the int8
# gate FIT_MAX_REL / FIT_MEDIAN_REL) at the bench shape, over phase 4b's
# grid with BF16_TOPOLOGIES, at BF16_FRAMES frames of AUDIO_CONFIG's shape
# (n 2048, P 4096) and with a run axis of BF16_RUNS there; phase 27 B5 bf16
# bit-equal to its B2 launches with the stable selection (the bench config,
# and RAGGED_POP) and evolve with fused_evolve in bf16; phase 28 the operand
# cache at 2^CACHE_LOG2N (build, then load) in SUITE_DIR and
# bench_suite.main over SUITE_SUITES with SUITE_ARGS; phase 29 the bf16
# kernels' times at the bench shape (B5 over BF16_B5_GENERATIONS)
BF16_FRAMES, BF16_RUNS = 8, 4
BF16_TOPOLOGIES = GRID_TOPOLOGIES + ("fm3_parallel",)
# phase 26's grid populations (as GRID_POPS; tests/test_torch_gpu.py::
# test_b1_b2_bf16_grid holds all five)
BF16_GRID_POPS = (65, 513)
BF16_B5_GENERATIONS = 10
CACHE_LOG2N = 14
SUITE_DIR = "build/chip_smoke_suite"
SUITE_SUITES = ("all",)
SUITE_ARGS = ("--fused", "--gens", "2")

# phases 30-35 (the rest of ROADMAP Queue B item 3): fm{k}_parallel banks in
# B3, B4 and B5, and 20 to 32 genes (fm5_parallel's compile-time bank; the
# wide codes: chains of 9-16 oscillators, banks of 6-8 pairs) in every
# kernel. Phase 30 holds B3 over BANK_FOLD_GRID (each bank and each sine
# order, each frame of the synth_fold route; int8 and bf16, both layouts)
# and B4 over BANK_STREAM_GRID (bf16 and f32; 65536 the cell (d) frame)
# bit-equal to their plain versions at LARGE_GRID_POPS, a wide chain in each
# (B4's at a short frame: the plain version's cost grows with n x chain)
BANK_FOLD_GRID = (("fm2_parallel", 7, 4096), ("fm3_parallel", 9, 8192),
                  ("fm4_parallel", 9, 4096), ("fm5_parallel", 7, 8192),
                  ("fm3_parallel", 7, 16384), ("fm12_series", 9, 4096))
BANK_STREAM_GRID = (("fm2_parallel", 9, 65536), ("fm3_parallel", 7, 65536),
                    ("fm4_parallel", 9, 32768), ("fm5_parallel", 7, 32768),
                    ("fm12_series", 9, 8192))
# phase 31: B5 on fm3_parallel at PARALLEL_CONFIG's shape (P 8192, mu 64,
# n 1024, sine order 9) in int8, bf16 and f32, bit-equal to
# B5_BANK_GENERATIONS launches of B2 with the stable selection, for each
# (runs, frames) of B5_BANK_SETTINGS
B5_BANK_SETTINGS = ((None, 1), (None, STFT_FRAMES), (4, 1))
B5_BANK_GENERATIONS = 10
# phase 32: B1/B2 at 20-32 genes against their plain versions at
# PARALLEL_CONFIG's shape in int8, bf16 and f32, each truth planted first:
# fm5_parallel (examples/fm4_parallel_match.json's pairs and
# FM5_FIFTH_PAIR, benchmarks/pursuit_fm5_parallel.json's true_genes[16:20]
# times the ranges), three more pairs for fm8_parallel, and chains of 10 and
# 16 with indices up to 0.225 and 0.1125 (a long chain with larger ones is
# chaotic: synthesize_single's target and the kernels' synthesis of its own
# truth part, by half the target's energy at indices up to 0.45 on 16)
FM5_BASE_CONFIG = "examples/fm4_parallel_match.json"
FM5_FIFTH_PAIR = (2182.4, 1.2, 3273.6, 0.5)
WIDE_TRUTHS = {
    "fm5_parallel": PARALLEL_TRUTH + FM5_FIFTH_PAIR,
    "fm8_parallel": PARALLEL_TRUTH + FM5_FIFTH_PAIR + (1320.0, 1.8, 2640.0, 0.4,
                                                       880.0, 2.2, 1760.0, 0.3,
                                                       3300.0, 0.9, 1650.0, 0.35),
    "fm10_series": (3078.0, 0.2, 3015.0, 0.15, 3141.0, 0.1, 2500.0, 0.175, 1800.0, 0.125,
                    1200.0, 0.15, 900.0, 0.225, 2200.0, 0.1, 1500.0, 0.2, 2800.0, 0.15),
    "fm16_series": (3078.0, 0.1, 3015.0, 0.075, 3141.0, 0.05, 2500.0, 0.0875, 1800.0, 0.0625,
                    1200.0, 0.075, 900.0, 0.1125, 2200.0, 0.05, 1500.0, 0.1, 2800.0, 0.075,
                    2000.0, 0.0625, 1100.0, 0.075, 2600.0, 0.05, 1700.0, 0.0875, 3300.0, 0.075,
                    2400.0, 0.1125),
}
# phase 33: the paths: the fm5_parallel pursuit through cli.main cut as
# phase 21 cuts (PURSUIT_GENERATION_CUT, one attempt); evolve on
# fm3_parallel with fused_evolve (B5) at PARALLEL_CONFIG's shape in int8 and
# f32, BANK_EVOLVE_GENERATIONS generations; evolve on fm3_parallel at cell
# (c)'s shape (n 8192, P 2^15: synth_fold) and cell (d)'s (n 65536, P 2^13:
# synth_stream), BANK_LARGE_GENERATIONS generations each
BANK_EVOLVE_GENERATIONS = 50
BANK_LARGE_GENERATIONS = 5
# phase 34: the new modes' times (B5 over B5_BANK_GENERATIONS) and B3's two
# layouts on banks over BANK_LAYOUT_SHAPES x FOLD_LAYOUT_POPS (the wrapper's
# FOLD_TP_BELOW_POP bank rows), BANK_LAYOUT_LAUNCHES launches each
BANK_LAYOUT_SHAPES = tuple((t, 7, 8192, m) for t in (
    "fm2_parallel", "fm3_parallel", "fm4_parallel", "fm5_parallel") for m in (True, False)) + (
    ("fm3_parallel", 7, 4096, True), ("fm3_parallel", 7, 16384, True))
BANK_LAYOUT_LAUNCHES = 10
# phase 35 (only with --only 35, not in the whole run): the fm5_parallel
# pursuit through cli.main as written, its first chunk below
# FM5_TARGET_REL (its targetRel)
FM5_TARGET_REL = 0.03
FM5_WATCHDOG_S = 2400
# phases 37 and 38 (only with --only, each under a watchdog of its own): the
# fm5_parallel pursuit on benchmarks/pursuit_fm5_parallel.json's own meta,
# seeds 64-65 and 66-67 (its seed_offset 64), scored as the study scores
# them; a seed's attempt is ~86 s on the card
C2_STUDY = "benchmarks/pursuit_fm5_parallel.json"
C2_SEEDS = {"37": (64, 65), "38": (66, 67)}
C2_WATCHDOG_S = 900
# phase 36 (A9 on the card): evolve_checkpointed at the bench config for
# A9_GENERATIONS in segments of A9_EVERY, stopped after A9_STOP_AFTER saves
# and resumed from disk (B2, B2 with restarts every A9_PATIENCE stalled
# generations, B5); match_audio on AUDIO_CONFIG (AUDIO_GENERATIONS) stopped
# after A9_CHUNKS chunks; cli.main --mode stft on AUDIO_CONFIG at
# AUDIO_GENERATIONS with --checkpoint-every A9_STFT_EVERY, stopped after its
# first save; the population readback; --export-aot and --aot in a
# subprocess of a copy of the package whose build is disabled
A9_DIR = "build/chip_smoke_a9"
A9_GENERATIONS, A9_EVERY, A9_STOP_AFTER, A9_PATIENCE = 60, 20, 2, 2
A9_CHUNKS = 4
A9_STFT_EVERY = 50
A9_POPULATION_GENERATIONS = 20
A9_SUBPROCESS_S = 300
# phase 39 (A10): the bench shape through parallel.evolve_sharded (cfg of the
# inputs phase); the subprocesses' limit; the CLI's work directory, where it
# runs SHIPPED_CONFIG with its generations a chunk cut to A10_CLI_GENERATIONS
A10_GENERATIONS = 200
A10_FRAME_GENERATIONS = 10  # the frame path synthesises all frames of every candidate
A10_SUBPROCESS_S = 300
A10_DIR = "build/chip_smoke_a10"
A10_CLI_RANKS = 2
A10_CLI_GENERATIONS = 100
# phase 40 (A1): convergence_check at A1_SEEDS seeds and A1_GENERATIONS
A1_DIR = "build/chip_smoke_a1"
A1_SEEDS, A1_GENERATIONS = 2, 50
A1_VARIANTS = ("f32", "int8+sin7", "int8+sin7+refine", "shipped")

# phase 41 (ROADMAP Queue B item 3's remainder): topologies above 32 genes,
# the long synthesis code (csrc synth_common.cuh::LongSynth) in every kernel.
# LONG_SAME: topologies the fixed and wide codes run, held bit for bit
# against the long code with synth_fitness.LONG_ABOVE_GENES lowered to
# LONG_SAME_ABOVE (B1/B2 at the bench's n, B3 at LONG_SAME_FOLD_N, B4 at
# LONG_SAME_STREAM_N, P LONG_SAME_POP); LONG_TRUTHS: the planted truths of
# the long topologies (examples/fm4_parallel_match.json's four pairs,
# FM5_FIFTH_PAIR, then pairs of the same ranges; a chain of 17 with
# fm16_series's mild indices); B1/B2 at LONG_FRAMES frames and a run axis of
# LONG_RUNS at AUDIO_CONFIG's shape; B5 over LONG_B5_GENERATIONS; B4 at
# n 65536 on fm17_series over its plain walk's first
# LONG_STREAM_CHECK_BLOCKS time blocks; the scan kernel and the unfused
# engine past 32 at LONG_SCAN; evolve for LONG_GENERATIONS generations;
# cli.main on LONG_CLI_CONFIG made fm9_parallel, LONG_CLI_GENERATIONS
# generations and a refine tail of LONG_CLI_REFINE; kernel times over
# LONG_TIMED_LAUNCHES
LONG_SAME = ("fm5_parallel", "fm8_parallel", "fm10_series", "fm16_series")
LONG_SAME_ABOVE = 16
LONG_SAME_POP = 1000
LONG_SAME_FOLD_N, LONG_SAME_STREAM_N = 4096, 8192
LONG_PAIRS = ((3076.48, 2.0, 3016.64, 0.9), (1936.0, 2.4, 2182.4, 0.8),
              (2499.2, 1.6, 1584.0, 0.7), (1161.6, 3.2, 985.6, 0.6), FM5_FIFTH_PAIR,
              (1320.0, 1.8, 2640.0, 0.4), (880.0, 2.2, 1760.0, 0.3), (3300.0, 0.9, 1650.0, 0.35),
              (2750.0, 1.4, 1375.0, 0.45), (1045.0, 2.6, 2090.0, 0.25),
              (1567.0, 1.1, 3134.0, 0.3), (2349.0, 0.8, 1174.5, 0.4), (660.0, 3.0, 1980.0, 0.2),
              (1396.0, 1.7, 2793.0, 0.3), (1865.0, 2.1, 932.5, 0.35), (2960.0, 0.7, 1480.0, 0.25))
LONG_TRUTHS = {
    "fm9_parallel": sum(LONG_PAIRS[:9], ()),
    "fm17_series": WIDE_TRUTHS["fm16_series"] + (1900.0, 0.08),
    "fm16_parallel": sum(LONG_PAIRS, ()),
}
LONG_FRAMES, LONG_RUNS = 4, 4
LONG_B5_GENERATIONS = 10
LONG_STREAM_CHECK_BLOCKS = 16
LONG_SCAN = ("fm33_series", "fm33_parallel")
LONG_GENERATIONS = 50
LONG_CLI_CONFIG = "examples/params_match.json"
LONG_CLI_GENERATIONS, LONG_CLI_REFINE = 100, 20
LONG_TIMED_LAUNCHES = 10

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, int8 ops/s, f32 and
# bf16 FLOP/s
PEAK_BYTES, PEAK_INT8, PEAK_F32, PEAK_BF16 = 3.35e12, 1979e12, 67e12, 989e12

# phase 43: B2 int8 on the fixed banks in its two layouts (csrc/fused_tp.cuh's
# time-parallel one against fused_eval.cu's one-warp one): bit-equal over
# TP_BANKS x TP_SINE_ORDERS x TP_POPS x TP_RUNS at n 1024 (K 512, the
# pursuit's polishes), each against a random target; B2 in the new layout
# against its plain version at fm5_parallel, P 8192, the truth first; B5
# bit-equal to TP_B5_GENERATIONS time-parallel B2 launches with the stable
# selection; both layouts' device times over GEN_LAYOUT_POPS at the frames
# TP_LAYOUT_N, sine order 9 (~6 s); the cut fm5_parallel pursuit's B2
# launches by layout
TP_BANKS = ("fm2_parallel", "fm3_parallel", "fm4_parallel", "fm5_parallel")
TP_SINE_ORDERS = (5, 7, 9)
TP_POPS = (2048, 8191, 8192)
TP_RUNS = (None, 2)
TP_B5_GENERATIONS = 5
# the other frames, each bank at sine order 9, P TP_FRAME_POP, runs 1 and 2;
# n 2048 is also timed, beside the n 1024 row it takes
TP_FRAMES = (256, 512, 2048)
TP_FRAME_POP = 1000
TP_LAYOUT_N = (256, 512, 1024, 2048)
GEN_LAYOUT_POPS = (2048, 4096, 8192, 16384, 1 << 15, 1 << 16)
# the chains and the frames: TP_CHAINS_CHECKED x TP_CHAIN_FRAMES and every
# bank of TP_BANKS x TP_BANK_FRAMES, each at n TP_CHAIN_N, bit-equal in the
# two layouts, setting i at sine order TP_SINE_ORDERS[i % 3], P
# TP_CHAIN_POPS[i % 2] and runs TP_RUNS[i // 2 % 2] (the card-only test takes
# every combination); the time-parallel layout against its plain version at
# --mode stft's shape (fm3_series, F 8, P 4096, n 2048, the truth first); B5
# bit-equal to TP_B5_GENERATIONS F 8 B2 launches in the layout the wrapper
# takes; both layouts' device times at the shapes of PERF.md's cells (h)
# (F 1), (m) (F 8) and (n) (8 runs), TP_CELL_LAUNCHES launches, the layouts
# alternated one-warp, time-parallel, time-parallel, one-warp
TP_CHAINS_CHECKED = ("fm2", "fm3_series", "fm4_series", "fm8_series")
TP_CHAIN_FRAMES = (1, 2, 8)
TP_BANK_FRAMES = (2, 8)
TP_CHAIN_N = (1024, 2048)
TP_CHAIN_POPS = (4095, 4096)
TP_CELLS = (("(h)", 1, None), ("(m)", 8, None), ("(n)", 1, 8))  # (cell, frames, runs)
TP_CELL_LAUNCHES = 10
GEN_LAYOUT_LAUNCHES = 10
HOST_CALLS = 100  # B2 calls timed on the host clock (the wrapper's time a launch)
# cuda_ms: cycles of a spin kernel that hold the card while a timed run's
# launches are queued behind it (~11 ms at 1.755 GHz, above the host's time
# to queue them)
QUEUE_SPIN_CYCLES = 20_000_000
# phase 44: B2 true f32 at the shapes users' paths give it, (label, config,
# frames, runs): cells (m) --mode stft, (n) --mode parallel-chunks, (h)
# audio_match.json's refine tail and (g) the shipped refine tail
F32_ORDER = ("old", "new", "new", "old")  # phase 44's turns: the DFT route, then the FFT
# phase 45: the f32 synthesis' two layouts bit-equal over these, one of the
# frames a topology and frame count, in turn (the card-only test takes all)
F32_TP_TOPOLOGIES = ("fm2", "fm3_series", "fm4_series", "fm8_series", "fm2_parallel",
                     "fm3_parallel", "fm4_parallel", "fm5_parallel")
F32_TP_FRAMES = (1, 2, 8)
F32_TP_N = (256, 1024, 2048, 3584)
F32_TP_POPS = (1000, 2049)
F32_SPLIT_SHAPES = (("(m) --mode stft", "examples/audio_match.json", 8, None),
                    ("(n) --mode parallel-chunks", "examples/audio_match.json", 1, 8),
                    ("(h) audio_match.json", "examples/audio_match.json", 1, None),
                    ("(g) shipped refine tail", "examples/params_match.json", 1, None))

# phase 17: the scan's two layouts (one thread a candidate, time-parallel)
# bit-equal to the plain loop and to each other; timed alternated
# (one-thread, time-parallel, time-parallel, one-thread) at parameters.json's
# shape and the bench's, TIMED_LAUNCHES launches a median
SCAN_ORDER = (False, True, True, False)
# phase 46: B1 int8 in its two layouts (csrc/fused_tp.cuh's time-parallel one
# against fused_eval.cu's one-warp one) bit-equal at the settings the driven
# paths give it, (label, config, topology, frames, runs, pop): the pursuits'
# seed rescores (P 1: fm3_parallel as written, the cut fm4/fm5_parallel,
# fm4/fm5_series), --mode stft's fused_kernel path (F 8) and the run axis
# (8 runs), P 4096; the bench shape (P 2^15, which the rule keeps one-warp);
# then B2's fitness bit-equal to B1's on its own offspring with both in the
# time-parallel layout; the two layouts timed alternated (B1_TP_TIMED)
B1_TP_SETTINGS = (
    ("pursuit seed rescore", "examples/fm3_parallel_match.json", "fm3_parallel", 1, None, 1),
    ("pursuit seed rescore", "examples/fm4_parallel_match.json", "fm4_parallel", 1, None, 1),
    ("pursuit seed rescore", "examples/fm4_parallel_match.json", "fm5_parallel", 1, None, 1),
    ("pursuit seed rescore", "examples/fm4_series_match.json", "fm4_series", 1, None, 1),
    ("pursuit seed rescore", "examples/fm5_series_match.json", "fm5_series", 1, None, 1),
    ("P 32", "examples/fm3_parallel_match.json", "fm2", 1, None, 32),
    ("P 8192", "examples/fm3_parallel_match.json", "fm3_parallel", 1, None, 8192),
    ("--mode stft", "examples/audio_match.json", "fm3_series", 8, None, 4096),
    ("run axis", "examples/audio_match.json", "fm3_series", 1, 8, 4096),
    ("bench", "examples/params_match.json", "fm3_series", 1, None, 1 << 15))
B1_TP_TIMED = ("pursuit seed rescore", "--mode stft", "run axis")
B1_TP_LAUNCHES = 25
# phase 47: B1/B2 bf16 in their layouts (csrc/fused_tp_bf16.cuh's time-parallel
# one, fused_bf16.cu's one-warp one) bit-equal at the reference suite's
# shapes, (topology, n, runs, pop): the populations and the run axes of
# fm3_series at n 1024, n 512 and 2048, the topologies; and n 768 (six warps a
# block, a round of 96 bins: the ring of terms is rounded up to 256 rows);
# then B2's values, steps and fitness at the bench config and a run axis, B2's
# fitness bit-equal to B1's on its own offspring, and each layout against the
# plain versions (the int8 gate); B5 bf16 at the bench config in its
# wrapper's layout against B5 forced one-warp and its B2 launches; the
# layouts timed alternated at the first BF16_TP_TIMED shapes
BF16_TP_SHAPES = (
    ("fm3_series", 1024, None, 1 << 11), ("fm3_series", 1024, None, 1 << 13),
    ("fm3_series", 1024, None, 1 << 15), ("fm3_series", 1024, 4, 1 << 13),
    ("fm3_series", 1024, 32, 1 << 11), ("fm3_series", 512, None, 1 << 15),
    ("fm3_series", 2048, None, 1 << 15), ("fm2", 1024, None, 1 << 15),
    ("fm4_series", 1024, None, 1 << 15), ("fm5_series", 1024, None, 1 << 15),
    ("fm3_parallel", 1024, None, 1 << 15), ("fm4_parallel", 1024, None, 1 << 15),
    ("fm3_series", 768, 4, 1 << 11), ("fm5_parallel", 768, None, 1 << 13))
BF16_TP_TIMED = 7
BF16_TP_LAUNCHES = 10
BF16_TP_B5_GENERATIONS = 5  # B5 bf16 at the bench config against its B2 launches
# phase 48: B5 int8 and bf16 at PERF.md §6's B5 rows, (label, mode, config:
# AUDIO_CONFIG "audio", PARALLEL_CONFIG "parallel" or the bench's "bench",
# frames, runs): every generation one-warp (``gen_layout(gn, False)``: B5
# before it took B2's layouts) and the wrapper's pick, alternated in one
# process (B5_TURN_ORDER), B5_TURN_CALLS calls of B5_TURN_GENERATIONS a turn
B5_TURN_ROWS = (("B5, multi-frame", "int8", "audio", 8, None),
                ("B5, run axis", "int8", "audio", 1, 8),
                ("B5, bank", "int8", "parallel", 1, None),
                ("B5 bf16", "bf16", "bench", 1, None),
                ("B5 int8, bench config", "int8", "bench", 1, None))
B5_TURN_GENERATIONS = 10
B5_TURN_CALLS = 5
B5_TURN_ORDER = (False, True, True, False)  # one-warp, the wrapper's pick, ...

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
    one synchronise at the end, behind a spin kernel that holds the card
    while they are queued, so the device does not wait on the host between
    them and each interval is one call's device time (a B2 launch's host
    time, ~0.2 ms, is above a small population's kernel)."""
    fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(runs + 1)]
    torch.cuda._sleep(QUEUE_SPIN_CYCLES)
    events[0].record()
    for e in events[1:]:
        fn()
        e.record()
    events[-1].synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in zip(events, events[1:]))


def once_ms(fn) -> float:
    """Device time of one call of ``fn()``, no warm-up: a plain version whose
    one call takes seconds."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def kernel_times(fn, runs: int, per_launch: bool = False) -> dict:
    """Mean device ms per call of each CUDA kernel that ``runs`` calls of
    ``fn()`` launch (``per_launch``: per recorded launch of it, which holds
    where the trace keeps only part of the launches: late in a long run it
    has kept ~10-40% of them), by name with its template arguments, from
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
            out[name] = out.get(name, 0.0) + us / (max(ev.count, 1) if per_launch else runs) / 1e3
    return out


def kernel_breakdown(fn, runs: int) -> str:
    """The f32 kernels' rows of ``kernel_times`` as "name ms, ..." (a launch
    each a call of ``fn``: the mean per recorded launch); "not measured"
    when the trace holds no device time."""
    rows = [f"{name} {ms:.4f} ms" for name, ms in kernel_times(fn, runs, True).items()
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


@contextlib.contextmanager
def gen_layout(gn, time_parallel: bool):
    """B1/B2's wrappers in one layout: the time-parallel one wherever its
    kernel takes the shape (``tp_faster`` made to say yes: int8 or bf16 on a
    fixed chain or bank), or the one-warp one everywhere (``tp_faster`` made
    to say no); restored after."""
    saved = gn.tp_faster
    gn.tp_faster = lambda *a, **k: time_parallel
    try:
        yield
    finally:
        gn.tp_faster = saved


@contextlib.contextmanager
def scan_layout(ss, time_parallel: bool):
    """The scan's wrapper in one layout: the time-parallel one wherever its
    kernel takes the chain, or one thread a candidate everywhere
    (``scan_tp_faster`` made to say yes or no); restored after."""
    saved = ss.scan_tp_faster
    ss.scan_tp_faster = lambda pop: time_parallel
    try:
        yield
    finally:
        ss.scan_tp_faster = saved


def scan_layout_name(time_parallel: bool) -> str:
    return "time_parallel" if time_parallel else "one_thread"


def bench_config():
    """The bench ES (P 2^15, mu 256, fm3_series, n 1024, int8, sine order 7):
    the reference bench's configuration."""
    from pmfm_tpu_torch.es import ESConfig

    return ESConfig(
        num_parents=MU, num_offspring=POP - MU, num_dimensions=D, topology=TOPOLOGY,
        audio_length_log2=LOG2N, synthesis_engine="scanless", spectrum_method="dft",
        dft_dtype="int8", mutation_noise="clt12", sine_order=7, fused_kernel=True,
        fused_generation=True, fused_evolve=False, pop_block=1024,
    )


def b5_layout_taken(ev, fn) -> str:
    """The layout B5's call ``fn()`` ran its generations in, as its wrapper
    counted it (``fused_evolve.launches_by_layout``: one key a call)."""
    ev.fused_evolve.launches_by_layout.clear()
    fn()
    got = dict(ev.fused_evolve.launches_by_layout)
    require(len(got) == 1 and sum(got.values()) == 1, f"B5 counted {got} for one call")
    return next(iter(got))


def b2_layout(gn, kw2, k: int, d: int, runs: int = 1) -> str:
    """The layout of the B2 int8 kernel that the wrapper launches for
    ``kw2`` (its keyword arguments) at ``k`` bins, ``d`` genes and ``runs``
    runs."""
    tp = gn.time_parallel(kw2["n"], k, d, kw2["topology"], "int8", kw2.get("num_frames", 1),
                          kw2["pop"], runs)
    return "time_parallel" if tp else "one_warp"


@contextlib.contextmanager
def f32_mode(sf, fft: bool, time_parallel=None):
    """B1/B2/B5 true f32 in one route and synthesis layout: the FFT at
    power-of-two frames (``F32_FFT`` set) or the DFT at every frame; the
    time-parallel synthesis wherever its kernel takes the shape
    (``f32_tp_faster`` made to say yes), the one-thread one everywhere
    (``F32_TIME_PARALLEL`` cleared) or, with None, the wrapper's rule; all
    restored after."""
    saved = sf.F32_FFT, sf.F32_TIME_PARALLEL, sf.f32_tp_faster
    sf.F32_FFT = fft
    if time_parallel is not None:
        sf.F32_TIME_PARALLEL = time_parallel
        if time_parallel:
            sf.f32_tp_faster = lambda *a, **k: True
    try:
        yield
    finally:
        sf.F32_FFT, sf.F32_TIME_PARALLEL, sf.f32_tp_faster = saved


def f32_rows(params, topology: str, n: int, frames: int, sine_order: int,
             time_parallel: bool):
    """The rows of samples the true-f32 B1 writes to its scratch for
    ``params`` (P, D) or (B, P, D) at ``frames`` frames of ``n``, through
    the library's own entry (``pmfm_fused_synth_fitness_f32``) in the chosen
    synthesis layout on the route the wrapper takes: ``(rows (B, F, P, n),
    fitness)`` against a zero target. The two layouts must write the same
    rows bit for bit."""
    from pmfm_tpu_torch.kernels import _build
    from pmfm_tpu_torch.kernels import synth_fitness as sf
    from pmfm_tpu_torch.ops import spectral

    dev = params.device
    p = params if params.dim() == 3 else params[None]
    runs, pop, d = p.shape
    so = spectral.make_spectrum_ops(n, None, dft_dtype="float32", device=dev)
    k = so.num_bins
    sp = sf.synth_params_struct(
        topology=topology, n=n, k=k, d=d, dft_scale=0.0, sine_order=sine_order, frames=frames,
        inv_sr=sf.inv_sample_rate(sf.DEFAULT_WAVETABLE_SIZE, sf.DEFAULT_SAMPLE_RATE))
    with f32_mode(sf, True, time_parallel):
        sf.f32_launch(sp, topology, pop, runs, dev)
        require(bool(sp.f32_tp) == time_parallel, f"{topology}: no time-parallel layout at n={n}")
        floats = sf.f32_scratch_floats(pop, n, frames, runs)
    scratch = torch.full((floats,), float("nan"), device=dev)
    target = torch.zeros((runs, frames, k), device=dev)
    fitness = torch.empty((runs, pop), device=dev)
    p = p.contiguous()
    _build.check(_build.library().pmfm_fused_synth_fitness_f32(
        p.data_ptr(), pop, runs, sp, so.dft_packed.data_ptr(), target.data_ptr(),
        fitness.data_ptr(), scratch.data_ptr(), scratch.numel(),
        torch.cuda.current_stream(dev).cuda_stream), "pmfm_fused_synth_fitness_f32")
    pad = sf.f32_pop_pad(pop)
    rows = scratch[: runs * frames * pad * n].view(runs, frames, pad, n)[:, :, :pop].clone()
    return rows, fitness


def b2_source(layout: str, topology: str = "fm3_parallel") -> str:
    """The source of B1/B2 int8's kernel for ``topology`` in ``layout`` (B1
    takes B2's rule): the time-parallel layout's chains are
    fused_tp_chain.cu's, its banks fused_tp.cu's (both on fused_tp.cuh)."""
    if layout != "time_parallel":
        return "pmfm_tpu_torch/csrc/fused_eval.cu"
    bank = topology.endswith("_parallel")
    return f"pmfm_tpu_torch/csrc/{'fused_tp.cu' if bank else 'fused_tp_chain.cu'}"


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


def f32_fft_ops(rows: int, n: int) -> float:
    """float32 operations of a real FFT of ``rows`` frames of n samples,
    2.5 N log2 N a frame (a complex FFT of N/2 points and the split); the
    epilogue's are synth_ops_f32's 12 a bin."""
    return rows * 2.5 * n * math.log2(n)


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
                args, i = [], 1
                while i < len(tail) and tail[i] != "E":  # integer, float or named arguments
                    m = (re.match(r"L[ib](n?\d+)E", tail[i:]) or re.match(r"(f)", tail[i:])
                         or re.match(r"\d+", tail[i:]))
                    if not m:
                        break
                    if m.re.pattern == r"\d+":
                        width = int(m.group(0))
                        args.append(tail[i + len(m.group(0)):i + len(m.group(0)) + width])
                        i += len(m.group(0)) + width
                    else:
                        args.append("float" if m.group(1) == "f" else m.group(1).replace("n", "-"))
                        i += len(m.group(0))
                name = f"{name}<{','.join(args)}>"
            rows.append([name, "?", "?"])
        elif rows and rows[-1][1] == "?" and (r := re.search(r"Used (\d+) registers", ln)):
            rows[-1][1] = r.group(1)
        elif rows and rows[-1][2] == "?" and (r := re.search(r"(\d+) bytes spill stores", ln)):
            rows[-1][2] = r.group(1)
    return rows


def bound(bytes_moved: float, int8_ops: float, f32_ops: float, bf16_ops: float = 0.0):
    times = {
        "bytes": bytes_moved / PEAK_BYTES,
        "operations": max(int8_ops / PEAK_INT8, f32_ops / PEAK_F32, bf16_ops / PEAK_BF16),
    }
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def pursuit_cut(load, generation_cut=PURSUIT_GENERATION_CUT):
    """A ``load_config`` that cuts a pursuit config's stages to a
    ``generation_cut``-th of their generations (at least 1) and one
    attempt."""
    import dataclasses
    import inspect

    from pmfm_tpu_torch.es import staged
    from pmfm_tpu_torch.ops.synthesis import series_ops

    def cut(path):
        rc = load(path)
        series = (series_ops(rc.es.topology) or 0) >= 4
        keys = staged.SERIES_CONFIG_KEY_MAP if series else staged.CONFIG_KEY_MAP
        defaults = inspect.signature(
            staged._series_attempt if series else staged._pursuit_attempt).parameters
        p = dict(rc.pursuit, maxAttempts=1)
        for key, snake in keys.items():
            if key.endswith("Generations"):
                p[key] = max(1, int(p.get(key, defaults[snake].default)) // generation_cut)
        return dataclasses.replace(rc, pursuit=tuple(sorted(p.items())))

    return cut


def fm5_parallel_config(root: str) -> dict:
    """examples/fm4_parallel_match.json as written with a fifth pair: the
    20-gene fm5_parallel family of the reference's pursuit benchmark
    (benchmarks/pursuit_fm5_parallel.json), its fifth true pair
    FM5_FIFTH_PAIR, built here (no example file holds it)."""
    import os

    with open(os.path.join(root, FM5_BASE_CONFIG)) as f:
        raw = json.load(f)
    ev, ty = raw["evolutionary"], raw["type"]
    ev["numDimensions"] = 20
    ev["paramMins"] = list(ev["paramMins"]) + [0, 0, 0, 0]
    ev["paramMaxs"] = list(ev["paramMaxs"]) + [3520, 8, 3520, 1]
    ty["params"] = list(ty["params"]) + list(FM5_FIFTH_PAIR)
    raw["tpu"]["topology"] = "fm5_parallel"
    raw["general"]["outputAudioPath"] = "output_audio/output_fm5_parallel.wav"
    return raw


def _stft_record(out) -> dict:
    """What a ``pipeline.stft_run`` call returned, as numpy arrays."""
    cfg, final, traj, start, scaled, audio = out
    return dict(best_fitness=final.best_fitness.cpu().numpy(),
                best_values=final.best_values.cpu().numpy(),
                parent_values=final.parent_values.cpu().numpy(),
                parent_fitness=final.parent_fitness.cpu().numpy(),
                generation=np.int64(final.generation), scaled=scaled.cpu().numpy(),
                audio=audio.cpu().numpy())


def _records_equal(a: dict, b: dict) -> bool:
    """Two ``_stft_record``s bit for bit."""
    return a.keys() == b.keys() and all(
        np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes() for k in a)


class Smoke:
    def __init__(self, device: str = "cuda", only=None):
        self.dev = torch.device(device)
        self.kernels = {}
        self.failed = []
        self.cell_ms = {}
        self.scan_by_layout = collections.Counter()  # phases 18-19: the scan's path launches
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
        self.build_seconds, self.build_log = res["seconds"], res["log"]
        log(f"nvcc: built={res['built']} in {res['seconds']:.1f}s -> {res['path']}")
        for name, regs, spill in ptxas_summary(res["log"]):
            print(f"  ptxas {name}: {regs} registers, {spill} bytes spill stores", flush=True)
        for ln in res["log"].splitlines():
            if ln.startswith("nvcc "):
                print(f"  {ln}", flush=True)
        _build.library()

    # -- shared inputs --------------------------------------------------------
    def setup(self):
        from pmfm_tpu_torch.es import make_spectrum_ops
        from pmfm_tpu_torch.ops import synthesize_single, target_spectrum

        self.cfg = bench_config()
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
        g64 = g.to(torch.float64)
        gm, gv = float(g64.mean()), float(g64.var())
        kurt = float(((g64 - gm) ** 4).mean() / gv**2) - 3.0  # excess kurtosis
        log(f"B2 draws: CLT gaussian mean {gm:.3e} var {gv:.5f} sigma {gv ** 0.5:.5f} excess "
            f"kurtosis {kurt:.4f} (expect 0, {1 / 36:.5f}, {1 / 6:.5f}, {GEN_KURTOSIS:g}); coin "
            f"mean {coin:.4f}; parent-index chi2 {chi2:.1f} on {MU - 1} dof")
        m = POP * D  # draws of each kind; bounds at 6 standard errors
        checks = {
            "parent_choice": {"mu": MU, "chi2": chi2, "dof": MU - 1,
                              "ok": chi2 < (MU - 1) + 6 * (2 * (MU - 1)) ** 0.5},
            "clt12": {"mean": gm, "sigma": gv**0.5, "excess_kurtosis": kurt,
                      "ok": (abs(gm) < 6 * (1 / 36 / m) ** 0.5
                             and abs(gv - 1 / 36) < 6 * (1 / 36) * (2 / m) ** 0.5
                             and abs(kurt - GEN_KURTOSIS) < 6 * (24 / m) ** 0.5)},
            "coin": {"rate": coin, "ok": abs(coin - 0.5) < 6 * 0.5 / m**0.5},
        }
        self.gen_check(seed, m, checks)
        require(checks["clt12"]["ok"], "CLT draws off")
        require(checks["coin"]["ok"], "coin not fair")
        require(checks["parent_choice"]["ok"], "parent index not uniform")
        self.kernels["fused_generation"] = {"max_abs_err": float((fk - fp).abs().max())}

    def gen_check(self, seed, draws, checks):
        """Write the draws' statistics and the sources' fingerprint as
        GEN_CHECK_OUT (the content of pmfm_tpu_torch/gen_check.json, which
        is committed from a card run), and fail when the committed artifact's
        fingerprint is not the sources' (``utils.provenance``)."""
        import os

        from pmfm_tpu_torch.utils.provenance import GEN_CHECK_ARTIFACT, seeding_fingerprint

        fp = seeding_fingerprint()
        report = {"fingerprint": fp, "device": CARD["name"], "power_limit": CARD["power_limit"],
                  "source": "chip_smoke.py phase 4", "seed": seed, "pop": POP, "d": D,
                  "draws": draws, "checks": checks, "ok": all(c["ok"] for c in checks.values())}
        os.makedirs(os.path.dirname(GEN_CHECK_OUT), exist_ok=True)
        with open(GEN_CHECK_OUT, "w") as f:
            json.dump(report, f, indent=1)
        print(f"gen_check report: {json.dumps(report)}", flush=True)
        committed = json.loads(GEN_CHECK_ARTIFACT.read_text()) if GEN_CHECK_ARTIFACT.exists() else {}
        log(f"B2 draws written to {GEN_CHECK_OUT}; sources' fingerprint {fp}, the committed "
            f"artifact's {committed.get('fingerprint')}")
        require(committed.get("fingerprint") == fp,
                "pmfm_tpu_torch/gen_check.json is stale: the draw sources changed; commit "
                f"{GEN_CHECK_OUT} from this run")

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
        self.last_median = (float(e1.median()), float(e2.median()))
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
        ``topologies`` x ``orders``, one of ``grid_pops`` a setting in turn
        (and P 2^15 at n 1024), and at GRID_ODD_BINS, against a random
        target, within ``limits``; the data from ``seed``, the kernel seeds
        from ``seeds``."""
        from pmfm_tpu_torch.es import kernel_seed
        from pmfm_tpu_torch.ops import spectral
        from pmfm_tpu_torch.ops.synthesis import topology_dims

        rng = np.random.default_rng(seed)
        cases = 0
        for ni, (n, bins) in enumerate([(n, None) for n in GRID_N] + [GRID_ODD_BINS]):
            so = spectral.make_spectrum_ops(n, bins, dft_dtype=dtype, device=self.dev)
            tgt = torch.from_numpy(rng.uniform(0.0, 50.0, so.num_bins).astype(np.float32)).to(
                self.dev)
            worst, count, worst_med = [0.0, 0.0], 0, 0.0
            extra = (POP,) if n == 1 << LOG2N and bins is None else ()
            pops = grid_pops + extra
            for ti, topology in enumerate(topologies):
                d = topology_dims(topology)
                mins, maxs = (0.0,) * d, param_maxs(topology)
                for oi, order in enumerate(orders):
                    for pop in (grid_pops[(ni + ti + oi) % len(grid_pops)],) + extra:
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
                        worst_med = max(worst_med, *self.last_median)
                        count += 1
                        cases += 1
            log(f"B1/B2 {dtype} grid, n={n} (K={so.num_bins}): {count} settings ({topologies} "
                f"x sine orders {orders}, P {pops} in turn) within {limits[0]:g} / "
                f"{limits[1]:g}, worst max rel B1 {worst[0]:.3e} B2 {worst[1]:.3e}, worst "
                f"median rel {worst_med:.3e}; B2 values bit-equal, B2 fitness bit-equal to B1 "
                f"on its offspring")

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
                b2_source(b2_layout(gn, self.b2_kwargs(POP), k, D), TOPOLOGY),
                "pmfm_tpu/kernels/synth_fitness.py:767",
            ),
            "fused_generation": (
                b2, b2_plain, 2 * MU * D * 4 + operand + k * 4 + POP * 4 + 2 * POP * D * 4,
                POP * D * 12 * 2.0,  # CLT sums and the mutation, f32
                b2_source(b2_layout(gn, self.b2_kwargs(POP), k, D), TOPOLOGY),
                "pmfm_tpu/kernels/generation.py:438",
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
            for attr in ("launches_by", "launches_by_layout", "launches_by_f32"):
                if hasattr(fn, attr):
                    getattr(fn, attr).clear()

    def read_counts(self):
        return {name: fn.launches for name, fn in self.counters().items()}

    def f32_counts(self):
        """The true-f32 launches of B1, B2 and B5 since the last reset, by
        route (``fft``, ``dft``) and synthesis layout (``time_parallel``,
        ``one_thread``)."""
        out = collections.Counter()
        for fn in self.counters().values():
            out.update(getattr(fn, "launches_by_f32", {}))
        return out

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

    def fold_grid(self, grid=FOLD_GRID):
        """B3 bit-equal to its plain version over ``grid`` in both modes and
        both layouts, at each of LARGE_GRID_POPS."""
        from pmfm_tpu_torch.kernels import synth_fold as sfo

        t0, checked, big = time.perf_counter(), 0, max(LARGE_GRID_POPS)
        for topology, order, n in grid:
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

    def fold_layouts(self, shapes=FOLD_LAYOUT_SHAPES, launches=TIMED_LAUNCHES):
        """B3's two layouts timed over ``shapes`` x FOLD_LAYOUT_POPS (the
        median of ``launches``), each beside the one the wrapper takes."""
        from pmfm_tpu_torch.kernels import synth_fold as sfo

        big = max(FOLD_LAYOUT_POPS)
        for topology, order, n, int8 in shapes:
            params = self.grid_params(topology, big, n + order)
            kw = dict(topology=topology, n=n, sine_order=order, dft_scale=1e-5 if int8 else 0.0)
            for pop in FOLD_LAYOUT_POPS:
                p = params[:pop]
                t = {}
                for tp in (True, False):
                    with fold_layout(sfo, tp):
                        t[tp] = cuda_ms(lambda: sfo.fused_synth_fold(p, **kw), launches)
                pick = sfo.fold_geometry(pop, n, int8, topology)["time_parallel"]
                log(f"B3 layouts ({topology}, sine order {order}, n={n}, "
                    f"{'int8' if int8 else 'bf16'}, P={pop}): time-parallel {t[True]:.4f} ms, "
                    f"single pass {t[False]:.4f} ms; the wrapper takes the "
                    f"{'time-parallel' if pick else 'single-pass'} one, "
                    f"{100 * (t[pick] / min(t.values()) - 1):.1f}% over the faster {card()}")

    def grid_params(self, topology, pop, seed):
        """``pop`` candidates of ``topology`` uniform in ``param_maxs``' ranges
        ((0, 3520 Hz) x (0, 8) an operator, amplitude (0, 1) a pair), from
        ``seed``, on the card."""
        maxs = np.asarray(param_maxs(topology), np.float32)
        rng = np.random.default_rng(seed)
        cand = (rng.random((pop, len(maxs))) * maxs).astype(np.float32)
        return torch.from_numpy(cand).to(self.dev)

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

    def stream_grid(self, grid=STREAM_GRID):
        """B4 bit-equal to its plain version over ``grid`` in both modes,
        at each of LARGE_GRID_POPS. The plain version runs once a setting in
        f32: its bf16 output is the same f32 audio rounded by ``.to`` (it
        writes ``audio.to(out.dtype)``), so the kernel's bf16 audio is held
        against that rounding."""
        from pmfm_tpu_torch.kernels import synth_stream as sst
        from pmfm_tpu_torch.ops import hann_window

        t0, checked, big = time.perf_counter(), 0, max(LARGE_GRID_POPS)
        for topology, order, n in grid:
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
        # the three settings' frames (n 1024, 2048) take the FFT route
        self.kernels["fused_f32_fft"] = {"max_abs_err": max(worst.values())}
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
        f32 = self.f32_counts()
        log(f"shipped path's true-f32 launches by route and synthesis layout: {dict(f32)}")
        require(f32["fft"] == r + 1 and not f32["dft"], "the shipped f32 launches take the FFT")
        self.kernels.setdefault("fused_f32_fft", {})["launches"] = f32["fft"]
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
        f32 = self.f32_counts()
        log(f"match_audio's true-f32 launches by route and synthesis layout: {dict(f32)}")
        require(f32["fft"] == chunks * (r + 1) and f32["time_parallel"] == chunks * (r + 1),
                "audio_match.json's f32 launches take the FFT and the time-parallel synthesis")
        self.kernels.setdefault("fused_f32_synth_tp", {})["launches"] = f32["time_parallel"]
        # per chunk: g B2 launches (int8, then f32) and one B1 f32 rescore
        require(counts["fused_generation"] == chunks * g
                and counts["fused_synth_fitness"] == chunks
                and sum(counts.values()) == chunks * (g + 1), "match_audio launches")

    # -- 16 -----------------------------------------------------------------
    def f32_turns(self, fn, runs: int):
        """``fn``'s device time (``cuda_ms`` over ``runs`` calls) in F32_ORDER's
        turns: the earlier design (the DFT route, one thread a candidate) and
        the wrapper's choice; (the new ms, the median of its turns; every
        turn's ms by design)."""
        from pmfm_tpu_torch.kernels import synth_fitness as sf

        modes = {"old": (False, False), "new": (True, None)}
        times = {"old": [], "new": []}
        for mode in F32_ORDER:
            with f32_mode(sf, *modes[mode]):
                times[mode].append(cuda_ms(fn, runs))
        return statistics.median(times["new"]), times

    def third_timings(self):
        """B1/B2 f32 at the shipped tail's shapes (the earlier design and this
        one in turns, ``f32_turns``), B5 at the bench config and in f32 at
        the shipped tail, and the port's bench (one repetition after a
        warm-up), then the host time of the one-run forms the ES loop keeps
        (``host_forms``)."""
        from pmfm_tpu_torch import bench
        from pmfm_tpu_torch.es import kernel_seed
        from pmfm_tpu_torch.kernels import evolve as ev
        from pmfm_tpu_torch.kernels import generation as gn
        from pmfm_tpu_torch.kernels import synth_fitness as sf

        c = self.f32["shipped refine tail"]
        cfg = c["cfg"]
        pop, mu, n, k = cfg.population_size, cfg.num_parents, cfg.n_samples, c["so"].num_bins
        seed = kernel_seed(SEED, 9)
        # the work any implementation does: the synthesis, a real FFT a frame
        # (f32_fft_ops) and the epilogue; the folded DFT's two (K, N/2)
        # products a candidate beside it for the record
        f32_ops = synth_ops_f32(pop, n, k, kn=3, ncoef=5) + f32_fft_ops(pop, n)
        dft_ops = 2.0 * 2 * k * (n // 2) * pop
        kw1, kw2 = self.kw_b1(c), self.kw_b2(c)
        src = "pmfm_tpu_torch/csrc/fused_f32.cu"
        rows = {
            "fused_synth_fitness_f32": (
                lambda: sf.fused_synth_fitness(c["params"], c["target"], **kw1),
                lambda: sf.fused_synth_fitness_plain(c["params"], c["target"], **kw1),
                pop * D * 4 + k * 4 + pop * 4, 0.0, f32_ops, src,
                "pmfm_tpu/kernels/synth_fitness.py:767",
            ),
            "fused_generation_f32": (
                lambda: gn.fused_generation(seed, c["pv"], c["ps"], c["target"], **kw2),
                lambda: gn.fused_generation_plain(seed, c["pv"], c["ps"], c["target"], **kw2),
                2 * mu * D * 4 + k * 4 + pop * 4 + 2 * pop * D * 4, 0.0,
                f32_ops + pop * D * 12 * 2.0, src, "pmfm_tpu/kernels/generation.py:438",
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
            turns = ""
            if name == "fused_evolve":
                ms = cuda_ms(fn, 5)
                layout = b5_layout_taken(ev, fn)
                turns = f" (B2's {layout} layout)"
                self.kernels.setdefault(name, {})["layout"] = layout
            else:
                ms, times = self.f32_turns(fn, TIMED_LAUNCHES)
                turns = (f" (turns {F32_ORDER}: old, the DFT route and one thread a candidate, "
                         f"{times['old']}; new {times['new']}; the bound with the DFT's "
                         f"{dft_ops / 1e9:.2f} G operations "
                         f"{bound(nbytes, 0.0, f32 - f32_fft_ops(pop, n) + dft_ops)[0]:.4f} ms)")
            plain_ms = cuda_ms(plain, PLAIN_RUNS)
            bound_ms, by = bound(nbytes, int8_ops, f32)
            per = f", {ms / g:.4f} ms a generation" if name == "fused_evolve" else ""
            log(f"{name}: kernel {ms:.4f} ms{per}, plain {plain_ms:.2f} ms (median of "
                f"{PLAIN_RUNS}), bound {bound_ms:.4f} ms by {by} ({nbytes / 1e6:.2f} MB, "
                f"{int8_ops / 1e9:.1f} G int8 ops, {f32 / 1e9:.2f} G f32 ops){turns} {card()}")
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

    # -- 44 -----------------------------------------------------------------
    def f32_shapes(self):
        """B2 true f32 at each of F32_SPLIT_SHAPES, the earlier design and
        this one alternated in one process (old, new, new, old, F32_ORDER):
        the DFT route with one thread a candidate (``f32_mode(sf, False,
        False)``: the parent's kernels and the fold that now lies between
        them) against the wrapper's choice (the FFT, the synthesis layout of
        ``f32_time_parallel``). Each one's device time (``cuda_ms``) and its
        kernels' times from torch.profiler, the two fitnesses within the f32
        gates, two yardsticks for the spectrum stage that the port never
        calls (cuFFT: ``torch.fft.rfft`` of the same number of windowed
        float32 frames of n; cuBLAS SGEMM: the folded DFT's two products,
        TF32 off), and each one's bound: the bytes and the operations any
        implementation must do (the synthesis, a real FFT's 2.5 N log2 N a
        frame, the epilogue; the DFT's 2 x 2K x N/2 beside it for the
        record). At cell (m)'s shape it also times the FFT kernel and the
        time-parallel synthesis as kernels of their own (the JSON line's
        ``fused_f32_fft`` and ``fused_f32_synth_tp``) against their plain
        versions (the fold and folded DFT of ``dft_fitness_plain`` on the same
        frames; ``synth_f32_plain``)."""
        from pmfm_tpu_torch.device import exact_f32_matmul
        from pmfm_tpu_torch.es import kernel_seed, make_spectrum_ops
        from pmfm_tpu_torch.io import load_config
        from pmfm_tpu_torch.kernels import generation as gn
        from pmfm_tpu_torch.kernels import synth_fitness as sf
        from pmfm_tpu_torch.ops import spectral

        modes = {"old": (False, False), "new": (True, None)}
        for i, (label, path, frames, runs) in enumerate(F32_SPLIT_SHAPES):
            cfg = load_config(path).es.refine_config().replace(num_frames=frames)
            so = make_spectrum_ops(cfg, device=self.dev)
            b = runs or 1
            c = self.run_inputs(cfg, so, b, SEED + 1700 + i)
            if runs is None:
                c = {key: v[0] for key, v in c.items()}
            kw2 = self.kw_b2(dict(cfg=cfg, so=so))
            seeds = [kernel_seed(SEED, 1710 + j) for j in range(b)]
            seed = seeds if runs else seeds[0]
            b2 = lambda: gn.fused_generation(seed, c["pv"], c["ps"], c["target"], **kw2)  # noqa: E731
            pop, n, k, d = cfg.population_size, cfg.n_samples, so.num_bins, cfg.num_dimensions
            rows = b * frames * pop
            times, split, fit = {"old": [], "new": []}, {}, {}
            for mode in F32_ORDER:
                with f32_mode(sf, *modes[mode]):
                    times[mode].append(cuda_ms(b2, TIMED_LAUNCHES))
                    if mode not in split:
                        split[mode] = kernel_breakdown(b2, PROFILED_LAUNCHES)
                        fit[mode] = b2()[0]
            e = rel_err(fit["new"], fit["old"])
            require(float(e.max()) <= F32_FIT_MAX_REL and float(e.median()) <= F32_FIT_MEDIAN_REL,
                    f"{label}: the FFT route disagrees with the DFT route")
            geo = sf.f32_geometry(pop, n, k, frames, b, cfg.topology)
            g = torch.Generator(device=self.dev).manual_seed(SEED)
            x = torch.randn((rows, n), generator=g, device=self.dev)
            w = torch.from_numpy(spectral.hann_window(n).astype(np.float32)).to(self.dev)
            fft_ms = cuda_ms(lambda: torch.fft.rfft(x * w, dim=-1), TIMED_LAUNCHES)
            ap, am = (torch.randn((rows, n // 2), generator=g, device=self.dev) for _ in range(2))
            op = so.dft_packed
            with exact_f32_matmul():
                mm_ms = cuda_ms(lambda: (torch.matmul(ap, op[:k].T), torch.matmul(am, op[k:].T)),
                                TIMED_LAUNCHES)
            del ap, am
            synth = synth_ops_f32(pop * b, n, k, kn=3, ncoef=5) * frames
            offspring = pop * b * d * 12 * 2.0
            io = b * frames * k * 4 + 2 * b * cfg.num_parents * d * 4 + 3 * b * pop * d * 4
            fft_ops = rows * 2.5 * n * math.log2(n)
            dft_ops = rows * 2.0 * 2 * k * (n // 2)
            bound_ms, by = bound(io, 0.0, synth + offspring + fft_ops)
            dft_bound_ms, dft_by = bound(io + 2 * k * (n // 2) * 4, 0.0, synth + offspring + dft_ops)
            log(f"B2 f32 at {label} (n={n}, K={k}, P={pop}, F={frames}, B={b}, {cfg.topology}, "
                f"sine order {cfg.sine_order}; {F32_ORDER}, each the median of "
                f"{TIMED_LAUNCHES}): old (DFT, one thread a candidate) "
                f"{' '.join(f'{t:.4f}' for t in times['old'])} ms, new ({geo['route']}, "
                f"{geo['layout']} synthesis) {' '.join(f'{t:.4f}' for t in times['new'])} ms; "
                f"new vs old fitness max rel {float(e.max()):.3e} median {float(e.median()):.3e}; "
                f"bound {bound_ms:.4f} ms by {by} ({(synth + offspring + fft_ops) / 1e9:.2f} G "
                f"f32 ops with the FFT; with the DFT {dft_bound_ms:.4f} ms by {dft_by}, "
                f"{(synth + offspring + dft_ops) / 1e9:.2f} G); yardsticks for the spectrum of "
                f"{rows} frames: cuFFT rfft of the windowed frames {fft_ms:.4f} ms, cuBLAS SGEMM "
                f"of the folded DFT {mm_ms:.4f} ms {card()}")
            for mode in ("old", "new"):
                log(f"  B2 f32 by kernel at {label}, {mode} (torch.profiler, mean of "
                    f"{PROFILED_LAUNCHES} launches): {split[mode]} {card()}")
            if i == 0:
                self.f32_kernel_rows(c, cfg, so, b2, x, w, fft_ms)
            del x

    def f32_kernel_rows(self, c, cfg, so, b2, x, w, fft_ms):
        """The JSON line's rows of the FFT kernel and the time-parallel
        synthesis at cell (m)'s shape: each one's device time in B2 (from
        torch.profiler), its plain version's (``dft_fitness_plain`` after the
        fold, on ``x``'s frames; ``synth_f32_plain``) and its bound; cuFFT
        the FFT's library call."""
        from pmfm_tpu_torch.kernels import synth_fitness as sf

        times = kernel_times(b2, PROFILED_LAUNCHES, per_launch=True)
        by_name = {name.split("<")[0]: ms for name, ms in times.items()}
        require("f32_fft_kernel" in by_name and "f32_synth_tp_kernel" in by_name,
                f"cell (m)'s B2 f32 ran {sorted(by_name)}")
        pop, n, k, frames = cfg.population_size, cfg.n_samples, so.num_bins, cfg.num_frames
        rows = x.shape[0]
        tgt = c["target"].reshape(frames, k)

        def plain_spectrum():
            fit = None
            for f in range(frames):
                ap, am, edge = sf.fold(x[f * pop : (f + 1) * pop].T)
                t = sf.dft_fitness_plain(ap, am, edge, None, so.dft_packed, 0.0, tgt[f])
                fit = t if fit is None else fit + t
            return fit

        scaled = torch.rand((pop, cfg.num_dimensions), device=self.dev) * torch.tensor(
            cfg.param_maxs, device=self.dev)
        kw = dict(topology=cfg.topology, n=n * frames, sine_order=cfg.sine_order,
                  inv_sr=sf.inv_sample_rate(cfg.wavetable_size, cfg.sample_rate))
        rows_spec = {
            "fused_f32_fft": (by_name["f32_fft_kernel"], cuda_ms(plain_spectrum, PLAIN_RUNS),
                              rows * n * 4 + frames * k * 4 + rows * 4,
                              rows * (2.5 * n * math.log2(n) + 12 * k), fft_ms,
                              "pmfm_tpu_torch/csrc/fused_f32.cu",
                              "pmfm_tpu/kernels/synth_fitness.py:767"),
            "fused_f32_synth_tp": (by_name["f32_synth_tp_kernel"],
                                   cuda_ms(lambda: sf.synth_f32_plain(scaled, **kw), PLAIN_RUNS),
                                   rows * n * 4 + pop * cfg.num_dimensions * 4,
                                   synth_ops_f32(pop, n, 0, kn=3, ncoef=5) * frames, None,
                                   "pmfm_tpu_torch/csrc/fused_f32_tp.cu",
                                   "pmfm_tpu/kernels/generation.py:438"),
        }
        for name, (ms, plain_ms, nbytes, ops, lib_ms, src, replaces) in rows_spec.items():
            bound_ms, by = bound(nbytes, 0.0, ops)
            log(f"{name} (cell (m): n={n}, K={k}, P={pop}, F={frames}): kernel {ms:.4f} ms "
                f"(torch.profiler, in B2), plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms by "
                f"{by} ({nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} G f32 ops), library "
                f"{'not applicable' if lib_ms is None else f'{lib_ms:.4f} ms (cuFFT rfft)'} "
                f"{card()}")
            self.kernels.setdefault(name, {}).update(
                route="cuda", source=src, replaces=replaces, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, library_ms=lib_ms)

    # -- 45 -----------------------------------------------------------------
    def f32_layouts(self):
        """The true-f32 synthesis' two layouts write the same rows of samples
        bit for bit (``f32_rows``) over F32_TP_TOPOLOGIES x F32_TP_FRAMES x
        one of F32_TP_N (in turn, every frame size at every frame count), sine
        orders 5/7/9, populations F32_TP_POPS and runs 1 and 2 in turn, and
        B1's fitness from them is bit-equal; then B2 in both
        layouts bit-equal (fitness, values, steps) at cell (m)'s shape and
        with a run axis of 8, and B5 at F 8 bit-equal to its B2 launches in
        the layout the wrapper takes (``fused_evolve_plain`` runs them)."""
        from pmfm_tpu_torch.es import kernel_seed
        from pmfm_tpu_torch.kernels import evolve as ev
        from pmfm_tpu_torch.kernels import generation as gn
        from pmfm_tpu_torch.kernels import synth_fitness as sf
        from pmfm_tpu_torch.ops.synthesis import topology_dims

        rng = np.random.default_rng(SEED + 45)
        cases = 0
        for ti, topology in enumerate(F32_TP_TOPOLOGIES):
            d, maxs = topology_dims(topology), np.asarray(param_maxs(topology))
            for fi, frames in enumerate(F32_TP_FRAMES):
                for n in (F32_TP_N[(ti + fi) % len(F32_TP_N)],):
                    order = GRID_SINE_ORDERS[cases % 3]
                    pop = F32_TP_POPS[cases % len(F32_TP_POPS)]
                    lead = (2,) if (cases // 2) % 2 else ()
                    params = torch.from_numpy(
                        (rng.random((*lead, pop, d)) * maxs).astype(np.float32)).to(self.dev)
                    a, fa = f32_rows(params, topology, n, frames, order, False)
                    b, fb = f32_rows(params, topology, n, frames, order, True)
                    where = f"{topology}, n={n}, F={frames}, P={pop}, runs {lead or 1}, order {order}"
                    require(bool(torch.isfinite(a).all()), f"f32 samples not finite ({where})")
                    require(bits_equal(a, b), f"the f32 synthesis layouts differ ({where})")
                    require(bits_equal(fa, fb), f"B1 f32 differs between layouts ({where})")
                    cases += 1
        self.kernels.setdefault("fused_f32_synth_tp", {})["max_abs_err"] = 0.0
        log(f"f32 synthesis, time-parallel vs one thread a candidate: {cases} settings "
            f"({F32_TP_TOPOLOGIES} x F {F32_TP_FRAMES} x one of n {F32_TP_N}, P {F32_TP_POPS}, "
            f"runs 1/2, sine orders 5/7/9), every row of samples bit-equal and B1's fitness "
            f"bit-equal")
        # B2 in both layouts, and B5 against its B2 launches, at cell (m) and (n)'s shapes
        from pmfm_tpu_torch.es import make_spectrum_ops
        from pmfm_tpu_torch.io import load_config

        for label, frames, runs in (("(m)", 8, None), ("(n)", 1, 8)):
            cfg = load_config(AUDIO_CONFIG).es.refine_config().replace(num_frames=frames)
            so = make_spectrum_ops(cfg, device=self.dev)
            bb = runs or 1
            c = self.run_inputs(cfg, so, bb, SEED + 4500 + frames)
            if runs is None:
                c = {key: v[0] for key, v in c.items()}
            kw2 = self.kw_b2(dict(cfg=cfg, so=so))
            seeds = [kernel_seed(SEED, 4510 + j) for j in range(bb)]
            seed = seeds if runs else seeds[0]
            out = {}
            for tp in (False, True):
                with f32_mode(sf, True, tp):
                    out[tp] = gn.fused_generation(seed, c["pv"], c["ps"], c["target"], **kw2)
            require(all(bits_equal(x, y) for x, y in zip(out[False], out[True])),
                    f"B2 f32 differs between the synthesis layouts at {label}")
            msg = f"B2 f32 at cell {label}'s shape: bit-equal in both synthesis layouts"
            if runs is None:
                s5 = [kernel_seed(SEED, 4520 + j) for j in range(EVOLVE_CHECK_GENERATIONS)]
                args = (c["pv"], c["ps"], c["pv"][0].clone(),
                        torch.tensor(float("inf"), device=self.dev), c["target"])
                self.reset_counts()
                got = ev.fused_evolve(s5, *args, **kw2)
                layout = dict(self.f32_counts())
                want = ev.fused_evolve_plain(s5, *args, generation=gn.fused_generation, **kw2)
                require(all(bits_equal(x, y) for x, y in zip(got, want)),
                        f"B5 f32 differs from its B2 launches at {label}")
                msg += (f"; B5 ({len(s5)} generations, {layout}) bit-equal to its B2 launches "
                        f"with the stable selection")
            log(msg)

    # -- 17 -----------------------------------------------------------------
    def scan_vs_plain(self):
        """The scan's two layouts, each bit-equal to its plain loop over
        samples and to the other: at the bench's shape (fm3_series, P 2^15,
        n 1024), at parameters.json's (its population, n 2048), and over
        SCAN_GRID x the three oscillators x float32 and bf16 output at
        SCAN_GRID_POP, SCAN_GRID_N; then at the first two both layouts' times
        alternated (SCAN_ORDER) beside the plain loop's, the byte/op bound
        and the chain floor (``scan.chain_floor_ms``: n x one add-and-wrap's
        latency on a single thread)."""
        from pmfm_tpu_torch.io import load_config
        from pmfm_tpu_torch.kernels import scan as ss
        from pmfm_tpu_torch.ops.synthesis import topology_dims

        pj = load_config("parameters.json").es
        shapes = (("bench", TOPOLOGY, POP, 1 << LOG2N, self.cfg.param_maxs),
                  ("parameters.json", pj.topology, pj.population_size, pj.n_samples,
                   pj.param_maxs))
        grid = [(f"grid {t}", t, SCAN_GRID_POP, SCAN_GRID_N, None) for t in SCAN_GRID]
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
                # the plain loop's bf16 audio is its float32 audio rounded by
                # .to (it returns audio.to(out_dtype)): one plain run for both
                b32 = ss.scan_synth_plain(p, n, topology, osc_mode=osc)
                for dt in (torch.float32, torch.bfloat16):
                    b = b32.to(dt)
                    outs = {}
                    for tp in (False, True):
                        ss.scan_synth.launches_by_layout.clear()
                        with scan_layout(ss, tp):
                            outs[tp] = a = ss.scan_synth(p, n, topology, osc_mode=osc,
                                                         out_dtype=dt)
                        torch.cuda.synchronize()
                        got = dict(ss.scan_synth.launches_by_layout)
                        where = f"{label}, {osc}, {dt}, {scan_layout_name(tp)}"
                        require(got == {scan_layout_name(tp): 1}, f"scan ({where}): launched {got}")
                        worst = max(worst, float((a.float() - b.float()).abs().max()))
                        checked += 1
                        require(bits_equal(a.float(), b.float()) and a.shape == (n, pop),
                                f"scan kernel differs from its plain version ({where})")
                    require(bits_equal(outs[False].float(), outs[True].float()),
                            f"scan layouts differ ({label}, {osc}, {dt})")
            if not label.startswith("grid"):
                tt = {False: [], True: []}
                for tp in SCAN_ORDER:
                    with scan_layout(ss, tp):
                        tt[tp].append(cuda_ms(lambda: ss.scan_synth(p, n, topology),
                                              TIMED_LAUNCHES))
                ms = {tp: statistics.median(v) for tp, v in tt.items()}
                plain_ms = cuda_ms(lambda: ss.scan_synth_plain(p, n, topology), 1)
                kn = 2 if topology == "fm2" else int(topology[2:].split("_")[0])
                ops = float(pop) * n * kn * (SINF_OPS + 6)
                bound_ms, by = bound(n * pop * 4 + pop * d * 4, 0.0, ops)
                floor_ms = ss.chain_floor_ms(n, self.dev)
                pick = ss.scan_launch(pop, n, topology, "floor", torch.float32)
                log(f"scan_synth ({label}: {topology}, P={pop}, n={n}, floor, float32): one thread "
                    f"a candidate {ms[False]:.4f} ms {[round(x, 4) for x in tt[False]]}, "
                    f"time-parallel {ms[True]:.4f} ms {[round(x, 4) for x in tt[True]]} (medians "
                    f"of {TIMED_LAUNCHES}, alternated); the wrapper takes {pick['layout']} "
                    f"(group {pick['group']}, {pick['warps']} warps); plain loop "
                    f"{plain_ms:.2f} ms; bound {bound_ms:.4f} ms by {by}; chain floor "
                    f"{floor_ms:.4f} ms (n x one add-and-wrap's latency) {card()}")
                row = dict(route="cuda", source="pmfm_tpu_torch/csrc/scan_synth.cu",
                           replaces="pmfm_tpu/ops/synthesis.py:220", plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=by, library_ms=None,
                           chain_floor_ms=floor_ms)
                # the one-thread layout's row at the bench's shape, the
                # time-parallel one's at parameters.json's
                name, tp = ("scan_synth", False) if label == "bench" else ("scan_synth_tp", True)
                self.kernels.setdefault(name, {}).update(row, ms=ms[tp])
        log(f"scan layouts bit-equal to their plain loop and to each other in {checked} settings "
            f"(chains {SCAN_GRID} x floor/exact/table x float32/bf16 at P={SCAN_GRID_POP}, "
            f"n={SCAN_GRID_N}; the bench's and parameters.json's shapes)")
        for name in ("scan_synth", "scan_synth_tp"):
            self.kernels.setdefault(name, {})["max_abs_err"] = worst

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
        from pmfm_tpu_torch.kernels import scan as ss
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
                layouts = dict(ss.scan_synth.launches_by_layout)
                self.scan_by_layout.update(layouts)
                log(f"unfused {name} ({dtype}, {synth} synthesis; n={cfg.n_samples}, P={POP}): "
                    f"card vs CPU on {UNFUSED_CHECK_POP} candidates max rel {float(e.max()):.3e} "
                    f"median rel {float(e.median()):.3e} (tolerance {max_rel:g} / "
                    f"{median_rel:g}); truth rank {rank}; {UNFUSED_GENERATIONS} "
                    f"generations {ms:.4f} ms/gen, {POP / ms * 1e3:.4g} candidate-evals/s, best "
                    f"fitness {float(final.best_fitness):.6g}; launches {counts}, the scan's by "
                    f"layout {layouts} {card()}")
                require(bool(torch.isfinite(fit).all()), f"{name}: fitness not finite")
                require(float(e.max()) <= max_rel and float(e.median()) <= median_rel,
                        f"{name} ({dtype}, {synth}): the card disagrees with the CPU")
                require(rank == 0, f"{name} ({dtype}, {synth}): the truth does not rank first")
                want_scan = UNFUSED_GENERATIONS if synth == "scan" else 0
                pick = ss.scan_launch(POP, cfg.n_samples, TOPOLOGY, "floor", torch.float32)
                require(counts["scan_synth"] == want_scan and sum(counts.values()) == want_scan
                        and layouts == ({pick["layout"]: want_scan} if want_scan else {}),
                        f"{name}: launches {counts}, the scan's by layout {layouts}")
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
        from pmfm_tpu_torch.kernels import scan as ss

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
                layouts = dict(ss.scan_synth.launches_by_layout)
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
                    # a launch a generation, the target's, the best's, and the stage rows',
                    # each in the layout the rule gives its population (the
                    # candidates' and the stage rows') or one candidate
                    want = {ss.scan_launch(p, cfg.n_samples, cfg.topology, cfg.osc_mode,
                                           torch.float32)["layout"]
                            for p in (1, cfg.population_size)}
                    log(f"cli {config}: the scan's launches by layout {layouts} (the rule: "
                        f"{sorted(want)})")
                    require(counts["scan_synth"] >= gens + 2 and set(layouts) <= want
                            and sum(layouts.values()) == counts["scan_synth"],
                            f"{config}: launches {counts}, the scan's by layout {layouts}")
                    self.scan_by_layout.update(layouts)
                    by = self.scan_by_layout
                    require(by["one_thread"] > 0 and by["time_parallel"] > 0,
                            f"the scan's path launches by layout (phases 18-19): {dict(by)}")
                    self.kernels.setdefault("scan_synth", {})["launches"] = by["one_thread"]
                    self.kernels.setdefault("scan_synth_tp", {})["launches"] = by["time_parallel"]
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
            # int8: the folded DFT on the operand; f32: the FFT (no operand)
            operand = 2 * k * (n // 2) if mode == "int8" else 0
            int8_ops, f32_ops = ((dft_ops, synth) if mode == "int8"
                                 else (0.0, synth + f32_fft_ops(pop, n)))
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
                source = b2_source(b2_layout(gn, kw2, k, d), cfg.topology) if mode == "int8" \
                    else src
                turns = ""
                if mode == "int8":
                    ms = cuda_ms(fn, TIMED_LAUNCHES)
                else:
                    ms, times = self.f32_turns(fn, TIMED_LAUNCHES)
                    turns = f"; turns old {times['old']}, new {times['new']}"
                plain_ms = cuda_ms(plain, PLAIN_RUNS)
                bound_ms, by = bound(nbytes, i8, f32)
                log(f"{name} ({cfg.topology}, n={n}, K={k}, P={pop}, sine order "
                    f"{cfg.sine_order}): kernel {ms:.4f} ms (median of {TIMED_LAUNCHES}), plain "
                    f"{plain_ms:.2f} ms (median of {PLAIN_RUNS}), bound {bound_ms:.4f} ms by {by} "
                    f"({nbytes / 1e6:.2f} MB, {i8 / 1e9:.1f} G int8 ops, {f32 / 1e9:.2f} G f32 "
                    f"ops){turns} {card()}")
                self.kernels.setdefault(name, {}).update(
                    route="cuda", source=source, replaces=replaces, ms=ms, plain_ms=plain_ms,
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
        it: PURSUIT_AS_WRITTEN as written but for one attempt a chunk (exit
        0, the WAV and the CSV, its first chunk's relative spectral error
        under the f32 engine below PURSUIT_MAX_REL), the others with each stage's generations cut by
        PURSUIT_GENERATION_CUT and one attempt through a wrapped
        ``load_config`` (exit 0, the WAV and the CSV, the final f32 fitness
        no worse than the silent estimate's, every chunk); each run's
        attempts, generations, seconds by part, launches, and how far the
        true parameters lie from each chunk under the same f32 engine (the
        best a phase-0 model can reach there, about). First the f32 engine's
        peak memory per candidate sample at the block stages' shapes, the
        calibration of ``es.staged._batch_width_cap``."""
        import os
        import shutil

        import pmfm_tpu_torch.io
        from pmfm_tpu_torch.kernels import generation as gn
        from pmfm_tpu_torch.kernels import synth_fitness as sf

        self.engine_memory()
        root = os.getcwd()
        work = os.path.join(root, PURSUIT_DIR)
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        load = pmfm_tpu_torch.io.load_config
        cut = pursuit_cut(load)
        once = pursuit_cut(load, generation_cut=1)

        try:
            for config in (PURSUIT_AS_WRITTEN,) + PURSUIT_CUT:
                as_written = config == PURSUIT_AS_WRITTEN
                code, counts, modes, lines = self.pursuit_cli(
                    os.path.join(root, config), work, once if as_written else cut, as_written)
                layouts = dict(gn.fused_generation.launches_by_layout)
                b1_layouts = dict(sf.fused_synth_fitness.launches_by_layout)
                log(f"{config}: B2 int8 launches by layout {layouts}, B1's {b1_layouts}")
                require(code == 0 and lines, f"{config}: exit {code}")
                if as_written:
                    require(modes["B2"].get("parallel_int8", 0) > 0
                            and modes["B2"].get("parallel_f32", 0) > 0
                            and modes["B1"].get("parallel_int8", 0) > 0
                            and modes["B1"].get("parallel_f32", 0) > 0,
                            f"{config}: the parallel kernels did not all run: {modes}")
                    # B2 int8 ran in one layout, the one phase 20 timed (b2_layout)
                    require(len(layouts) == 1 and sum(layouts.values())
                            == modes["B2"]["parallel_int8"],
                            f"{config}: B2 int8 launches by layout {layouts}, by mode {modes}")
                    # B1 int8 (the seed rescores at P 1, the block stages' at
                    # the polish population) all time-parallel, by B2's rule
                    require(b1_layouts == {"time_parallel": modes["B1"]["parallel_int8"]},
                            f"{config}: B1 int8 launches by layout {b1_layouts}, by mode {modes}")
                    self.kernels.setdefault("fused_synth_fitness_tp", {})["launches"] = \
                        b1_layouts["time_parallel"]
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

    def pursuit_cli(self, path, work, loader, as_written, max_rel=PURSUIT_MAX_REL):
        """``cli.main(["-j", path])`` in ``work`` with ``loader`` in place of
        ``pmfm_tpu_torch.io.load_config``: exit code, launches, B1/B2
        launches by mode and the ``pursuit chunk`` lines, each printed
        beside the true parameters' own relative spectral error on that
        chunk. Every chunk's final f32 fitness must be finite and no worse
        than its silent estimate, the WAV and the CSV written; ``as_written``
        also holds the first chunk below ``max_rel``."""
        import io
        import os

        import pmfm_tpu_torch.io
        from pmfm_tpu_torch import cli
        from pmfm_tpu_torch.kernels import generation as gn
        from pmfm_tpu_torch.kernels import synth_fitness as sf

        root, load = os.getcwd(), pmfm_tpu_torch.io.load_config
        pmfm_tpu_torch.io.load_config = loader
        try:
            rc = loader(path)
            out = io.StringIO()
            os.chdir(work)
            torch.cuda.synchronize()
            self.reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                code = cli.main(["-j", path])
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
        how = "as written, one attempt a chunk" if as_written else (
            f"stage generations / {PURSUIT_GENERATION_CUT}, one attempt: {dict(rc.pursuit)}")
        log(f"pursuit {os.path.relpath(path, root)} ({how}): exit {code} in {seconds:.2f}s "
            f"(stage rows included), {engine!r}; launches {counts}, B1/B2 by mode {modes} "
            f"{card()}")
        truth = self.truth_rel(rc)
        for i, ln in enumerate(lines):
            print(f"  {ln}; the true parameters' own error on this chunk {truth[i]:.6g}",
                  flush=True)
        if code != 0 or not lines:
            return code, counts, modes, lines
        require(os.path.exists(wav) and os.path.exists(csv), f"{path}: no WAV or CSV")
        for i, ln in enumerate(lines):
            m = re.search(r"f32 fitness (\S+), silent estimate (\S+), relative spectral "
                          r"error (\S+)", ln)
            f32, silent, rel = (float(x) for x in m.groups())
            require(np.isfinite(f32) and f32 <= silent, f"{path}: worse than silence")
            if as_written and i == 0:
                require(rel < max_rel, f"{path}: relative spectral error {rel} >= {max_rel}")
        return code, counts, modes, lines

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
        frames, then over FRAME_GRID_F x FRAME_GRID_TOPOLOGIES, FRAME_GRID_N
        in turn, at FRAME_GRID_POP against a random (F, K) target, int8 and
        f32."""
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
            for ni, n in enumerate(FRAME_GRID_N):
                so = spectral.make_spectrum_ops(n, None, dft_dtype=dtype, device=self.dev)
                for fi, frames in enumerate(FRAME_GRID_F):
                    tgt = torch.from_numpy(rng.uniform(0.0, 50.0, (frames, so.num_bins)).astype(
                        np.float32)).to(self.dev)
                    for ti, topology in enumerate(FRAME_GRID_TOPOLOGIES):
                        if (ni + fi + ti) % len(FRAME_GRID_N):  # n in turn
                            continue
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
            log(f"B1/B2 multi-frame {mode} grid: F {FRAME_GRID_F} x {FRAME_GRID_TOPOLOGIES}, n "
                f"{FRAME_GRID_N} in turn, at P {pop}, sine order 9, within {limits[mode][0]:g} / "
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
                a = synthesize_single(torch.tensor(truth, device=self.dev), BATCH_SAMPLES,
                                      cfg.topology).cpu()
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
                # int8: the folded DFT on the operand; f32: the FFT (no operand)
                operand = 0 if f32 else 2 * k * (n // 2)
                dft_ops = (f32_fft_ops(pop * b * frames, n) if f32
                           else 2.0 * 2 * k * (n // 2) * pop * b * frames)
                synth = synth_ops_f32(pop * b, n, k, kn=3, ncoef=5) * frames
                offspring = pop * b * d * 12 * 2.0
                io = operand + b * frames * k * 4 + b * pop * 4
                sfx = ("_frames" if runs is None else "_runs") + ("_f32" if f32 else "")
                rows = {
                    f"fused_synth_fitness{sfx}": (
                        lambda: sf.fused_synth_fitness(c["params"], c["target"], **kw1),
                        lambda: sf.fused_synth_fitness_plain(c["params"], c["target"], **kw1),
                        io + b * pop * d * 4, dft_ops, synth, 1,
                        "pmfm_tpu_torch/csrc/fused_f32.cu" if f32 else
                        b2_source(b2_layout(gn, kw2, k, d, b), cfg.topology),
                        "pmfm_tpu/kernels/synth_fitness.py:767"),
                    f"fused_generation{sfx}": (
                        lambda: gn.fused_generation(seed, c["pv"], c["ps"], c["target"], **kw2),
                        lambda: gn.fused_generation_plain(seed, c["pv"], c["ps"], c["target"],
                                                          **kw2),
                        io + 2 * b * mu * d * 4 + 2 * b * pop * d * 4, dft_ops,
                        synth + offspring, 1,
                        "pmfm_tpu_torch/csrc/fused_f32.cu" if f32 else
                        b2_source(b2_layout(gn, kw2, k, d, b), cfg.topology),
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
                    turns = ""
                    if f32:
                        ms, times = self.f32_turns(fn, TIMED_LAUNCHES)
                        turns = (f"; turns old (the DFT route, one thread a candidate) "
                                 f"{times['old']}, new {times['new']}")
                    else:
                        ms = cuda_ms(fn, TIMED_LAUNCHES if gens == 1 else 5)
                    if name.startswith("fused_evolve"):
                        layout = b5_layout_taken(ev, fn)
                        turns = f"; B2's {layout} layout"
                        self.kernels.setdefault(name, {})["layout"] = layout
                    plain_ms = cuda_ms(plain, PLAIN_RUNS_A6)
                    bound_ms, by = bound(nbytes, int8_ops, f32_ops)
                    per = f", {ms / gens:.4f} ms a generation" if gens > 1 else ""
                    log(f"{name} ({mode}, F={frames}, B={b}, n={n}, K={k}, P={pop}): kernel "
                        f"({src.rsplit('/', 1)[-1]}) {ms:.4f} ms{per}, plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms by "
                        f"{by} ({nbytes / 1e6:.2f} MB, {int8_ops / 1e9:.1f} G int8 ops, "
                        f"{f32_ops / 1e9:.2f} G f32 ops); {ms / bound_ms:.1f}x the bound"
                        f"{turns} {card()}")
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

    # -- 26 -----------------------------------------------------------------
    def bf16_settings(self):
        """(label, ESConfig) of the bf16 checks: the bench shape (the suite's
        and bench.py's: fm3_series, n 1024, P 2^15, sine order 7) and
        AUDIO_CONFIG's shape at BF16_FRAMES frames, each in bf16."""
        from pmfm_tpu_torch.io import load_config

        audio = load_config(AUDIO_CONFIG).es.replace(dft_dtype="bfloat16", refine_generations=0)
        return (("bench shape", self.cfg.replace(dft_dtype="bfloat16")),
                (f"audio_match shape, F={BF16_FRAMES}", audio.replace(num_frames=BF16_FRAMES)),
                ("audio_match shape", audio))

    def bf16_kernels(self):
        """B1/B2 in the bf16 mode against their plain versions (``fused_check``,
        the int8 gate): at the bench shape and at BF16_FRAMES frames of
        AUDIO_CONFIG's shape with the truth planted first, over phase 4b's
        grid with BF16_TOPOLOGIES, and with a run axis of BF16_RUNS at
        AUDIO_CONFIG's shape (bit-equal to lone launches, within the limits
        of the plain version run by run)."""
        from pmfm_tpu_torch.es import kernel_seed, make_spectrum_ops
        from pmfm_tpu_torch.kernels import generation as gn
        from pmfm_tpu_torch.kernels import synth_fitness as sf
        from pmfm_tpu_torch.ops import spectral, synthesize_single

        limits = (FIT_MAX_REL, FIT_MEDIAN_REL)
        self.bf16 = {}
        for i, (label, cfg) in enumerate(self.bf16_settings()[:2]):
            c = self.inputs(cfg, SEED + 150 + i)
            require(c["so"].dft_packed.dtype == torch.bfloat16, f"{label}: not the bf16 operand")
            if cfg.num_frames > 1:
                audio = synthesize_single(torch.tensor(TRUTH), cfg.n_samples * cfg.num_frames,
                                          cfg.topology).to(self.dev)
                c["target"] = spectral.target_spectrum_frames(audio, c["so"])
            self.bf16[label] = c
            where = (f"bf16, {label}: {cfg.topology}, n={cfg.n_samples}, F={cfg.num_frames}, "
                     f"K={c['so'].num_bins}, P={cfg.population_size}, sine order {cfg.sine_order}")
            e1, e2, fk, a1, a2 = self.fused_check(
                where, c["params"], c["pv"], c["ps"], c["target"], self.kw_b1(c), self.kw_b2(c),
                kernel_seed(SEED, 150 + i), limits)
            rank = int(torch.argmin(fk))
            m1, m2 = self.last_median
            log(f"B1/B2 {where}: fitness max rel B1 {e1:.3e} B2 {e2:.3e}, median rel B1 "
                f"{m1:.3e} B2 {m2:.3e} (limits {limits[0]:g} / {limits[1]:g}); B2 values "
                f"bit-equal, B2 fitness bit-equal to B1 on its offspring; truth rank {rank}")
            require(rank == 0, "the known-params truth does not rank first")
            if i == 0:
                self.kernels["fused_synth_fitness_bf16"] = {"max_abs_err": a1}
                self.kernels["fused_generation_bf16"] = {"max_abs_err": a2}
        self.grid("bfloat16", BF16_GRID_POPS, limits, SEED + 160, 16000,
                  topologies=BF16_TOPOLOGIES)
        # the run axis at AUDIO_CONFIG's shape, one frame
        cfg = self.bf16_settings()[2][1]
        so = make_spectrum_ops(cfg, device=self.dev)
        c = self.run_inputs(cfg, so, BF16_RUNS, SEED + 170)
        tgt = c["target"][:, 0].contiguous()
        kw1, kw2 = self.kw_b1(dict(cfg=cfg, so=so)), self.kw_b2(dict(cfg=cfg, so=so))
        seeds = [kernel_seed(SEED, 1700 + r) for r in range(BF16_RUNS)]
        fb = sf.fused_synth_fitness(c["params"], tgt, **kw1)
        gb = gn.fused_generation(seeds, c["pv"], c["ps"], tgt, **kw2)
        for r in range(BF16_RUNS):
            lone1 = sf.fused_synth_fitness(c["params"][r], tgt[r], **kw1)
            lone2 = gn.fused_generation(seeds[r], c["pv"][r], c["ps"][r], tgt[r], **kw2)
            require(bits_equal(fb[r], lone1) and all(bits_equal(a[r], b)
                                                     for a, b in zip(gb, lone2)),
                    f"bf16 run axis: run {r} is not its lone launch")
        plain = sf.fused_synth_fitness_plain(c["params"], tgt, **kw1)
        torch.cuda.synchronize()
        e = rel_err(fb, plain)
        log(f"B1/B2 bf16 run axis (B={BF16_RUNS}, n={cfg.n_samples}, P={cfg.population_size}): "
            f"each run bit-equal to its lone launch; B1 against its plain version max rel "
            f"{float(e.max()):.3e} median rel {float(e.median()):.3e}")
        require(float(e.max()) <= FIT_MAX_REL and float(e.median()) <= FIT_MEDIAN_REL,
                "bf16 B1 with a run axis disagrees with its plain version")

    # -- 27 -----------------------------------------------------------------
    def bf16_evolve(self):
        """B5 in the bf16 mode bit-equal to EVOLVE_CHECK_GENERATIONS launches
        of the B2 bf16 kernel with the stable selection (the bench config,
        and at RAGGED_POP), within B2's limits of its plain version over
        EVOLVE_PLAIN_GENERATIONS, then ``evolve`` with fused_evolve in bf16
        at the bench config: one B5 launch for GENERATIONS generations."""
        from pmfm_tpu_torch.es import evolve, init_state, kernel_seed
        from pmfm_tpu_torch.es.pipeline import _fused_evolve_ok
        from pmfm_tpu_torch.kernels import evolve as ev
        from pmfm_tpu_torch.kernels import generation as gn

        bench = self.bf16["bench shape"]
        ragged = self.inputs(bench["cfg"].replace(num_offspring=RAGGED_POP - MU), SEED + 171)

        def args(c):
            return (c["pv"], c["ps"], c["pv"][0].clone(),
                    torch.tensor(float("inf"), device=self.dev), c["target"])

        for label, c in (("bench config", bench), ("bench config, ragged P", ragged)):
            kw = self.kw_b2(c)
            seeds = [kernel_seed(SEED, 1800 + g) for g in range(EVOLVE_CHECK_GENERATIONS)]
            ev.fused_evolve.launches_by_layout.clear()
            out = ev.fused_evolve(seeds, *args(c), **kw)
            b5 = dict(ev.fused_evolve.launches_by_layout)
            torch.cuda.synchronize()
            gn.fused_generation.launches_by_layout.clear()
            loop = ev.fused_evolve_plain(seeds, *args(c), generation=gn.fused_generation, **kw)
            b2 = dict(gn.fused_generation.launches_by_layout)
            equal = all(bits_equal(a, b) for a, b in zip(out, loop))
            traj = out[5].cpu()
            log(f"B5 bf16 ({b5}) vs {len(seeds)} B2 bf16 launches ({b2}) + stable selection "
                f"({label}: P={c['cfg'].population_size}): bit-equal {equal}; best-ever first "
                f"{float(traj[0]):.6g} last {float(traj[-1]):.6g}")
            require(equal, "B5 bf16 is not bit-equal to the loop of B2 launches")
            require(set(b5) == set(b2) and sum(b5.values()) == 1,
                    f"B5 bf16 ran {b5}, its B2 launches {b2}")
            require(bool(torch.isfinite(traj).all() and (traj[1:] <= traj[:-1]).all()),
                    "B5 bf16 best-ever trajectory")
        kw = self.kw_b2(bench)
        seeds = [kernel_seed(SEED, 1900 + g) for g in range(EVOLVE_PLAIN_GENERATIONS)]
        out = ev.fused_evolve(seeds, *args(bench), **kw)
        torch.cuda.synchronize()
        plain = ev.fused_evolve_plain(seeds, *args(bench), **kw)
        e_pf, e_tr = rel_err(out[2], plain[2]), rel_err(out[5], plain[5])
        log(f"B5 bf16 vs plain (bench config, {len(seeds)} generations): parent fitness max rel "
            f"{float(e_pf.max()):.3e} median rel {float(e_pf.median()):.3e}, best-ever max rel "
            f"{float(e_tr.max()):.3e} (tolerance {FIT_MAX_REL:g} / {FIT_MEDIAN_REL:g})")
        require(float(e_pf.max()) <= FIT_MAX_REL and float(e_pf.median()) <= FIT_MEDIAN_REL
                and float(e_tr.max()) <= FIT_MAX_REL, "B5 bf16 disagrees with its plain version")
        self.kernels["fused_evolve_bf16"] = {"max_abs_err": float((out[2] - plain[2]).abs().max())}
        cfg = bench["cfg"].replace(fused_evolve=True)
        so, target = bench["so"], bench["target"]
        require(_fused_evolve_ok(cfg, so, self.dev), "bf16 fused_evolve does not route to B5")
        evolve(init_state(1, cfg, device=self.dev), target, 2, so, cfg)  # warm-up
        state = init_state(7, cfg, device=self.dev)
        torch.cuda.synchronize()
        self.reset_counts()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        final, traj = evolve(state, target, GENERATIONS, so, cfg, record_trajectory=True)
        b.record()
        b.synchronize()
        counts, by = self.read_counts(), self.launches_by()
        ms = a.elapsed_time(b) / GENERATIONS
        traj = traj.cpu()
        log(f"evolve (bf16, fused_evolve -> B5, bench config): {GENERATIONS} generations "
            f"{ms:.4f} ms/gen, {POP / (ms / 1e3):.4g} candidate-evals/s {card()}; best fitness "
            f"first {float(traj[0]):.6g} final {float(traj[-1]):.6g}; launches {counts}, by mode "
            f"{by.get('fused_evolve')}")
        require(counts["fused_evolve"] == 1 and sum(counts.values()) == 1
                and by.get("fused_evolve", {}).get("bf16") == 1,
                "bf16 fused_evolve did not run as exactly one bf16 B5 launch")
        require(bool(torch.isfinite(traj).all() and (traj[1:] <= traj[:-1]).all()), "trajectory")
        require(float(traj[-1]) < float(traj[0]), "evolve did not improve the best fitness")
        self.kernels["fused_evolve_bf16"]["launches"] = by["fused_evolve"]["bf16"]
        self.cell_ms["bf16_fused_evolve"] = ms

    # -- 28 -----------------------------------------------------------------
    def suite(self):
        """The operand disk cache at 2^CACHE_LOG2N, int8 and bf16 (a build that
        writes the file, then a load of it), then ``bench_suite.main`` over
        SUITE_SUITES with SUITE_ARGS and the cache, on the card: each row
        printed beside the card; then the suite's runner at fm8_series (B1,
        then B2), a chain the bf16 rule keeps one-warp; the bf16 B1/B2
        launches of both counted by layout."""
        import csv
        import shutil
        from pathlib import Path

        from pmfm_tpu_torch import bench_suite
        from pmfm_tpu_torch.ops import spectral

        work = Path(SUITE_DIR)
        shutil.rmtree(work, ignore_errors=True)
        cache = work / "operand_cache"
        n = 1 << CACHE_LOG2N
        for dtype in ("int8", "bfloat16"):
            times = []
            ops = []
            for _ in range(2):
                t0 = time.perf_counter()
                ops.append(spectral.make_spectrum_ops(n, dft_dtype=dtype, cache_dir=str(cache),
                                                      device=self.dev))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            same = all(torch.equal(getattr(ops[0], f).view(torch.int8),
                                   getattr(ops[1], f).view(torch.int8))
                       for f in ("dft_cos", "dft_sin", "dft_packed"))
            files = sorted(p.name for p in cache.glob("*.npz"))
            log(f"operand cache, n={n} {dtype}: build (writes the file) {times[0]:.2f} s, load "
                f"{times[1]:.2f} s; operands bit-equal {same}; files {files}")
            require(same and times[1] < times[0], f"operand cache ({dtype})")
        self.reset_counts()
        t0 = time.perf_counter()
        rows = []
        for name in SUITE_SUITES:
            argv = ["--suite", name, *SUITE_ARGS, "--operand-cache", str(cache),
                    "--csv", str(work / f"suite_{name}.csv")]
            require(bench_suite.main(argv) == 0, f"bench_suite {name}")
            with open(work / f"suite_{name}.csv", newline="") as f:
                # the reference's CSV does not quote: a row name may hold
                # commas ("..._65536[synth_stream,pop=2^13]"), the last 8
                # fields are numbers
                got = [[",".join(r[:-8]), *r[-8:]] for r in csv.reader(f)]
            rows += got[1 if rows else 0:]
        seconds = time.perf_counter() - t0
        by = self.launches_by()
        for row in rows[1:]:
            log(f"suite row {row[0]}: total {float(row[1]):.3f} ms, population {row[7]}, "
                f"generations {row[8]} {card()}")
        log(f"bench_suite --suite {','.join(SUITE_SUITES)} {' '.join(SUITE_ARGS)}: "
            f"{len(rows) - 1} rows in {seconds:.1f}s; launches by mode {by} {card()}")
        require(tuple(rows[0])[:2] == ("Test_Name", "Total_Time") and len(rows) > 1, "suite CSV")
        require(all(float(row[1]) > 0.0 for row in rows[1:]), "suite row without a time")
        b1 = by.get("fused_synth_fitness", {}).get("bf16", 0)
        b2 = by.get("fused_generation", {}).get("bf16", 0)
        require(b1 > 0 and b2 > 0, "the suite did not run B1 and B2 in bf16")
        # the suite's shapes take the bf16 time-parallel layout; the one-warp
        # kernels run where the rule keeps them: a long chain on a full grid,
        # the suite's own runner at fm8_series with B1, then with B2
        from pmfm_tpu_torch.kernels import generation as gn
        from pmfm_tpu_torch.kernels import synth_fitness as sf

        args = bench_suite.parse_args(list(SUITE_ARGS))
        args.device = self.dev
        chain = dict(topology="fm8_series", num_dimensions=16, param_mins=(0.0,) * 16,
                     param_maxs=(3520.0, 8.0) * 8)
        for over in ({}, {"fused_generation": True}):
            cfg = bench_suite._base_cfg(args, **chain, **over)
            bench_suite._make_runner(cfg, args.gens, device=self.dev)()
        torch.cuda.synchronize()
        # each bf16 launch by layout (generation.layout_key): the one-warp kernel
        # (fused_bf16.cu) or the time-parallel one (fused_tp_bf16.cuh)
        for name, fn in (("fused_synth_fitness_bf16", sf.fused_synth_fitness),
                         ("fused_generation_bf16", gn.fused_generation)):
            layouts = {x: v for x, v in fn.launches_by_layout.items() if x.startswith("bf16_")}
            log(f"bench_suite and fm8_series: {name} launches by layout {layouts}")
            require(layouts.get("bf16_one_warp", 0) > 0 and layouts.get("bf16_time_parallel", 0),
                    f"{name}: the launches by layout {layouts}")
            self.kernels.setdefault(name, {})["launches"] = layouts["bf16_one_warp"]
            self.kernels.setdefault(name + "_tp", {})["launches"] = layouts["bf16_time_parallel"]

    # -- 29 -----------------------------------------------------------------
    def bf16_timings(self):
        """B1/B2/B5 bf16 at the bench shape, B1/B2 in the one-warp layout
        (phase 47 times the time-parallel one), B5 in the layout its wrapper
        takes (B2's, the time-parallel one there), beside their plain versions and
        their bound (bytes at 3.35 TB/s; the DFT's operations at the dense
        bf16 peak and the synthesis's at the f32 peak), and the DFT half's
        yardstick: bf16 ``torch.mm`` with float32 output, U and V of
        candidate-major a+/- against the operand's halves (the port never
        calls it)."""
        from pmfm_tpu_torch.es import kernel_seed
        from pmfm_tpu_torch.kernels import evolve as ev
        from pmfm_tpu_torch.kernels import generation as gn
        from pmfm_tpu_torch.kernels import synth_fitness as sf

        c = self.bf16["bench shape"]
        n, k, g = c["cfg"].n_samples, c["so"].num_bins, BF16_B5_GENERATIONS
        operand = 2 * k * (n // 2) * 2
        dft_ops = 2.0 * 2 * k * (n // 2) * POP
        synth = synth_ops_f32(POP, n, k, kn=3, ncoef=4)
        offspring = POP * D * 12 * 2.0
        io = operand + k * 4 + POP * 4
        kw1, kw2 = self.kw_b1(c), self.kw_b2(c)
        seed = kernel_seed(SEED, 2000)
        seeds = [kernel_seed(SEED, 2001 + i) for i in range(g)]
        best = torch.tensor(float("inf"), device=self.dev)
        pv, ps, tgt = c["pv"], c["ps"], c["target"]
        rows = {
            "fused_synth_fitness_bf16": (
                lambda: sf.fused_synth_fitness(c["params"], tgt, **kw1),
                lambda: sf.fused_synth_fitness_plain(c["params"], tgt, **kw1),
                io + POP * D * 4, dft_ops, synth, 1, "pmfm_tpu_torch/csrc/fused_bf16.cu",
                "pmfm_tpu/kernels/synth_fitness.py:767"),
            "fused_generation_bf16": (
                lambda: gn.fused_generation(seed, pv, ps, tgt, **kw2),
                lambda: gn.fused_generation_plain(seed, pv, ps, tgt, **kw2),
                io + 2 * MU * D * 4 + 2 * POP * D * 4, dft_ops, synth + offspring, 1,
                "pmfm_tpu_torch/csrc/fused_bf16.cu", "pmfm_tpu/kernels/generation.py:438"),
            "fused_evolve_bf16": (
                lambda: ev.fused_evolve(seeds, pv, ps, pv[0], best, tgt, **kw2),
                lambda: ev.fused_evolve_plain(seeds, pv, ps, pv[0], best, tgt, **kw2),
                4 * MU * D * 4 + 2 * (D + 1) * 4 + operand + k * 4 + g * 4, g * dft_ops,
                g * (synth + offspring), g, "pmfm_tpu_torch/csrc/evolve.cu",
                "pmfm_tpu/kernels/evolve.py:366"),
        }
        for name, (fn, plain, nbytes, bops, fops, gens, src, replaces) in rows.items():
            if gens > 1:  # B5 in the layout its wrapper takes, as a user's run takes it
                ms = cuda_ms(fn, 5)
                layout = b5_layout_taken(ev, fn)
                self.kernels.setdefault(name, {})["layout"] = layout
                per = f", {ms / gens:.4f} ms a generation (B2's {layout} layout)"
            else:
                with gen_layout(gn, False):  # B1/B2's rule takes phase 47's layout here
                    ms = cuda_ms(fn, TIMED_LAUNCHES)
                per = ""
            plain_ms = cuda_ms(plain, 1 if gens > 1 else PLAIN_RUNS)
            bound_ms, by = bound(nbytes, 0.0, fops, bops)
            log(f"{name} (n={n}, K={k}, P={POP}, fm3_series, sine order 7): kernel {ms:.4f} ms"
                f"{per}, plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms by {by} "
                f"({nbytes / 1e6:.2f} MB, {bops / 1e9:.1f} G bf16 ops, {fops / 1e9:.2f} G f32 "
                f"ops); {ms / bound_ms:.1f}x the bound {card()}")
            self.kernels.setdefault(name, {}).update(
                route="cuda", source=src, replaces=replaces, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, library_ms=None)
        gen = torch.Generator(device=self.dev).manual_seed(SEED)
        ap, am = (torch.randn((POP, n // 2), generator=gen, device=self.dev).to(torch.bfloat16)
                  for _ in range(2))
        op = c["so"].dft_packed
        cos_t, sin_t = op[:k].T, op[k:].T
        mm_ms = cuda_ms(lambda: (torch.mm(ap, cos_t, out_dtype=torch.float32),
                                 torch.mm(am, sin_t, out_dtype=torch.float32)), TIMED_LAUNCHES)
        b1_ms = self.kernels["fused_synth_fitness_bf16"]["ms"]
        log(f"B1 bf16 split (n={n}, K={k}, P={POP}): B1 {b1_ms:.4f} ms; yardstick bf16 torch.mm "
            f"U+V (float32 out) on candidate-major a+/- {mm_ms:.4f} ms "
            f"({dft_ops / (mm_ms * 1e-3) / 1e12:.1f} bf16 TFLOP/s); int8 B1 at the same shape "
            f"{self.kernels.get('fused_synth_fitness', {}).get('ms', float('nan')):.4f} ms "
            f"{card()}")

    # -- 30 -----------------------------------------------------------------
    def bank_large(self):
        """B3 and B4 on fm{k}_parallel banks and on a wide chain, bit-equal to
        their plain versions: B3 over BANK_FOLD_GRID (int8 and bf16, both
        layouts), B4 over BANK_STREAM_GRID (bf16 and f32), at each of
        LARGE_GRID_POPS."""
        self.fold_grid(BANK_FOLD_GRID)
        self.stream_grid(BANK_STREAM_GRID)
        for name in ("fused_synth_fold_parallel", "fused_synth_stream_parallel"):
            self.kernels.setdefault(name, {})["max_abs_err"] = 0.0  # bit-equal, or it raised

    # -- 31 -----------------------------------------------------------------
    def bank_b5(self):
        """B5 on fm3_parallel (PARALLEL_CONFIG's shape) in int8, bf16 and f32,
        for each of B5_BANK_SETTINGS (one run or four, one frame or eight):
        one call bit-equal to B5_BANK_GENERATIONS launches of B2's bank
        kernel with the stable selection (``fused_evolve_plain`` given the B2
        wrapper)."""
        from pmfm_tpu_torch.es import kernel_seed, make_spectrum_ops
        from pmfm_tpu_torch.io import load_config
        from pmfm_tpu_torch.kernels import evolve as ev
        from pmfm_tpu_torch.kernels import generation as gn

        base = load_config(PARALLEL_CONFIG).es
        g = B5_BANK_GENERATIONS
        for mode, cfg in (("int8", base), ("bf16", base.replace(dft_dtype="bfloat16")),
                          ("f32", base.refine_config())):
            so = make_spectrum_ops(cfg, device=self.dev)
            pop, mu, d = cfg.population_size, cfg.num_parents, cfg.num_dimensions
            for runs, frames in B5_BANK_SETTINGS:
                t0 = time.perf_counter()
                rng = np.random.default_rng(SEED + 3000 + frames + (runs or 0))
                lead = () if runs is None else (runs,)
                t = lambda a: torch.from_numpy(a.astype(np.float32)).to(self.dev)  # noqa: E731
                pv, ps = t(rng.random(lead + (mu, d))), t(rng.uniform(0.02, 0.3, lead + (mu, d)))
                tgt = t(rng.uniform(0.0, 50.0, lead + (frames, so.num_bins)))
                kw = dict(self.kw_b2(dict(cfg=cfg, so=so)), num_frames=frames)
                if runs is None:
                    seeds = [kernel_seed(SEED + 3100, i) for i in range(g)]
                    best = (pv[0].clone(), torch.tensor(float("inf"), device=self.dev))
                else:
                    seeds = [[kernel_seed(SEED + 3100 + r, i) for i in range(g)]
                             for r in range(runs)]
                    best = (pv[:, 0].clone(), torch.full((runs,), float("inf"), device=self.dev))
                args = (pv, ps, *best, tgt)
                before = ev.fused_evolve.launches
                out = ev.fused_evolve(seeds, *args, **kw)
                require(ev.fused_evolve.launches == before + 1, "B5 is not one launch")
                loop = ev.fused_evolve_plain(seeds, *args, generation=gn.fused_generation, **kw)
                same = all(bits_equal(a, b) for a, b in zip(out, loop))
                log(f"B5 bank ({mode}, {cfg.topology}, n={cfg.n_samples}, P={pop}, mu={mu}, "
                    f"runs {runs or 1}, F {frames}): {g} generations in one call bit-equal to {g} "
                    f"B2 launches + the stable selection: {same} "
                    f"({time.perf_counter() - t0:.1f}s)")
                require(same, f"B5 on a bank differs from its B2 launches ({mode}, runs {runs}, "
                              f"F {frames})")
                require(bool(torch.isfinite(out[5]).all()), "B5 trajectory not finite")
                if mode == "int8" and runs is None and frames == 1:
                    self.kernels.setdefault("fused_evolve_parallel", {})["max_abs_err"] = 0.0

    # -- 32 -----------------------------------------------------------------
    def wide_kernels(self):
        """B1/B2 at 20-32 genes (each of WIDE_TRUTHS) against their plain
        versions at PARALLEL_CONFIG's shape in int8, bf16 (the int8 limits)
        and f32, the truth planted first: B2's values bit-equal and its
        fitness bit-equal to B1's on its own offspring."""
        from pmfm_tpu_torch.es import kernel_seed
        from pmfm_tpu_torch.io import load_config
        from pmfm_tpu_torch.ops.synthesis import topology_dims

        base = load_config(PARALLEL_CONFIG).es
        limits = {"int8": (FIT_MAX_REL, FIT_MEDIAN_REL), "bf16": (FIT_MAX_REL, FIT_MEDIAN_REL),
                  "f32": (F32_FIT_MAX_REL, F32_FIT_MEDIAN_REL)}
        self.wide = {}
        for i, (topology, truth) in enumerate(WIDE_TRUTHS.items()):
            d = topology_dims(topology)
            top = base.replace(topology=topology, num_dimensions=d, param_mins=(0.0,) * d,
                               param_maxs=param_maxs(topology))
            for j, (mode, cfg) in enumerate((("int8", top),
                                             ("bf16", top.replace(dft_dtype="bfloat16")),
                                             ("f32", top.refine_config()))):
                t0 = time.perf_counter()
                c = self.inputs(cfg, SEED + 3200 + 3 * i + j, truth)
                self.wide[topology, mode] = c
                where = (f"{mode}, {topology}, n={cfg.n_samples}, P={cfg.population_size}, "
                         f"sine order {cfg.sine_order}")
                e1, e2, fk, a1, a2 = self.fused_check(
                    where, c["params"], c["pv"], c["ps"], c["target"], self.kw_b1(c),
                    self.kw_b2(c), kernel_seed(SEED, 3200 + 3 * i + j), limits[mode])
                rank = int(torch.argmin(fk))
                log(f"B1/B2 wide {where}: fitness max rel B1 {e1:.3e} B2 {e2:.3e} (limits "
                    f"{limits[mode][0]:g} / {limits[mode][1]:g}), median {self.last_median[0]:.3e}"
                    f" / {self.last_median[1]:.3e}; B2 values bit-equal, B2 fitness bit-equal "
                    f"to B1 on its offspring; truth rank {rank} ({time.perf_counter() - t0:.1f}s)")
                require(rank == 0, f"{where}: the known-params truth does not rank first")
                if topology == "fm5_parallel" and mode == "int8":
                    self.kernels["fused_synth_fitness_wide"] = {"max_abs_err": a1}
                    self.kernels["fused_generation_wide"] = {"max_abs_err": a2}

    # -- 33 -----------------------------------------------------------------
    def bank_paths(self):
        """The paths that run the new modes, each through its entry point:
        the fm5_parallel pursuit through ``cli.main`` (FM5_BASE_CONFIG with a
        fifth pair, cut as phase 21 cuts), whose polishes run B2 int8 at
        D 20; ``evolve`` on fm3_parallel with fused_evolve (one B5 call) in
        int8 and f32; ``evolve`` on fm3_parallel through synth_fold (n 8192,
        P 2^15) and synth_stream (n 65536, P 2^13), each route named by
        ``active_engine``."""
        import os
        import shutil

        import pmfm_tpu_torch.io
        from pmfm_tpu_torch.kernels import generation as gn

        root = os.getcwd()
        work = os.path.join(root, PURSUIT_DIR)
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        try:
            path = os.path.join(work, "fm5_parallel_match.json")
            with open(path, "w") as f:
                json.dump(fm5_parallel_config(root), f)
            code, counts, modes, lines = self.pursuit_cli(
                path, work, pursuit_cut(pmfm_tpu_torch.io.load_config), False)
            layouts = dict(gn.fused_generation.launches_by_layout)
            log(f"fm5_parallel pursuit: B2 int8 launches by layout {layouts}")
            require(code == 0 and lines, f"fm5_parallel pursuit: exit {code}")
            require(modes["B2"].get("parallel_int8", 0) > 0 and modes["B1"].get(
                "parallel_int8", 0) > 0, f"fm5_parallel pursuit: B1/B2 int8 did not run: {modes}")
            # B2 int8 ran in one layout, the one phase 34 times (b2_layout)
            require(len(layouts) == 1 and sum(layouts.values()) == modes["B2"]["parallel_int8"],
                    f"fm5_parallel pursuit: B2 int8 launches by layout {layouts}")
            self.kernels.setdefault("fused_generation_wide", {})["launches"] = \
                modes["B2"]["parallel_int8"]
            self.kernels.setdefault("fused_synth_fitness_wide", {})["launches"] = \
                modes["B1"]["parallel_int8"]
        finally:
            shutil.rmtree(work, ignore_errors=True)
        self.bank_evolve_fused()
        self.bank_evolve_large()

    def bank_evolve_fused(self):
        """``evolve`` on fm3_parallel with fused_evolve at PARALLEL_CONFIG's
        shape, int8 and f32: one B5 launch for BANK_EVOLVE_GENERATIONS
        generations, the trajectory improving."""
        from pmfm_tpu_torch.es import evolve, init_state, make_spectrum_ops
        from pmfm_tpu_torch.es.pipeline import _fused_evolve_ok
        from pmfm_tpu_torch.io import load_config
        from pmfm_tpu_torch.kernels import evolve as ev
        from pmfm_tpu_torch.ops import synthesize_single, target_spectrum

        base = load_config(PARALLEL_CONFIG).es.replace(fused_evolve=True, restart_patience=0,
                                                       fitness_threshold=0.0)
        g = BANK_EVOLVE_GENERATIONS
        for mode, cfg in (("int8", base), ("f32", base.refine_config().replace(fused_evolve=True))):
            so = make_spectrum_ops(cfg, device=self.dev)
            require(_fused_evolve_ok(cfg, so, self.dev), f"{mode}: fused_evolve does not route "
                                                         f"to B5")
            audio = synthesize_single(torch.tensor(PARALLEL_TRUTH[: cfg.num_dimensions]),
                                      cfg.n_samples, cfg.topology)
            target = target_spectrum(audio.to(self.dev), so)
            torch.cuda.synchronize()
            self.reset_counts()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            final, traj = evolve(init_state(7, cfg, device=self.dev), target, g, so, cfg,
                                 record_trajectory=True)
            b.record()
            b.synchronize()
            counts = {k: v for k, v in self.read_counts().items() if v}
            by = dict(ev.fused_evolve.launches_by)
            traj = traj.cpu()
            log(f"evolve ({cfg.topology}, fused_evolve -> B5, {mode}, n={cfg.n_samples}, "
                f"P={cfg.population_size}): {g} generations {a.elapsed_time(b) / g:.4f} ms/gen "
                f"{card()}; best fitness first {float(traj[0]):.6g} final {float(traj[-1]):.6g}; "
                f"launches {counts}, B5 by mode {by}")
            require(counts == {"fused_evolve": 1} and by == {f"parallel_{mode}": 1},
                    "fused_evolve on a bank did not run as exactly one B5 launch")
            require(bool(torch.isfinite(traj).all() and (traj[1:] <= traj[:-1]).all()),
                    "trajectory")
            require(float(traj[-1]) < float(traj[0]), "evolve did not improve the best fitness")
            if mode == "int8":
                self.kernels.setdefault("fused_evolve_parallel", {})["launches"] = 1

    def bank_evolve_large(self):
        """``evolve`` on fm3_parallel at cell (c)'s shape (n 8192, P 2^15,
        int8: synth_fold, B3 + the prefolded DFT) and cell (d)'s (n 65536,
        P 2^13, bf16: synth_stream, B4 + the factored DFT), with
        PARALLEL_TRUTH's first three pairs as the target:
        BANK_LARGE_GENERATIONS generations, one kernel launch each and none
        of another kernel."""
        from pmfm_tpu_torch.es import active_engine, evolve, init_state, make_spectrum_ops
        from pmfm_tpu_torch.ops import synthesize_single, target_spectrum

        g = BANK_LARGE_GENERATIONS
        for key, label, pop, kernel, engine in (
                ("fold", "c", FOLD_POP, "fused_synth_fold", "synth_fold"),
                ("stream", "d", STREAM_POP, "fused_synth_stream", "synth_stream")):
            cell = self.cells[key]["cfg"]
            cfg = cell.replace(topology="fm3_parallel", num_dimensions=12,
                               param_mins=(0.0,) * 12, param_maxs=param_maxs("fm3_parallel"))
            t0 = time.perf_counter()
            so = self.cells[key]["so"]  # the cell's operands: they depend on n, not on the model
            require(active_engine(cfg, so) == engine, f"fm3_parallel at cell ({label})'s shape "
                    f"routes to {active_engine(cfg, so)}, not {engine}")
            audio = synthesize_single(torch.tensor(PARALLEL_TRUTH[:12]), cfg.n_samples,
                                      cfg.topology, engine="scanless")
            target = target_spectrum(audio.to(self.dev), so)
            evolve(init_state(1, cfg, device=self.dev), target, 1, so, cfg)  # warm-up
            torch.cuda.synchronize()
            self.reset_counts()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            final, traj = evolve(init_state(7, cfg, device=self.dev), target, g, so, cfg,
                                 record_trajectory=True)
            b.record()
            b.synchronize()
            counts = {k: v for k, v in self.read_counts().items() if v}
            traj = traj.cpu()
            log(f"evolve (fm3_parallel at cell ({label})'s shape: {engine}, n={cfg.n_samples}, "
                f"P={pop}): {g} generations {a.elapsed_time(b) / g:.4f} ms/gen {card()}; best "
                f"fitness first {float(traj[0]):.6g} final {float(traj[-1]):.6g}; launches "
                f"{counts} ({time.perf_counter() - t0:.1f}s with the target)")
            require(counts == {kernel: g}, f"{kernel} launches != generations, or another kernel")
            require(bool(torch.isfinite(traj).all() and (traj[1:] <= traj[:-1]).all()),
                    "trajectory")
            self.kernels.setdefault(f"{kernel}_parallel", {})["launches"] = g

    # -- 34 -----------------------------------------------------------------
    def bank_timings(self):
        """The new modes' times beside their plain versions and bounds: B3 on
        fm3_parallel at cell (c)'s shape (int8), B4 at cell (d)'s (bf16), B5
        on fm3_parallel at PARALLEL_CONFIG's shape (int8, B5_BANK_GENERATIONS
        generations), B1/B2 int8 at fm5_parallel there (beside fm4_parallel:
        the compile-time bank of five against four) and at the wide codes
        (fm8_parallel, fm16_series); then B3's two layouts on the banks over
        BANK_LAYOUT_SHAPES x FOLD_LAYOUT_POPS."""
        from pmfm_tpu_torch.es import kernel_seed
        from pmfm_tpu_torch.io import load_config
        from pmfm_tpu_torch.kernels import evolve as ev
        from pmfm_tpu_torch.kernels import generation as gn
        from pmfm_tpu_torch.kernels import synth_fitness as sf
        from pmfm_tpu_torch.kernels import synth_fold as sfo
        from pmfm_tpu_torch.kernels import synth_stream as sst
        from pmfm_tpu_torch.ops.synthesis import topology_dims

        rows = {}
        # B3 / B4 on fm3_parallel: the synthesis ops (bank_ops_f32 without bins)
        for key, name in (("fold", "fused_synth_fold_parallel"),
                          ("stream", "fused_synth_stream_parallel")):
            c = self.cells[key]
            cfg, so = c["cfg"], c["so"]
            n, pop = cfg.n_samples, cfg.population_size
            params = self.grid_params("fm3_parallel", pop, SEED + 3400)
            ops = bank_ops_f32(pop, n, 0, 3, ncoef=4 if cfg.sine_order == 7 else 5)
            if key == "fold":
                kw = dict(topology="fm3_parallel", n=n, sine_order=cfg.sine_order,
                          dft_scale=so.dft_packed_scale)
                fn = lambda p=params, kw=kw: sfo.fused_synth_fold(p, **kw)  # noqa: E731
                plain = lambda p=params, kw=kw: sfo.fused_synth_fold_plain(  # noqa: E731
                    p, pop_block=pop, **kw)
                nbytes = pop * 12 * 4 + 2 * pop * (n // 2) + 2 * pop * 4
                src, rep = ("pmfm_tpu_torch/csrc/large_frame_wide.cu",
                            "pmfm_tpu/kernels/synth_fold.py:176")
            else:
                kw = dict(topology="fm3_parallel", n=n, sine_order=cfg.sine_order)
                fn = lambda p=params, kw=kw: sst.fused_synth_stream(  # noqa: E731
                    p, so.window, **kw)
                plain = lambda p=params, kw=kw: sst.fused_synth_stream_plain(  # noqa: E731
                    p, so.window, pop_block=pop, **kw)
                nbytes = pop * 12 * 4 + n * 4 + 2 * n * pop
                ops += float(pop) * n * 2  # the amplitude and the window
                src, rep = ("pmfm_tpu_torch/csrc/large_frame_wide.cu",
                            "pmfm_tpu/kernels/synth_stream.py:161")
            rows[name] = (fn, plain, nbytes, 0.0, ops, 1, src, rep,
                          f"fm3_parallel, n={n}, P={pop}, sine order {cfg.sine_order}")
        # B5 and B1/B2 at PARALLEL_CONFIG's shape (int8)
        c5 = self.wide["fm5_parallel", "int8"]
        cfg = c5["cfg"]
        n, pop, mu, k = cfg.n_samples, cfg.population_size, cfg.num_parents, c5["so"].num_bins
        dft_ops = 2.0 * 2 * k * (n // 2) * pop
        operand, io = 2 * k * (n // 2), 2 * k * (n // 2) + k * 4 + pop * 4
        par = self.inputs(load_config(PARALLEL_CONFIG).es, SEED + 3450, PARALLEL_TRUTH[:12])
        g = B5_BANK_GENERATIONS
        seeds = [kernel_seed(SEED + 3500, i) for i in range(g)]
        kw3 = self.kw_b2(par)
        best = torch.tensor(float("inf"), device=self.dev)
        synth3 = bank_ops_f32(pop, n, k, 3, ncoef=5) + pop * 12 * 12 * 2.0
        rows["fused_evolve_parallel"] = (
            lambda: ev.fused_evolve(seeds, par["pv"], par["ps"], par["pv"][0], best,
                                    par["target"], **kw3),
            lambda: ev.fused_evolve_plain(seeds, par["pv"], par["ps"], par["pv"][0], best,
                                          par["target"], **kw3),
            4 * mu * 12 * 4 + 2 * 13 * 4 + operand + k * 4 + g * 4, g * dft_ops, g * synth3, g,
            "pmfm_tpu_torch/csrc/evolve.cu", "pmfm_tpu/kernels/evolve.py:366",
            f"fm3_parallel, n={n}, P={pop}, mu={mu}")
        seed = kernel_seed(SEED, 3600)
        synth5 = bank_ops_f32(pop, n, k, 5, ncoef=5)
        kw1, kw2 = self.kw_b1(c5), self.kw_b2(c5)
        rows["fused_synth_fitness_wide"] = (
            lambda: sf.fused_synth_fitness(c5["params"], c5["target"], **kw1),
            lambda: sf.fused_synth_fitness_plain(c5["params"], c5["target"], **kw1),
            io + pop * 20 * 4, dft_ops, synth5, 1,
            b2_source(b2_layout(gn, kw2, k, 20), "fm5_parallel"),
            "pmfm_tpu/kernels/synth_fitness.py:767", f"fm5_parallel, n={n}, P={pop}")
        rows["fused_generation_wide"] = (
            lambda: gn.fused_generation(seed, c5["pv"], c5["ps"], c5["target"], **kw2),
            lambda: gn.fused_generation_plain(seed, c5["pv"], c5["ps"], c5["target"], **kw2),
            io + 2 * mu * 20 * 4 + 2 * pop * 20 * 4, dft_ops, synth5 + pop * 20 * 12 * 2.0, 1,
            b2_source(b2_layout(gn, kw2, k, 20), "fm5_parallel"),
            "pmfm_tpu/kernels/generation.py:438",
            f"fm5_parallel, n={n}, P={pop}")
        for name, (fn, plain, nbytes, i8, f32, gens, src, rep, where) in rows.items():
            ms = cuda_ms(fn, TIMED_LAUNCHES if gens == 1 else 5)
            plain_ms = cuda_ms(plain, 1)
            bound_ms, by = bound(nbytes, i8, f32)
            per = f", {ms / gens:.4f} ms a generation" if gens > 1 else ""
            if gens > 1:
                layout = b5_layout_taken(ev, fn)
                self.kernels.setdefault(name, {})["layout"] = layout
                per += f" (B2's {layout} layout)"
            log(f"{name} ({where}): kernel {ms:.4f} ms{per}, plain {plain_ms:.2f} ms, bound "
                f"{bound_ms:.4f} ms by {by} ({nbytes / 1e6:.2f} MB, {i8 / 1e9:.1f} G int8 ops, "
                f"{f32 / 1e9:.2f} G f32 ops); {ms / bound_ms:.1f}x the bound {card()}")
            self.kernels.setdefault(name, {}).update(
                route="cuda", source=src, replaces=rep, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, library_ms=None)
        # B1/B2 int8 at each bank and wide code, at the same P, n, sine order
        line = []
        for topology in ("fm4_parallel", "fm5_parallel", "fm8_parallel", "fm16_series",
                         "fm3_series"):
            td, maxs = topology_dims(topology), param_maxs(topology)
            params = self.grid_params(topology, pop, SEED + 3700)
            rng = np.random.default_rng(SEED + 3701)
            t = lambda a: torch.from_numpy(a.astype(np.float32)).to(self.dev)  # noqa: E731
            pv, ps = t(rng.random((mu, td))), t(rng.uniform(0.02, 0.3, (mu, td)))
            k1 = dict(kw1, topology=topology)
            k2 = dict(kw2, topology=topology, param_mins=(0.0,) * td, param_maxs=maxs,
                      beta_scale=1.0 / td)
            b1 = cuda_ms(lambda: sf.fused_synth_fitness(params, c5["target"], **k1),
                         TIMED_LAUNCHES)
            b2 = cuda_ms(lambda: gn.fused_generation(seed, pv, ps, c5["target"], **k2),
                         TIMED_LAUNCHES)
            line.append(f"{topology} B1 {b1:.4f} ms B2 {b2:.4f} ms")
            if topology == "fm4_parallel":
                b2_fm4 = b2
            if topology == "fm5_parallel":
                b2_fm5 = b2
        log(f"B1/B2 int8 at n={n}, K={k}, P={pop}, sine order {cfg.sine_order}: "
            f"{'; '.join(line)}; fm5_parallel's B2 {b2_fm5 / b2_fm4:.3f}x fm4_parallel's {card()}")
        self.fold_layouts(BANK_LAYOUT_SHAPES, BANK_LAYOUT_LAUNCHES)

    # -- 35 -----------------------------------------------------------------
    def fm5_pursuit(self):
        """The fm5_parallel pursuit through ``cli.main`` as written
        (FM5_BASE_CONFIG with a fifth pair): exit 0, every chunk's f32
        fitness no worse than its silent estimate, the first chunk below
        FM5_TARGET_REL; its seconds, attempts and each chunk's relative
        spectral error beside the true parameters' own."""
        import os
        import shutil

        import pmfm_tpu_torch.io

        root = os.getcwd()
        work = os.path.join(root, PURSUIT_DIR)
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        try:
            path = os.path.join(work, "fm5_parallel_match.json")
            with open(path, "w") as f:
                json.dump(fm5_parallel_config(root), f)
            code, _, modes, lines = self.pursuit_cli(path, work, pmfm_tpu_torch.io.load_config,
                                                     True, FM5_TARGET_REL)
            require(code == 0 and lines, f"fm5_parallel pursuit: exit {code}")
            require(modes["B2"].get("parallel_int8", 0) > 0, "B2 int8 did not run")
        finally:
            shutil.rmtree(work, ignore_errors=True)


    # -- 41 -----------------------------------------------------------------
    def long_codes(self):
        """Topologies above 32 genes (the long synthesis code, csrc
        synth_common.cuh::LongSynth) in every kernel: the long code bit-equal
        to the fixed and wide codes where both run (``long_same``); B1/B2 in
        each mode against their plain versions (``long_b1_b2``), B5 against
        its B2 launches, B3 and B4 against their plain versions
        (``long_large``), the scan kernel and the unfused engines past 32
        (``long_scan``); the paths through ``evolve`` and ``cli.main``
        (``long_paths``); the new instantiations' times (``long_times``)."""
        self.long, self.long_plain_ms = {}, {}
        self.long_same()
        self.long_b1_b2()
        self.long_large()
        self.long_scan()
        self.long_paths()
        self.long_times()

    def long_config(self, topology, log2n=LOG2N):
        """The bench config (P 2^15, mu 256, int8, sine order 7) at
        ``topology``, its genes' ranges ``param_maxs``."""
        from pmfm_tpu_torch.ops.synthesis import topology_dims

        d = topology_dims(topology)
        return self.cfg.replace(topology=topology, num_dimensions=d, param_mins=(0.0,) * d,
                                param_maxs=param_maxs(topology), audio_length_log2=log2n)

    def long_same(self):
        """The long code bit-equal to the fixed and wide codes: with
        LONG_ABOVE_GENES lowered to LONG_SAME_ABOVE, B1/B2 (int8, bf16, f32),
        B3 (int8, bf16) and B4 (bf16, f32) at each of LONG_SAME take the long
        code, and every output is the one the fixed or wide code gives."""
        from pmfm_tpu_torch.es import kernel_seed
        from pmfm_tpu_torch.kernels import generation as gn
        from pmfm_tpu_torch.kernels import synth_fitness as sf
        from pmfm_tpu_torch.kernels import synth_fold as sfo
        from pmfm_tpu_torch.kernels import synth_stream as sst
        from pmfm_tpu_torch.ops import spectral

        t0 = time.perf_counter()
        window = spectral.make_spectrum_ops(LONG_SAME_STREAM_N, None, method="dft_factored",
                                            device=self.dev).window
        checked = 0
        for i, topology in enumerate(LONG_SAME):
            cfg = self.long_config(topology)
            d = cfg.num_dimensions
            params = self.grid_params(topology, LONG_SAME_POP, SEED + 4100 + i)
            rng = np.random.default_rng(SEED + 4110 + i)
            pv = torch.from_numpy(rng.random((MU, d)).astype(np.float32)).to(self.dev)
            ps = torch.from_numpy(rng.uniform(0.02, 0.3, (MU, d)).astype(np.float32)).to(self.dev)
            runs = []
            for dtype in ("int8", "bfloat16", "float32"):
                so = spectral.make_spectrum_ops(cfg.n_samples, None, dft_dtype=dtype,
                                                device=self.dev)
                tgt = torch.from_numpy(rng.uniform(0.0, 50.0, so.num_bins).astype(np.float32)).to(
                    self.dev)
                kw1 = dict(dft_packed=so.dft_packed, dft_scale=so.dft_packed_scale,
                           topology=topology, n=cfg.n_samples, sine_order=7)
                kw2 = dict(kw1, pop=LONG_SAME_POP, param_mins=cfg.param_mins,
                           param_maxs=cfg.param_maxs)
                seed = kernel_seed(SEED, 4120 + i)
                runs.append((f"B1 {dtype}", lambda kw1=kw1, tgt=tgt: (
                    sf.fused_synth_fitness(params, tgt, **kw1),)))
                runs.append((f"B2 {dtype}", lambda kw2=kw2, tgt=tgt, seed=seed: (
                    gn.fused_generation(seed, pv, ps, tgt, **kw2))))
            for int8 in (True, False):
                kw = dict(topology=topology, n=LONG_SAME_FOLD_N, sine_order=9,
                          dft_scale=1e-5 if int8 else 0.0)
                runs.append((f"B3 {'int8' if int8 else 'bf16'}",
                             lambda kw=kw: sfo.fused_synth_fold(params, **kw)))
            for f32 in (True, False):
                kw = dict(topology=topology, n=LONG_SAME_STREAM_N, sine_order=9, audio_f32=f32)
                runs.append((f"B4 {'f32' if f32 else 'bf16'}",
                             lambda kw=kw: (sst.fused_synth_stream(params, window, **kw),)))
            for label, fn in runs:
                want = fn()
                saved = sf.LONG_ABOVE_GENES
                sf.LONG_ABOVE_GENES = LONG_SAME_ABOVE
                try:
                    require(sf.uses_long_code(topology), f"{topology}: not on the long code")
                    got = fn()
                finally:
                    sf.LONG_ABOVE_GENES = saved
                same = all(bits_equal(a.float(), b.float()) for a, b in zip(got, want))
                require(same, f"the long code differs from the fixed or wide one: {label}, "
                              f"{topology}")
                checked += 1
        log(f"long code bit-equal to the fixed and wide codes: {checked} settings ({LONG_SAME} x "
            f"B1/B2 int8, bf16, f32 at n={1 << LOG2N}, B3 int8, bf16 at "
            f"n={LONG_SAME_FOLD_N}, B4 bf16, f32 at n={LONG_SAME_STREAM_N}; P={LONG_SAME_POP}) "
            f"({time.perf_counter() - t0:.1f}s)")

    def long_b1_b2(self):
        """B1/B2 above 32 genes against their plain versions
        (``fused_check``): int8 at the bench shape on each of LONG_TRUTHS
        (fm16_parallel at n 256: its 64 genes staged in shared memory fill
        the block's int8 a+/- exactly), the truth planted first; bf16 and f32
        at the bench shape on fm9_parallel and fm17_series; at LONG_FRAMES
        frames of AUDIO_CONFIG's shape and with a run axis of LONG_RUNS
        there (bit-equal to lone launches) on fm9_parallel; B5 on
        fm9_parallel bit-equal to LONG_B5_GENERATIONS launches of B2 with the
        stable selection."""
        from pmfm_tpu_torch.es import kernel_seed, make_spectrum_ops
        from pmfm_tpu_torch.io import load_config
        from pmfm_tpu_torch.kernels import evolve as ev
        from pmfm_tpu_torch.kernels import generation as gn
        from pmfm_tpu_torch.kernels import synth_fitness as sf

        limits = {"int8": (FIT_MAX_REL, FIT_MEDIAN_REL), "bf16": (FIT_MAX_REL, FIT_MEDIAN_REL),
                  "f32": (F32_FIT_MAX_REL, F32_FIT_MEDIAN_REL)}
        cases = [(t, "int8", LOG2N if t != "fm16_parallel" else 8) for t in LONG_TRUTHS]
        cases += [(t, m, LOG2N) for t in ("fm9_parallel", "fm17_series") for m in ("bf16", "f32")]
        for i, (topology, mode, log2n) in enumerate(cases):
            t0 = time.perf_counter()
            cfg = self.long_config(topology, log2n)
            cfg = {"int8": cfg, "bf16": cfg.replace(dft_dtype="bfloat16"),
                   "f32": cfg.refine_config()}[mode]
            require(sf.uses_long_code(topology), f"{topology}: not on the long code")
            c = self.inputs(cfg, SEED + 4200 + i, LONG_TRUTHS[topology])
            where = (f"{mode}, {topology}, n={cfg.n_samples}, P={cfg.population_size}, sine order "
                     f"{cfg.sine_order}")
            e1, e2, fk, a1, a2 = self.fused_check(
                where, c["params"], c["pv"], c["ps"], c["target"], self.kw_b1(c), self.kw_b2(c),
                kernel_seed(SEED, 4200 + i), limits[mode])
            rank = int(torch.argmin(fk))
            log(f"B1/B2 long {where}: fitness max rel B1 {e1:.3e} B2 {e2:.3e} (limits "
                f"{limits[mode][0]:g} / {limits[mode][1]:g}), median {self.last_median[0]:.3e} / "
                f"{self.last_median[1]:.3e}; B2 values bit-equal, B2 fitness bit-equal to B1 on "
                f"its offspring; truth rank {rank} ({time.perf_counter() - t0:.1f}s)")
            require(rank == 0, f"{where}: the known-params truth does not rank first")
            self.long[topology, mode, log2n] = c
            if topology == "fm9_parallel":
                sfx = "" if mode == "int8" else f"_{mode}"
                self.kernels.setdefault(f"fused_synth_fitness_long{sfx}", {})["max_abs_err"] = a1
                self.kernels.setdefault(f"fused_generation_long{sfx}", {})["max_abs_err"] = a2
        # LONG_FRAMES frames and a run axis of LONG_RUNS at AUDIO_CONFIG's shape
        audio = load_config(AUDIO_CONFIG).es
        d = 36
        base = audio.replace(topology="fm9_parallel", num_dimensions=d, param_mins=(0.0,) * d,
                             param_maxs=param_maxs("fm9_parallel"))
        for j, (mode, cfg0) in enumerate((("int8", base),
                                          ("bf16", base.replace(dft_dtype="bfloat16")),
                                          ("f32", base.refine_config()))):
            t0 = time.perf_counter()
            cfg = cfg0.replace(num_frames=LONG_FRAMES)
            so = make_spectrum_ops(cfg, device=self.dev)
            c = self.run_inputs(cfg, so, 1, SEED + 4300 + j)
            c = dict(cfg=cfg, so=so, params=c["params"][0], pv=c["pv"][0], ps=c["ps"][0],
                     target=c["target"][0])
            where = (f"{mode}, fm9_parallel, n={cfg.n_samples}, F={LONG_FRAMES}, "
                     f"P={cfg.population_size}")
            if mode != "int8":  # the int8 frames share the bf16 template's frame loop
                e1, e2, _, _, _ = self.fused_check(
                    where, c["params"], c["pv"], c["ps"], c["target"], self.kw_b1(c),
                    self.kw_b2(c), kernel_seed(SEED, 4300 + j), limits[mode])
                log(f"B1/B2 long multi-frame {where}: fitness max rel B1 {e1:.3e} B2 {e2:.3e}; "
                    f"B2 values bit-equal, B2 fitness bit-equal to B1 on its offspring "
                    f"({time.perf_counter() - t0:.1f}s)")
            rcfg = cfg0
            rso = make_spectrum_ops(rcfg, device=self.dev)
            r = self.run_inputs(rcfg, rso, LONG_RUNS, SEED + 4310 + j)
            kw1, kw2 = self.kw_b1(dict(cfg=rcfg, so=rso)), self.kw_b2(dict(cfg=rcfg, so=rso))
            seeds = [kernel_seed(SEED, 4320 + q) for q in range(LONG_RUNS)]
            fb = sf.fused_synth_fitness(r["params"], r["target"], **kw1)
            gb = gn.fused_generation(seeds, r["pv"], r["ps"], r["target"], **kw2)
            f1 = torch.stack([sf.fused_synth_fitness(r["params"][q], r["target"][q], **kw1)
                              for q in range(LONG_RUNS)])
            g1 = [gn.fused_generation(seeds[q], r["pv"][q], r["ps"][q], r["target"][q], **kw2)
                  for q in range(LONG_RUNS)]
            eq1 = bits_equal(fb, f1)
            eq2 = all(bits_equal(gb[k], torch.stack([x[k] for x in g1])) for k in range(3))
            log(f"B1/B2 long run axis ({mode}, fm9_parallel, B={LONG_RUNS}, n={rcfg.n_samples}, "
                f"P={rcfg.population_size}): one launch bit-equal to {LONG_RUNS} lone launches: "
                f"B1 {eq1}, B2 {eq2}")
            require(eq1 and eq2, f"a batched long-code launch differs from the lone ones ({mode})")
        # B5: bit-equal to its B2 launches with the stable selection
        c = self.long["fm9_parallel", "int8", LOG2N]
        g = LONG_B5_GENERATIONS
        seeds = [kernel_seed(SEED + 4400, i) for i in range(g)]
        kw2 = self.kw_b2(c)
        args = (c["pv"], c["ps"], c["pv"][0].clone(), torch.tensor(float("inf"), device=self.dev),
                c["target"])
        before = ev.fused_evolve.launches
        out = ev.fused_evolve(seeds, *args, **kw2)
        require(ev.fused_evolve.launches == before + 1, "B5 is not one launch")
        loop = ev.fused_evolve_plain(seeds, *args, generation=gn.fused_generation, **kw2)
        same = all(bits_equal(a, b) for a, b in zip(out, loop))
        log(f"B5 long (int8, fm9_parallel, n={c['cfg'].n_samples}, P={c['cfg'].population_size}): "
            f"{g} generations in one call bit-equal to {g} B2 launches + the stable selection: "
            f"{same}")
        require(same and bool(torch.isfinite(out[5]).all()), "B5 long differs from its B2 launches")
        self.kernels.setdefault("fused_evolve_long", {})["max_abs_err"] = 0.0

    def long_large(self):
        """B3 at cell (c)'s shape (n 8192, P 2^15) in int8 and bf16 and B4 at
        cell (d)'s (n 65536, P 2^13) in bf16 and f32, on fm9_parallel and
        fm17_series, bit-equal to their plain versions: B3 whole; B4 whole on
        fm9_parallel (the plain walk timed), on fm17_series over the plain
        walk's first LONG_STREAM_CHECK_BLOCKS time blocks (the whole walk
        takes ~20 s) and whole at n LONG_SAME_STREAM_N."""
        from pmfm_tpu_torch.kernels import synth_fitness as sf
        from pmfm_tpu_torch.kernels import synth_fold as sfo
        from pmfm_tpu_torch.kernels import synth_stream as sst
        from pmfm_tpu_torch.ops import spectral
        from pmfm_tpu_torch.ops.wavetable import DEFAULT_SAMPLE_RATE, DEFAULT_WAVETABLE_SIZE

        fold, stream = self.cells["fold"], self.cells["stream"]
        for i, topology in enumerate(("fm9_parallel", "fm17_series")):
            t0 = time.perf_counter()
            n, pop = fold["cfg"].n_samples, fold["cfg"].population_size
            params = self.grid_params(topology, pop, SEED + 4500 + i)
            for int8 in (True, False):
                kw = dict(topology=topology, n=n, sine_order=9,
                          dft_scale=fold["so"].dft_packed_scale if int8 else 0.0)
                require(not sfo.fold_geometry(pop, n, int8, topology)["time_parallel"],
                        "the long code takes B3's single pass")
                k = sfo.fused_synth_fold(params, **kw)
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                p = sfo.fused_synth_fold_plain(params, pop_block=pop, **kw)
                b.record()
                b.synchronize()
                same = all(torch.equal(x, y) for x, y in zip(k, p))
                require(same, f"B3 long differs from its plain version ({topology}, int8 {int8})")
                if topology == "fm9_parallel" and int8:
                    self.long_plain_ms["fold"] = a.elapsed_time(b)
            log(f"B3 long ({topology}, n={n}, P={pop}, sine order 9, single pass): int8 and bf16 "
                f"bit-equal to the plain version ({time.perf_counter() - t0:.1f}s)")
            t0 = time.perf_counter()
            n, pop = stream["cfg"].n_samples, stream["cfg"].population_size
            params = self.grid_params(topology, pop, SEED + 4510 + i)
            window = stream["so"].window
            got = {f32: sst.fused_synth_stream(params, window, topology=topology, n=n,
                                               sine_order=9, audio_f32=f32)
                   for f32 in (True, False)}
            require(all(bool(torch.isfinite(x.float()).all()) for x in got.values()),
                    f"B4 long output not finite ({topology})")
            if topology == "fm9_parallel":  # the whole frame, the plain walk timed
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                want = sst.fused_synth_stream_plain(params, window, topology=topology, n=n,
                                                    sine_order=9, audio_f32=True, pop_block=pop)
                b.record()
                b.synchronize()
                self.long_plain_ms["stream"] = a.elapsed_time(b)
                what = "whole"
            else:  # the plain walk's first blocks, and a short frame whole
                nb = LONG_STREAM_CHECK_BLOCKS * 128
                got = {f32: x[:nb] for f32, x in got.items()}
                amp = sf.bank_amp(params, topology, False)
                inv_sr = sf.inv_sample_rate(DEFAULT_WAVETABLE_SIZE, DEFAULT_SAMPLE_RATE)
                blocks = sf.synth_blocks_plain(params, topology=topology, n=n, inv_sr=inv_sr,
                                               sine_order=9, int8=False)
                head = torch.cat([next(blocks) * amp for _ in range(LONG_STREAM_CHECK_BLOCKS)])
                want = head * window[:nb, None]
                small = spectral.make_spectrum_ops(LONG_SAME_STREAM_N, None,
                                                   method="dft_factored", device=self.dev).window
                kw = dict(topology=topology, n=LONG_SAME_STREAM_N, sine_order=9)
                sp_ = params[:LONG_SAME_POP]
                p = sst.fused_synth_stream_plain(sp_, small, pop_block=LONG_SAME_POP,
                                                 audio_f32=True, **kw)
                k32 = sst.fused_synth_stream(sp_, small, audio_f32=True, **kw)
                k16 = sst.fused_synth_stream(sp_, small, **kw)
                require(bits_equal(k32, p)
                        and bits_equal(k16.float(), p.to(torch.bfloat16).float()),
                        f"B4 long differs from its plain version at n={LONG_SAME_STREAM_N}")
                what = (f"over the plain walk's first {LONG_STREAM_CHECK_BLOCKS} blocks, and at "
                        f"n={LONG_SAME_STREAM_N}, P={LONG_SAME_POP} whole")
            same = bits_equal(got[True], want) and bits_equal(
                got[False].float(), want.to(torch.bfloat16).float())
            require(same, f"B4 long differs from its plain version ({topology}, n={n})")
            log(f"B4 long ({topology}, n={n}, P={pop}, sine order 9): f32 and bf16 bit-equal to "
                f"the plain version {what} ({time.perf_counter() - t0:.1f}s)")
        for name in ("fused_synth_fold_long", "fused_synth_stream_long"):
            self.kernels.setdefault(name, {})["max_abs_err"] = 0.0

    def long_scan(self):
        """The scan kernel bit-equal to its plain loop at each of LONG_SCAN
        (SCAN_GRID_POP, n 1024, floor, float32 and bf16), and the unfused
        engine xla_dft on the scan synthesis at each, P 2^15, n 1024: the card
        against the CPU on UNFUSED_CHECK_POP mild-index candidates within
        UNFUSED_TOL, UNFUSED_GENERATIONS generations of ``evolve`` with the
        scan's launch count."""
        from pmfm_tpu_torch.es import active_engine, evaluate, evolve, init_state
        from pmfm_tpu_torch.es import make_spectrum_ops
        from pmfm_tpu_torch.kernels import scan as ss
        from pmfm_tpu_torch.ops.synthesis import topology_dims

        for i, topology in enumerate(LONG_SCAN):
            t0 = time.perf_counter()
            d = topology_dims(topology)
            p = self.grid_params(topology, SCAN_GRID_POP, SEED + 4600 + i)
            a = ss.scan_synth(p, 1024, topology)
            ab = ss.scan_synth(p, 1024, topology, out_dtype=torch.bfloat16)
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev0.record()
            b = ss.scan_synth_plain(p, 1024, topology)
            ev1.record()
            ev1.synchronize()
            if i == 0:
                self.long_plain_ms["scan"] = ev0.elapsed_time(ev1)
            require(bits_equal(a, b) and bits_equal(ab.float(), b.to(torch.bfloat16).float()),
                    f"the scan kernel differs from its plain loop ({topology})")
            mild = (2000.0, 2.0, 2000.0, 1.0) * (d // 4) if "parallel" in topology else (
                2000.0, 0.1) * (d // 2)
            cfg = self.long_config(topology).replace(
                fused_kernel=False, fused_generation=False, synthesis_engine="scan",
                spectrum_method="dft", dft_dtype="float32", mutation_noise="clt12_neutral")
            so = make_spectrum_ops(cfg, device=self.dev)
            name = active_engine(cfg, so)
            require(name == "xla_dft", f"{topology}: the router names {name}")
            rng = np.random.default_rng(SEED + 4610 + i)
            check_v = rng.random((UNFUSED_CHECK_POP, d)).astype(np.float32)
            check_t = (rng.random(cfg.n_samples // 2) * 5.0).astype(np.float32)
            ck = cfg.replace(param_maxs=mild, num_offspring=UNFUSED_CHECK_POP - MU)
            got = evaluate(torch.from_numpy(check_v).to(self.dev),
                           torch.from_numpy(check_t).to(self.dev), so, ck).cpu()
            want = evaluate(torch.from_numpy(check_v), torch.from_numpy(check_t),
                            make_spectrum_ops(ck, device="cpu"), ck)
            e = rel_err(got.double(), want.double())
            max_rel, median_rel = UNFUSED_TOL["float32"]
            tgt = torch.rand((so.num_bins,), device=self.dev) * 5.0
            state = init_state(SEED, cfg, device=self.dev)
            evolve(state, tgt, 1, so, cfg)  # warm-up
            torch.cuda.synchronize()
            self.reset_counts()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            final, _ = evolve(state, tgt, UNFUSED_GENERATIONS, so, cfg)
            e1.record()
            e1.synchronize()
            counts = {k: v for k, v in self.read_counts().items() if v}
            log(f"scan long ({topology}, P={SCAN_GRID_POP}, n=1024): kernel bit-equal to its "
                f"plain loop (float32, bf16); unfused {name} (scan synthesis, P={POP}): card vs "
                f"CPU on {UNFUSED_CHECK_POP} candidates max rel {float(e.max()):.3e} median rel "
                f"{float(e.median()):.3e} (tolerance {max_rel:g} / {median_rel:g}); "
                f"{UNFUSED_GENERATIONS} generations {e0.elapsed_time(e1) / UNFUSED_GENERATIONS:.4f}"
                f" ms/gen, best fitness {float(final.best_fitness):.6g}; launches {counts} "
                f"({time.perf_counter() - t0:.1f}s) {card()}")
            require(float(e.max()) <= max_rel and float(e.median()) <= median_rel,
                    f"{topology}: the card disagrees with the CPU")
            require(counts == {"scan_synth": UNFUSED_GENERATIONS}, f"{topology}: launches {counts}")
            if i == 0:
                self.kernels.setdefault("scan_synth_long", {}).update(
                    max_abs_err=0.0, launches=counts["scan_synth"])
        torch.cuda.empty_cache()

    def long_evolve(self, cfg, target, so, generations, label):
        """``evolve`` from a fresh state for ``generations`` (after a one
        generation warm-up): ms a generation, the trajectory and the
        launches (by kernel, and B1/B2/B5's by mode)."""
        from pmfm_tpu_torch.es import evolve, init_state
        from pmfm_tpu_torch.kernels import evolve as ev
        from pmfm_tpu_torch.kernels import generation as gn
        from pmfm_tpu_torch.kernels import synth_fitness as sf

        evolve(init_state(1, cfg, device=self.dev), target, 1, so, cfg)  # warm-up
        torch.cuda.synchronize()
        self.reset_counts()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        final, traj = evolve(init_state(7, cfg, device=self.dev), target, generations, so, cfg,
                             record_trajectory=True)
        b.record()
        b.synchronize()
        counts = {k: v for k, v in self.read_counts().items() if v}
        by = {"B1": dict(sf.fused_synth_fitness.launches_by),
              "B2": dict(gn.fused_generation.launches_by), "B5": dict(ev.fused_evolve.launches_by)}
        traj = traj.cpu()
        log(f"evolve ({label}, n={cfg.n_samples}, P={cfg.population_size}): {generations} "
            f"generations {a.elapsed_time(b) / generations:.4f} ms/gen {card()}; best fitness "
            f"first {float(traj[0]):.6g} final {float(traj[-1]):.6g}; launches {counts}, by mode "
            f"{ {k: v for k, v in by.items() if v} }")
        require(bool(torch.isfinite(traj).all() and (traj[1:] <= traj[:-1]).all()), "trajectory")
        return counts, by

    def long_paths(self):
        """The entry points above 32 genes: ``evolve`` at the bench shape for
        LONG_GENERATIONS generations on fm9_parallel and fm17_series through
        fused_generation (B2) in int8, on fm9_parallel through fused_kernel
        (B1) in int8, both in bf16 and in f32 (the refine config), and
        through fused_evolve (one B5 launch); at cell (c)'s and (d)'s shapes
        on fm9_parallel through synth_fold (B3) and synth_stream (B4),
        BANK_LARGE_GENERATIONS each; ``cli.main`` on an fm9_parallel config
        (LONG_CLI_CONFIG with nine pairs, fusedGeneration and its refine
        tail) at the bench's population, in a temporary directory."""
        import io
        import os
        import shutil
        import tempfile

        from pmfm_tpu_torch.es import active_engine, make_spectrum_ops
        from pmfm_tpu_torch.ops import synthesize_single, target_spectrum

        g = LONG_GENERATIONS
        runs = []
        for topology in ("fm9_parallel", "fm17_series"):
            runs.append((topology, "int8", "fused_generation", "fused_generation", ""))
        for mode in ("int8", "bf16", "f32"):
            sfx = "" if mode == "int8" else f"_{mode}"
            if mode != "int8":
                runs.append(("fm9_parallel", mode, "fused_generation", "fused_generation", sfx))
            runs.append(("fm9_parallel", mode, "fused_kernel", "fused_synth_fitness", sfx))
        runs.append(("fm9_parallel", "int8", "fused_evolve", "fused_evolve", ""))
        for topology, mode, route, kernel, sfx in runs:
            cfg = self.long_config(topology)
            cfg = {"int8": cfg, "bf16": cfg.replace(dft_dtype="bfloat16"),
                   "f32": cfg.refine_config()}[mode]
            cfg = cfg.replace(fused_generation=route != "fused_kernel",
                              fused_evolve=route == "fused_evolve", restart_patience=0,
                              fitness_threshold=0.0)
            so = make_spectrum_ops(cfg, device=self.dev)
            audio = synthesize_single(torch.tensor(LONG_TRUTHS[topology]), cfg.n_samples,
                                      topology)
            target = target_spectrum(audio.to(self.dev), so)
            gens = 1 if route == "fused_evolve" else g
            counts, by = self.long_evolve(cfg, target, so, g, f"{topology}, {route}, {mode}, "
                                          f"{active_engine(cfg, so)}")
            want = f"parallel_{mode}" if "parallel" in topology else mode
            key = {"fused_kernel": "B1", "fused_generation": "B2", "fused_evolve": "B5"}[route]
            require(counts == {kernel: gens} and by[key] == {want: gens},
                    f"{topology} {route} {mode}: launches {counts}, by mode {by}")
            if topology == "fm9_parallel":
                name = {"fused_kernel": "fused_synth_fitness", "fused_generation":
                        "fused_generation", "fused_evolve": "fused_evolve"}[route]
                self.kernels.setdefault(f"{name}_long{sfx}", {})["launches"] = gens
        for key, label, kernel, engine in (("fold", "c", "fused_synth_fold", "synth_fold"),
                                           ("stream", "d", "fused_synth_stream", "synth_stream")):
            cell = self.cells[key]
            cfg = cell["cfg"].replace(topology="fm9_parallel", num_dimensions=36,
                                      param_mins=(0.0,) * 36,
                                      param_maxs=param_maxs("fm9_parallel"))
            so = cell["so"]
            require(active_engine(cfg, so) == engine, f"fm9_parallel at cell ({label})'s shape "
                    f"routes to {active_engine(cfg, so)}")
            audio = synthesize_single(torch.tensor(LONG_TRUTHS["fm9_parallel"]), cfg.n_samples,
                                      cfg.topology, engine="scanless")
            target = target_spectrum(audio.to(self.dev), so)
            counts, _ = self.long_evolve(cfg, target, so, BANK_LARGE_GENERATIONS,
                                         f"fm9_parallel at cell ({label})'s shape, {engine}")
            require(counts == {kernel: BANK_LARGE_GENERATIONS},
                    f"{kernel} launches != generations, or another kernel")
            self.kernels.setdefault(f"{kernel}_long", {})["launches"] = BANK_LARGE_GENERATIONS
        # the CLI on an fm9_parallel config, in a temporary directory
        from pmfm_tpu_torch import cli

        root = os.getcwd()
        with open(os.path.join(root, LONG_CLI_CONFIG)) as f:
            raw = json.load(f)
        ev_, ty, tpu = raw["evolutionary"], raw["type"], raw["tpu"]
        ev_.update(numDimensions=36, paramMins=[0.0] * 36,
                   paramMaxs=list(param_maxs("fm9_parallel")), numGenerations=LONG_CLI_GENERATIONS)
        ty["params"] = list(LONG_TRUTHS["fm9_parallel"])
        tpu.update(topology="fm9_parallel", fusedKernel=True, fusedGeneration=True,
                   refineGenerations=LONG_CLI_REFINE)
        work = tempfile.mkdtemp(prefix="chip_smoke_long_")
        try:
            path = os.path.join(work, "fm9_parallel_match.json")
            with open(path, "w") as f:
                json.dump(raw, f)
            out = io.StringIO()
            os.chdir(work)
            torch.cuda.synchronize()
            self.reset_counts()
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(out):
                    code = cli.main(["-j", path])
            finally:
                os.chdir(root)
            from pmfm_tpu_torch.kernels import generation as gn

            counts = {k: v for k, v in self.read_counts().items() if v}
            by = dict(gn.fused_generation.launches_by)
            text = out.getvalue()
            engine = next((ln for ln in text.splitlines() if ln.startswith("engine: ")), "")
            log(f"cli fm9_parallel (P={ev_['numParents'] + ev_['numOffspring']}, "
                f"{LONG_CLI_GENERATIONS} generations, refine tail {LONG_CLI_REFINE}): exit {code} "
                f"in {time.perf_counter() - t0:.2f}s, {engine!r}; launches {counts}, B2 by mode "
                f"{by} {card()}")
            require(code == 0 and "fused_generation" in engine, f"fm9_parallel cli: exit {code}")
            require(by.get("parallel_int8", 0) > 0 and by.get("parallel_f32", 0) > 0,
                    f"fm9_parallel cli: B2 int8 and f32 did not both run: {by}")
            require("Overall best parameters found" in text, "fm9_parallel cli: no best parameters")
        finally:
            shutil.rmtree(work, ignore_errors=True)

    def long_times(self):
        """The new instantiations' times at their shapes beside their plain
        versions (one call, timed in the checks above) and their bounds:
        B1/B2 int8, bf16 and f32 and B5 on fm9_parallel at the bench shape,
        B3 at cell (c)'s shape, B4 at cell (d)'s, the scan kernel at
        SCAN_GRID_POP, n 1024 on fm33_series; B2 int8 beside fm8_parallel's
        (the wide code) and fm17_series's."""
        from pmfm_tpu_torch.es import kernel_seed
        from pmfm_tpu_torch.kernels import evolve as ev
        from pmfm_tpu_torch.kernels import generation as gn
        from pmfm_tpu_torch.kernels import scan as ss
        from pmfm_tpu_torch.kernels import synth_fitness as sf
        from pmfm_tpu_torch.kernels import synth_fold as sfo
        from pmfm_tpu_torch.kernels import synth_stream as sst

        d = 36
        rows = {}
        for mode in ("int8", "bf16", "f32"):
            sfx = "" if mode == "int8" else f"_{mode}"
            c = self.long["fm9_parallel", mode, LOG2N]
            cfg, so = c["cfg"], c["so"]
            n, k, pop, mu = cfg.n_samples, so.num_bins, cfg.population_size, cfg.num_parents
            ncoef = 4 if cfg.sine_order == 7 else 5
            # int8, bf16: the folded DFT on the operand; f32: the FFT (no operand)
            elem = {"int8": 1, "bf16": 2, "f32": 0}[mode]
            operand = 2 * k * (n // 2) * elem
            dft = 2.0 * 2 * k * (n // 2) * pop
            synth = bank_ops_f32(pop, n, k, 9, ncoef)
            ops = {"int8": (dft, synth, 0.0), "bf16": (0.0, synth, dft),
                   "f32": (0.0, synth + f32_fft_ops(pop, n), 0.0)}[mode]
            io = operand + k * 4 + pop * 4
            kw1, kw2 = self.kw_b1(c), self.kw_b2(c)
            seed = kernel_seed(SEED, 4700)
            src = {"int8": "pmfm_tpu_torch/csrc/fused_long.cu",
                   "bf16": "pmfm_tpu_torch/csrc/fused_long.cu",
                   "f32": "pmfm_tpu_torch/csrc/fused_f32.cu"}[mode]
            rows[f"fused_synth_fitness_long{sfx}"] = (
                lambda kw1=kw1, c=c: sf.fused_synth_fitness(c["params"], c["target"], **kw1),
                lambda kw1=kw1, c=c: sf.fused_synth_fitness_plain(c["params"], c["target"], **kw1),
                io + pop * d * 4, ops, 1, src,
                "pmfm_tpu/kernels/synth_fitness.py:767", f"{mode}, n={n}, P={pop}")
            rows[f"fused_generation_long{sfx}"] = (
                lambda kw2=kw2, c=c: gn.fused_generation(seed, c["pv"], c["ps"], c["target"],
                                                         **kw2),
                lambda kw2=kw2, c=c: gn.fused_generation_plain(seed, c["pv"], c["ps"],
                                                               c["target"], **kw2),
                io + 2 * mu * d * 4 + 2 * pop * d * 4,
                (ops[0], ops[1] + pop * d * 12 * 2.0, ops[2]), 1, src,
                "pmfm_tpu/kernels/generation.py:438", f"{mode}, n={n}, P={pop}")
            if mode == "int8":
                g = LONG_B5_GENERATIONS
                seeds = [kernel_seed(SEED + 4710, i) for i in range(g)]
                best = torch.tensor(float("inf"), device=self.dev)
                rows["fused_evolve_long"] = (
                    lambda kw2=kw2, c=c: ev.fused_evolve(seeds, c["pv"], c["ps"], c["pv"][0], best,
                                                         c["target"], **kw2),
                    lambda kw2=kw2, c=c: ev.fused_evolve_plain(seeds, c["pv"], c["ps"], c["pv"][0],
                                                               best, c["target"], **kw2),
                    4 * mu * d * 4 + 2 * (d + 1) * 4 + operand + k * 4 + g * 4,
                    (g * dft, g * (synth + pop * d * 12 * 2.0), 0.0), g,
                    "pmfm_tpu_torch/csrc/evolve.cu", "pmfm_tpu/kernels/evolve.py:366",
                    f"int8, n={n}, P={pop}, mu={mu}")
        fold, stream = self.cells["fold"], self.cells["stream"]
        n, pop = fold["cfg"].n_samples, fold["cfg"].population_size
        fp = self.grid_params("fm9_parallel", pop, SEED + 4500)
        kwf = dict(topology="fm9_parallel", n=n, sine_order=9,
                   dft_scale=fold["so"].dft_packed_scale)
        rows["fused_synth_fold_long"] = (
            lambda: sfo.fused_synth_fold(fp, **kwf), self.long_plain_ms["fold"],
            pop * d * 4 + 2 * pop * (n // 2) + 2 * pop * 4,
            (0.0, bank_ops_f32(pop, n, 0, 9, 5), 0.0),
            1, "pmfm_tpu_torch/csrc/large_frame_long.cu", "pmfm_tpu/kernels/synth_fold.py:176",
            f"int8, n={n}, P={pop}")
        n, pop = stream["cfg"].n_samples, stream["cfg"].population_size
        sp_ = self.grid_params("fm9_parallel", pop, SEED + 4510)
        rows["fused_synth_stream_long"] = (
            lambda: sst.fused_synth_stream(sp_, stream["so"].window, topology="fm9_parallel", n=n,
                                           sine_order=9),
            self.long_plain_ms["stream"], pop * d * 4 + n * 4 + 2 * n * pop,
            (0.0, bank_ops_f32(pop, n, 0, 9, 5) + float(pop) * n * 2, 0.0), 1,
            "pmfm_tpu_torch/csrc/large_frame_long.cu", "pmfm_tpu/kernels/synth_stream.py:161",
            f"bf16, n={n}, P={pop}")
        scp = self.grid_params("fm33_series", SCAN_GRID_POP, SEED + 4600)
        rows["scan_synth_long"] = (
            lambda: ss.scan_synth(scp, 1024, "fm33_series"), self.long_plain_ms["scan"],
            1024 * SCAN_GRID_POP * 4 + SCAN_GRID_POP * 66 * 4,
            (0.0, float(SCAN_GRID_POP) * 1024 * 33 * (SINF_OPS + 6), 0.0), 1,
            "pmfm_tpu_torch/csrc/scan_synth.cu", "pmfm_tpu/ops/synthesis.py:220",
            f"fm33_series, floor, float32, n=1024, P={SCAN_GRID_POP}")
        for name, (fn, plain, nbytes, (i8, f32, b16), gens, src, rep, where) in rows.items():
            ms = cuda_ms(fn, LONG_TIMED_LAUNCHES if gens == 1 else 3)
            plain_ms = plain if isinstance(plain, float) else once_ms(plain)
            bound_ms, by = bound(nbytes, i8, f32, b16)
            per = f", {ms / gens:.4f} ms a generation" if gens > 1 else ""
            log(f"{name} ({where}, fm9_parallel unless named): kernel {ms:.4f} ms{per}, plain "
                f"{plain_ms:.2f} ms, bound {bound_ms:.4f} ms by {by} ({nbytes / 1e6:.2f} MB, "
                f"{i8 / 1e9:.1f} G int8 ops, {f32 / 1e9:.2f} G f32 ops, {b16 / 1e9:.1f} G bf16 "
                f"ops); {ms / bound_ms:.1f}x the bound {card()}")
            self.kernels.setdefault(name, {}).update(
                route="cuda", source=src, replaces=rep, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, library_ms=None)
        # B2 int8 at the bench shape: the long code beside the wide one
        c = self.long["fm9_parallel", "int8", LOG2N]
        line = []
        for topology in ("fm8_parallel", "fm16_series", "fm9_parallel", "fm17_series"):
            cfg = self.long_config(topology)
            td = cfg.num_dimensions
            rng = np.random.default_rng(SEED + 4720)
            t = lambda a: torch.from_numpy(a.astype(np.float32)).to(self.dev)  # noqa: E731
            pv, ps = t(rng.random((MU, td))), t(rng.uniform(0.02, 0.3, (MU, td)))
            k2 = dict(self.kw_b2(c), topology=topology, param_mins=(0.0,) * td,
                      param_maxs=param_maxs(topology), beta_scale=1.0 / td)
            b2 = cuda_ms(lambda: gn.fused_generation(kernel_seed(SEED, 4721), pv, ps, c["target"],
                                                     **k2), LONG_TIMED_LAUNCHES)
            line.append(f"{topology} ({'long' if sf.uses_long_code(topology) else 'wide'}) "
                        f"{b2:.4f} ms")
        log(f"B2 int8 at the bench shape (n={c['cfg'].n_samples}, P={POP}, sine order 7): "
            f"{'; '.join(line)} {card()}")

    # -- 42 -----------------------------------------------------------------
    def long_pursuit(self):
        """The fm9_parallel pursuit through ``cli.main`` (FM5_BASE_CONFIG with
        five more pairs of LONG_TRUTHS, cut as phase 21 cuts: each stage's
        generations / PURSUIT_GENERATION_CUT, one attempt): exit 0, every
        chunk no worse than its silent estimate, B1/B2 int8 on the bank."""
        import os
        import shutil

        import pmfm_tpu_torch.io

        root = os.getcwd()
        work = os.path.join(root, PURSUIT_DIR)
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        try:
            raw = fm5_parallel_config(root)
            ev_, ty = raw["evolutionary"], raw["type"]
            ev_["numDimensions"] = 36
            ev_["paramMins"] = [0.0] * 36
            ev_["paramMaxs"] = list(param_maxs("fm9_parallel"))
            ty["params"] = list(LONG_TRUTHS["fm9_parallel"])
            raw["tpu"]["topology"] = "fm9_parallel"
            raw["general"]["outputAudioPath"] = "output_audio/output_fm9_parallel.wav"
            path = os.path.join(work, "fm9_parallel_match.json")
            with open(path, "w") as f:
                json.dump(raw, f)
            code, counts, modes, lines = self.pursuit_cli(
                path, work, pursuit_cut(pmfm_tpu_torch.io.load_config), False)
            require(code == 0 and lines, f"fm9_parallel pursuit: exit {code}")
            require(modes["B2"].get("parallel_int8", 0) > 0,
                    f"fm9_parallel pursuit: B2 int8 did not run: {modes}")
        finally:
            shutil.rmtree(work, ignore_errors=True)

    # -- 43 -----------------------------------------------------------------
    def tp_chains(self):
        """B2 int8's time-parallel layout on the fixed chains and at F > 1
        (chains and banks): bit-equal to the one-warp layout over the
        sampled TP_CHAINS_CHECKED / TP_BANKS grid; against its plain version
        at --mode stft's shape; B5 bit-equal to its F 8 B2 launches in the
        layout the wrapper takes; both layouts' device times at cells (h),
        (m) and (n)."""
        import itertools

        from pmfm_tpu_torch.es import kernel_seed, make_spectrum_ops
        from pmfm_tpu_torch.es.pipeline import fused_generation_kwargs
        from pmfm_tpu_torch.io import load_config
        from pmfm_tpu_torch.kernels import evolve as ev
        from pmfm_tpu_torch.kernels import generation as gn
        from pmfm_tpu_torch.ops import spectral, synthesize_single
        from pmfm_tpu_torch.ops.synthesis import topology_dims

        audio = load_config(AUDIO_CONFIG).es
        rng = np.random.default_rng(SEED + 4350)
        t = lambda a: torch.from_numpy(a.astype(np.float32)).to(self.dev)  # noqa: E731
        t0, cases = time.perf_counter(), 0
        grid = (list(itertools.product(TP_CHAINS_CHECKED, TP_CHAIN_FRAMES, TP_CHAIN_N))
                + list(itertools.product(TP_BANKS, TP_BANK_FRAMES, TP_CHAIN_N)))
        for i, (topology, frames, n) in enumerate(grid):
            order, pop = TP_SINE_ORDERS[i % 3], TP_CHAIN_POPS[i % 2]
            runs = TP_RUNS[i // 2 % 2]
            d = topology_dims(topology)
            cfg = audio.replace(topology=topology, num_dimensions=d, param_mins=(0.0,) * d,
                                param_maxs=param_maxs(topology), sine_order=order,
                                audio_length_log2=n.bit_length() - 1, num_frames=frames)
            so = make_spectrum_ops(cfg, device=self.dev)
            kw = dict(fused_generation_kwargs(cfg, so), pop=pop)
            lead = () if runs is None else (runs,)
            tshape = (*lead, frames, so.num_bins) if frames > 1 else (*lead, so.num_bins)
            mu = cfg.num_parents
            pv, ps = t(rng.random((*lead, mu, d))), t(rng.uniform(0.02, 0.3, (*lead, mu, d)))
            tg = t(rng.uniform(0, 50, tshape))
            seed = (kernel_seed(SEED + 4350, i) if runs is None
                    else [kernel_seed(SEED + 4350 + r, i) for r in range(runs)])
            where = f"{topology}, n={n}, F={frames}, sine order {order}, P={pop}, runs {runs or 1}"
            outs = {}
            for tp in (False, True):
                gn.fused_generation.launches_by_layout.clear()
                with gen_layout(gn, tp):
                    outs[tp] = gn.fused_generation(seed, pv, ps, tg, **kw)
                got = dict(gn.fused_generation.launches_by_layout)
                require(got == {"time_parallel" if tp else "one_warp": 1},
                        f"{where}: launched {got}")
            require(all(bits_equal(a, b) for a, b in zip(outs[False], outs[True])),
                    f"B2's layouts differ ({where})")
            cases += 1
        log(f"B2 int8 layouts bit-equal (fitness, values, steps) on {cases} settings: "
            f"{', '.join(TP_CHAINS_CHECKED)} x F {TP_CHAIN_FRAMES} and {', '.join(TP_BANKS)} x F "
            f"{TP_BANK_FRAMES}, each at n {TP_CHAIN_N}, sine orders, P {TP_CHAIN_POPS} and runs "
            f"1, 2 in turn ({time.perf_counter() - t0:.1f}s)")

        # the new layout against its plain version at --mode stft's shape
        cfg = audio.replace(num_frames=STFT_FRAMES)
        c = self.inputs(cfg, SEED + 4360)
        wave = synthesize_single(torch.tensor(TRUTH), cfg.n_samples * cfg.num_frames,
                                 cfg.topology).to(self.dev)
        c["target"] = spectral.target_spectrum_frames(wave, c["so"])
        kw1, kw2 = self.kw_b1(c), self.kw_b2(c)
        where = (f"time-parallel, {cfg.topology}, n={cfg.n_samples}, F={cfg.num_frames}, "
                 f"P={cfg.population_size}")
        gn.fused_generation.launches_by_layout.clear()
        with gen_layout(gn, True):
            e1, e2, fk, _, _ = self.fused_check(where, c["params"], c["pv"], c["ps"],
                                                c["target"], kw1, kw2, kernel_seed(SEED, 4360))
        require("time_parallel" in gn.fused_generation.launches_by_layout,
                f"{where}: B2 ran {dict(gn.fused_generation.launches_by_layout)}")
        require(int(torch.argmin(fk)) == 0, f"{where}: the known-params truth does not rank first")
        log(f"B2 {where}: fitness max rel {e2:.3e} (B1 {e1:.3e}; limits {FIT_MAX_REL:g} / "
            f"{FIT_MEDIAN_REL:g}), median {self.last_median[1]:.3e}, values bit-equal, fitness "
            f"bit-equal to B1 on its offspring, the truth first")
        # B5 against its F 8 B2 launches in the layout the wrapper takes
        want = b2_layout(gn, kw2, c["so"].num_bins, cfg.num_dimensions)
        g = TP_B5_GENERATIONS
        seeds = [kernel_seed(SEED + 4370, j) for j in range(g)]
        args = (c["pv"], c["ps"], c["pv"][0].clone(), torch.tensor(float("inf"), device=self.dev),
                c["target"])
        ev.fused_evolve.launches_by_layout.clear()
        out = ev.fused_evolve(seeds, *args, **kw2)
        b5 = dict(ev.fused_evolve.launches_by_layout)
        gn.fused_generation.launches_by_layout.clear()
        loop = ev.fused_evolve_plain(seeds, *args, generation=gn.fused_generation, **kw2)
        require(b5 == {want: 1}, f"B5 at F {cfg.num_frames} ran {b5}, B2's wrapper takes {want}")
        require(dict(gn.fused_generation.launches_by_layout) == {want: g}
                and all(bits_equal(a, b) for a, b in zip(out, loop)),
                f"B5 at F {cfg.num_frames} differs from its {want} B2 launches")
        log(f"B5 at F {cfg.num_frames} ran its generations in B2's layout ({b5}) and is "
            f"bit-equal to {g} B2 launches in the layout the wrapper takes ({want}) with the "
            f"stable selection")

        # both layouts' device times at the cells' shapes, and the wrapper's pick
        for cell, frames, runs in TP_CELLS:
            cfg = audio.replace(num_frames=frames)
            so = make_spectrum_ops(cfg, device=self.dev)
            kw = fused_generation_kwargs(cfg, so)
            b = runs or 1
            ci = self.run_inputs(cfg, so, b, SEED + 4380 + frames + b)
            if runs is None:
                ci = {key: v[0] for key, v in ci.items()}
            seed = [kernel_seed(SEED, 4380 + r) for r in range(b)] if runs else 7
            fn = lambda: gn.fused_generation(seed, ci["pv"], ci["ps"], ci["target"], **kw)  # noqa: E731
            tt = {False: [], True: []}
            for tp in (False, True, True, False):
                with gen_layout(gn, tp):
                    tt[tp].append(cuda_ms(fn, TP_CELL_LAUNCHES))
            pick = b2_layout(gn, kw, so.num_bins, cfg.num_dimensions, b)
            log(f"B2 int8 layouts at cell {cell}'s shape ({cfg.topology}, n={cfg.n_samples}, "
                f"F={frames}, B={b}, P={cfg.population_size}, sine order {cfg.sine_order}; device "
                f"ms, each of 2 rounds): one-warp {tt[False]}, time-parallel {tt[True]}; the "
                f"wrapper takes {pick} {card()}")

    def b1_tp(self):
        """B1 int8 in its two layouts (csrc/fused_tp.cuh's time-parallel one,
        fused_eval.cu's one-warp one) bit-equal at every B1_TP_SETTINGS
        setting, each launch counted in the layout it was forced to; B2's
        fitness bit-equal to B1's on its own offspring with both forced to
        the time-parallel layout (the pursuit's shapes); the two layouts'
        device times alternated at B1_TP_TIMED's settings, beside the
        layout the wrapper takes and the bound."""
        from pmfm_tpu_torch.es import kernel_seed, make_spectrum_ops
        from pmfm_tpu_torch.es.pipeline import fused_generation_kwargs
        from pmfm_tpu_torch.io import load_config
        from pmfm_tpu_torch.kernels import generation as gn
        from pmfm_tpu_torch.kernels import synth_fitness as sf
        from pmfm_tpu_torch.ops.synthesis import parallel_pairs, topology_dims

        rng = np.random.default_rng(SEED + 4600)
        t = lambda a: torch.from_numpy(a.astype(np.float32)).to(self.dev)  # noqa: E731
        t0, worst = time.perf_counter(), 0.0
        for i, (label, config, topology, frames, runs, pop) in enumerate(B1_TP_SETTINGS):
            d = topology_dims(topology)
            cfg = load_config(config).es.replace(
                topology=topology, num_dimensions=d, param_mins=(0.0,) * d,
                param_maxs=param_maxs(topology), num_frames=frames)
            so = make_spectrum_ops(cfg, device=self.dev)
            n, k = cfg.n_samples, so.num_bins
            lead = () if runs is None else (runs,)
            params = t(rng.random((*lead, pop, d)) * np.asarray(cfg.param_maxs))
            target = t(rng.uniform(0, 50, (*lead, frames, k) if frames > 1 else (*lead, k)))
            kw1 = dict(dft_packed=so.dft_packed, dft_scale=so.dft_packed_scale, topology=topology,
                       n=n, sine_order=cfg.sine_order, num_frames=frames)
            where = (f"{label}: {topology}, n={n}, F={frames}, runs {runs or 1}, P={pop}, sine "
                     f"order {cfg.sine_order}")
            fn = lambda: sf.fused_synth_fitness(params, target, **kw1)  # noqa: E731
            outs = {}
            for tp in (False, True):
                sf.fused_synth_fitness.launches_by_layout.clear()
                with gen_layout(gn, tp):
                    outs[tp] = fn()
                got = dict(sf.fused_synth_fitness.launches_by_layout)
                require(got == {"time_parallel" if tp else "one_warp": 1},
                        f"B1 ({where}): launched {got}")
            torch.cuda.synchronize()
            require(bool(torch.isfinite(outs[False]).all()) and bits_equal(outs[False], outs[True]),
                    f"B1's layouts differ ({where})")
            worst = max(worst, float((outs[False] - outs[True]).abs().max()))
            pick = gn.time_parallel(n, k, d, topology, "int8", frames, pop, runs or 1)
            if label == "pursuit seed rescore":
                # B2 at the pursuit's polish shape, both in the time-parallel layout
                kw2 = dict(fused_generation_kwargs(cfg, so), pop=cfg.population_size)
                pv, ps = t(rng.random((cfg.num_parents, d))), t(rng.uniform(
                    0.02, 0.3, (cfg.num_parents, d)))
                with gen_layout(gn, True):
                    gk, vk, _ = gn.fused_generation(kernel_seed(SEED + 4600, i), pv, ps, target,
                                                    **kw2)
                    own = sf.fused_synth_fitness(
                        gn.scale_rows(vk, kw2["param_mins"], kw2["param_maxs"]), target, **kw1)
                torch.cuda.synchronize()
                require(bits_equal(gk, own), f"B2's fitness differs from B1's on its offspring, "
                        f"both time-parallel ({topology}, P={cfg.population_size})")
            if label in B1_TP_TIMED and (label != "pursuit seed rescore"
                                         or topology in ("fm3_parallel", "fm5_parallel")):
                tt = {False: [], True: []}
                for tp in SCAN_ORDER:
                    with gen_layout(gn, tp):
                        tt[tp].append(cuda_ms(fn, B1_TP_LAUNCHES))
                ms = {tp: statistics.median(v) for tp, v in tt.items()}
                rows = pop * (runs or 1)
                npair = parallel_pairs(topology)
                synth = (bank_ops_f32(rows, n * frames, k, npair, cfg.sine_order // 2 + 1)
                         if npair else synth_ops_f32(rows, n * frames, k, sf.chain_length(topology),
                                                     cfg.sine_order // 2 + 1))
                bound_ms, by = bound(params.numel() * 4 + target.numel() * 4 + rows * 4
                                     + so.dft_packed.numel(), 2.0 * 2 * k * (n // 2) * rows
                                     * frames, synth)
                log(f"B1 int8 layouts ({where}): one-warp {ms[False]:.4f} ms "
                    f"{[round(x, 4) for x in tt[False]]}, time-parallel {ms[True]:.4f} ms "
                    f"{[round(x, 4) for x in tt[True]]} (medians of {B1_TP_LAUNCHES}, "
                    f"alternated); the wrapper takes {'time_parallel' if pick else 'one_warp'}; "
                    f"bound {bound_ms:.4f} ms by {by} {card()}")
                if label == "pursuit seed rescore" and topology == "fm3_parallel":
                    plain_ms = cuda_ms(lambda: sf.fused_synth_fitness_plain(
                        params, target, **dict(kw1, pop_block=pop)), 1)
                    self.kernels.setdefault("fused_synth_fitness_tp", {}).update(
                        route="cuda", source="pmfm_tpu_torch/csrc/fused_tp.cu",
                        replaces="pmfm_tpu/kernels/synth_fitness.py:767", ms=ms[True],
                        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by, library_ms=None)
            log(f"B1 int8 ({where}): the layouts bit-equal; the wrapper takes "
                f"{'time_parallel' if pick else 'one_warp'}")
        self.kernels.setdefault("fused_synth_fitness_tp", {})["max_abs_err"] = worst
        log(f"B1 int8 layouts bit-equal at {len(B1_TP_SETTINGS)} settings "
            f"({time.perf_counter() - t0:.1f}s)")

    # -- 47 -----------------------------------------------------------------
    def bf16_tp(self):
        """B1/B2 bf16 in their two layouts (fused_bf16.cu's one warp,
        csrc/fused_tp_bf16.cuh's time-parallel one) bit-equal at
        BF16_TP_SHAPES, each launch counted
        in the layout it was forced to; at the bench config B2's fitness,
        values and steps bit-equal across the layouts, B2's fitness bit-equal
        to B1's on its own offspring, and each layout within the int8 gate
        of the plain versions (the truth first); a run axis of 4 for B2; B5
        at the bench config in the layout its wrapper takes (B2's), counted
        there, bit-equal to B5 forced one-warp and to its B2 launches; the
        layouts timed alternated at the first BF16_TP_TIMED shapes beside the
        wrapper's pick; the new kernels' JSON rows at the bench config; the
        ptxas of their instantiations."""
        from pmfm_tpu_torch.es import kernel_seed
        from pmfm_tpu_torch.kernels import evolve as ev
        from pmfm_tpu_torch.kernels import generation as gn
        from pmfm_tpu_torch.kernels import synth_fitness as sf
        from pmfm_tpu_torch.ops.spectral import make_spectrum_ops
        from pmfm_tpu_torch.ops.synthesis import topology_dims

        rows = [r for r in ptxas_summary(getattr(self, "build_log", "")) if "bf16_tp" in r[0]]
        require(rows or not getattr(self, "build_log", ""), "no bf16 time-parallel kernel built")
        for kind in ("fused_synth_fitness_bf16_tp", "fused_generation_bf16_tp"):
            got = [(int(r), int(sp)) for name, r, sp in rows if name.startswith(kind + "<")]
            if got:
                log(f"ptxas {kind}: {len(got)} instantiations, registers "
                    f"{min(r for r, _ in got)}-{max(r for r, _ in got)}, spill stores "
                    f"{min(sp for _, sp in got)}-{max(sp for _, sp in got)} bytes")
        rng = np.random.default_rng(SEED + 4700)
        t = lambda a: torch.from_numpy(a.astype(np.float32)).to(self.dev)  # noqa: E731
        by1, by2 = sf.fused_synth_fitness.launches_by_layout, gn.fused_generation.launches_by_layout
        t0 = time.perf_counter()
        for i, (topology, n, runs, pop) in enumerate(BF16_TP_SHAPES):
            d = topology_dims(topology)
            so = make_spectrum_ops(n, dft_dtype="bfloat16", device=self.dev)
            k = so.num_bins
            lead = () if runs is None else (runs,)
            params = t(rng.random((*lead, pop, d)) * np.asarray(param_maxs(topology)))
            target = t(rng.uniform(0, 50, (*lead, k)))
            kw1 = dict(dft_packed=so.dft_packed, dft_scale=so.dft_packed_scale, topology=topology,
                       n=n, sine_order=9)
            where = f"{topology}, n={n}, runs {runs or 1}, P={pop}"
            fn = lambda: sf.fused_synth_fitness(params, target, **kw1)  # noqa: E731
            outs = {}
            for tp in (False, True):
                by1.clear()
                with gen_layout(gn, tp):
                    outs[tp] = fn()
                require(dict(by1) == {gn.layout_key("bf16", tp): 1},
                        f"B1 bf16 ({where}): launched {dict(by1)}")
            torch.cuda.synchronize()
            require(bool(torch.isfinite(outs[False]).all()) and bits_equal(outs[False], outs[True]),
                    f"B1 bf16's layouts differ ({where})")
            pick = gn.layout_key("bf16", gn.time_parallel(n, k, d, topology, "bf16", 1, pop,
                                                          runs or 1))
            if i < BF16_TP_TIMED:
                tt = {False: [], True: []}
                for tp in SCAN_ORDER:
                    with gen_layout(gn, tp):
                        tt[tp].append(cuda_ms(fn, BF16_TP_LAUNCHES))
                log(f"B1 bf16 layouts ({where}): " + ", ".join(
                    f"{gn.layout_key('bf16', tp)} {statistics.median(v):.4f} ms "
                    f"{[round(y, 4) for y in v]}" for tp, v in tt.items())
                    + f" (medians of {BF16_TP_LAUNCHES}, alternated); the wrapper takes {pick} "
                    f"{card()}")
            else:
                log(f"B1 bf16 ({where}): the layouts bit-equal; the wrapper takes {pick}")
        # B2 at the bench config (the truth first) and with a run axis of 4
        c = self.inputs(self.cfg.replace(dft_dtype="bfloat16"), SEED + 4701)
        kw1, kw2 = self.kw_b1(c), self.kw_b2(c)
        seed = kernel_seed(SEED, 4700)
        rc = self.run_inputs(c["cfg"], c["so"], 4, SEED + 4702)
        rt = rc["target"][:, 0].contiguous()
        seeds = [kernel_seed(SEED, 4710 + r) for r in range(4)]
        outs, runs_out = {}, {}
        for tp in (False, True):
            by2.clear()
            with gen_layout(gn, tp):
                outs[tp] = gn.fused_generation(seed, c["pv"], c["ps"], c["target"], **kw2)
                runs_out[tp] = gn.fused_generation(seeds, rc["pv"], rc["ps"], rt, **kw2)
                require(dict(by2) == {gn.layout_key("bf16", tp): 2}, f"B2 bf16: {dict(by2)}")
                own = sf.fused_synth_fitness(
                    gn.scale_rows(outs[tp][1], kw2["param_mins"], kw2["param_maxs"]),
                    c["target"], **kw1)
            torch.cuda.synchronize()
            require(bits_equal(outs[tp][0], own), f"B2 bf16's fitness differs from B1's on its "
                    f"offspring ({gn.layout_key('bf16', tp)})")
        require(all(bits_equal(a, b) for a, b in zip(outs[False], outs[True]))
                and all(bits_equal(a, b) for a, b in zip(runs_out[False], runs_out[True])),
                "B2 bf16's layouts differ (bench config, run axis of 4)")
        # B5 bf16 at the bench config in its wrapper's layout (B2's there),
        # against B5 forced one-warp and against its B2 launches
        g = BF16_TP_B5_GENERATIONS
        b5_seeds = [kernel_seed(SEED, 4720 + i) for i in range(g)]
        b5_args = (c["pv"], c["ps"], c["pv"][0].clone(),
                   torch.tensor(float("inf"), device=self.dev), c["target"])
        want = gn.layout_key("bf16", gn.takes_time_parallel(c["pv"], **kw2))
        require(want == "bf16_time_parallel", f"the bench config's bf16 B5 takes {want}")
        outs5, taken = {}, {}
        for tp in (None, False):  # the wrapper's rule, then the one-warp layout forced
            with contextlib.nullcontext() if tp is None else gen_layout(gn, tp):
                ev.fused_evolve.launches_by_layout.clear()
                outs5[tp] = ev.fused_evolve(b5_seeds, *b5_args, **kw2)
                taken[tp] = dict(ev.fused_evolve.launches_by_layout)
        by2.clear()
        loop = ev.fused_evolve_plain(b5_seeds, *b5_args, generation=gn.fused_generation, **kw2)
        torch.cuda.synchronize()
        require(taken == {None: {want: 1}, False: {"bf16_one_warp": 1}}
                and dict(by2) == {want: g}, f"B5 bf16 ran {taken}, its B2 launches {dict(by2)}")
        require(all(bits_equal(a, b) for a, b in zip(outs5[None], outs5[False]))
                and all(bits_equal(a, b) for a, b in zip(outs5[None], loop)),
                "B5 bf16 (bench config) differs across its layouts or from its B2 launches")
        log(f"B5 bf16 at the bench config ({want}) bit-equal to B5 forced one-warp and to {g} "
            f"B2 launches ({dict(by2)}) with the stable selection")
        plain1 = sf.fused_synth_fitness_plain(c["params"], c["target"], **kw1)
        plain2 = gn.fused_generation_plain(seed, c["pv"], c["ps"], c["target"], **kw2)
        torch.cuda.synchronize()
        pop, n, k = c["cfg"].population_size, c["cfg"].n_samples, c["so"].num_bins
        errs = {}
        for tp in (False, True):
            with gen_layout(gn, tp):
                f1 = sf.fused_synth_fitness(c["params"], c["target"], **kw1)
            torch.cuda.synchronize()
            e1, e2 = rel_err(f1, plain1), rel_err(outs[tp][0], plain2[0])
            layout = gn.layout_key("bf16", tp)
            require(float(e1.max()) <= FIT_MAX_REL and float(e1.median()) <= FIT_MEDIAN_REL
                    and float(e2.max()) <= FIT_MAX_REL and float(e2.median()) <= FIT_MEDIAN_REL
                    and int(torch.argmin(f1)) == 0,
                    f"B1/B2 bf16 ({layout}) disagree with their plain versions or miss the truth")
            errs[tp] = (float((f1 - plain1).abs().max()),
                        float((outs[tp][0] - plain2[0]).abs().max()))
            log(f"B1/B2 bf16 {layout} (bench config: n={n}, K={k}, P={pop}, sine order "
                f"{c['cfg'].sine_order}) against the plain versions: max rel B1 "
                f"{float(e1.max()):.3e} B2 {float(e2.max()):.3e}, median rel B1 "
                f"{float(e1.median()):.3e} B2 {float(e2.median()):.3e} (limits {FIT_MAX_REL:g} / "
                f"{FIT_MEDIAN_REL:g}); truth first")
        # the JSON rows: B1/B2 in the wrapper's layout at the bench config
        # (time-parallel), against the plain versions and the bound
        synth = synth_ops_f32(pop, n, k, kn=3, ncoef=c["cfg"].sine_order // 2 + 1)
        dft_ops = 2.0 * 2 * k * (n // 2) * pop
        io = c["so"].dft_packed.numel() * 2 + k * 4 + pop * 4
        require(gn.time_parallel(n, k, D, TOPOLOGY, "bf16", 1, pop),
                "the bench config's bf16 shape is not time-parallel")
        timed = {
            "fused_synth_fitness_bf16_tp": (
                lambda: sf.fused_synth_fitness(c["params"], c["target"], **kw1),
                lambda: sf.fused_synth_fitness_plain(c["params"], c["target"], **kw1),
                io + pop * D * 4, synth, 0, "pmfm_tpu/kernels/synth_fitness.py:767"),
            "fused_generation_bf16_tp": (
                lambda: gn.fused_generation(seed, c["pv"], c["ps"], c["target"], **kw2),
                lambda: gn.fused_generation_plain(seed, c["pv"], c["ps"], c["target"], **kw2),
                io + 2 * MU * D * 4 + 2 * pop * D * 4, synth + pop * D * 12 * 2.0, 1,
                "pmfm_tpu/kernels/generation.py:438"),
        }
        for name, (fn, plain, nbytes, fops, j, replaces) in timed.items():
            ms = cuda_ms(fn, TIMED_LAUNCHES)
            plain_ms = cuda_ms(plain, PLAIN_RUNS)
            bound_ms, by = bound(nbytes, 0.0, fops, dft_ops)
            log(f"{name} (bench config): kernel {ms:.4f} ms, plain "
                f"{plain_ms:.2f} ms, bound {bound_ms:.4f} ms by {by}; {ms / bound_ms:.1f}x the "
                f"bound {card()}")
            self.kernels.setdefault(name, {}).update(
                route="cuda", source="pmfm_tpu_torch/csrc/fused_tp_bf16_chain.cu",
                replaces=replaces, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                library_ms=None, max_abs_err=errs[True][j])
        for name, j in (("fused_synth_fitness_bf16", 0), ("fused_generation_bf16", 1)):
            self.kernels.setdefault(name, {})["max_abs_err"] = errs[False][j]
        log(f"B1/B2 bf16 layouts bit-equal at {len(BF16_TP_SHAPES)} shapes and the bench "
            f"config ({time.perf_counter() - t0:.1f}s)")

    def tp_layout(self):
        """B2 int8 on the fixed banks in its two layouts (csrc/fused_tp.cuh's
        time-parallel one, fused_eval.cu's one-warp one): fitness, values and
        steps bit-equal over TP_BANKS x TP_SINE_ORDERS x TP_POPS x TP_RUNS;
        the new layout against its plain version (the truth first, its
        fitness bit-equal to B1's on its own offspring); B5 bit-equal to its
        time-parallel B2 launches; both layouts' device times over
        GEN_LAYOUT_POPS; the wrapper's host time a call; the cut
        fm5_parallel pursuit, its B2 launches in the layout the wrapper
        takes."""
        import os
        import shutil

        import pmfm_tpu_torch.io
        from pmfm_tpu_torch.es import kernel_seed, make_spectrum_ops
        from pmfm_tpu_torch.es.pipeline import fused_generation_kwargs
        from pmfm_tpu_torch.io import load_config
        from pmfm_tpu_torch.kernels import evolve as ev
        from pmfm_tpu_torch.kernels import generation as gn
        from pmfm_tpu_torch.ops.synthesis import topology_dims

        base = load_config(PARALLEL_CONFIG).es
        rng = np.random.default_rng(SEED + 4300)
        t = lambda a: torch.from_numpy(a.astype(np.float32)).to(self.dev)  # noqa: E731

        def bank(topology, **kw):
            d = topology_dims(topology)
            return base.replace(topology=topology, num_dimensions=d, param_mins=(0.0,) * d,
                                param_maxs=param_maxs(topology), **kw)

        def parents(cfg, so, lead=()):
            d, mu = cfg.num_dimensions, cfg.num_parents
            return (t(rng.random((*lead, mu, d))), t(rng.uniform(0.02, 0.3, (*lead, mu, d))),
                    t(rng.uniform(0, 50, (*lead, so.num_bins))))

        t0, cases = time.perf_counter(), 0
        settings = [(t, o, 1024, TP_POPS) for t in TP_BANKS for o in TP_SINE_ORDERS] + [
            (t, 9, n, (TP_FRAME_POP,)) for n in TP_FRAMES for t in TP_BANKS]
        for topology, order, n, pops in settings:
            cfg = bank(topology, sine_order=order, audio_length_log2=n.bit_length() - 1)
            so = make_spectrum_ops(cfg, device=self.dev)
            kw = fused_generation_kwargs(cfg, so)
            for pop in pops:
                for runs in TP_RUNS:
                    pv, ps, tg = parents(cfg, so, () if runs is None else (runs,))
                    seed = (kernel_seed(SEED + 4300, cases) if runs is None
                            else [kernel_seed(SEED + 4300 + r, cases) for r in range(runs)])
                    where = (f"{topology}, n={n}, sine order {order}, P={pop}, "
                             f"runs {runs or 1}")
                    outs = {}
                    for tp in (False, True):
                        gn.fused_generation.launches_by_layout.clear()
                        with gen_layout(gn, tp):
                            outs[tp] = gn.fused_generation(seed, pv, ps, tg,
                                                           **dict(kw, pop=pop))
                        got = dict(gn.fused_generation.launches_by_layout)
                        require(got == {"time_parallel" if tp else "one_warp": 1},
                                f"{where}: launched {got}")
                    require(all(bits_equal(a, b) for a, b in zip(outs[False], outs[True])),
                            f"B2's layouts differ ({where})")
                    cases += 1
        log(f"B2 int8 layouts bit-equal (fitness, values, steps) on {cases} settings: "
            f"{', '.join(TP_BANKS)} x sine orders {TP_SINE_ORDERS} x P {TP_POPS} x runs 1, 2 "
            f"at n=1024, and each bank at n {TP_FRAMES}, sine order 9, P={TP_FRAME_POP}, runs "
            f"1, 2 ({time.perf_counter() - t0:.1f}s)")

        # the new layout against its plain version and B1, then B5 against it
        c = self.inputs(bank("fm5_parallel"), SEED + 4310, WIDE_TRUTHS["fm5_parallel"])
        cfg, kw1, kw2 = c["cfg"], self.kw_b1(c), self.kw_b2(c)
        where = f"time-parallel, fm5_parallel, n={cfg.n_samples}, P={cfg.population_size}"
        seed = kernel_seed(SEED, 4310)
        with gen_layout(gn, True):
            e1, e2, fk, _, _ = self.fused_check(where, c["params"], c["pv"], c["ps"],
                                                c["target"], kw1, kw2, seed)
        require(int(torch.argmin(fk)) == 0, f"{where}: the known-params truth does not rank first")
        g = TP_B5_GENERATIONS
        seeds = [kernel_seed(SEED + 4320, i) for i in range(g)]
        args = (c["pv"], c["ps"], c["pv"][0].clone(), torch.tensor(float("inf"), device=self.dev),
                c["target"])
        want = b2_layout(gn, kw2, c["so"].num_bins, cfg.num_dimensions)
        ev.fused_evolve.launches_by_layout.clear()
        out = ev.fused_evolve(seeds, *args, **kw2)
        b5 = dict(ev.fused_evolve.launches_by_layout)
        require(b5 == {want: 1}, f"B5 on fm5_parallel ran {b5}, B2's wrapper takes {want}")
        gn.fused_generation.launches_by_layout.clear()
        with gen_layout(gn, True):
            loop = ev.fused_evolve_plain(seeds, *args, generation=gn.fused_generation, **kw2)
        require(dict(gn.fused_generation.launches_by_layout) == {"time_parallel": g}
                and all(bits_equal(a, b) for a, b in zip(out, loop)),
                "B5 differs from its time-parallel B2 launches")
        log(f"B2 {where}: fitness max rel {e2:.3e} (B1 {e1:.3e}; limits {FIT_MAX_REL:g} / "
            f"{FIT_MEDIAN_REL:g}), median {self.last_median[1]:.3e}, values bit-equal, fitness "
            f"bit-equal to B1 on its offspring, the truth first; B5 ({want}) bit-equal to {g} "
            f"time-parallel B2 launches with the stable selection")

        # device times of both layouts at each frame and population
        for n in TP_LAYOUT_N:
            for topology in TP_BANKS:
                cfg = bank(topology, audio_length_log2=n.bit_length() - 1)
                so = make_spectrum_ops(cfg, device=self.dev)
                kw = fused_generation_kwargs(cfg, so)
                pv, ps, tg = parents(cfg, so)
                row, cross = [], None
                for pop in GEN_LAYOUT_POPS:
                    fn = lambda pop=pop: gn.fused_generation(7, pv, ps, tg,  # noqa: E731
                                                             **dict(kw, pop=pop))
                    tt = {}
                    for tp in (False, True):
                        with gen_layout(gn, tp):
                            tt[tp] = cuda_ms(fn, GEN_LAYOUT_LAUNCHES)
                    if cross is None and tt[False] < tt[True]:
                        cross = pop
                    row.append(f"P={pop} one-warp {tt[False]:.4f} time-parallel {tt[True]:.4f}")
                faster = (f"the one-warp layout faster from P={cross}" if cross else
                          f"the time-parallel layout faster at every P to {max(GEN_LAYOUT_POPS)}")
                log(f"B2 int8 layouts ({topology}, n={n}, K={so.num_bins}, sine order "
                    f"{cfg.sine_order}; device ms): {'; '.join(row)}; {faster} {card()}")
        host = {}
        for tp in (False, True):
            with gen_layout(gn, tp):
                gn.fused_generation(seed, c["pv"], c["ps"], c["target"], **kw2)
                torch.cuda.synchronize()
                h0 = time.perf_counter()
                for _ in range(HOST_CALLS):
                    gn.fused_generation(seed, c["pv"], c["ps"], c["target"], **kw2)
                host[tp] = (time.perf_counter() - h0) / HOST_CALLS * 1e3
                torch.cuda.synchronize()
        log(f"B2's host time a call (fm5_parallel, P={cfg.population_size}, {HOST_CALLS} calls "
            f"on the host clock, no synchronise between): one-warp {host[False]:.4f} ms, "
            f"time-parallel {host[True]:.4f} ms")

        # the cut fm5_parallel pursuit: its polishes in the layout the wrapper takes
        want = b2_layout(gn, kw2, c["so"].num_bins, 20)
        root = os.getcwd()
        work = os.path.join(root, PURSUIT_DIR)
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        try:
            path = os.path.join(work, "fm5_parallel_match.json")
            with open(path, "w") as f:
                json.dump(fm5_parallel_config(root), f)
            code, counts, modes, lines = self.pursuit_cli(
                path, work, pursuit_cut(pmfm_tpu_torch.io.load_config), False)
            layout = dict(gn.fused_generation.launches_by_layout)
            log(f"cut fm5_parallel pursuit: B2 launches by layout {layout} {card()}")
            require(code == 0 and lines, f"fm5_parallel pursuit: exit {code}")
            require(set(layout) == {want} and layout[want] > 0,
                    f"the pursuit's polishes took {layout}, the wrapper's layout {want}")
        finally:
            shutil.rmtree(work, ignore_errors=True)

    # -- 48 -----------------------------------------------------------------
    def b5_layouts(self, check_layout=True):
        """B5 int8 and bf16 at B5_TURN_ROWS (PERF.md §6's B5 rows): every
        generation in the one-warp layout (``gen_layout(gn, False)``, B5's
        design before it took B2's layouts: "old") and in the wrapper's pick
        ("new"), bit-equal, then alternated in one process (B5_TURN_ORDER),
        each turn the median of B5_TURN_CALLS calls of B5_TURN_GENERATIONS
        generations, and each layout's split a generation (``b5_split``)
        beside B2 alone in the same layout. With ``check_layout`` the new
        call must be counted under the layout B2's wrapper takes at the
        same arguments (``generation.time_parallel`` at B5's population and
        runs); a probe run on a tree whose B5 has no layout counter passes
        False."""
        from pmfm_tpu_torch.es import kernel_seed, make_spectrum_ops
        from pmfm_tpu_torch.io import load_config
        from pmfm_tpu_torch.kernels import evolve as ev
        from pmfm_tpu_torch.kernels import generation as gn

        configs = dict(audio=load_config(AUDIO_CONFIG).es,
                       parallel=load_config(PARALLEL_CONFIG).es, bench=bench_config())
        g = B5_TURN_GENERATIONS
        for i, (label, mode, which, frames, runs) in enumerate(B5_TURN_ROWS):
            cfg = configs[which].replace(num_frames=frames,
                                         dft_dtype="bfloat16" if mode == "bf16" else "int8")
            so = make_spectrum_ops(cfg, device=self.dev)
            b = runs or 1
            c = self.run_inputs(cfg, so, b, SEED + 4800 + i)
            if frames == 1:
                c["target"] = c["target"][:, 0].contiguous()
            if runs is None:
                c = {key: v[0] for key, v in c.items()}
            kw = self.kw_b2(dict(cfg=cfg, so=so))
            n, k, d, pop = cfg.n_samples, so.num_bins, cfg.num_dimensions, cfg.population_size
            if runs is None:
                seeds = [kernel_seed(SEED + 4800 + i, j) for j in range(g)]
                seed = seeds[0]
            else:
                seeds = [[kernel_seed(SEED + 4800 + i + 10 * r, j) for j in range(g)]
                         for r in range(runs)]
                seed = [run[0] for run in seeds]
            lead = c["pv"].shape[:-2]
            args = (c["pv"], c["ps"], c["pv"][..., 0, :].clone(),
                    torch.full(lead, float("inf"), device=self.dev), c["target"])
            b5 = lambda: ev.fused_evolve(seeds, *args, **kw)  # noqa: E731
            b2 = lambda: gn.fused_generation(seed, c["pv"], c["ps"], c["target"], **kw)  # noqa: E731
            key = gn.layout_key(mode, gn.time_parallel(n, k, d, cfg.topology, mode, frames, pop, b))
            where = (f"{mode}, {cfg.topology}, n={n}, F={frames}, B={b}, P={pop}, sine order "
                     f"{cfg.sine_order}")

            def layout(new):  # the wrapper's pick, or every generation one-warp
                return contextlib.nullcontext() if new else gen_layout(gn, False)

            outs = {}
            for new in (False, True):
                with layout(new):
                    if check_layout:
                        taken = b5_layout_taken(ev, b5)
                        want = key if new else gn.layout_key(mode, False)
                        require(taken == want, f"{label} ({where}): B5 ran {taken}, not {want}")
                    outs[new] = b5()
            torch.cuda.synchronize()
            require(all(bits_equal(a, b) for a, b in zip(outs[False], outs[True])),
                    f"{label} ({where}): B5's layouts differ")
            turns = {False: [], True: []}
            for new in B5_TURN_ORDER:
                with layout(new):
                    turns[new].append(cuda_ms(b5, B5_TURN_CALLS) / g)
            b2_ms = {}
            for new in (False, True):
                with layout(new):
                    b2_ms[new] = cuda_ms(b2, TIMED_LAUNCHES)
            old_ms, new_ms = (statistics.median(turns[x]) for x in (False, True))
            log(f"{label} ({where}): B5 ms a generation, old (one-warp) "
                f"{[round(x, 4) for x in turns[False]]}, new ({key}) "
                f"{[round(x, 4) for x in turns[True]]} (turns old, new, new, old; medians of "
                f"{B5_TURN_CALLS} calls of {g} generations): {old_ms:.4f} -> {new_ms:.4f} "
                f"({old_ms / new_ms:.2f}x); B2 alone one-warp {b2_ms[False]:.4f}, {key} "
                f"{b2_ms[True]:.4f}; bit-equal {card()}")
            for new in (False, True):
                with layout(new):
                    self.b5_split(f"{label}, {'new: ' + key if new else 'old: one-warp'}", b5, g,
                                  statistics.median(turns[new]) * g, b2_ms[new])

    # -- 36 -----------------------------------------------------------------
    def a9(self):
        """A9 on the card: resume bit-equal to a run that was not stopped
        (``evolve_checkpointed`` under B2, B2 with restarts and B5;
        ``match_audio(checkpoint_dir=)``; ``cli.main --mode stft
        --checkpoint-dir --checkpoint-every``), the population readback,
        and an AOT artifact exported by ``cli.main --export-aot`` and run by
        ``--aot`` in a subprocess that cannot build the kernels."""
        import os
        import shutil

        root = os.getcwd()
        work = os.path.join(root, A9_DIR)
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        shutil.copytree(os.path.join(root, "input_audio"), os.path.join(work, "input_audio"))
        try:
            for label, cfg in (("B2", self.cfg),
                               ("B2 with restarts", self.cfg.replace(restart_patience=A9_PATIENCE)),
                               ("B5", self.cfg.replace(fused_evolve=True))):
                self.a9_evolve(label, cfg, os.path.join(work, label.replace(" ", "_")))
            self.a9_population()
            self.a9_chunks(work)
            self.a9_stft_and_aot(work)
        finally:
            shutil.rmtree(work, ignore_errors=True)

    @staticmethod
    def preempt_after(saves):
        """A context in which the ``saves``-th checkpoint write (of
        ``utils.checkpoint.save_checkpoint`` or ``utils.chunk_store.save_chunk``)
        completes and then raises ``Preempted``: a run stopped right after a
        save, its in-memory state lost."""
        from pmfm_tpu_torch.utils import checkpoint, chunk_store

        class Preempted(Exception):
            pass

        @contextlib.contextmanager
        def ctx():
            count = [0]
            orig = {m: getattr(m, n) for m, n in ((checkpoint, "save_checkpoint"),
                                                   (chunk_store, "save_chunk"))}

            def wrap(fn):
                def save(*a, **k):
                    out = fn(*a, **k)
                    count[0] += 1
                    if count[0] == saves:
                        raise Preempted(f"stopped after save {saves}")
                    return out
                return save

            checkpoint.save_checkpoint = wrap(orig[checkpoint])
            chunk_store.save_chunk = wrap(orig[chunk_store])
            try:
                yield Preempted
            finally:
                checkpoint.save_checkpoint = orig[checkpoint]
                chunk_store.save_chunk = orig[chunk_store]

        return ctx()

    def a9_evolve(self, label, cfg, directory):
        from pmfm_tpu_torch.es import evolve, evolve_checkpointed, init_state

        g = A9_GENERATIONS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, want_traj = evolve(init_state(9, cfg, device=self.dev), self.target, g, self.so, cfg,
                                 record_trajectory=True)
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
        self.reset_counts()
        t0 = time.perf_counter()
        with self.preempt_after(A9_STOP_AFTER) as preempted:
            try:
                evolve_checkpointed(init_state(9, cfg, device=self.dev), self.target, g, self.so,
                                    cfg, directory, every=A9_EVERY, record_trajectory=True)
                require(False, f"{label}: the run was not stopped")
            except preempted:
                pass
        # every in-memory state dropped: a fresh state, resumed from disk
        got, traj = evolve_checkpointed(init_state(9, cfg, device=self.dev), self.target, g,
                                        self.so, cfg, directory, every=A9_EVERY,
                                        record_trajectory=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: v for k, v in self.read_counts().items() if v}
        same = all(bits_equal(getattr(got, f), getattr(want, f)) for f in (
            "parent_values", "parent_steps", "parent_fitness", "best_values", "best_fitness",
            "stall")) and got.generation == want.generation == g
        same_traj = np.array_equal(traj, want_traj.cpu().numpy())
        same_gen = torch.equal(got.generator.get_state(), want.generator.get_state())
        restarts, stall, best = 0, 0, float("inf")  # as generation_step counts them
        for f in want_traj.cpu().tolist():
            stall, best = (0, f) if f < best else (stall + 1, best)
            if cfg.restart_patience and stall >= cfg.restart_patience:
                restarts, stall = restarts + 1, 0
        log(f"A9 {label}: evolve_checkpointed {g} generations in segments of {A9_EVERY}, stopped "
            f"after {A9_STOP_AFTER * A9_EVERY} and resumed from disk, in {seconds:.3f}s (one "
            f"evolve({g}) {one_s:.3f}s); state bit-equal {same}, trajectory bit-equal "
            f"{same_traj}, generator state equal {same_gen}; restarts {restarts}; launches "
            f"{launches} {card()}")
        require(same and same_traj and same_gen, f"A9 {label}: the resumed run differs")
        require(restarts > 0 or not cfg.restart_patience, f"A9 {label}: no restart fired")
        kernel = "fused_evolve" if cfg.fused_evolve else "fused_generation"
        require(launches.get(kernel, 0) > 0, f"A9 {label}: {kernel} did not run")

    def a9_population(self):
        from pmfm_tpu_torch.es import evolve, init_state
        from pmfm_tpu_torch.kernels import synth_fitness as sf

        cfg, g = self.cfg, A9_POPULATION_GENERATIONS
        self.reset_counts()
        final, _, pop = evolve(init_state(11, cfg, device=self.dev), self.target, g, self.so,
                               cfg, return_population=True)
        launches = {k: v for k, v in self.read_counts().items() if v}
        scaled = self.mins + pop.values * (self.maxs - self.mins)
        fb1 = sf.fused_synth_fitness(scaled, self.target, **self.b1_kwargs(POP))
        e = rel_err(pop.fitness, fb1)
        mx, med = float(e.max()), float(e.median())
        sorted_ok = bool((pop.fitness[1:] >= pop.fitness[:-1]).all())
        log(f"A9 population readback: evolve({g}, return_population=True) under B2: values "
            f"{tuple(pop.values.shape)}, fitness ascending {sorted_ok}, the parents its first "
            f"{cfg.num_parents} rows {torch.equal(pop.values[:cfg.num_parents], final.parent_values)}"
            f"; against B1 on the returned values max rel {mx:.3e} median rel {med:.3e} (B1's "
            f"int8 limit {FIT_MAX_REL:g} / {FIT_MEDIAN_REL:g}), bit-equal "
            f"{bits_equal(pop.fitness, fb1)}; launches {launches} {card()}")
        require(pop.values.shape == (POP, D) and pop.fitness.shape == (POP,) and sorted_ok,
                "population shape or order")
        require(torch.equal(pop.values[0], final.parent_values[0])
                and torch.equal(pop.values[:cfg.num_parents], final.parent_values),
                "the parents are not the population's first rows")
        require(mx <= FIT_MAX_REL and med <= FIT_MEDIAN_REL, "population fitness against B1")
        require(launches.get("fused_generation", 0) == g, "B2 launches")

    def a9_chunks(self, work):
        import os

        from pmfm_tpu_torch.es import match_audio
        from pmfm_tpu_torch.io import load_config, read_wav

        rc = load_config(AUDIO_CONFIG)
        cfg, g = rc.es, AUDIO_GENERATIONS
        wav, _ = read_wav(rc.input_audio_path)
        n = cfg.n_samples
        t0 = time.perf_counter()
        want = match_audio(wav, cfg, seed=SEED, num_generations=g, device=self.dev)
        one_s = time.perf_counter() - t0
        d = os.path.join(work, "chunks")
        self.reset_counts()
        t0 = time.perf_counter()
        part = match_audio(wav[: A9_CHUNKS * n], cfg, seed=SEED, num_generations=g,
                           checkpoint_dir=d, device=self.dev)
        files = sorted(os.listdir(d))
        got = match_audio(wav, cfg, seed=SEED, num_generations=g, checkpoint_dir=d,
                          device=self.dev)
        seconds = time.perf_counter() - t0
        launches = {k: v for k, v in self.read_counts().items() if v}
        chunks = len(wav) // n
        same = (len(got.chunks) == len(want.chunks) == chunks and all(
            np.array_equal(a.best_params_scaled, b.best_params_scaled)
            and np.array_equal(a.best_params_norm, b.best_params_norm)
            and a.best_fitness == b.best_fitness and a.generations_run == b.generations_run
            and a.refine_start_fitness == b.refine_start_fitness
            for a, b in zip(got.chunks, want.chunks))
            and np.array_equal(got.output_audio, want.output_audio))
        log(f"A9 chunks: match_audio({AUDIO_CONFIG}, {g} generations, checkpoint_dir) on the "
            f"first {len(part.chunks)} chunks ({files}), then resumed on all {chunks}, in "
            f"{seconds:.3f}s (uninterrupted {one_s:.3f}s); chunks and audio bit-equal {same}; "
            f"launches {launches} {card()}")
        require(len(part.chunks) == A9_CHUNKS and files == [
            f"chunk_{i:04d}.npz" for i in range(A9_CHUNKS)], "the chunks written")
        require(same, "A9 chunks: the resumed run differs")
        # each chunk once: g B2 launches and one B1 rescore
        require(launches.get("fused_generation") == chunks * g
                and launches.get("fused_synth_fitness") == chunks, "chunk launches")

    def a9_stft_and_aot(self, work):
        """``cli.main --mode stft`` on AUDIO_CONFIG at AUDIO_GENERATIONS:
        without checkpoints, then with ``--checkpoint-every``, stopped after
        its first save and run again; each run's ``stft_run`` output
        recorded and compared bit for bit. Then ``--export-aot`` and the
        ``--aot`` run in a subprocess (``a9_aot_subprocess``)."""
        import os

        from pmfm_tpu_torch.es import pipeline

        seen = []
        inner = pipeline.stft_run

        def recorded(*a, **k):
            out = inner(*a, **k)
            seen.append(_stft_record(out))
            return out

        gens = ["--mode", "stft", "--generations", str(AUDIO_GENERATIONS)]
        ck = os.path.join(work, "stft_checkpoints")
        pipeline.stft_run = recorded
        try:
            t0 = time.perf_counter()
            self.a6_cli(work, AUDIO_CONFIG, gens, "--mode stft (no checkpoints)")
            plain_s = time.perf_counter() - t0
            ckpt = gens + ["--checkpoint-dir", ck, "--checkpoint-every", str(A9_STFT_EVERY)]
            t0 = time.perf_counter()
            with self.preempt_after(2) as preempted:  # the int8 part, then a tail segment
                try:
                    self.a6_cli(work, AUDIO_CONFIG, ckpt, "--checkpoint-every (to be stopped)")
                    require(False, "the stft run was not stopped")
                except preempted:
                    pass
            files = sorted(os.listdir(ck))
            self.a6_cli(work, AUDIO_CONFIG, ckpt, "--checkpoint-every, resumed")
            ckpt_s = time.perf_counter() - t0
        finally:
            pipeline.stft_run = inner
        same = len(seen) == 2 and _records_equal(seen[0], seen[1])
        log(f"A9 stft: cli --mode stft {AUDIO_GENERATIONS} generations with --checkpoint-every "
            f"{A9_STFT_EVERY}, stopped after its first tail save ({files}) and resumed, in "
            f"{ckpt_s:.3f}s (without checkpoints {plain_s:.3f}s): bit-equal {same} {card()}")
        require(same, "A9 stft: the resumed run differs from the run without checkpoints")
        import io

        from pmfm_tpu_torch import cli

        art = os.path.join(work, "matcher.pmfm")
        out, root = io.StringIO(), os.getcwd()
        os.chdir(work)
        try:
            with contextlib.redirect_stdout(out):
                code = cli.main(["-j", os.path.join(root, AUDIO_CONFIG), *gens,
                                 "--export-aot", art])
        finally:
            os.chdir(root)
        require(code == 0 and os.path.exists(art), f"--export-aot: exit {code}")
        log(f"A9 AOT: {out.getvalue().strip()}")
        aot = self.a9_aot_subprocess(work, art)
        same = _records_equal(seen[0], aot["record"])
        log(f"A9 AOT: --aot in a subprocess with the build disabled and no library: exit "
            f"{aot['code']}, artifact loaded (library placed) in {aot['load_s']:.3f}s beside this "
            f"run's nvcc build of {self.build_seconds:.1f}s; process {aot['seconds']:.2f}s; "
            f"bit-equal to the live run {same} {card()}")
        require(aot["code"] == 0 and same, "A9 AOT: the --aot run differs from the live run")

    def a9_aot_subprocess(self, work, art):
        """``cli.main --aot art`` in a subprocess on a copy of the package
        whose build directory is empty and whose ``_build.build`` raises:
        its exit code, its ``stft_run`` record, the seconds the artifact took
        to load and the process's."""
        import os
        import shutil

        root = os.getcwd()
        copy = os.path.join(work, "copy")
        shutil.copytree(os.path.join(root, "pmfm_tpu_torch"),
                        os.path.join(copy, "pmfm_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copytree(os.path.join(root, "input_audio"), os.path.join(copy, "input_audio"))
        out_npz = os.path.join(work, "aot_record.npz")
        script = f"""
import json, re, sys
import numpy as np
from pmfm_tpu_torch.kernels import _build
assert not _build.BUILD_DIR.exists() or not any(_build.BUILD_DIR.iterdir()), "a library exists"
def refuse(*a, **k):
    raise RuntimeError("the build is disabled in this process")
_build.build = refuse
sys.path.append({root!r})  # after the copy: chip_smoke.py, not the checkout's package
from chip_smoke import _stft_record
from pmfm_tpu_torch.es import pipeline
inner, rec = pipeline.stft_run, {{}}
def recorded(*a, **k):
    out = inner(*a, **k)
    rec.update(_stft_record(out))
    return out
pipeline.stft_run = recorded
import io, contextlib
from pmfm_tpu_torch import cli
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    code = cli.main(["-j", {os.path.join(root, AUDIO_CONFIG)!r}, "--aot", {art!r}, "--mode",
                     "stft"])
print(buf.getvalue())
np.savez({out_npz!r}, **rec)
m = re.search(r"loaded AOT matcher .* in (\\S+)s", buf.getvalue())
print(json.dumps({{"code": code, "load_s": float(m.group(1)) if m else -1.0}}))
"""
        env = dict(os.environ, PYTHONPATH=copy)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", script], cwd=copy, env=env,
                              capture_output=True, text=True, timeout=A9_SUBPROCESS_S)
        seconds = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], flush=True)
            require(False, f"the --aot subprocess exited {proc.returncode}")
        res = json.loads(lines[-1])
        with np.load(out_npz) as z:
            record = {k: z[k] for k in z.files}
        return dict(res, seconds=seconds, record=record)

    # -- 39 -----------------------------------------------------------------
    def a10(self):
        """A10 on the card at the bench shape: a world of one on NCCL
        against ``evolve``; two ranks sharing the card through gloo, 1-D and
        (1 pop x 2 frame); the CLI under ``torch.distributed.run``. The
        ranks are processes of their own on this card: this process's
        cached blocks from earlier phases are released before they start."""
        self.a10_world_of_one()
        gib = lambda b: f"{b / 2**30:.2f} GiB"  # noqa: E731
        reserved = torch.cuda.memory_reserved()
        torch.cuda.empty_cache()
        log(f"A10 this process before the ranks: {gib(torch.cuda.memory_allocated())} allocated, "
            f"{gib(reserved)} reserved, {gib(torch.cuda.memory_reserved())} after "
            f"empty_cache; the card's free memory {gib(torch.cuda.mem_get_info()[0])}")
        self.a10_ranks()
        self.a10_cli()

    def a10_world_of_one(self):
        import torch.distributed as dist

        from pmfm_tpu_torch.es import evolve, init_state
        from pmfm_tpu_torch.parallel import evolve_sharded, make_mesh

        mesh = make_mesh((1,), device=self.dev)
        try:
            cfg, g = self.cfg, A10_GENERATIONS
            # a warm-up: NCCL's first collective sets up its communicator
            evolve_sharded(init_state(SEED, cfg, device=self.dev), self.target, 2, self.so, cfg,
                           mesh)
            runs = {}
            for name, fn in (("evolve", lambda s: evolve(
                    s, self.target, g, self.so, cfg, record_trajectory=True)),
                             ("evolve_sharded", lambda s: evolve_sharded(
                                 s, self.target, g, self.so, cfg, mesh, record_trajectory=True))):
                state = init_state(SEED, cfg, device=self.dev)
                self.reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(state)
                torch.cuda.synchronize()
                runs[name] = (out, (time.perf_counter() - t0) * 1e3 / g,
                              self.read_counts()["fused_generation"])
            (a, ta), ms_a, la = runs["evolve"]
            (b, tb), ms_b, lb = runs["evolve_sharded"]
            fields = ("parent_values", "parent_steps", "parent_fitness", "best_values",
                      "best_fitness", "stall")
            equal = (all(bits_equal(getattr(a, f), getattr(b, f)) for f in fields)
                     and bits_equal(ta, tb) and a.generation == b.generation)
            log(f"A10 world of one on {mesh.backend}: evolve_sharded bit-equal to evolve over "
                f"{g} generations at P {cfg.population_size}: {equal} (best "
                f"{float(b.best_fitness):.6g}); {ms_b:.4f} ms/gen against evolve's {ms_a:.4f} (host clock to a synchronize); "
                f"B2 launches {lb} and {la} {card()}")
            require(mesh.backend == "nccl", f"a world of one on the card is on {mesh.backend}")
            require(equal, "a world of one is not bit-equal to evolve")
            require(la == lb == g, f"B2 launches {la}, {lb} for {g} generations")
        finally:
            dist.destroy_process_group()

    def a10_ranks(self):
        """``multiprocess_check.run`` at the bench shape with 2 ranks on the
        card: 1-D (P 2^14 a rank) and (1 pop x 2 frame)."""
        from pmfm_tpu_torch import multiprocess_check as mp

        for mesh2d in (False, True):
            cfg = self.cfg.replace(num_frames=2) if mesh2d else self.cfg
            gens = A10_FRAME_GENERATIONS if mesh2d else A10_GENERATIONS
            t0 = time.perf_counter()
            code, lines = mp.run(A10_CLI_RANKS, mesh2d, "cuda", cfg=cfg, generations=gens)
            seconds = time.perf_counter() - t0
            for ln in lines:
                if not ln.startswith("MPBYTES"):
                    print(f"  {ln}", flush=True)
            label = "1 pop x 2 frame" if mesh2d else "2 pop"
            require(code == 0, f"A10 {label}: a rank failed")
            rows = lambda tag: [ln.split()[2:] for ln in lines if ln.startswith(tag)]  # noqa: E731
            digests = {r[-1] for r in rows("MPCHK")}
            require(len(rows("MPCHK")) == A10_CLI_RANKS and len(digests) == 1,
                    f"A10 {label}: ranks disagree {digests}")
            launches = [int(r[0].split("=")[1]) for r in rows("MPLAUNCH")]
            engines = {ln.split(maxsplit=2)[2] for ln in lines if ln.startswith("MPENGINE")}
            times = [r[2] for r in rows("MPTIME")]
            log(f"A10 {A10_CLI_RANKS} ranks sharing the card ({label}, gloo): every rank's state "
                f"byte-equal ({digests.pop()}); engine {sorted(engines)}, B2 launches a rank "
                f"{launches} in {gens} generations; a rank's "
                f"{', '.join(times)} (contention on one card, not scaling); {seconds:.1f}s with "
                f"the ranks' start {card()}")
            if mesh2d:
                frames = [dict(kv.split("=") for kv in r[1:]) for r in rows("MPFRAME")]
                limit = UNFUSED_TOL["float32"]  # the unfused engines' (1e-3, 1e-6)
                require(frames and all(float(f["max_rel"]) <= limit[0] and
                                       float(f["median_rel"]) <= limit[1]
                                       for f in frames), f"A10 frame all-reduce: {frames}")
            want = ("xla_stft (frame-sharded)", 0) if mesh2d else ("fused_generation", gens)
            require(engines == {want[0]} and launches == [want[1]] * A10_CLI_RANKS,
                    f"A10 {label}: engine {engines}, B2 launches {launches}")

    def a10_cli(self):
        """``python -m torch.distributed.run --nproc-per-node 2 -m
        pmfm_tpu_torch.cli -j <SHIPPED_CONFIG, A10_CLI_GENERATIONS
        generations a chunk> --mesh 2`` in A10_DIR."""
        import os
        import shutil

        root = os.getcwd()
        work = os.path.join(root, A10_DIR)
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        try:
            with open(os.path.join(root, SHIPPED_CONFIG)) as f:
                config = json.load(f)
            config["evolutionary"]["numGenerations"] = A10_CLI_GENERATIONS
            path = os.path.join(work, os.path.basename(SHIPPED_CONFIG))
            with open(path, "w") as f:
                json.dump(config, f)
            cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                   "--nproc-per-node", str(A10_CLI_RANKS), "-m", "pmfm_tpu_torch.cli", "-j",
                   path, "--mesh", str(A10_CLI_RANKS)]
            env = dict(os.environ, PYTHONPATH=os.pathsep.join(
                [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=work, env=env, capture_output=True, text=True,
                                  timeout=A10_SUBPROCESS_S)
            seconds = time.perf_counter() - t0
            text = proc.stdout
            engine = next((ln for ln in text.splitlines() if ln.startswith("engine: ")), "")
            for ln in text.splitlines():
                if ln.startswith(("Total time to complete", "candidate evaluations", "chunk ")):
                    print(f"  {ln}", flush=True)
            log(f"A10 torch.distributed.run --nproc-per-node {A10_CLI_RANKS} cli --mesh "
                f"{A10_CLI_RANKS} on {SHIPPED_CONFIG} ({A10_CLI_GENERATIONS} generations a "
                f"chunk): exit {proc.returncode} in {seconds:.2f}s "
                f"(the ranks' start and the stage rows included), {engine!r} {card()}")
            if proc.returncode != 0:
                print(text[-4000:], proc.stderr[-4000:], flush=True)
            require(proc.returncode == 0, f"the CLI under torch.distributed.run exited "
                                          f"{proc.returncode}")
            require(f"mesh {{'pop': {A10_CLI_RANKS}}} on gloo" in engine, f"engine {engine!r}")
            require(text.count("chunk 0: fitness = ") == 1, "not one report")
            require(os.path.exists(os.path.join(work, "output_audio", "output.wav")), "no WAV")
        finally:
            shutil.rmtree(work, ignore_errors=True)

    # -- 40 -----------------------------------------------------------------
    def a1(self):
        """``convergence_check.main`` at A1_SEEDS seeds and A1_GENERATIONS
        generations over A1_VARIANTS into A1_DIR, its layout and the bench's
        readers; the kernels it ran."""
        import os
        import shutil

        from pmfm_tpu_torch import bench
        from pmfm_tpu_torch import convergence_check as cc

        work = os.path.join(os.getcwd(), A1_DIR)
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        path = os.path.join(work, "quality_gates.json")
        try:
            self.reset_counts()
            t0 = time.perf_counter()
            code = cc.main(["--seeds", str(A1_SEEDS), "--gens", str(A1_GENERATIONS),
                            "--seed-offset", "64", "--split", "holdout", "--variants",
                            *A1_VARIANTS, "--json", path])
            seconds = time.perf_counter() - t0
            counts = self.read_counts()
            with open(path) as f:
                hold = json.load(f)["splits"]["holdout"]
            res = hold["results"]
            parts = ", ".join("%s %.2fs, median %.6g" % (k, v["seconds"], v["median"])
                              for k, v in res.items())
            log(f"A1 convergence_check at {A1_SEEDS} seeds x {A1_GENERATIONS} generations: exit "
                f"{code} in {seconds:.2f}s; {parts}; bench reads {bench.generations_to_converge(path)['split']} and "
                f"{bench.quality_holdout(path)}; launches {counts} {card()}")
            require(code == 0 and set(res) == set(A1_VARIANTS), f"A1 results {sorted(res)}")
            require(all(np.isfinite(r["fits"]).all() and len(r["fits"]) == A1_SEEDS
                        for r in res.values()), "A1: a fitness is not finite")
            require(hold["meta"]["device"]["name"] == CARD["name"], f"A1 device {hold['meta']}")
            require(counts["fused_generation"] > 0 and counts["fused_synth_fitness"] > 0,
                    f"A1 launches {counts}")
        finally:
            shutil.rmtree(work, ignore_errors=True)

    # -- 37, 38 -------------------------------------------------------------
    def study_pursuit(self, seeds):
        """``es.staged.match_parallel_pursuit`` on C2_STUDY's own meta (its
        topology, populations, every stage's generations, tries and rounds,
        the int8 polishes, the scan-rendered target of its true genes times
        the ranges, targetRel and attempts) for each of ``seeds``, each
        rescored as the study rescores it (the f32 engine without the fused
        kernels: relative error sqrt(fitness / target energy)). Prints each
        seed's attempts, generations, relative error and seconds beside the
        study's rates; every seed must finish with a finite fitness no worse
        than silence."""
        import os

        from pmfm_tpu_torch.es import ESConfig, evaluate, make_spectrum_ops
        from pmfm_tpu_torch.es.staged import match_parallel_pursuit
        from pmfm_tpu_torch.models import get_topology
        from pmfm_tpu_torch.ops import synthesize_single, target_spectrum
        from pmfm_tpu_torch.ops.synthesis import scale_params

        with open(os.path.join(os.getcwd(), C2_STUDY)) as f:
            study = json.load(f)
        m = study["meta"]
        require(m["solver"] == "match_parallel_pursuit" and m["engine"] == "int8",
                f"{C2_STUDY}: not the int8 parallel pursuit")
        topo = get_topology(m["topology"])
        cfg = ESConfig(
            num_parents=m["mu"], num_offspring=m["pop"] - m["mu"],
            num_dimensions=topo.num_dimensions, topology=m["topology"],
            param_mins=topo.default_param_mins, param_maxs=topo.default_param_maxs,
            audio_length_log2=10, synthesis_engine="scanless", spectrum_method="dft",
            pop_block=1024, mutation_noise="clt12_neutral", min_step=1e-4,
            restart_patience=100, refine_generations=m["refine_gens"], dft_dtype="int8",
            fused_kernel=True, fused_generation=True,
        )
        truth = torch.tensor(m["true_genes"], dtype=torch.float32, device=self.dev)
        lo = torch.tensor(cfg.param_mins, device=self.dev)
        hi = torch.tensor(cfg.param_maxs, device=self.dev)
        audio = synthesize_single(scale_params(truth[None], lo, hi)[0], cfg.n_samples,
                                  cfg.topology, engine=m["target_engine"])
        cfg32 = cfg.replace(dft_dtype="float32", fused_kernel=False, fused_generation=False,
                            refine_generations=0)
        so32 = make_spectrum_ops(cfg32, device=self.dev)
        tspec32 = target_spectrum(audio, so32)
        energy = float(torch.sum(tspec32.double() ** 2))
        log(f"C2 on {C2_STUDY}'s meta: {m['topology']} P {m['pop']} mu {m['mu']} stage_pop "
            f"{m['stage_pop']}, target energy {energy:.9g} (the study's {m['tgt_energy']:.9g}); "
            f"the study: attempts {study['attempts']}, median rel {study['median_rel']}, "
            f"median seed seconds {study['median_seed_seconds']} (its own hardware)")
        target = audio.cpu().numpy()
        for seed in seeds:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = match_parallel_pursuit(
                target, cfg, seed, device=self.dev, stage_population=m["stage_pop"],
                peel_generations=m["peel_gens"], peel_tries=m["peel_tries"],
                tail_generations=m["tail_gens"], tail_tries=m["tail_tries"],
                alias_rounds=m["alias_rounds"], alias_generations=m["alias_gens"],
                joint_generations=m["joint_gens"], repair_rounds=m["repair_rounds"],
                repair_generations=m["repair_gens"], target_rel=m["target_rel"],
                max_attempts=m["max_attempts"],
            )
            values = torch.from_numpy(np.asarray(r.best_values, np.float32)).to(self.dev)
            f32 = float(evaluate(values[None], tspec32, so32, cfg32)[0])
            seconds = time.perf_counter() - t0
            rel = (max(f32, 0.0) / energy) ** 0.5
            parts = ", ".join(f"{k} {v:.3f}s" for k, v in (r.seconds or {}).items())
            log(f"C2 seed {seed}: attempts {r.attempts}, generations {r.generations_used}, "
                f"f32 fitness {f32:.9g}, relative error {rel:.6f} (targetRel "
                f"{m['target_rel']}: {'met' if rel <= m['target_rel'] else 'not met'}), "
                f"{seconds:.2f}s ({parts}) {card()}")
            require(np.isfinite(f32) and f32 <= energy, f"C2 seed {seed}: worse than silence")

    def kernels_line(self):
        keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms")
        out = []
        for name in KERNELS:
            row = dict(self.kernels.get(name, {}), name=name)
            missing = [k for k in keys if k not in row]
            require(not missing, f"{name}: no {missing}")
            out.append({k: row[k] for k in keys + ("chain_floor_ms", "layout") if k in row})
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
    only = None if args.only is None else set(args.only.split(","))
    # phase 35 (only when named) runs a pursuit of minutes on top of the rest
    watchdog = WATCHDOG_S + (FM5_WATCHDOG_S if only and "35" in only else 0)
    faulthandler.dump_traceback_later(watchdog, exit=True)
    import pmfm_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    s = Smoke(only=only)
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
    s.phase("26 B1/B2 bf16 vs plain", s.bf16_kernels)
    if "26 B1/B2 bf16 vs plain" not in s.failed:
        s.phase("27 B5 bf16 and evolve", s.bf16_evolve)
        s.phase("28 operand cache and the bench suite", s.suite)
        s.phase("29 bf16 kernel times", s.bf16_timings)
    if "large inputs" not in s.failed:
        s.phase("30 B3/B4 banks and a wide chain vs plain", s.bank_large)
    s.phase("31 B5 on a bank vs its B2 launches", s.bank_b5)
    s.phase("32 B1/B2 at 20-32 genes vs plain", s.wide_kernels)
    if "large inputs" not in s.failed:
        s.phase("33 paths: the fm5_parallel pursuit, fm3_parallel on B5, B3, B4", s.bank_paths)
        if "32 B1/B2 at 20-32 genes vs plain" not in s.failed:
            s.phase("34 bank and wide kernel times, B3's layouts on banks", s.bank_timings)
    if "large inputs" not in s.failed:
        s.phase("41 topologies above 32 genes: the long code in every kernel", s.long_codes)
    s.phase("43 B2 int8: the time-parallel layout on chains and frames", s.tp_chains)
    s.phase("43 B2 int8 banks: the time-parallel layout", s.tp_layout)
    s.phase("46 B1 int8: the time-parallel layout", s.b1_tp)
    s.phase("47 B1/B2 bf16: the time-parallel layout", s.bf16_tp)
    s.phase("48 B5 int8/bf16 on B2's layouts, in turns", s.b5_layouts)
    s.phase("44 B2 true f32 at the users' shapes", s.f32_shapes)
    s.phase("45 B1/B2/B5 true f32: the synthesis layouts bit-equal", s.f32_layouts)
    s.phase("36 A9: resume, population readback, AOT", s.a9)
    s.phase("39 A10: a world of one, two ranks on the card, the CLI over a mesh", s.a10)
    s.phase("40 A1: the ES-quality gate, 2 seeds", s.a1)
    if s.only is not None and "35" in s.only:  # minutes: never part of the whole run
        s.phase("35 the fm5_parallel pursuit as written", s.fm5_pursuit)
    if s.only is not None and "42" in s.only:  # never part of the whole run
        s.phase("42 the fm9_parallel pursuit through the CLI, cut", s.long_pursuit)
    for number, seeds in C2_SEEDS.items():  # minutes each: never part of the whole run
        if s.only is not None and number in s.only:
            # a watchdog of its own; the run's resumes after it, moved on by
            # the phase's seconds
            t0 = time.perf_counter()
            faulthandler.dump_traceback_later(C2_WATCHDOG_S, exit=True)
            s.phase(f"{number} C2: the fm5_parallel study's meta, seeds {seeds}",
                    lambda seeds=seeds: s.study_pursuit(seeds))
            watchdog += time.perf_counter() - t0
            faulthandler.dump_traceback_later(
                max(1.0, watchdog - (time.perf_counter() - T0)), exit=True)
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
