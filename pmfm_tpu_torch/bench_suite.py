"""Benchmark suite (port of ``pmfm_tpu/bench_suite.py``).

The reference's planned benchmark list (main.cpp:291-301), suite by suite
with the reference's row names, configurations and engine annotations:

  overall        OverallExecution: an evolve run's wall time
  stages         per-stage device time (recombine, mutate, synthesis, the
                 spectrum, selection, the fused evaluation)
  chunk_size     AudioAnalysisChunkSize: audioLengthLog2 9..17, each row named
                 with the engine ``es.strategy.active_engine`` picks, plus
                 rfft comparison rows at 13..16
  population     PopulationScaling: 2^11 .. 2^18 candidates
  optimizations  engine ablations (scan vs scanless, dft vs rfft, f32 vs bf16
                 vs int8, the fused kernels and the whole-run kernel)
  topologies     every model family
  stft_frames    multi-frame fitness at 1/2/4/8 frames (int8 B2)
  multi_target   ``match_many`` over 1, 4 and 32 targets

The default engine preset is the reference's: bf16 (``dft_dtype="bfloat16"``)
with the fused kernels under ``--fused``, so every row of overall,
population, topologies, multi_target and the small frames of chunk_size runs
B1 in its bf16 mode on the card; ``--engine flagship`` takes bench.py's
engine (folded int8, B2, sine order 7). Every suite writes the reference's
CSV: its 7 timing columns, population and generations (``utils.Benchmarker``).

On the card (the default device) a row's time is the best of three runs
after a warm one, each ending in ``torch.cuda.synchronize``; on the CPU
(``main(argv, device="cpu")``, the tests) the kernels' plain versions run, at
tiny sizes. The reference's ``enable_compile_cache`` has no counterpart: the
port's kernels are built once per source hash by ``kernels/_build.py``
(``build/pmfm_tpu_torch/``), which plays that part.

Usage: python -m pmfm_tpu_torch.bench_suite [--suite all] [--fused] [--pop 32768] ...
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def _sync(x) -> None:
    """Wait for the device work behind ``x`` (a tensor, or anything else)."""
    if torch.is_tensor(x) and x.is_cuda:
        torch.cuda.synchronize(x.device)


def _steady_time(fn, *args, reps=3):
    """Seconds of the fastest of ``reps`` calls of ``fn(*args)`` after a warm
    one, each timed to the end of its device work."""
    _sync(fn(*args))
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        _sync(fn(*args))
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best


def _make_runner(cfg, gens, so=None, *, device="cuda"):
    """A call that runs ``gens`` generations of ``evolve`` from a fresh state
    against a flat target and returns the best fitness (a device tensor)."""
    from .es import evolve, init_state, make_spectrum_ops

    if so is None:
        so = make_spectrum_ops(cfg, device=device)
    tspec = torch.ones((so.num_bins,), dtype=torch.float32, device=so.window.device)

    def run():
        final, _ = evolve(init_state(0, cfg, device=device), tspec, gens, so, cfg)
        return final.best_fitness

    return run


# --engine presets: "default" = bf16 + --fused flag; "flagship" = the
# bench.py engine (folded int8, fully-fused generation, order-7 sine)
ENGINES = {
    "default": {},
    "flagship": dict(synthesis_engine="scanless", spectrum_method="dft",
                     dft_dtype="int8", fused_kernel=True,
                     fused_generation=True, sine_order=7),
}


def _base_cfg(args, **over):
    from .es import ESConfig

    kw = dict(
        num_parents=args.parents,
        num_offspring=args.pop - args.parents,
        num_dimensions=6,
        topology="fm3_series",
        audio_length_log2=args.log2,
        synthesis_engine="scanless",
        spectrum_method="dft",
        dft_dtype="bfloat16",
        fused_kernel=args.fused,
        pop_block=1024,
        # large-frame rows (chunk_size n >= 16384): the O(N^2) operand build
        # is host float64 trig per (n, bins, dtype): cache it on disk
        operand_cache_dir=getattr(args, "operand_cache", None),
    )
    kw.update(ENGINES[getattr(args, "engine", "default")])
    kw.update(over)
    return ESConfig(**kw)


def suite_overall(args, bm):
    cfg = _base_cfg(args)
    dt = _steady_time(_make_runner(cfg, args.gens, device=args.device))
    bm.add_timer("OverallExecution", dt * 1e3)
    evals = cfg.population_size * args.gens / dt
    print(f"OverallExecution: {dt*1e3:.1f}ms for {args.gens} gens "
          f"({evals/1e6:.2f}M evals/s)")
    bm.elapsed_timer("OverallExecution")


def suite_stages(args, bm):
    """Per-stage timing, each stage called repeatedly on fixed inputs
    (``utils.stage_bench.timed_loop``: CUDA events on the card)."""
    from .es import make_spectrum_ops
    from .es.strategy import evaluate, mutate, recombine, select
    from .ops import magnitude_spectrum, synthesize
    from .utils.stage_bench import timed_loop

    dev = args.device
    cfg = _base_cfg(args)
    so = make_spectrum_ops(cfg, device=dev)
    P, N, MU = cfg.population_size, cfg.n_samples, cfg.num_parents
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    tspec = torch.ones((so.num_bins,), dtype=torch.float32, device=dev)
    values = torch.rand((P, cfg.num_dimensions), generator=gen, device=dev)
    steps = torch.full_like(values, 0.1)
    audio = torch.randn((N, P), generator=gen, device=dev)
    fitness = torch.rand((P,), generator=gen, device=dev)
    scaled = values * 3000.0

    stages = [
        ("recombinePopulation", lambda v: recombine(gen, v[:MU], steps[:MU], cfg)[0], values),
        ("mutatePopulation", lambda v: mutate(gen, v, steps, cfg)[0], values),
        ("synthesisePopulation",
         lambda p: synthesize(p, N, cfg.topology, engine=cfg.synthesis_engine), scaled),
        ("applyWindow+FFT", lambda a: magnitude_spectrum(a, so), audio),
        ("fitness+sort(topk)", lambda f: select(values, steps, f, MU)[2], fitness),
        ("evaluateFused", lambda v: evaluate(v, tspec, so, cfg), values),
    ]
    iters = 30 if dev.type == "cuda" else 1
    for name, fn, x in stages:
        ms = timed_loop(fn, x, iters=iters)
        bm.add_timer(name, ms)
        print(f"{name:24s} {ms:8.3f} ms")
        bm.elapsed_timer(name)


def suite_chunk_size(args, bm):
    """AudioAnalysisChunkSize sweep, 2^9..2^17, engine-annotated rows: the
    fused kernels up to their frame limit, then synth_fold (B3 + the folded
    DFT) to 16384, then synth_stream (B4 + the factored DFT); 2^13..2^16 add
    an rfft comparison row (cuFFT). From 2^16 the population shrinks (2^13,
    then 2^12; annotated) to keep the audio and spectra in device memory."""
    from .es import make_spectrum_ops
    from .es.strategy import active_engine

    def row(log2, name, **over):
        pop_l2 = 15 if log2 <= 15 else (13 if log2 == 16 else 12)
        over.setdefault("num_parents", args.parents)
        over.setdefault("num_offspring", (1 << pop_l2) - args.parents)
        cfg = _base_cfg(args, audio_length_log2=log2, **over)
        gens = args.gens if log2 <= 12 else max(5, args.gens // 10)
        # one operand build serves both the annotation and the runner
        so = make_spectrum_ops(cfg, device=args.device)
        eng = active_engine(cfg, so)
        if pop_l2 != 15:
            eng += f",pop=2^{pop_l2}"
        dt = _steady_time(_make_runner(cfg, gens, so, device=args.device))
        name = f"{name}_{1<<log2}[{eng}]"
        bm.add_timer(name, dt * 1e3)
        bm.set_workload(name, cfg.population_size, gens)
        print(f"{name}: {dt*1e3:.1f}ms "
              f"({cfg.population_size*gens/dt/1e6:.2f}M evals/s)")
        bm.elapsed_timer(name)

    for log2 in (9, 10, 11, 12, 13, 14, 15, 16, 17):
        row(log2, "AudioAnalysisChunkSize")
    for log2 in (13, 14, 15, 16):  # whole-generation rfft comparison
        try:
            row(log2, "AudioAnalysisChunkSize", spectrum_method="rfft",
                fused_kernel=False, fused_generation=False)
        except torch.cuda.OutOfMemoryError as e:
            # rfft at 2^15 / pop 2^15 may exceed device memory; anything
            # else (a failed launch, a shape error) propagates
            torch.cuda.empty_cache()
            print(f"AudioAnalysisChunkSize_{1<<log2}[rfft]: SKIP ({e})", flush=True)


def suite_population(args, bm):
    for pop_log2 in (11, 13, 15, 17, 18):
        pop = 1 << pop_log2
        mu = max(args.parents, pop // 128)
        cfg = _base_cfg(args, num_parents=mu, num_offspring=pop - mu)
        dt = _steady_time(_make_runner(cfg, args.gens, device=args.device))
        name = f"PopulationScaling_2^{pop_log2}"
        bm.add_timer(name, dt * 1e3)
        bm.set_workload(name, pop, args.gens)
        print(f"{name}: {dt*1e3:.1f}ms ({pop*args.gens/dt/1e6:.2f}M evals/s)")
        bm.elapsed_timer(name)


# suite_multi_target's target sounds (fm3_series truths)
TRUE_SETS = (
    (3078.0, 2.0, 3015.0, 1.5, 3141.0, 1.0),
    (2400.0, 3.0, 1800.0, 2.0, 900.0, 4.0),
    (440.0, 6.0, 880.0, 1.2, 1760.0, 2.5),
    (3520.0, 1.0, 2637.0, 3.3, 1975.0, 0.8),
)


def suite_multi_target(args, bm):
    """Batched multi-target matching: ``match_many`` runs B independent
    runs, one a target sound, as one batched state (one kernel launch a
    generation for all runs). Rows give aggregate candidate-evals/s for
    B = 1, 4 and 32 (32 at 2^11 candidates a target)."""
    from .es.pipeline import match_many
    from .ops import synthesize_single

    pop = 1 << 13  # per-target population (B targets run concurrently)
    cfg = _base_cfg(args, num_parents=max(64, pop // 128),
                    num_offspring=pop - max(64, pop // 128))
    targets = np.stack([synthesize_single(torch.tensor(p), cfg.n_samples, cfg.topology).numpy()
                        for p in TRUE_SETS])
    gens = args.gens
    for b in (1, 4, 32):
        cfg_b = cfg
        if b == 32:
            small_mu = max(16, (1 << 11) // 128)
            cfg_b = cfg.replace(num_parents=small_mu, num_offspring=(1 << 11) - small_mu)
        tgts = targets[:b] if b <= len(targets) else np.tile(
            targets, (-(-b // len(targets)), 1))[:b]
        t0 = time.perf_counter()
        match_many(tgts, cfg_b, seed=0, num_generations=gens, device=args.device)
        warm = time.perf_counter() - t0  # includes the kernels' build on a first call
        t0 = time.perf_counter()
        match_many(tgts, cfg_b, seed=1, num_generations=gens, device=args.device)
        if torch.device(args.device).type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        name = f"MultiTarget_B{b}" + ("[pop=2^11]" if b == 32 else "")
        bm.add_timer(name, dt * 1e3)
        bm.set_workload(name, b * cfg_b.population_size, gens)
        print(f"{name}: {dt*1e3:.1f}ms for {gens} gens x {b} targets "
              f"({b*cfg_b.population_size*gens/dt/1e6:.2f}M evals/s aggregate; "
              f"first call {warm:.1f}s)")
        bm.elapsed_timer(name)


OPT_VARIANTS = {
    "scan+rfft+f32": dict(synthesis_engine="scan", spectrum_method="rfft",
                          dft_dtype="float32", fused_kernel=False),
    "scan+dft+f32": dict(synthesis_engine="scan", spectrum_method="dft",
                         dft_dtype="float32", fused_kernel=False),
    "scanless+dft+f32": dict(synthesis_engine="scanless", spectrum_method="dft",
                             dft_dtype="float32", fused_kernel=False),
    "scanless+dft+bf16": dict(synthesis_engine="scanless", spectrum_method="dft",
                              dft_dtype="bfloat16", fused_kernel=False),
    "fused-pallas": dict(synthesis_engine="scanless", spectrum_method="dft",
                         dft_dtype="bfloat16", fused_kernel=True),
    "fused-generation": dict(synthesis_engine="scanless", spectrum_method="dft",
                             dft_dtype="bfloat16", fused_kernel=True,
                             fused_generation=True),
    "fused-generation+int8": dict(synthesis_engine="scanless",
                                  spectrum_method="dft", dft_dtype="int8",
                                  fused_kernel=True, fused_generation=True),
    "whole-run+int8": dict(synthesis_engine="scanless", spectrum_method="dft",
                           dft_dtype="int8", fused_kernel=True,
                           fused_generation=True, fused_evolve=True),
    # the bench.py config: fused generations + order-7 sine
    "fused-generation+int8+sin7": dict(
        synthesis_engine="scanless", spectrum_method="dft",
        dft_dtype="int8", fused_kernel=True, fused_generation=True,
        sine_order=7),
}


def suite_optimizations(args, bm):
    for name, over in OPT_VARIANTS.items():
        cfg = _base_cfg(args, **over)
        dt = _steady_time(_make_runner(cfg, args.gens, device=args.device))
        bm.add_timer(f"Opt_{name}", dt * 1e3)
        print(f"Opt_{name:22s}: {dt*1e3:8.1f}ms "
              f"({cfg.population_size*args.gens/dt/1e6:.2f}M evals/s)")
        bm.elapsed_timer(f"Opt_{name}")


TOPOLOGIES = ("fm2", "fm3_series", "fm3_parallel", "fm4_series", "fm5_series", "fm4_parallel")


def suite_topologies(args, bm):
    """Steady-state throughput for every model family. Dims: 2 params per
    serial operator, 4 per parallel pair."""
    from .ops.synthesis import topology_dims

    for topo in TOPOLOGIES:
        d = topology_dims(topo)
        cfg = _base_cfg(
            args,
            topology=topo,
            num_dimensions=d,
            param_mins=(0.0,) * d,
            param_maxs=tuple([3520.0, 8.0] * (d // 2)),
        )
        dt = _steady_time(_make_runner(cfg, args.gens, device=args.device))
        name = f"Topology_{topo}"
        bm.add_timer(name, dt * 1e3)
        print(f"{name}: {dt*1e3:.1f}ms "
              f"({cfg.population_size*args.gens/dt/1e6:.2f}M evals/s)")
        bm.elapsed_timer(name)


def suite_stft_frames(args, bm):
    """Multi-frame STFT fitness scaling: each candidate synthesises F n
    continuous samples and sums the frames' spectral errors, in one B2
    launch a generation."""
    from .es import evolve, init_state, make_spectrum_ops

    for frames in (1, 2, 4, 8):
        cfg = _base_cfg(
            args,
            num_parents=256,
            num_offspring=(1 << 13) - 256,  # smaller pop: F*N samples each
            num_frames=frames,
            dft_dtype="int8",
            fused_kernel=True,
            fused_generation=True,
        )
        so = make_spectrum_ops(cfg, device=args.device)
        tgt = torch.ones((frames, so.num_bins), dtype=torch.float32, device=so.window.device)

        def run(cfg=cfg, so=so, tgt=tgt):
            final, _ = evolve(init_state(0, cfg, device=args.device), tgt, args.gens, so, cfg)
            return final.best_fitness

        dt = _steady_time(run)
        name = f"STFTFrames_{frames}"
        bm.add_timer(name, dt * 1e3)
        bm.set_workload(name, cfg.population_size, args.gens)
        pop = cfg.population_size
        print(f"{name}: {dt*1e3:.1f}ms ({pop*args.gens/dt/1e6:.2f}M cand/s, "
              f"{pop*frames*args.gens/dt/1e6:.2f}M frame-evals/s)")
        bm.elapsed_timer(name)


SUITES = {
    "overall": suite_overall,
    "stages": suite_stages,
    "chunk_size": suite_chunk_size,
    "population": suite_population,
    "optimizations": suite_optimizations,
    "topologies": suite_topologies,
    "stft_frames": suite_stft_frames,
    "multi_target": suite_multi_target,
}


def parse_args(argv=None) -> argparse.Namespace:
    """The reference's command line: the suites' ``args``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--suite", default="all", choices=[*SUITES, "all"],
                    help=f"one of {list(SUITES)} or 'all'")
    ap.add_argument("--pop", type=int, default=1 << 15)
    ap.add_argument("--parents", type=int, default=256)
    ap.add_argument("--log2", type=int, default=10)
    ap.add_argument("--gens", type=int, default=50)
    ap.add_argument("--fused", action="store_true", default=False)
    ap.add_argument("--engine", default="default", choices=list(ENGINES),
                    help="engine preset: 'flagship' = the bench.py config "
                         "(folded int8 + fused generation + order-7 sine)")
    ap.add_argument("--csv", default=None, help="CSV output path")
    ap.add_argument("--operand-cache", default=None, metavar="DIR",
                    help="disk cache for large-frame DFT operands "
                         "(ESConfig.operand_cache_dir)")
    return ap.parse_args(argv)


def main(argv=None, *, device: str | torch.device = "cuda"):
    """Run the suites ``argv`` names on ``device`` (the card unless the
    caller asks for the CPU) and write their CSV; returns 0."""
    from .device import resolve_device
    from .utils import Benchmarker

    args = parse_args(argv)
    args.device = resolve_device(device)
    # no enable_compile_cache(): kernels/_build.py builds once per source hash

    csv = args.csv or Benchmarker.log_filename("gpu_suite", args.pop, args.gens, 1 << args.log2)
    bm = Benchmarker(csv_path=csv, quiet=True, population=args.pop, generations=args.gens)
    names = list(SUITES) if args.suite == "all" else [args.suite]
    for name in names:
        print(f"=== {name} ===", flush=True)
        SUITES[name](args, bm)
    bm.close()
    print(f"wrote {csv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
