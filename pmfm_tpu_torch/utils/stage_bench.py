"""Per-pipeline-stage timing rows for the CLI (port of
``pmfm_tpu/utils/stage_bench.py``).

The reference ends every ``parameterMatchAudio`` run by flushing one CSV row
per pipeline kernel (Evolutionary_Strategy_OpenCL.hpp:601-609), with the
kernel names from its enum: ``recombinePopulation, mutatePopulation,
synthesisePopulation*, applyWindowPopulation, openCLFFT, fitnessPopulation,
sortPopulation, rotatePopulation`` followed by ``Total Audio Analysis Time``.

The port's generation is a few fused launches, so per-stage times are not
collected from the run itself: when ``isBenchmarking`` is on, the CLI calls
:func:`record_stage_rows` once after the match, which re-runs each stage
standalone under the run's config and engine and feeds its milliseconds per
call to the Benchmarker. On the card each repetition is ``iters`` calls
between two CUDA events (device time, no host wait between calls); on the
CPU the host clock.

Stage mapping (the reference's notes):

* ``applyWindowPopulation`` times the explicit ``audio * window`` multiply;
  the DFT engines fold the window into their operands.
* ``openCLFFT`` times this config's spectrum (``ops/spectral.py::
  magnitude_spectrum``: the matmul DFT, the factored DFT or cuFFT).
* ``sortPopulation`` times truncation selection (``torch.topk`` and the
  survivor gathers).
* ``rotatePopulation`` is flushed as an empty row: functional updates remove
  the ping-pong rotation; the row keeps the CSVs row-aligned.
"""
from __future__ import annotations

import time
from typing import Callable

import torch


def synthesis_stage_name(topology: str) -> str:
    """The reference kernel-enum name for this topology's synthesis stage."""
    return {
        "fm2": "synthesisePopulation",
        "fm3_series": "synthesisePopulationDoubleSeries",
        "fm3_parallel": "synthesisePopulationTripleParallel",
    }.get(topology, f"synthesisePopulation_{topology}")


def timed_loop(stage_fn: Callable, x: torch.Tensor, iters: int = 20) -> float:
    """Milliseconds per call of ``stage_fn(x)``, over ``iters`` calls after
    one warm-up: CUDA events around the calls on the card, the host clock on
    the CPU."""
    stage_fn(x)
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            stage_fn(x)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        stage_fn(x)
    return (time.perf_counter() - t0) / iters * 1e3


def record_stage_rows(bm, cfg, *, device: str | torch.device = "cuda", reps: int | None = None,
                      iters: int | None = None) -> None:
    """Time every reference pipeline stage under this run's config on
    ``device`` and flush one Benchmarker row per stage, in the reference's
    names and order. ``reps`` timed repetitions per stage fill the Max/Min
    and jitter columns: by default 5 of 20 calls on the card, 2 of 1 on the
    CPU (where the scan synthesis is a Python loop over samples)."""
    from ..es.pipeline import make_spectrum_ops
    from ..es.strategy import evaluate, mutate, recombine, select
    from ..ops import synthesize
    from ..ops.spectral import magnitude_spectrum, spectral_fitness

    dev = torch.device(device)
    if reps is None:
        reps = 5 if dev.type == "cuda" else 2
    if iters is None:
        iters = 20 if dev.type == "cuda" else 1
    so = make_spectrum_ops(cfg, device=dev)
    pop, d, mu = cfg.population_size, cfg.num_dimensions, cfg.num_parents
    n = cfg.n_samples * cfg.num_frames
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    values = torch.rand((pop, d), generator=gen, device=dev)
    steps = torch.full_like(values, 0.1)
    mins = torch.tensor(cfg.param_mins, dtype=torch.float32, device=dev)
    maxs = torch.tensor(cfg.param_maxs, dtype=torch.float32, device=dev)
    scaled = values * (maxs - mins) + mins
    audio = torch.randn((cfg.n_samples, pop), generator=gen, device=dev)
    fitness = torch.rand((pop,), generator=gen, device=dev)
    spectra = torch.rand((pop, so.num_bins), generator=gen, device=dev)
    # the fused row's target: (F, K) at several frames, as the engines take it
    tspec = torch.ones((*((cfg.num_frames,) if cfg.num_frames > 1 else ()), so.num_bins),
                       dtype=torch.float32, device=dev)

    stages = [
        ("recombinePopulation",
         lambda v: recombine(gen, v[:mu], steps[:mu], cfg)[0], values),
        ("mutatePopulation", lambda v: mutate(gen, v, steps, cfg)[0], values),
        (synthesis_stage_name(cfg.topology),
         lambda p: synthesize(p, n, cfg.topology, wavetable_size=cfg.wavetable_size,
                              sample_rate=cfg.sample_rate, osc_mode=cfg.osc_mode,
                              engine=cfg.synthesis_engine), scaled),
        ("applyWindowPopulation", lambda a: a * so.window[:, None], audio),
        ("openCLFFT", lambda a: magnitude_spectrum(a, so), audio),
        ("fitnessPopulation",
         lambda s: spectral_fitness(s, tspec[0] if cfg.num_frames > 1 else tspec), spectra),
        ("sortPopulation", lambda f: select(values, steps, f, mu)[2], fitness),
    ]
    # the fused engines run stages 4-7 as one kernel: report that too (an
    # extra row, as the reference adds)
    if cfg.fused_kernel or cfg.fused_generation:
        stages.append(("evaluateFused(synth+window+FFT+fitness)",
                       lambda v: evaluate(v, tspec, so, cfg), values))

    for name, fn, x in stages:
        for _ in range(reps):
            bm.add_timer(name, timed_loop(fn, x, iters=iters))
        bm.elapsed_timer(name)
    bm.elapsed_timer("rotatePopulation")
