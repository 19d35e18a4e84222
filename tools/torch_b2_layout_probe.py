"""B2 int8's two layouts, kernel by kernel and end to end, on a card.

The port's B2 (``pmfm_tpu_torch.kernels.generation.fused_generation``) runs
int8 on a fixed chain or a fixed bank of 2-5 pairs in its time-parallel
layout (``csrc/fused_tp.cuh``) where ``generation.time_parallel`` picks it,
else in the one-warp layout (``csrc/fused_eval.cu``); the two give the same
results bit for bit. This script holds them against each other in one
process, the layouts alternated one-warp, time-parallel, time-parallel,
one-warp (the time-parallel one forced wherever its kernel takes the shape,
as ``chip_smoke.py::gen_layout`` forces it):

* ``sweep``: B2's device time in both layouts (``chip_smoke.py::cuda_ms``,
  the median of SWEEP_LAUNCHES launches, SWEEP_ROUNDS rounds of the four)
  for every fixed chain and bank at n 256 to 2048 over SWEEP_SHAPES (one
  frame, one run, P 4096 to 2^15; 8 runs; 8 frames), beside the layout the
  wrapper takes: the evidence for ``time_parallel``'s rule;
* ``modes``: ``cli.main`` on examples/audio_match.json as written with
  ``--mode stft`` and ``--mode parallel-chunks``, seconds and B2 launches
  by layout, MODE_REPEATS rounds of the four;

* ``b2``: at n 1024, P 8192 (the pursuit's polishes) on fm3_parallel and
  fm5_parallel, the wrapper's host time a call (HOST_CALLS calls on the host
  clock, no synchronise between) and the device time of back-to-back calls
  (CUDA events);
* ``evolve``: ``es.evolve`` under B2 at the same shape, GENERATIONS
  generations with the trajectory recorded (no synchronise a generation)
  and with the early-stop check under a threshold no run meets (a copy to
  the host a generation, as the pursuit's polishes make), ms a generation;
* ``pursuit``: ``cli.main`` on examples/fm3_parallel_match.json as written,
  the seconds of each chunk's block, alias and final stages;
* ``timeline``: one ``torch.profiler`` trace a layout of the same pursuit
  with its stages' generations cut by ``--cut`` and one attempt: over its B2
  kernels, the medians of the kernel's time, of the device's idle gap
  before it and of the interval from one B2 start to the next.

Usage, on a machine with a CUDA card, from the repository's root::

    python3 tools/torch_b2_layout_probe.py [--repeats 1] [--cut 10] [--skip pursuit]
    python3 tools/torch_b2_layout_probe.py --skip b2 evolve timeline pursuit  # sweep, modes

Prints one line a measurement, each with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import inspect
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

CONFIG = os.path.join(ROOT, "examples", "fm3_parallel_match.json")
AUDIO_CONFIG = os.path.join(ROOT, "examples", "audio_match.json")
SWEEP_N = (256, 512, 1024, 2048)
# (frames, runs, populations): one-warp grids of 128 .. 8192 blocks of 32
SWEEP_SHAPES = ((1, 1, (4096, 8192, 16384, 1 << 15)), (1, 8, (4096, 1 << 15)),
                (8, 1, (4096, 1 << 15)))
SWEEP_LAUNCHES = 10
SWEEP_ROUNDS = 2  # rounds of ORDER a point
MODE_REPEATS = 1
WORK = os.path.join(ROOT, "build", "b2_layout_probe")
HOST_CALLS = 200
TIMED_CALLS = 50
GENERATIONS = 1000
EARLY_STOP = 1e-12  # a fitness threshold no run meets: the check runs every generation
BANK_MAXS = (3520.0, 8.0, 3520.0, 1.0)
LAYOUTS = {False: "one-warp", True: "time-parallel"}
ORDER = (False, True, True, False)
B2_KERNEL = "fused_generation_int8"


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
        return f"[{out[0]}]" if out else "[nvidia-smi: no output]"
    except (OSError, subprocess.SubprocessError) as e:
        return f"[nvidia-smi: {e}]"


def layout(time_parallel: bool):
    """B2's wrapper in one layout (``chip_smoke.py::gen_layout``), restored
    after."""
    from chip_smoke import gen_layout
    from pmfm_tpu_torch.kernels import generation as gn

    return gen_layout(gn, time_parallel)


def bank_config(topology: str):
    from pmfm_tpu_torch.io import load_config
    from pmfm_tpu_torch.ops.synthesis import topology_dims

    d = topology_dims(topology)
    return load_config(CONFIG).es.replace(topology=topology, num_dimensions=d,
                                          param_mins=(0.0,) * d,
                                          param_maxs=BANK_MAXS * (d // 4))


def b2_times(dev, card_name: str):
    """The wrapper's host ms a call and the back-to-back device ms a call."""
    from pmfm_tpu_torch.es import make_spectrum_ops
    from pmfm_tpu_torch.es.pipeline import fused_generation_kwargs
    from pmfm_tpu_torch.kernels import generation as gn

    gen = torch.Generator().manual_seed(19)
    for topology in ("fm3_parallel", "fm5_parallel"):
        cfg = bank_config(topology)
        so = make_spectrum_ops(cfg, device=dev)
        kw = dict(fused_generation_kwargs(cfg, so), pop_block=cfg.population_size)
        d, mu = cfg.num_dimensions, cfg.num_parents
        pv = torch.rand(mu, d, generator=gen).to(dev)
        ps = (0.02 + 0.28 * torch.rand(mu, d, generator=gen)).to(dev)
        tgt = (50 * torch.rand(so.num_bins, generator=gen)).to(dev)
        for tp in ORDER:
            with layout(tp):
                gn.fused_generation.launches_by_layout.clear()
                call = lambda: gn.fused_generation(7, pv, ps, tgt, **kw)  # noqa: E731
                call()
                torch.cuda.synchronize()
                h0 = time.perf_counter()
                for _ in range(HOST_CALLS):
                    call()
                host = (time.perf_counter() - h0) / HOST_CALLS * 1e3
                torch.cuda.synchronize()
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_CALLS + 1)]
                ev[0].record()
                for e in ev[1:]:
                    call()
                    e.record()
                ev[-1].synchronize()
                dms = statistics.median(a.elapsed_time(b) for a, b in zip(ev, ev[1:]))
                took = dict(gn.fused_generation.launches_by_layout)
            print(f"b2 {topology} n={cfg.n_samples} P={cfg.population_size} {LAYOUTS[tp]}: "
                  f"host {host:.4f} ms a call, back-to-back device {dms:.4f} ms a call; "
                  f"launches {took} {card_name}", flush=True)


def evolve_times(dev, card_name: str):
    """es.evolve under B2: ms a generation without and with the early-stop check."""
    from pmfm_tpu_torch.es import evolve, init_state, make_spectrum_ops

    gen = torch.Generator().manual_seed(23)
    for topology in ("fm3_parallel", "fm5_parallel"):
        cfg = bank_config(topology)
        so = make_spectrum_ops(cfg, device=dev)
        tgt = (50 * torch.rand(so.num_bins, generator=gen)).to(dev)
        evolve(init_state(1, cfg, device=dev), tgt, 2, so, cfg)  # warm-up
        for tp in ORDER:
            row = []
            for checked in (False, True):
                run_cfg = cfg.replace(fitness_threshold=EARLY_STOP if checked else 0.0)
                with layout(tp):
                    state = init_state(7, cfg, device=dev)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    evolve(state, tgt, GENERATIONS, so, run_cfg, record_trajectory=not checked)
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t0) / GENERATIONS * 1e3
                row.append(f"{'early-stop check' if checked else 'trajectory'} {ms:.4f}")
            print(f"evolve {topology} P={cfg.population_size} {GENERATIONS} generations "
                  f"{LAYOUTS[tp]}: ms a generation {', '.join(row)} {card_name}", flush=True)


def sweep_times(dev, card_name: str):
    """B2's device ms in both layouts over the fixed chains and banks x
    SWEEP_N x SWEEP_SHAPES, and the layout the wrapper takes."""
    from chip_smoke import cuda_ms, param_maxs
    from pmfm_tpu_torch.es import make_spectrum_ops
    from pmfm_tpu_torch.es.pipeline import fused_generation_kwargs
    from pmfm_tpu_torch.io import load_config
    from pmfm_tpu_torch.kernels import generation as gn
    from pmfm_tpu_torch.ops.synthesis import topology_dims

    base = load_config(AUDIO_CONFIG).es
    gen = torch.Generator().manual_seed(29)
    topologies = sorted(gn.TP_CHAINS, key=topology_dims) + sorted(gn.TP_BANKS, key=topology_dims)
    for topology in topologies:
        d = topology_dims(topology)
        for n in SWEEP_N:
            for frames, runs, pops in SWEEP_SHAPES:
                for pop in pops:
                    cfg = base.replace(topology=topology, num_dimensions=d,
                                       param_mins=(0.0,) * d, param_maxs=param_maxs(topology),
                                       audio_length_log2=n.bit_length() - 1, num_frames=frames)
                    so = make_spectrum_ops(cfg, device=dev)
                    kw = dict(fused_generation_kwargs(cfg, so), pop=pop)
                    mu, lead = cfg.num_parents, (runs,) if runs > 1 else ()
                    pv = torch.rand(*lead, mu, d, generator=gen).to(dev)
                    ps = (0.02 + 0.28 * torch.rand(*lead, mu, d, generator=gen)).to(dev)
                    tgt = (50 * torch.rand(*lead, frames, so.num_bins, generator=gen)).to(dev)
                    seed = [7 + r for r in range(runs)] if runs > 1 else 7
                    call = lambda: gn.fused_generation(seed, pv, ps, tgt, **kw)  # noqa: E731
                    times = {False: [], True: []}
                    for tp in ORDER * SWEEP_ROUNDS:
                        with layout(tp):
                            times[tp].append(cuda_ms(call, SWEEP_LAUNCHES))
                    ow, tp_ms = statistics.median(times[False]), statistics.median(times[True])
                    pick = gn.time_parallel(n, so.num_bins, d, topology, "int8", frames, pop, runs)
                    print(f"sweep {topology} n={n} F={frames} B={runs} P={pop}: one-warp "
                          f"{ow:.4f} ms {[round(x, 4) for x in times[False]]}, time-parallel "
                          f"{tp_ms:.4f} ms {[round(x, 4) for x in times[True]]}, one-warp / "
                          f"time-parallel {ow / tp_ms:.3f} (medians; worst pair "
                          f"{min(times[False]) / max(times[True]):.3f}); one-warp blocks "
                          f"{-(-pop // 32) * runs}; the wrapper takes "
                          f"{LAYOUTS[pick]} {card_name}", flush=True)


def mode_times(repeats: int, card_name: str):
    """``cli.main`` on AUDIO_CONFIG with --mode stft and --mode
    parallel-chunks, the layouts alternated."""
    from pmfm_tpu_torch import cli
    from pmfm_tpu_torch.kernels import generation as gn

    work = os.path.join(ROOT, "build", "b2_layout_modes")
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "input_audio"), os.path.join(work, "input_audio"))
    try:
        for mode in ("stft", "parallel-chunks"):
            args = ["-j", AUDIO_CONFIG, "--mode", mode]
            with contextlib.redirect_stdout(io.StringIO()):
                os.chdir(work)
                try:
                    cli.main(args)  # warm-up: builds and caches every shape
                finally:
                    os.chdir(ROOT)
            secs = {False: [], True: []}
            for _ in range(repeats):
                for tp in ORDER:
                    out = io.StringIO()
                    with layout(tp), contextlib.redirect_stdout(out):
                        gn.fused_generation.launches_by_layout.clear()
                        os.chdir(work)
                        try:
                            torch.cuda.synchronize()
                            t0 = time.perf_counter()
                            code = cli.main(args)
                            torch.cuda.synchronize()
                            seconds = time.perf_counter() - t0
                        finally:
                            os.chdir(ROOT)
                        took = dict(gn.fused_generation.launches_by_layout)
                    if code != 0:
                        raise SystemExit(f"--mode {mode} exited {code}:\n{out.getvalue()[-4000:]}")
                    secs[tp].append(seconds)
                    print(f"--mode {mode} audio_match.json as written, {LAYOUTS[tp]}: "
                          f"{seconds:.3f} s; B2 launches by layout {took} {card_name}",
                          flush=True)
            print(f"--mode {mode} seconds, " + "; ".join(
                f"{LAYOUTS[tp]} {[round(x, 3) for x in secs[tp]]} mean "
                f"{statistics.fmean(secs[tp]):.3f}" for tp in (False, True)) + f" {card_name}",
                flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def cut_loader(load, cut: int):
    """``load_config`` with each pursuit stage's generations cut by ``cut``
    (at least 1) and one attempt."""
    from pmfm_tpu_torch.es import staged

    defaults = inspect.signature(staged._pursuit_attempt).parameters

    def loader(path):
        rc = load(path)
        p = dict(rc.pursuit, maxAttempts=1)
        for key, snake in staged.CONFIG_KEY_MAP.items():
            if key.endswith("Generations"):
                p[key] = max(1, int(p.get(key, defaults[snake].default)) // cut)
        return dataclasses.replace(rc, pursuit=tuple(sorted(p.items())))

    return loader


STAGES = re.compile(r"seconds block ([\d.]+)s, alias ([\d.]+)s, final ([\d.]+)s")


def run_cli(loader=None) -> tuple[float, list]:
    """``cli.main`` on CONFIG in WORK (through ``loader`` if given): its
    seconds and each chunk's (block, alias, final) seconds."""
    import pmfm_tpu_torch.io
    from pmfm_tpu_torch import cli

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    load = pmfm_tpu_torch.io.load_config
    if loader is not None:
        pmfm_tpu_torch.io.load_config = loader
    out = io.StringIO()
    try:
        os.chdir(WORK)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            code = cli.main(["-j", CONFIG])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        os.chdir(ROOT)
        pmfm_tpu_torch.io.load_config = load
        shutil.rmtree(WORK, ignore_errors=True)
    if code != 0:
        raise SystemExit(f"cli.main exited {code}:\n{out.getvalue()[-4000:]}")
    stages = [tuple(float(x) for x in m.groups()) for m in STAGES.finditer(out.getvalue())]
    return seconds, stages


def pursuit_times(repeats: int, card_name: str):
    from pmfm_tpu_torch.kernels import generation as gn

    alias = {False: [], True: []}
    for _ in range(repeats):
        for tp in ORDER:
            with layout(tp):
                gn.fused_generation.launches_by_layout.clear()
                seconds, stages = run_cli()
                took = dict(gn.fused_generation.launches_by_layout)
            alias[tp].append(sum(s[1] for s in stages))
            print(f"pursuit fm3_parallel_match.json as written {LAYOUTS[tp]}: {seconds:.2f} s; "
                  f"chunks (block, alias, final) s {stages}; B2 launches {took} {card_name}",
                  flush=True)
    print("pursuit alias seconds, " + "; ".join(
        f"{LAYOUTS[tp]} {[round(x, 2) for x in alias[tp]]} mean "
        f"{statistics.fmean(alias[tp]):.2f}" for tp in (False, True)) + f" {card_name}",
        flush=True)


def b2_gaps(events: list) -> dict:
    """Over the B2 kernels of a chrome trace's kernel events (dicts with
    ``name``, ``ts`` and ``dur`` in us): their count and the medians of the
    kernel's time, of the idle gap before it (from the end of the latest
    kernel before it) and of the interval from one B2 start to the next."""
    kernels = sorted((e for e in events if e.get("cat") == "kernel"), key=lambda e: e["ts"])
    durs, gaps, periods, end, last = [], [], [], None, None
    for e in kernels:
        if B2_KERNEL in e["name"]:
            durs.append(e["dur"])
            if end is not None:
                gaps.append(max(0.0, e["ts"] - end))
            if last is not None:
                periods.append(e["ts"] - last)
            last = e["ts"]
        end = e["ts"] + e["dur"] if end is None else max(end, e["ts"] + e["dur"])
    med = lambda xs: statistics.median(xs) if xs else float("nan")  # noqa: E731
    return dict(b2=len(durs), kernel_us=med(durs), gap_before_us=med(gaps),
                period_us=med(periods), busy_us=sum(e["dur"] for e in kernels),
                span_us=(kernels[-1]["ts"] + kernels[-1]["dur"] - kernels[0]["ts"])
                if kernels else 0.0)


def timelines(cut: int, card_name: str):
    import pmfm_tpu_torch.io
    from torch.profiler import ProfilerActivity, profile

    loader = cut_loader(pmfm_tpu_torch.io.load_config, cut)
    run_cli(loader)  # warm-up at the cut shapes
    for tp in (False, True):
        with layout(tp), profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
            seconds, stages = run_cli(loader)
        with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        g = b2_gaps(events)
        print(f"timeline fm3_parallel pursuit, stage generations / {cut}, {LAYOUTS[tp]} (under "
              f"the profiler): {seconds:.2f} s, chunks (block, alias, final) s {stages}; "
              f"{g['b2']} B2 kernels, median us: kernel {g['kernel_us']:.1f}, idle gap before "
              f"{g['gap_before_us']:.1f}, B2 start to next B2 start {g['period_us']:.1f}; "
              f"kernels busy {g['busy_us'] / 1e6:.3f} s of a {g['span_us'] / 1e6:.3f} s span "
              f"{card_name}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=1,
                    help="rounds of the pursuit as written (each one-warp, "
                         "time-parallel, time-parallel, one-warp)")
    ap.add_argument("--cut", type=int, default=10,
                    help="the timeline's cut of each stage's generations")
    ap.add_argument("--skip", nargs="*", default=(),
                    choices=("b2", "evolve", "pursuit", "timeline", "sweep", "modes"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card_name = card()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    steps = (("sweep", lambda: sweep_times(dev, card_name)),
             ("modes", lambda: mode_times(max(args.repeats, MODE_REPEATS), card_name)),
             ("b2", lambda: b2_times(dev, card_name)),
             ("evolve", lambda: evolve_times(dev, card_name)),
             ("timeline", lambda: timelines(args.cut, card_name)),
             ("pursuit", lambda: pursuit_times(args.repeats, card_name)))
    for name, step in steps:
        if name not in args.skip:
            t0 = time.perf_counter()
            step()
            print(f"({name}: {time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
