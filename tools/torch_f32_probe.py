"""B1/B2 true f32 on a card: the two synthesis layouts swept, and the paths
users run end to end, the earlier design and this one alternated.

The port's true-f32 B1/B2/B5 (``pmfm_tpu_torch.kernels.synth_fitness``)
synthesise each frame's samples one thread a candidate or, where
``f32_time_parallel`` picks it, in the time-parallel layout
(``csrc/fused_f32_tp.cu``); the two write the same samples bit for bit. At a
power-of-two frame the spectrum is the FFT (``csrc/fused_f32.cu::
f32_fft_kernel``), at any other the folded DFT (``f32_route``). This script,
in one process:

* ``sweep``: B2 f32's device time in both synthesis layouts
  (``chip_smoke.py::cuda_ms``, the median of SWEEP_LAUNCHES launches, the
  layouts alternated one-thread, time-parallel, time-parallel, one-thread)
  for the fixed chains and banks of SWEEP_TOPOLOGIES at n SWEEP_N over
  SWEEP_SHAPES, beside the one-thread grid's warps an SM and the layout the
  wrapper takes: the evidence for ``f32_time_parallel``'s rule;
* ``paths``: ``cli.main`` on examples/audio_match.json as written (cell
  (h)), with ``--mode stft`` (cell (m)) and ``--mode parallel-chunks`` (cell
  (n)), and the bench's ``value_shipped`` (``pmfm_tpu_torch.bench``, cell
  (g)'s f32 tail), each in turns old, new, new, old: old is the DFT route
  with one thread a candidate at every frame (``chip_smoke.py::f32_mode(sf,
  False, False)``: the parent's kernels with the fold between them), new the
  wrapper's choice; seconds of the host clock to the end of the run, and
  the true-f32 launches by route and layout;
* ``truth``: B1 true f32 at the planted truths of chip_smoke.py's bank
  checks (fitness ~1e-9) and a chain's, on the FFT route (which scores such
  exact matches by the direct sums, ``fused_f32.cu::FFT_EXACT_BELOW``) and
  on the DFT route, against the plain version and against a float64
  evaluation of the same samples.

Usage, on a machine with a CUDA card, from the repository's root::

    python3 tools/torch_f32_probe.py [--skip sweep paths truth] [--repeats 1]

Prints one line a measurement, each with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

AUDIO_CONFIG = os.path.join(ROOT, "examples", "audio_match.json")
SWEEP_TOPOLOGIES = ("fm2", "fm3_series", "fm4_series", "fm8_series", "fm2_parallel",
                    "fm3_parallel", "fm5_parallel")
SWEEP_N = (256, 1024, 2048)
# (frames, runs, populations): one-thread grids of 4 to 256 blocks of 128
SWEEP_SHAPES = ((1, 1, (512, 1024, 2048, 4096, 8192, 16384, 1 << 15)), (1, 8, (1024, 4096)),
                (8, 1, (1024, 4096, 8192)))
SWEEP_LAUNCHES = 10
ORDER = (False, True, True, False)
LAYOUTS = {False: "one-thread", True: "time-parallel"}
MODES = {False: "old (DFT, one thread)", True: "new"}


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
        return f"[{out[0]}]" if out else "[nvidia-smi: no output]"
    except (OSError, subprocess.SubprocessError) as e:
        return f"[nvidia-smi: {e}]"


def sweep_times(dev, card_name: str):
    """B2 f32's device ms in both synthesis layouts (the FFT route) over
    SWEEP_TOPOLOGIES x SWEEP_N x SWEEP_SHAPES, and the layout the wrapper
    takes."""
    from chip_smoke import cuda_ms, f32_mode, param_maxs
    from pmfm_tpu_torch.es import make_spectrum_ops
    from pmfm_tpu_torch.es.pipeline import fused_generation_kwargs
    from pmfm_tpu_torch.io import load_config
    from pmfm_tpu_torch.kernels import generation as gn
    from pmfm_tpu_torch.kernels import synth_fitness as sf
    from pmfm_tpu_torch.ops.synthesis import topology_dims

    base = load_config(AUDIO_CONFIG).es.refine_config()
    gen = torch.Generator().manual_seed(31)
    for topology in SWEEP_TOPOLOGIES:
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
                    for tp in ORDER:
                        with f32_mode(sf, True, tp):
                            times[tp].append(cuda_ms(call, SWEEP_LAUNCHES))
                    one, tp_ms = statistics.median(times[False]), statistics.median(times[True])
                    warps = sf.f32_pop_pad(pop) // 128 * runs * 4 / sf.SMS
                    pick = sf.f32_time_parallel(n, topology, pop, runs)
                    print(f"sweep {topology} n={n} F={frames} B={runs} P={pop}: one-thread "
                          f"{one:.4f} ms {[round(x, 4) for x in times[False]]}, time-parallel "
                          f"{tp_ms:.4f} ms {[round(x, 4) for x in times[True]]}, one-thread / "
                          f"time-parallel {one / tp_ms:.3f}; one-thread warps an SM "
                          f"{warps:.3f}; the wrapper takes {LAYOUTS[pick]} {card_name}",
                          flush=True)


def _counts():
    from collections import Counter

    from pmfm_tpu_torch.kernels import evolve as ev
    from pmfm_tpu_torch.kernels import generation as gn
    from pmfm_tpu_torch.kernels import synth_fitness as sf

    out = Counter()
    for fn in (sf.fused_synth_fitness, gn.fused_generation, ev.fused_evolve):
        out.update(fn.launches_by_f32)
        fn.launches_by_f32.clear()
    return dict(out)


def path_times(repeats: int, card_name: str):
    """``cli.main`` on AUDIO_CONFIG as written, with --mode stft and with
    --mode parallel-chunks, and the bench's value_shipped, old and new in
    turns."""
    from chip_smoke import f32_mode
    from pmfm_tpu_torch import bench, cli
    from pmfm_tpu_torch.kernels import synth_fitness as sf

    work = os.path.join(ROOT, "build", "f32_probe_paths")
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "input_audio"), os.path.join(work, "input_audio"))
    modes = {False: (False, False), True: (True, None)}
    try:
        for label, args in (("audio_match.json", []), ("--mode stft", ["--mode", "stft"]),
                            ("--mode parallel-chunks", ["--mode", "parallel-chunks"])):
            argv = ["-j", AUDIO_CONFIG, *args]
            secs = {False: [], True: []}
            for turn, new in enumerate((True,) + ORDER * repeats):  # turn 0: a warm-up
                out = io.StringIO()
                with f32_mode(sf, *modes[new]), contextlib.redirect_stdout(out):
                    _counts()
                    os.chdir(work)
                    try:
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        code = cli.main(argv)
                        torch.cuda.synchronize()
                        seconds = time.perf_counter() - t0
                    finally:
                        os.chdir(ROOT)
                    took = _counts()
                if code != 0:
                    raise SystemExit(f"{label} exited {code}:\n{out.getvalue()[-4000:]}")
                if turn:
                    secs[new].append(seconds)
                print(f"{label} (examples/audio_match.json as written), {MODES[new]}: "
                      f"{seconds:.3f} s; f32 launches by route and layout {took} {card_name}",
                      flush=True)
            print(f"{label} seconds, " + "; ".join(
                f"{MODES[m]} {[round(x, 3) for x in secs[m]]} mean {statistics.fmean(secs[m]):.3f}"
                for m in (False, True)) + f" {card_name}", flush=True)
        b = bench.Bench(bench.GENS, device=torch.device("cuda"))
        vals = {False: [], True: []}
        for new in ORDER * repeats:
            with f32_mode(sf, *modes[new]):
                ms = bench.best_ms(b.run_shipped, 1)
            vals[new].append(b.evals_per_sec(ms))
            print(f"bench value_shipped ({bench.GENS} generations), {MODES[new]}: "
                  f"{b.evals_per_sec(ms):.1f} evals/s ({ms / bench.GENS:.4f} ms/gen) {card_name}",
                  flush=True)
        print("bench value_shipped, " + "; ".join(
            f"{MODES[m]} {[round(x, 1) for x in vals[m]]} mean {statistics.fmean(vals[m]):.1f}"
            for m in (False, True)) + f" {card_name}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def truth_errors(dev, card_name: str):
    """B1 true f32 on the planted truths of chip_smoke.py's bank checks
    (phases 20, 32, 41: fitness ~1e-9 against a population median ~1e-1)
    and a chain's (phase 32's fm16_series), against the plain version
    (cuBLAS SGEMM of the folded operand) and a float64 evaluation of the
    same samples (``synth_f32_plain``'s, the kernel's bit for bit; numpy's
    FFT of the windowed frame, magnitudes, squared differences and sum in
    float64): the FFT route and the DFT route, and each one's and the plain
    version's distance from float64 at the truth and at the random
    candidates."""
    import numpy as np

    import chip_smoke as cs
    from chip_smoke import f32_mode
    from pmfm_tpu_torch.kernels import synth_fitness as sf
    from pmfm_tpu_torch.ops import spectral, synthesize_single, target_spectrum

    cases = (("fm3_parallel", cs.PARALLEL_TRUTH[:12], 1024, 8192),
             ("fm5_parallel", cs.WIDE_TRUTHS["fm5_parallel"], 1024, 8192),
             ("fm9_parallel", cs.LONG_TRUTHS["fm9_parallel"], 1024, 1 << 15),
             ("fm16_series", cs.WIDE_TRUTHS["fm16_series"], 1024, 8192))
    for topology, truth, n, pop in cases:
        so = spectral.make_spectrum_ops(n, None, dft_dtype="float32", device=dev)
        tgt = target_spectrum(synthesize_single(torch.tensor(truth), n, topology).to(dev), so)
        d = len(truth)
        rng = np.random.default_rng(7)
        p = rng.random((pop, d)) * np.asarray(cs.param_maxs(topology))
        p[0] = truth
        p = torch.from_numpy(p.astype(np.float32)).to(dev)
        kw = dict(dft_packed=so.dft_packed, dft_scale=0.0, topology=topology, n=n,
                  pop_block=pop, sine_order=9)
        plain = sf.fused_synth_fitness_plain(p, tgt, **kw).double().cpu().numpy()
        got = {}
        for fft in (True, False):
            with f32_mode(sf, fft):
                fit = sf.fused_synth_fitness(p, tgt, **kw)
            got["fft" if fft else "dft"] = fit.double().cpu().numpy()
        inv_sr = sf.inv_sample_rate(sf.DEFAULT_WAVETABLE_SIZE, sf.DEFAULT_SAMPLE_RATE)
        x = sf.synth_f32_plain(p[:64], topology=topology, n=n, sine_order=9, inv_sr=inv_sr)
        x = x.T.double().cpu().numpy()
        w = spectral.hann_window(n) / (n * spectral.window_factor(n))
        spec = np.abs(np.fft.fft(x * w, axis=1)[:, : n // 2])
        f64 = ((spec - tgt.double().cpu().numpy()) ** 2).sum(axis=1)
        rel = lambda a, b: np.abs(a - b) / np.abs(b)  # noqa: E731
        line = [f"{name} vs plain {rel(v[0], plain[0]):.3e} (rest max "
                f"{rel(v[1:], plain[1:]).max():.3e}), vs float64 {rel(v[0], f64[0]):.3e} (rest "
                f"max {rel(v[1:64], f64[1:]).max():.3e})" for name, v in got.items()]
        print(f"truth {topology} n={n} P={pop}: truth fitness {plain[0]:.4e} (median "
              f"{np.median(plain):.4e}); plain vs float64 {rel(plain[0], f64[0]):.3e} (rest max "
              f"{rel(plain[1:64], f64[1:]).max():.3e}); " + "; ".join(line) + f" {card_name}",
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=1, help="rounds of old, new, new, old")
    ap.add_argument("--skip", nargs="*", default=(), choices=("sweep", "paths", "truth"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card_name = card()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    steps = (("sweep", lambda: sweep_times(dev, card_name)),
             ("paths", lambda: path_times(args.repeats, card_name)),
             ("truth", lambda: truth_errors(dev, card_name)))
    for name, step in steps:
        if name not in args.skip:
            t0 = time.perf_counter()
            step()
            print(f"({name}: {time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
