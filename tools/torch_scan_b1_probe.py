"""The scan synthesis' and B1 int8's layouts, kernel by kernel and end to end, on a card.

The port's scan synthesis (``pmfm_tpu_torch.kernels.scan.scan_synth``) runs
one thread a candidate (``csrc/scan_synth.cu``) or, where
``scan.scan_time_parallel`` says, level by level with the time split into
chunks (``csrc/scan_synth_tp.cu``); B1 int8
(``kernels.synth_fitness.fused_synth_fitness``) runs its one-warp layout or,
where B2's rule (``generation.time_parallel``) says, B2's time-parallel
layout (``csrc/fused_tp.cuh``). Each pair gives the same results bit for bit. This
script holds them against each other in one process, alternated old, new,
new, old (the new layout forced wherever its kernel takes the shape; on a
tree without it, the old layout alone):

* ``ptxas``: registers and spill stores of the scan kernels and of every
  time-parallel B1/B2 instantiation, from the build's ``-Xptxas -v`` report;
* ``b1``: B1 int8's device time (``chip_smoke.py::cuda_ms``, the median of
  B1_LAUNCHES launches) over B1_SHAPES (P 1: the pursuit's seed rescores;
  P 32, 8192; F 8 x P 4096 and 8 runs x P 4096 at n 2048; the bench shape),
  and at P 1 the host time of one wrapper call (HOST_CALLS calls, a
  synchronise after each);
* ``b2tp``: B2 int8's device time in the time-parallel layout alone over
  B2TP_SHAPES (every fixed chain and bank at sine order 9, n 1024, P 8192;
  F 8 x P 4096 at n 2048): the same kernel before and after a change to
  ``csrc/fused_tp.cuh``, run from a checkout of each in turns;
* ``scan``: the scan's device time over SCAN_POPS x SCAN_N x SCAN_TOPOLOGIES
  (float32, floor; the wrapper's group and warps), and the chain floor
  (``scan.chain_floor_ms``) where the tree has it;
* ``scan_groups``: the time-parallel scan's device time by candidates a
  block and warps a block over GROUP_POPS x SCAN_N x SCAN_TOPOLOGIES, beside
  one thread a candidate's;
* ``launches``: B1's launches by shape (P, runs, frames, n, genes) in
  ``cli.main`` on examples/fm3_parallel_match.json as written and on the
  fm5_parallel pursuit cut as ``chip_smoke.py`` phase 33 cuts it;
* ``cell_i``: ``cli.main`` on parameters.json (cell (i)): seconds and ms a
  generation in turns, then one ``torch.profiler`` trace: device ms a
  generation by kernel, launches a generation and the card's idle share
  (the share of the span of its kernels in which none runs);
* ``pursuit``: ``cli.main`` on examples/fm3_parallel_match.json as written,
  its seconds and B1's launches by shape and layout.

End to end, old against new is the parent commit against this one: run
``--skip ptxas b1 scan launches`` from a checkout of each, in turns (the
script degrades to the old layouts on a tree without the new ones).

Usage, on a machine with a CUDA card, from the repository's root::

    python3 tools/torch_scan_b1_probe.py [--skip scan pursuit | --only b2tp] [--repeats 1]

Prints one line a measurement, each with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
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

BANK_CONFIG = os.path.join(ROOT, "examples", "fm3_parallel_match.json")
AUDIO_CONFIG = os.path.join(ROOT, "examples", "audio_match.json")
CELL_I_CONFIG = os.path.join(ROOT, "parameters.json")
WORK = os.path.join(ROOT, "build", "scan_b1_probe")
# (topology, n, frames, runs, pops): the pursuit's seed rescores (P 1) and
# the rule's check points at n 1024; --mode stft and the run axis at n 2048
B1_SHAPES = tuple((t, 1024, 1, 1, (1, 32, 8192)) for t in (
    "fm2", "fm2_parallel", "fm3_parallel", "fm4_parallel", "fm5_parallel", "fm3_series",
    "fm4_series", "fm5_series", "fm8_series")) + (
    ("fm3_series", 2048, 8, 1, (4096,)), ("fm3_series", 2048, 1, 8, (4096,)),
    ("fm3_series", 1024, 1, 1, (1 << 15,)))
B1_LAUNCHES = 50
B2_BESIDE_POPS = (8192,)  # B1's populations at which B2 is timed beside it
# (topology, n, frames, pop) of the b2tp step
B2TP_SHAPES = tuple((t, 1024, 1, 8192) for t in (
    "fm2", "fm3_series", "fm4_series", "fm5_series", "fm6_series", "fm7_series", "fm8_series",
    "fm2_parallel", "fm3_parallel", "fm4_parallel", "fm5_parallel")) + (
    ("fm3_series", 2048, 8, 4096),)
B2TP_REPEATS = 3
HOST_CALLS = 100
# P 8192 is the last population the rule sends to the time-parallel layout
# (66 one-thread blocks: P <= 8448); 12288 and 16384 lie between it and 2^15
SCAN_POPS = (1, 32, 256, 2048, 8192, 12288, 16384, 1 << 15)
SCAN_N = (1024, 2048)
SCAN_TOPOLOGIES = ("fm2", "fm3_series", "fm8_series", "fm3_parallel")
SCAN_LAUNCHES = 10
GROUP_POPS = (256, 2048, 8192, 1 << 15)
ORDER = (False, True, True, False)
NAMES = {False: "old", True: "new"}


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
        return f"[{out[0]}]" if out else "[nvidia-smi: no output]"
    except (OSError, subprocess.SubprocessError) as e:
        return f"[nvidia-smi: {e}]"


def b1_layout(new: bool):
    """B1 int8 in one layout: B2's rule forced (``chip_smoke.py::gen_layout``)
    to the time-parallel one wherever its kernel takes the shape (new), or
    to the one-warp one; a tree whose B1 has one layout runs it either way."""
    from chip_smoke import gen_layout
    from pmfm_tpu_torch.kernels import generation as gn

    return gen_layout(gn, new)


def scan_layout(new: bool):
    """The scan synthesis in one layout (``chip_smoke.py::scan_layout`` where
    the tree has it, else its one layout)."""
    import chip_smoke
    from pmfm_tpu_torch.kernels import scan as ss

    if not hasattr(chip_smoke, "scan_layout"):
        return contextlib.nullcontext()
    return chip_smoke.scan_layout(ss, new)


def has_new(module: str) -> bool:
    """Whether the tree has the new layout of ``module`` ("scan" or "b1")."""
    from pmfm_tpu_torch.kernels import scan as ss
    from pmfm_tpu_torch.kernels import synth_fitness as sf

    if module == "scan":
        return hasattr(ss, "scan_time_parallel")
    return hasattr(sf.fused_synth_fitness, "launches_by_layout")


def ptxas(card_name: str):
    from chip_smoke import ptxas_summary
    from pmfm_tpu_torch.kernels import _build

    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    info = _build.build()
    for name, regs, spill in ptxas_summary(info["log"]):
        if name.startswith(("scan_synth", "fused_generation_int8_tp", "fused_synth_fitness_int8_tp",
                            "tp_int8")):
            print(f"ptxas {name}: {regs} registers, {spill} bytes spill stores", flush=True)
    for ln in info["log"].splitlines():
        if ln.startswith("nvcc "):
            print(f"  {ln}", flush=True)
    print(f"build {info['seconds']:.1f} s {card_name}", flush=True)


def b1_inputs(dev, topology: str, n: int, frames: int, runs: int, pop: int, gen):
    from chip_smoke import param_maxs
    from pmfm_tpu_torch.es import make_spectrum_ops
    from pmfm_tpu_torch.io import load_config
    from pmfm_tpu_torch.ops.synthesis import topology_dims

    d = topology_dims(topology)
    base = load_config(AUDIO_CONFIG if n == 2048 else BANK_CONFIG).es
    cfg = base.replace(topology=topology, num_dimensions=d, param_mins=(0.0,) * d,
                       param_maxs=param_maxs(topology), audio_length_log2=n.bit_length() - 1,
                       num_frames=frames, sine_order=9)
    so = make_spectrum_ops(cfg, device=dev)
    lead = (runs,) if runs > 1 else ()
    maxs = torch.tensor(cfg.param_maxs)
    p = (torch.rand(*lead, pop, d, generator=gen) * maxs).to(dev)
    tshape = (*lead, frames, so.num_bins) if frames > 1 else (*lead, so.num_bins)
    tgt = (50 * torch.rand(*tshape, generator=gen)).to(dev)
    kw = dict(dft_packed=so.dft_packed, dft_scale=so.dft_packed_scale, topology=topology, n=n,
              num_frames=frames, sine_order=9)
    return p, tgt, kw, so.num_bins, d


def b1_times(dev, card_name: str):
    from chip_smoke import cuda_ms, param_maxs
    from pmfm_tpu_torch.kernels import generation as gn
    from pmfm_tpu_torch.kernels import synth_fitness as sf

    layouts = ORDER if has_new("b1") else (False,)
    gen = torch.Generator().manual_seed(31)
    for topology, n, frames, runs, pops in B1_SHAPES:
        for pop in pops:
            p, tgt, kw, k, d = b1_inputs(dev, topology, n, frames, runs, pop, gen)
            call = lambda: sf.fused_synth_fitness(p, tgt, **kw)  # noqa: E731
            times, host, took = {False: [], True: []}, {False: [], True: []}, {}
            for new in layouts:
                with b1_layout(new):
                    by = getattr(sf.fused_synth_fitness, "launches_by_layout", collections.Counter())
                    by.clear()
                    times[new].append(cuda_ms(call, B1_LAUNCHES))
                    took[new] = dict(by)
                    if pop == 1:
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        for _ in range(HOST_CALLS):
                            call()
                            torch.cuda.synchronize()
                        host[new].append((time.perf_counter() - t0) / HOST_CALLS * 1e3)
            pick = has_new("b1") and gn.time_parallel(n, k, d, topology, "int8", frames, pop, runs)
            if pop in B2_BESIDE_POPS:
                # B2 at the same shape in both layouts: does it rank them as B1 does?
                kw2 = dict(pop=pop, param_mins=(0.0,) * d, param_maxs=param_maxs(topology),
                           **{key: kw[key] for key in ("dft_packed", "dft_scale", "topology", "n",
                                                       "num_frames", "sine_order")})
                pv = torch.rand(64, d, generator=gen).to(dev)
                ps = (0.02 + 0.28 * torch.rand(64, d, generator=gen)).to(dev)
                b2 = {False: [], True: []}
                for new in ORDER:
                    with b1_layout(new):
                        b2[new].append(cuda_ms(lambda: gn.fused_generation(7, pv, ps, tgt, **kw2),
                                               B1_LAUNCHES))
                print(f"b2 int8 {topology} n={n} P={pop}: old {statistics.median(b2[False]):.4f} "
                      f"ms {[round(x, 4) for x in b2[False]]}; new "
                      f"{statistics.median(b2[True]):.4f} ms {[round(x, 4) for x in b2[True]]} "
                      f"{card_name}", flush=True)
            row = "; ".join(
                f"{NAMES[new]} {statistics.median(times[new]):.4f} ms "
                f"{[round(x, 4) for x in times[new]]}"
                + (f", host a call {statistics.median(host[new]):.4f} ms" if host[new] else "")
                + f" (launched {took[new]})" for new in (False, True) if times[new])
            print(f"b1 int8 {topology} n={n} F={frames} B={runs} P={pop}: {row}; the wrapper "
                  f"takes {'time_parallel' if pick else 'one_warp'} {card_name}", flush=True)


def b2tp_times(dev, card_name: str):
    """B2 int8 in the time-parallel layout (``gen_layout`` forced) over
    B2TP_SHAPES, B2TP_REPEATS medians of B1_LAUNCHES launches each."""
    from chip_smoke import cuda_ms, param_maxs
    from pmfm_tpu_torch.kernels import generation as gn

    gen = torch.Generator().manual_seed(43)
    for topology, n, frames, pop in B2TP_SHAPES:
        _, tgt, kw, _, d = b1_inputs(dev, topology, n, frames, 1, 1, gen)
        kw2 = dict(pop=pop, param_mins=(0.0,) * d, param_maxs=param_maxs(topology),
                   **{key: kw[key] for key in ("dft_packed", "dft_scale", "topology", "n",
                                               "num_frames", "sine_order")})
        pv = torch.rand(64, d, generator=gen).to(dev)
        ps = (0.02 + 0.28 * torch.rand(64, d, generator=gen)).to(dev)
        call = lambda: gn.fused_generation(7, pv, ps, tgt, **kw2)  # noqa: E731
        with b1_layout(True):
            gn.fused_generation.launches_by_layout.clear()
            times = [cuda_ms(call, B1_LAUNCHES) for _ in range(B2TP_REPEATS)]
            took = dict(gn.fused_generation.launches_by_layout)
        print(f"b2tp int8 {topology} sine order 9 n={n} F={frames} P={pop}: "
              f"{statistics.median(times):.4f} ms {[round(x, 4) for x in times]} "
              f"(launched {took}) {card_name}", flush=True)


def scan_times(dev, card_name: str):
    from chip_smoke import cuda_ms, param_maxs
    from pmfm_tpu_torch.kernels import scan as ss
    from pmfm_tpu_torch.ops.synthesis import topology_dims

    layouts = ORDER if has_new("scan") else (False,)
    gen = torch.Generator().manual_seed(37)
    for n in SCAN_N:
        if hasattr(ss, "chain_floor_ms"):
            print(f"scan chain floor n={n}: {ss.chain_floor_ms(n, dev):.5f} ms {card_name}",
                  flush=True)
    for topology in SCAN_TOPOLOGIES:
        d = topology_dims(topology)
        maxs = torch.tensor(param_maxs(topology))
        for n in SCAN_N:
            for pop in SCAN_POPS:
                p = (torch.rand(pop, d, generator=gen) * maxs).to(dev)
                call = lambda: ss.scan_synth(p, n, topology)  # noqa: E731
                times = {False: [], True: []}
                for new in layouts:
                    with scan_layout(new):
                        times[new].append(cuda_ms(call, SCAN_LAUNCHES))
                pick = ss.scan_time_parallel(pop, topology) if has_new("scan") else False
                row = "; ".join(f"{NAMES[new]} {statistics.median(times[new]):.4f} ms "
                                f"{[round(x, 4) for x in times[new]]}"
                                for new in (False, True) if times[new])
                print(f"scan {topology} n={n} P={pop}: {row}; the wrapper takes "
                      f"{'time_parallel' if pick else 'one_thread'} {card_name}", flush=True)


def generations(text: str) -> int:
    """The generations of ``cli.main``'s chunks, from its ``chunk i: ...
    (g generations)`` lines."""
    return sum(int(g) for g in re.findall(r"^chunk \d+: .*\((\d+) generations\)", text, re.M))


@contextlib.contextmanager
def scan_geometry(group: int, warps: int):
    """The time-parallel scan forced to ``group`` candidates a block of
    ``warps`` warps."""
    from pmfm_tpu_torch.kernels import scan as ss

    saved = ss.scan_tp_group, ss.SCAN_TP_WARPS
    ss.scan_tp_group = lambda pop, topology: group
    ss.SCAN_TP_WARPS = warps
    try:
        yield
    finally:
        ss.scan_tp_group, ss.SCAN_TP_WARPS = saved


def scan_groups(dev, card_name: str):
    """The time-parallel scan's device time by candidates a block and warps
    over GROUP_POPS x SCAN_N x SCAN_TOPOLOGIES, beside one thread a
    candidate's: the evidence for ``scan_tp_group``, ``SCAN_TP_WARPS`` and
    the rule."""
    from chip_smoke import cuda_ms, param_maxs
    from pmfm_tpu_torch.kernels import scan as ss
    from pmfm_tpu_torch.ops.synthesis import topology_dims

    gen = torch.Generator().manual_seed(41)
    for topology in SCAN_TOPOLOGIES:
        d = topology_dims(topology)
        levels = ss.scan_levels(topology)
        maxs = torch.tensor(param_maxs(topology))
        for n in SCAN_N:
            for pop in GROUP_POPS:
                p = (torch.rand(pop, d, generator=gen) * maxs).to(dev)
                call = lambda: ss.scan_synth(p, n, topology)  # noqa: E731
                with scan_layout(False):
                    one = cuda_ms(call, SCAN_LAUNCHES)
                cells = []
                for group in sorted({g for g in (1, 2, 4, 8, 16) if g * levels <= 32}
                                    | {ss.SCAN_TP_MAX_LANES // levels}):
                    for warps in (2, 5, 8):
                        with scan_layout(True), scan_geometry(group, warps):
                            cells.append(f"G{group}/W{warps} {cuda_ms(call, SCAN_LAUNCHES):.4f}")
                with scan_layout(False):
                    one2 = cuda_ms(call, SCAN_LAUNCHES)
                la = ss.scan_launch(pop, n, topology, "floor", torch.float32)
                print(f"scan groups {topology} n={n} P={pop}: one thread {one:.4f}, {one2:.4f} ms; "
                      f"time-parallel {', '.join(cells)}; the wrapper takes {la['layout']} "
                      f"G{la['group']}/W{la['warps']} {card_name}", flush=True)


def run_cli(config: str, loader=None, profiler=None) -> tuple[float, str]:
    """``cli.main(["-j", config])`` in WORK (through ``loader`` if given):
    its seconds and its output."""
    import pmfm_tpu_torch.io
    from pmfm_tpu_torch import cli

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    if config == CELL_I_CONFIG:
        shutil.copytree(os.path.join(ROOT, "input_audio"), os.path.join(WORK, "input_audio"))
    load = pmfm_tpu_torch.io.load_config
    if loader is not None:
        pmfm_tpu_torch.io.load_config = loader
    out = io.StringIO()
    try:
        os.chdir(WORK)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), (profiler or contextlib.nullcontext()):
            code = cli.main(["-j", config])
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        os.chdir(ROOT)
        pmfm_tpu_torch.io.load_config = load
        shutil.rmtree(WORK, ignore_errors=True)
    if code != 0:
        raise SystemExit(f"cli.main exited {code}:\n{out.getvalue()[-4000:]}")
    return seconds, out.getvalue()


@contextlib.contextmanager
def b1_shapes():
    """B1's launches by (P, runs, frames, n, genes, layout) while the block
    runs, read from the library's entries."""
    from pmfm_tpu_torch.kernels import _build

    lib, seen = _build.library(), collections.Counter()
    names = [x for x in ("pmfm_fused_synth_fitness", "pmfm_fused_synth_fitness_tp")
             if hasattr(lib, x)]
    saved = {x: getattr(lib, x) for x in names}

    def wrap(x):
        def call(params, pop, runs, sp, *rest):
            seen[(pop, runs, sp.frames, sp.n, sp.d, "tp" if x.endswith("_tp") else "one_warp")] += 1
            return saved[x](params, pop, runs, sp, *rest)
        return call

    for x in names:
        setattr(lib, x, wrap(x))
    try:
        yield seen
    finally:
        for x in names:
            setattr(lib, x, saved[x])


def launch_shapes(card_name: str):
    import pmfm_tpu_torch.io
    from chip_smoke import fm5_parallel_config, pursuit_cut

    with b1_shapes() as seen:
        seconds, _ = run_cli(BANK_CONFIG)
    print(f"launches fm3_parallel_match.json as written ({seconds:.2f} s): B1 int8 by (P, runs, "
          f"F, n, d, layout) {dict(seen)} {card_name}", flush=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        path = os.path.join(tmp, "fm5_parallel_match.json")
        with open(path, "w") as f:
            json.dump(fm5_parallel_config(ROOT), f)
        with b1_shapes() as seen:
            seconds, _ = run_cli(path, pursuit_cut(pmfm_tpu_torch.io.load_config))
    print(f"launches fm5_parallel pursuit cut as chip_smoke.py phase 33 cuts it ({seconds:.2f} s): "
          f"B1 int8 by (P, runs, F, n, d, layout) {dict(seen)} {card_name}", flush=True)


def busy_union(kernels: list) -> float:
    """Microseconds in which at least one of ``kernels`` (ts, dur) runs."""
    total, end = 0.0, None
    for ts, dur in sorted(kernels):
        if end is None or ts >= end:
            total += dur
            end = ts + dur
        elif ts + dur > end:
            total += ts + dur - end
            end = ts + dur
    return total


def cell_i(repeats: int, card_name: str):
    from torch.profiler import ProfilerActivity, profile

    from pmfm_tpu_torch.kernels import scan as ss

    run_cli(CELL_I_CONFIG)  # warm-up
    for _ in range(repeats):
        by_layout = getattr(ss.scan_synth, "launches_by_layout", collections.Counter())
        by_layout.clear()
        before = ss.scan_synth.launches
        seconds, text = run_cli(CELL_I_CONFIG)
        gens = generations(text)
        total = next((ln for ln in text.splitlines() if ln.startswith("Total time")), "")
        print(f"cell (i) parameters.json: {seconds:.3f} s for {gens} generations, "
              f"{seconds / gens * 1e3:.4f} ms a generation over the whole command (stage rows "
              f"included); scan launches {ss.scan_synth.launches - before} by layout "
              f"{dict(by_layout)}; {total!r} {card_name}", flush=True)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    seconds, text = run_cli(CELL_I_CONFIG, profiler=prof)
    gens = generations(text)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    by = collections.defaultdict(float)
    count = collections.Counter()
    for e in events:
        name = e["name"].split("(")[0].removeprefix("void ")[:60]
        by[name] += e["dur"]
        count[name] += 1
    span = max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)
    busy = busy_union([(e["ts"], e["dur"]) for e in events])
    top = sorted(by.items(), key=lambda x: -x[1])[:8]
    print(f"cell (i) profiled: {seconds:.3f} s under the profiler, {gens} generations, "
          f"{len(events)} kernels ({len(events) / gens:.1f} a generation), device busy "
          f"{busy / 1e3:.3f} ms of a {span / 1e3:.3f} ms span (idle share "
          f"{1 - busy / span:.4f}), kernel ms a generation: " + ", ".join(
              f"{k} {v / gens / 1e3:.4f} (x{count[k] / gens:.2f})" for k, v in top)
          + f" {card_name}", flush=True)


def pursuit(repeats: int, card_name: str):
    for _ in range(repeats):
        with b1_shapes() as seen:
            seconds, _ = run_cli(BANK_CONFIG)
        print(f"pursuit fm3_parallel_match.json as written: {seconds:.2f} s; B1 int8 by (P, "
              f"runs, F, n, d, layout) {dict(seen)} {card_name}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=1,
                    help="runs of cell (i) and of the pursuit")
    names = ("ptxas", "b1", "b2tp", "scan", "scan_groups", "launches", "cell_i", "pursuit")
    ap.add_argument("--skip", nargs="*", default=(), choices=names)
    ap.add_argument("--only", nargs="*", default=None, choices=names,
                    help="run these steps alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card_name = card()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    steps = (("ptxas", lambda: ptxas(card_name)),
             ("b1", lambda: b1_times(dev, card_name)),
             ("b2tp", lambda: b2tp_times(dev, card_name)),
             ("scan", lambda: scan_times(dev, card_name)),
             ("scan_groups", lambda: scan_groups(dev, card_name)),
             ("launches", lambda: launch_shapes(card_name)),
             ("cell_i", lambda: cell_i(args.repeats, card_name)),
             ("pursuit", lambda: pursuit(args.repeats, card_name)))
    for name, step in steps:
        if name not in args.skip and (args.only is None or name in args.only):
            t0 = time.perf_counter()
            step()
            print(f"({name}: {time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
