"""B1 and B2 bf16's layouts, kernel by kernel and through the reference's suite, on a card.

B1 bf16 (``pmfm_tpu_torch.kernels.synth_fitness.fused_synth_fitness`` on a
bfloat16 operand) and B2 bf16 (``generation.fused_generation``) run the
one-warp layout of ``csrc/tc_eval.cuh`` (32 candidates a block on one warp)
or, where B2's rule (``generation.time_parallel``) says, the time-parallel
layout of ``csrc/fused_tp_bf16.cuh`` (32 candidates a block on up to eight
warps, the fold in place, the terms in rounds). The layouts give the same
fitness (B2: values and steps) bit for bit. This script times them against
each other in one process, alternated (one-warp, time-parallel,
time-parallel, one-warp; on a tree without the time-parallel layout, the
one-warp one alone):

* ``ptxas``: registers and spill stores of every B1/B2 bf16 kernel and every
  int8 time-parallel one, from the build's ``-Xptxas -v`` report;
* ``b1``: B1 bf16's device time (``chip_smoke.py::cuda_ms``, the median of
  LAUNCHES launches) at the reference suite's shapes (``SUITE_SHAPES``: the
  populations 2^11 .. 2^18 at n 1024, the run axis of ``multi_target``, n
  512 and 2048 of ``chunk_size`` and the topologies at P 2^15) with the
  wrapper's pick, and B2 bf16 beside it at P 2^15;
* ``split``: B1 bf16 at P 2^15, n 1024 with an operand and target of
  SPLIT_BINS bins (synthesis and fold alone) against the whole launch;
* ``sweep``: B1 bf16 at every fixed chain and bank x SWEEP_N x the suite's
  populations and run axes, both layouts in turns: the rule's evidence
  (``--rounds`` R: R rounds of the turns, 2 R medians a layout);
* ``suite``: the reference suite's bf16 rows (``bench_suite`` with
  ``--fused``, ``SUITE_GENS`` generations: overall, population,
  topologies, multi_target, the fused rows of chunk_size and
  Opt_fused-generation) with the wrapper's rule, then with the one-warp
  layout forced, in turns (``SUITE_ORDER``), ``--repeats`` rounds.

Usage, on a machine with a CUDA card, from the repository's root::

    python3 tools/torch_bf16_probe.py [--only ptxas b1 split sweep suite] [--repeats 2]
        [--rounds 5]

Prints one line a measurement, each with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

SUITE_POPS = (1 << 11, 1 << 13, 1 << 15, 1 << 17, 1 << 18)
SUITE_RUNS = ((4, 1 << 13), (32, 1 << 11))  # multi_target's run axes: (runs, pop a run)
SUITE_TOPOLOGIES = ("fm2", "fm4_series", "fm5_series", "fm3_parallel", "fm4_parallel")
# (topology, n, runs, pop): the suite's shapes of B1 bf16
SUITE_SHAPES = (tuple(("fm3_series", 1024, 1, p) for p in SUITE_POPS)
                + tuple(("fm3_series", 1024, r, p) for r, p in SUITE_RUNS)
                + (("fm3_series", 512, 1, 1 << 15), ("fm3_series", 2048, 1, 1 << 15))
                + tuple((t, 1024, 1, 1 << 15) for t in SUITE_TOPOLOGIES))
SWEEP_TOPOLOGIES = ("fm2", "fm3_series", "fm4_series", "fm5_series", "fm6_series", "fm7_series",
                    "fm8_series", "fm2_parallel", "fm3_parallel", "fm4_parallel", "fm5_parallel")
SWEEP_N = (512, 768, 1024, 2048)  # the suite's n, and 768: six warps a block
SWEEP_GRIDS = tuple((1, p) for p in SUITE_POPS) + SUITE_RUNS
LAUNCHES = 20
SPLIT_BINS = 8
SUITE_GENS = 50
SUITE_NAMES = ("overall", "population", "topologies", "multi_target")
CHUNK_LOG2 = (9, 10, 11)  # chunk_size's rows on the fused kernels (n 512 .. 2048)
SUITE_ORDER = ("rule", False, False, "rule")


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
        return f"[{out[0]}]" if out else "[nvidia-smi: no output]"
    except (OSError, subprocess.SubprocessError) as e:
        return f"[nvidia-smi: {e}]"


def layouts() -> tuple:
    """The bf16 layouts the tree has, in the order they are timed: the
    one-warp one (False), and the time-parallel one (True) where the tree
    has it."""
    from pmfm_tpu_torch.kernels import generation as gn

    return (False, True) if hasattr(gn, "layout_key") else (False,)


def forced(layout):
    """B1/B2 bf16 in one layout wherever its kernel takes the shape
    (``chip_smoke.py::gen_layout``: True the time-parallel one, False the
    one-warp one), or the wrapper's rule (``"rule"``)."""
    from chip_smoke import gen_layout
    from pmfm_tpu_torch.kernels import generation as gn

    if layout == "rule" or not hasattr(gn, "layout_key"):
        return contextlib.nullcontext()
    return gen_layout(gn, layout)


def label(layout) -> str:
    return layout if isinstance(layout, str) else ("time_parallel" if layout else "one_warp")


def in_turns(names: tuple) -> tuple:
    return names + names[::-1]


def ptxas(card_name: str):
    from chip_smoke import ptxas_summary
    from pmfm_tpu_torch.kernels import _build

    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    info = _build.build()
    for name, regs, spill in ptxas_summary(info["log"]):
        if "bf16" in name or "int8_tp" in name:
            print(f"ptxas {name}: {regs} registers, {spill} bytes spill stores", flush=True)
    for ln in info["log"].splitlines():
        if ln.startswith("nvcc "):
            print(f"  {ln}", flush=True)
    print(f"build {info['seconds']:.1f} s {card_name}", flush=True)


@functools.lru_cache(maxsize=None)
def operand(n: int, dev) -> tuple:
    """The bf16 folded operand at n, its bins and its scale (one build an n)."""
    from pmfm_tpu_torch.ops.spectral import make_spectrum_ops

    so = make_spectrum_ops(n, dft_dtype="bfloat16", device=dev)
    return so.dft_packed, so.num_bins, so.dft_packed_scale


def inputs(dev, topology: str, n: int, runs: int, pop: int, gen, bins=None):
    """Scaled candidates, targets and B1's keywords at a shape, on the
    bf16 operand (``bins``: the operand and target cut to that many bins)."""
    from chip_smoke import param_maxs
    from pmfm_tpu_torch.ops.synthesis import topology_dims

    d = topology_dims(topology)
    op, k, scale = operand(n, dev)
    if bins is not None:
        op = torch.cat([op[:bins], op[k:k + bins]]).contiguous()
        k = bins
    lead = (runs,) if runs > 1 else ()
    p = (torch.rand(*lead, pop, d, generator=gen) * torch.tensor(param_maxs(topology))).to(dev)
    tgt = (50 * torch.rand(*lead, k, generator=gen)).to(dev)
    kw = dict(dft_packed=op, dft_scale=scale, topology=topology, n=n)
    return p, tgt, kw, k, d


ROUNDS = [1]  # rounds of the turns a timing takes (``--rounds``)


def time_layouts(call, names: tuple, by) -> dict:
    """{layout: [ms, ...]} of ``call`` in each layout of ``names`` in turns
    (ROUNDS rounds of them), and the launches each made by layout (``by``, a
    Counter it clears)."""
    times, took = collections.defaultdict(list), {}
    from chip_smoke import cuda_ms

    for name in in_turns(names) * ROUNDS[0]:
        with forced(name):
            by.clear()
            times[name].append(cuda_ms(call, LAUNCHES))
            took[name] = dict(by)
    return times, took


def row(times: dict, took: dict) -> str:
    return "; ".join(f"{label(x)} {statistics.median(v):.4f} ms {[round(y, 4) for y in v]} "
                     f"(launched {took[x]})" for x, v in times.items())


def pick(n, k, d, topology, pop, runs) -> str:
    from pmfm_tpu_torch.kernels import generation as gn

    if not hasattr(gn, "layout_key"):
        return "one_warp"
    return label(gn.time_parallel(n, k, d, topology, "bf16", 1, pop, runs))


def b1_times(dev, card_name: str, shapes=SUITE_SHAPES, tag="b1"):
    from chip_smoke import param_maxs
    from pmfm_tpu_torch.kernels import generation as gn
    from pmfm_tpu_torch.kernels import synth_fitness as sf

    gen = torch.Generator().manual_seed(47)
    by = sf.fused_synth_fitness.launches_by_layout
    for topology, n, runs, pop in shapes:
        p, tgt, kw, k, d = inputs(dev, topology, n, runs, pop, gen)
        times, took = time_layouts(lambda: sf.fused_synth_fitness(p, tgt, **kw), layouts(), by)
        print(f"{tag} bf16 {topology} n={n} B={runs} P={pop}: {row(times, took)}; the wrapper "
              f"takes {pick(n, k, d, topology, pop, runs)} {card_name}", flush=True)
        if tag == "b1" and pop == 1 << 15 and runs == 1:
            kw2 = dict(pop=pop, param_mins=(0.0,) * d, param_maxs=param_maxs(topology), **kw)
            pv = torch.rand(pop // 128, d, generator=gen).to(dev)
            ps = (0.02 + 0.28 * torch.rand(pop // 128, d, generator=gen)).to(dev)
            times, took = time_layouts(lambda: gn.fused_generation(7, pv, ps, tgt, **kw2),
                                       layouts(), gn.fused_generation.launches_by_layout)
            print(f"b2 bf16 {topology} n={n} P={pop}: {row(times, took)} {card_name}",
                  flush=True)


def split(dev, card_name: str):
    from pmfm_tpu_torch.kernels import synth_fitness as sf

    gen = torch.Generator().manual_seed(53)
    by = sf.fused_synth_fitness.launches_by_layout
    for bins in (None, SPLIT_BINS):
        p, tgt, kw, k, _ = inputs(dev, "fm3_series", 1024, 1, 1 << 15, gen, bins)
        times, took = time_layouts(lambda: sf.fused_synth_fitness(p, tgt, **kw), layouts(), by)
        print(f"split b1 bf16 fm3_series n=1024 P=32768 K={k}: {row(times, took)} {card_name}",
              flush=True)


def sweep(dev, card_name: str):
    shapes = tuple((t, n, r, p) for n in SWEEP_N for t in SWEEP_TOPOLOGIES
                   for r, p in SWEEP_GRIDS)
    b1_times(dev, card_name, shapes, tag="sweep")


@contextlib.contextmanager
def quiet():
    import io

    with contextlib.redirect_stdout(io.StringIO()) as out:
        yield out


def suite(repeats: int, card_name: str):
    from pmfm_tpu_torch import bench_suite as bs

    args = bs.parse_args(["--fused", "--gens", str(SUITE_GENS)])
    args.device = torch.device("cuda")

    class Rows:  # the Benchmarker calls the suites make, kept as {row: ms}
        def __init__(self):
            self.ms = {}

        def add_timer(self, name, ms):
            self.ms[name] = ms

        def __getattr__(self, _):
            return lambda *a, **k: None

    def chunk_rows(bm):
        for log2 in CHUNK_LOG2:
            cfg = bs._base_cfg(args, audio_length_log2=log2)
            dt = bs._steady_time(bs._make_runner(cfg, args.gens, device=args.device))
            bm.add_timer(f"AudioAnalysisChunkSize_{1 << log2}", dt * 1e3)

    def opt_row(bm):
        cfg = bs._base_cfg(args, **bs.OPT_VARIANTS["fused-generation"])
        dt = bs._steady_time(bs._make_runner(cfg, args.gens, device=args.device))
        bm.add_timer("Opt_fused-generation", dt * 1e3)

    runs = [(name, lambda bm, name=name: bs.SUITES[name](args, bm)) for name in SUITE_NAMES]
    runs += [("chunk_size", chunk_rows), ("optimizations", opt_row)]
    for suite_name, fn in runs:
        got = collections.defaultdict(lambda: collections.defaultdict(list))
        for _ in range(repeats):
            for layout in SUITE_ORDER:
                bm = Rows()
                with forced(layout), quiet():
                    fn(bm)
                for key, ms in bm.ms.items():
                    got[key][layout].append(ms)
        for key, by in got.items():
            cells = "; ".join(f"{label(layout)} {statistics.median(v):.1f} ms "
                              f"{[round(x, 1) for x in v]}" for layout, v in by.items())
            print(f"suite {key} ({SUITE_GENS} generations): {cells} {card_name}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    names = ("ptxas", "b1", "split", "sweep", "suite")
    ap.add_argument("--only", nargs="*", default=names, choices=names)
    ap.add_argument("--repeats", type=int, default=1, help="rounds of the suite's turns")
    ap.add_argument("--rounds", type=int, default=1,
                    help="rounds of the layouts' turns in b1, split and sweep")
    args = ap.parse_args(argv)
    ROUNDS[0] = args.rounds
    if not torch.cuda.is_available():
        print("no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card_name = card()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    steps = {"ptxas": lambda: ptxas(card_name), "b1": lambda: b1_times(dev, card_name),
             "split": lambda: split(dev, card_name), "sweep": lambda: sweep(dev, card_name),
             "suite": lambda: suite(args.repeats, card_name)}
    for name in names:
        if name in args.only:
            t0 = time.perf_counter()
            steps[name]()
            print(f"({name}: {time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
