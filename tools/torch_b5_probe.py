"""B5 int8 and bf16 on B2's layouts, on a card: the build and the B5 rows' times.

B5 (``pmfm_tpu_torch.kernels.evolve.fused_evolve``) runs G generations of
B2's kernel and the selection in one call. In int8 and bf16 it launches, each
generation, B2's kernel in the layout B2's wrapper takes at the same
arguments (``generation.time_parallel``): the one-warp kernel or the
time-parallel one, bit-equal to each other. This script measures, in one
process:

* the build: nvcc's time a source and the whole, and the registers and spill
  stores of every B1/B2 int8 and bf16 kernel (one-warp and time-parallel)
  from nvcc's ``-Xptxas -v`` report; the report is written to
  ``build/b5_probe_<label>.log``, and ``--ptxas-against LOG`` counts
  the instantiations whose registers or spill stores differ from LOG's;
* ``chip_smoke.py``'s phase 48 (``Smoke.b5_layouts``): at PERF.md §6's B5
  rows (``chip_smoke.B5_TURN_ROWS``) B5 with every generation one-warp and
  with the wrapper's pick, alternated in one process, each with its split a
  generation (evaluation, selection, time not covered by kernels).

``--package-root DIR`` measures another checkout's ``pmfm_tpu_torch`` (a
parent commit unpacked by ``git archive``) with this tree's ``chip_smoke.py``:
its B5 has no layout counter, and both turns run what its B5 runs.

Usage, on a machine with a CUDA card, from the repository's root::

    python3 tools/torch_b5_probe.py [--package-root DIR] [--label L]
        [--ptxas-against build/b5_probe_parent.log]

Prints one line a measurement, each time with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PTXAS_FAMILIES = ("fused_generation_int8", "fused_generation_bf16", "fused_synth_fitness_int8",
                  "fused_synth_fitness_bf16")


def load_chip_smoke():
    """This tree's ``chip_smoke.py``, whatever checkout the package comes from."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = module
    spec.loader.exec_module(module)
    return module


def ptxas_rows(cs, log: str) -> dict:
    """{kernel<template arguments>: (registers, spill-store bytes)} of the
    B1/B2 int8 and bf16 kernels in a build's report."""
    return {name: (regs, spill) for name, regs, spill in cs.ptxas_summary(log)
            if name.startswith(PTXAS_FAMILIES)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package-root", default=None,
                    help="a checkout whose pmfm_tpu_torch to measure (default: this one)")
    ap.add_argument("--label", default="tree", help="names the build report's file")
    ap.add_argument("--ptxas-against", default=None, metavar="LOG",
                    help="an earlier build report to compare registers and spills with")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.package_root or ROOT))
    import torch

    if not torch.cuda.is_available():
        print("torch_b5_probe: no CUDA device", file=sys.stderr)
        return 2
    cs = load_chip_smoke()
    import pmfm_tpu_torch
    from pmfm_tpu_torch.kernels import _build
    from pmfm_tpu_torch.kernels import evolve as ev

    cs.log(f"package {os.path.dirname(pmfm_tpu_torch.__file__)}, sources {_build.source_digest()}")
    s = cs.Smoke()
    s.device()
    info = _build.build()
    out = os.path.join(ROOT, "build")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"b5_probe_{args.label}.log"), "w") as f:
        f.write(info["log"])
    for ln in info["log"].splitlines():
        if ln.startswith("nvcc "):
            print(f"  {ln}", flush=True)
    cs.log(f"build {info['seconds']:.1f} s (built={info['built']}) {cs.card()}")
    rows = ptxas_rows(cs, info["log"])
    for fam in PTXAS_FAMILIES:
        for tp in (False, True):
            got = [(int(r), int(sp)) for name, (r, sp) in rows.items()
                   if name.startswith(fam + "_") and ("_tp_kernel<" in name) == tp]
            if got:
                cs.log(f"ptxas {fam} {'time-parallel' if tp else 'one-warp'}: {len(got)} "
                       f"instantiations, registers {min(r for r, _ in got)}-"
                       f"{max(r for r, _ in got)}, spill stores {sorted({sp for _, sp in got})} "
                       f"bytes")
    if args.ptxas_against:
        with open(args.ptxas_against) as f:
            before = ptxas_rows(cs, f.read())
        same = [name for name in rows if before.get(name) == rows[name]]
        differ = [name for name in rows if name in before and before[name] != rows[name]]
        cs.log(f"ptxas against {args.ptxas_against}: {len(same)} of {len(rows)} B1/B2 "
               f"instantiations equal, {len(differ)} differ {differ[:8]}, "
               f"{len(set(rows) - set(before))} new, {len(set(before) - set(rows))} gone")
    _build.library()
    s.b5_layouts(check_layout=hasattr(ev.fused_evolve, "launches_by_layout"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
