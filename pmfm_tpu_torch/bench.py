"""Headline benchmark of the port on one CUDA card: candidate-evaluations/s.

    python -m pmfm_tpu_torch.bench

The reference's bench (root ``bench.py``) on the card, at its configuration:
fm3_series, population 2^15, mu 256, 1024-sample frames, the int8 folded
DFT, sine order 7, CLT-12 noise, ``fused_generation`` (kernel B2 once a
generation).

* ``value``: ``evolve`` for 1000 generations against an all-ones target
  spectrum, from ``init_state`` on; candidate-evaluations per second, the
  best of three runs after a warm-up, each timed with CUDA events.
* ``value_shipped``: the shipped example's settings
  (``examples/params_match.json``: the order-9 sine, neutral-drift noise,
  the step floor, restarts after 100 stalled generations and the
  100-generation true-f32 refine tail) through ``_evolve_on_target``
  against the known-params tone, 900 generations of B2 in int8, the
  boundary rescore on B1 in f32, 100 generations of B2 in f32.

Prints one JSON line with ``metric``, ``value``, ``unit``, ``vs_baseline``
(against the reference's 2080 Ti figure, as the root script computes it),
``value_shipped``, ``device`` (the card's name and power limit) and, as the
root script reads them from its quality gate, ``generations_to_converge``
and ``quality_vs_f32_holdout`` from ``QUALITY_GATES``
(``pmfm_tpu_torch/quality_gates.json``, written on the card by
``python -m pmfm_tpu_torch.convergence_check``; the held-out split first).
Without a CUDA device the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

from .es import ESConfig, evolve, init_state, make_spectrum_ops
from .es.pipeline import _evolve_on_target
from .ops import synthesize_single

GENS = 1000
REPS = 3
MU = 256
POP = 1 << 15
AUDIO_LOG2 = 10
# the reference's normalisation: the 2080 Ti figure in root bench.py
BASELINE_2080TI_EVALS_PER_SEC = 10e6
TRUTH = (3078.0, 2.0, 3015.0, 1.5, 3141.0, 1.0)  # examples/params_match.json
QUALITY_GATES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "quality_gates.json")


def bench_config() -> ESConfig:
    """The bench engine's configuration (root bench.py)."""
    return ESConfig(
        num_parents=MU,
        num_offspring=POP - MU,
        num_dimensions=6,
        topology="fm3_series",
        audio_length_log2=AUDIO_LOG2,
        synthesis_engine="scanless",
        spectrum_method="dft",
        dft_dtype="int8",
        mutation_noise="clt12",
        sine_order=7,
        fused_kernel=True,
        fused_generation=True,
        fused_evolve=False,
        pop_block=1024,
    )


def shipped_config(cfg: ESConfig) -> ESConfig:
    """The shipped example's knobs on the bench shape (root bench.py)."""
    return cfg.replace(sine_order=9, mutation_noise="clt12_neutral", min_step=1e-4,
                       restart_patience=100, refine_generations=100)


def card() -> dict:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    name, _, limit = (out[0] if out else "?, ?").partition(",")
    return {"name": name.strip(), "power_limit": limit.strip()}


def timed_ms(fn) -> float:
    """Device time of ``fn()`` in ms: CUDA events around it, then a sync."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def best_ms(fn, reps: int) -> float:
    """The best of ``reps`` timed calls of ``fn(rep)`` after one warm-up."""
    fn(0)
    return min(timed_ms(lambda: fn(rep)) for rep in range(reps))


class Bench:
    """The two measured runs, with their operands built once, outside the
    timing (the reference builds them at trace time)."""

    def __init__(self, generations: int = GENS, device: str | torch.device = "cuda"):
        self.gens = generations
        self.dev = torch.device(device)
        self.cfg = bench_config()
        self.so = make_spectrum_ops(self.cfg, device=self.dev)
        self.tspec = torch.ones((self.so.num_bins,), dtype=torch.float32, device=self.dev)
        self.cfg_s = shipped_config(self.cfg)
        self.so_s = make_spectrum_ops(self.cfg_s, device=self.dev)
        cfg_r = self.cfg_s.refine_config()
        self.refine_ops = (cfg_r, make_spectrum_ops(cfg_r, device=self.dev))
        self.target_audio = synthesize_single(
            torch.tensor(TRUTH), self.cfg_s.n_samples, self.cfg_s.topology).to(self.dev)

    def run_value(self, seed: int):
        state = init_state(seed, self.cfg, device=self.dev)
        return evolve(state, self.tspec, self.gens, self.so, self.cfg)[0]

    def run_shipped(self, seed: int):
        state = init_state(seed, self.cfg_s, device=self.dev)
        return _evolve_on_target(state, self.target_audio, self.gens, self.so_s, self.cfg_s,
                                 False, self.refine_ops)

    def evals_per_sec(self, ms: float) -> float:
        return POP * self.gens / (ms / 1e3)


def quality_holdout(path: str = QUALITY_GATES):
    """The bench engine family's held-out quality against f32 (seeds
    disjoint from any tuning): the median ratio and sign-test p of each
    rung, as root ``bench.py`` reports them; None without the file."""
    try:
        with open(path) as f:
            res = json.load(f)["splits"]["holdout"]["results"]
        return {name: {"median_ratio": round(res[name]["paired_vs_f32"]["median_ratio"], 3),
                       "sign_p": round(res[name]["paired_vs_f32"]["sign_test_p"], 3)}
                for name in ("int8+sin7+refine", "shipped")}
    except (OSError, KeyError, ValueError):
        return None


def generations_to_converge(path: str = QUALITY_GATES):
    """The median generations for the bench engine (and its refine rung)
    to reach each rescored fitness threshold, with the share of seeds that
    did, from the held-out split if there is one, else the train split (as
    root ``bench.py`` reads them); None without the file."""
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    for split in ("holdout", "train"):
        blk = data.get("splits", {}).get(split)
        if blk and "int8+sin7" in blk.get("results", {}):
            out = {"split": split, "seeds": blk["seeds"]}
            for rung in ("int8+sin7", "int8+sin7+refine"):
                if rung in blk["results"]:
                    gtc = blk["results"][rung]["generations_to_converge"]
                    out[rung] = {t: {"median_gens": v.get("median_gens"),
                                     "frac_converged": v["frac_converged"]}
                                 for t, v in gtc.items()}
            return out
    return None


def main() -> int:
    if not torch.cuda.is_available():
        print("pmfm_tpu_torch.bench: no CUDA device", file=sys.stderr)
        return 2
    b = Bench()
    value = b.evals_per_sec(best_ms(b.run_value, REPS))
    shipped = b.evals_per_sec(best_ms(b.run_shipped, REPS))
    out = {
        "metric": "candidate-evaluations/sec/chip (pop 2^15, 1024-pt FFT)",
        "value": round(value, 1),
        "unit": "evals/s",
        "vs_baseline": round(value / BASELINE_2080TI_EVALS_PER_SEC, 3),
        "value_shipped": round(shipped, 1),
        "device": card(),
    }
    gtc = generations_to_converge()
    if gtc is not None:
        out["generations_to_converge"] = gtc
    q = quality_holdout()
    if q is not None:
        out["quality_vs_f32_holdout"] = q
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
