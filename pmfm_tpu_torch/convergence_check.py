"""The ES-quality gate on the card: do the throughput engines search as well
as f32? (port of ``tools/convergence_check.py``).

    python -m pmfm_tpu_torch.convergence_check --seeds 64 --seed-offset 64 \\
        --split holdout --variants f32 int8+sin7 int8+sin7+refine shipped \\
        --json pmfm_tpu_torch/quality_gates.json

Known-parameter recovery (the reference's integration test: the target is
synthesised from ``TRUE_GENES_BY_TOPOLOGY``) at bench scale (P 2^15, mu
256, 1000 generations, n 1024) over paired seeds (seed s is
``init_state(s)`` in every variant), for each engine variant of
``VARIANTS``, reporting:

* the best fitness of each seed, its recovered parameters rescored by an
  independent scorer (the unfused true-f32 engine, ``xla_dft`` on the
  scanless synthesis's ``torch.sin``, with TF32 off:
  ``device.exact_f32_matmul``), so that no engine grades its own work;
* paired statistics against the f32 variant: per-seed ratios, an exact
  two-sided sign test, a Wilcoxon signed-rank test (normal approximation)
  and a bootstrap 95% interval on the median ratio;
* generations to converge: the run is cut in segments of
  ``--segment-gens``, the best candidate at each boundary rescored, and a
  seed's count is the first boundary at or below each threshold.

The JSON keeps the reference's layout (``meta``,
``splits.{train,holdout}.{seed_offset, seeds, meta, results}``,
``results.<variant>.{fits, paired_vs_f32, generations_to_converge, ...}``),
which ``python -m pmfm_tpu_torch.bench`` reads; ``meta.device`` holds the
card's name and power limit, ``results.<variant>.seconds`` its wall time.
The ES outcomes do not depend on the chip; the seeds draw from the port's
generators (torch, Philox), not the reference's, so the two packages'
files compare as distributions, not seed by seed.

The pursuit variant runs the port's staged solvers (``es/staged.py``) with
their default knobs, reported at one boundary: the generations it used.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch

from .device import exact_f32_matmul, resolve_device
from .es import ESConfig, evaluate, evolve, init_state, make_spectrum_ops, refine_boundary
from .ops import synthesize_single, target_spectrum
from .ops.synthesis import scale_params

# Known-parameter targets (normalised genes) per topology: the reference's
# table (tools/convergence_check.py), fm3_series first (examples/params_match.json)
TRUE_GENES_BY_TOPOLOGY = {
    "fm3_series": (0.874, 0.25, 0.857, 0.1875, 0.892, 0.125),
    "fm2": (0.874, 0.25, 0.857, 0.9),
    "fm3_parallel": (0.874, 0.25, 0.857, 0.9,
                     0.55, 0.30, 0.62, 0.8,
                     0.71, 0.20, 0.45, 0.7),
    "fm4_parallel": (0.874, 0.25, 0.857, 0.9,
                     0.55, 0.30, 0.62, 0.8,
                     0.71, 0.20, 0.45, 0.7,
                     0.33, 0.40, 0.28, 0.6),
    "fm5_parallel": (0.874, 0.25, 0.857, 0.9,
                     0.55, 0.30, 0.62, 0.8,
                     0.71, 0.20, 0.45, 0.7,
                     0.33, 0.40, 0.28, 0.6,
                     0.62, 0.15, 0.93, 0.5),
    "fm4_series": (0.874, 0.25, 0.857, 0.1875, 0.892, 0.15, 0.85, 0.125),
    "fm5_series": (0.874, 0.25, 0.857, 0.1875, 0.892, 0.15,
                   0.85, 0.10, 0.80, 0.125),
    "fm5_series_mild": (0.05, 0.25, 0.08, 0.19, 0.15, 0.15,
                        0.40, 0.10, 0.80, 0.125),
}
TRUE_GENES = TRUE_GENES_BY_TOPOLOGY["fm3_series"]

# the engine ladder (the reference's VARIANTS)
VARIANTS = {
    "f32": dict(dft_dtype="float32", fused_kernel=False, fused_generation=False),
    "bf16-fused": dict(dft_dtype="bfloat16", fused_kernel=True, fused_generation=True),
    "int8": dict(dft_dtype="int8", fused_kernel=True, fused_generation=True),
    "int8+sin7": dict(dft_dtype="int8", fused_kernel=True, fused_generation=True, sine_order=7),
    "int8+sin5": dict(dft_dtype="int8", fused_kernel=True, fused_generation=True, sine_order=5),
    # precision annealing: the last 100 generations under the f32 engine
    "int8+sin7+refine": dict(dft_dtype="int8", fused_kernel=True, fused_generation=True,
                             sine_order=7, refine_generations=100),
    # examples/params_match.json's "tpu" block
    "shipped": dict(dft_dtype="int8", fused_kernel=True, fused_generation=True,
                    mutation_noise="clt12_neutral", min_step=1e-4, restart_patience=100,
                    refine_generations=100),
    # the staged solver (es/staged.py), fm{k}_parallel and fm{k>=4}_series only
    "pursuit": dict(_pursuit=True, dft_dtype="int8", fused_kernel=True, fused_generation=True,
                    mutation_noise="clt12_neutral", min_step=1e-4, restart_patience=100,
                    refine_generations=100),
}
VARIANTS["sin9"] = VARIANTS["int8"]
VARIANTS["sin7"] = VARIANTS["int8+sin7"]
VARIANTS["sin5"] = VARIANTS["int8+sin5"]


# ---------------------------------------------------------------------------
# Paired statistics (numpy only; copies of the reference's)
# ---------------------------------------------------------------------------

def sign_test_p(diffs: np.ndarray) -> float:
    """Exact two-sided binomial sign test on paired differences."""
    d = diffs[diffs != 0]
    n = len(d)
    if n == 0:
        return 1.0
    k = int(np.sum(d > 0))
    lo = min(k, n - k)
    p = 2.0 * sum(math.comb(n, i) for i in range(lo + 1)) / 2.0**n
    return min(1.0, p)


def wilcoxon_p(diffs: np.ndarray) -> float:
    """Two-sided Wilcoxon signed-rank test, normal approximation with
    average ranks for ties (adequate at n >= ~20)."""
    d = diffs[diffs != 0]
    n = len(d)
    if n < 10:
        return 1.0
    a = np.abs(d)
    order = np.argsort(a)
    ranks = np.empty(n)
    sa = a[order]
    i = 0
    while i < n:
        j = i
        while j + 1 < n and sa[j + 1] == sa[i]:
            j += 1
        ranks[order[i : j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    w_plus = float(np.sum(ranks[d > 0]))
    mean = n * (n + 1) / 4.0
    var = n * (n + 1) * (2 * n + 1) / 24.0
    z = (w_plus - mean) / math.sqrt(var)
    return 2.0 * 0.5 * math.erfc(abs(z) / math.sqrt(2.0))


def bootstrap_median_ci(x: np.ndarray, reps: int = 10000, seed: int = 0):
    rng = np.random.default_rng(seed)
    meds = np.median(x[rng.integers(0, len(x), size=(reps, len(x)))], axis=1)
    return float(np.percentile(meds, 2.5)), float(np.percentile(meds, 97.5))


def paired_stats(variant_fits: np.ndarray, base_fits: np.ndarray) -> dict:
    """Per-seed paired comparison against the f32 baseline; a ratio below 1
    means the variant reached a lower (better) rescored fitness."""
    ratios = variant_fits / base_fits
    log_r = np.log(ratios)
    lo, hi = bootstrap_median_ci(ratios)
    return {
        "n_pairs": int(len(ratios)),
        "median_ratio": float(np.median(ratios)),
        "median_ratio_ci95": [lo, hi],
        "frac_variant_better": float(np.mean(variant_fits < base_fits)),
        "sign_test_p": sign_test_p(log_r),
        "wilcoxon_p": wilcoxon_p(log_r),
    }


def gens_to_converge(rescored: np.ndarray, boundaries, threshold: float):
    """Per seed: the first boundary (generation count) whose rescored best
    fitness is <= threshold; ``rescored`` is (seeds, len(boundaries))."""
    boundaries = np.asarray(boundaries)
    hit = rescored <= threshold
    first = np.where(hit.any(axis=1), hit.argmax(axis=1), len(boundaries) - 1)
    gens = boundaries[first]
    converged = hit.any(axis=1)
    out = {
        "threshold_f32_rescored": float(threshold),
        "frac_converged": float(np.mean(converged)),
        "gens": [int(g) if c else None for g, c in zip(gens, converged)],
    }
    if converged.any():
        g = gens[converged].astype(float)
        out["median_gens"] = float(np.median(g))
        out["iqr_gens"] = [float(np.percentile(g, 25)), float(np.percentile(g, 75))]
    return out


# ---------------------------------------------------------------------------
# The runs
# ---------------------------------------------------------------------------

def base_config(topology: str, pop: int, mu: int, mutation_noise: str) -> ESConfig:
    """The gate's configuration: the bench shape for ``topology``."""
    from .models import get_topology

    topo = get_topology(topology)
    return ESConfig(
        num_parents=mu, num_offspring=pop - mu, num_dimensions=topo.num_dimensions,
        topology=topology, param_mins=topo.default_param_mins,
        param_maxs=topo.default_param_maxs, audio_length_log2=10, synthesis_engine="scanless",
        spectrum_method="dft", mutation_noise=mutation_noise, pop_block=1024,
    )


def segmented_run(seed: int, cfg: ESConfig, audio: torch.Tensor, gens: int, segment: int,
                  device: torch.device):
    """One seed's run of ``cfg`` for ``gens`` generations in segments of
    ``segment`` (the refine tail, if any, in segments too, and the rest);
    returns ``(final best values (D,), the best values at each boundary
    (segments, D), the boundaries)``."""
    so = make_spectrum_ops(cfg, device=device)
    tspec = target_spectrum(audio, so)
    refine = min(cfg.refine_generations, gens) if cfg.refine_generations > 0 else 0
    cfg1 = cfg.replace(refine_generations=0)
    n1 = max(1, (gens - refine) // segment)
    n2 = refine // segment
    boundaries = [segment * (i + 1) for i in range(n1 + n2)]
    if refine and boundaries[-1] < gens:
        boundaries.append(gens)
    state = init_state(seed, cfg1, device=device)
    bvs = []
    for _ in range(n1):
        state, _ = evolve(state, tspec, segment, so, cfg1)
        bvs.append(state.best_values)
    if refine:
        cfg_r = cfg1.refine_config()
        so_r = make_spectrum_ops(cfg_r, device=device)
        tspec_r = target_spectrum(audio, so_r)
        state = refine_boundary(state, tspec_r, so_r, cfg1, cfg_r)
        for _ in range(n2):
            state, _ = evolve(state, tspec_r, segment, so_r, cfg_r)
            bvs.append(state.best_values)
        tail = refine - n2 * segment
        if tail:
            state, _ = evolve(state, tspec_r, tail, so_r, cfg_r)
            bvs.append(state.best_values)
    return state.best_values, torch.stack(bvs), boundaries


def card(device: torch.device) -> dict:
    """The card's name and power limit (nvidia-smi), or the CPU."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    from .bench import card as smi

    return smi()


def main(argv=None, *, device: str | torch.device | None = None) -> int:
    """The command line; ``device`` (the first card by default) is for
    callers in Python, as the CPU tests."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="+", default=["f32", "bf16-fused", "int8", "int8+sin7"],
                    choices=list(VARIANTS))
    ap.add_argument("--seeds", type=int, default=64)
    ap.add_argument("--seed-offset", type=int, default=0,
                    help="first seed; a held-out audit uses a block disjoint from the one any "
                         "config was tuned on (e.g. --seed-offset 64)")
    ap.add_argument("--split", default=None,
                    help="the seed block's name in the JSON (default: 'train' at offset 0, "
                         "'holdout' otherwise); --json merges splits")
    ap.add_argument("--gens", type=int, default=1000)
    ap.add_argument("--segment-gens", type=int, default=10,
                    help="rescore the best candidate every this many generations")
    ap.add_argument("--thresholds", type=float, nargs="+", default=[150000.0, 40000.0, 15000.0],
                    help="rescored fitness levels that count as converged")
    ap.add_argument("--pop-log2", type=int, default=15)
    ap.add_argument("--mu", type=int, default=256)
    ap.add_argument("--topology", default="fm3_series", choices=list(TRUE_GENES_BY_TOPOLOGY))
    ap.add_argument("--thresholds-rel", type=float, nargs="+", default=None,
                    help="thresholds as relative spectral error: converged when the rescored "
                         "fitness <= rel^2 * sum(target^2); overrides --thresholds")
    ap.add_argument("--mutation-noise", default="clt12")
    ap.add_argument("--json", default=None, help="write the results JSON here")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda" if device is None else device)
    split = args.split or ("train" if args.seed_offset == 0 else "holdout")

    pop = 1 << args.pop_log2
    topology = "fm5_series" if args.topology == "fm5_series_mild" else args.topology
    base = base_config(topology, pop, args.mu, args.mutation_noise)
    truth = torch.tensor(TRUE_GENES_BY_TOPOLOGY[args.topology], dtype=torch.float32)
    scaled = scale_params(truth[None], torch.tensor(base.param_mins),
                          torch.tensor(base.param_maxs))[0]
    audio = synthesize_single(scaled, base.n_samples, base.topology).to(dev)

    # the independent scorer: the unfused true-f32 engine, TF32 off
    cfg32 = base.replace(dft_dtype="float32", fused_kernel=False, fused_generation=False)
    so32 = make_spectrum_ops(cfg32, device=dev)
    tspec32 = target_spectrum(audio, so32)

    def rescore(values: torch.Tensor) -> np.ndarray:
        with exact_f32_matmul():
            return evaluate(values.to(dev), tspec32, so32, cfg32).double().cpu().numpy()

    if args.thresholds_rel:
        energy = float(torch.sum(tspec32.double() ** 2))
        thr_items = [(f"rel{r:g}", r * r * energy) for r in args.thresholds_rel]
        print(f"target spectral energy = {energy:.6g}; thresholds: "
              + ", ".join(f"{k}={v:.4g}" for k, v in thr_items))
    else:
        thr_items = [(str(int(t)), float(t)) for t in args.thresholds]
    seeds = range(args.seed_offset, args.seed_offset + args.seeds)

    results = {}
    for name in args.variants:
        over = dict(VARIANTS[name])
        is_pursuit = over.pop("_pursuit", False)
        cfg = base.replace(**over)
        t0 = time.perf_counter()
        if is_pursuit:
            from .es.staged import match_parallel_pursuit, match_series_pursuit
            from .ops.synthesis import parallel_pairs, series_ops

            if parallel_pairs(topology) is not None:
                solver = match_parallel_pursuit
            elif (series_ops(topology) or 0) >= 4:
                solver = match_series_pursuit
            else:
                print(f"{name}: SKIP (needs fm{{k}}_parallel or fm{{k>=4}}_series, got "
                      f"{topology})")
                continue
            target = audio.cpu().numpy()
            runs = [solver(target, cfg, s, device=dev) for s in seeds]
            finals = torch.from_numpy(np.stack([r.best_values for r in runs]).astype(np.float32))
            gens_list = [int(r.generations_used) for r in runs]
            fits = rescore(finals)
            boundaries = [max(gens_list)]
            seg_fits = fits[:, None]
            extra = {"generations_used": gens_list,
                     "solver": f"{solver.__name__} (es/staged.py, default knobs; its own "
                               "stage and alias budget: see generations_used)"}
        else:
            finals, trajs = [], []
            for s in seeds:
                bv, bvs, boundaries = segmented_run(s, cfg, audio, args.gens, args.segment_gens,
                                                    dev)
                finals.append(bv)
                trajs.append(bvs)
            fits = rescore(torch.stack(finals))
            trajs = torch.stack(trajs)  # (S, segments, D)
            seg_fits = rescore(trajs.reshape(-1, trajs.shape[-1])).reshape(args.seeds,
                                                                           len(boundaries))
            extra = {}
        if dev.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        results[name] = {
            "median": float(np.median(fits)),
            "mean": float(fits.mean()),
            "min": float(fits.min()),
            "max": float(fits.max()),
            "fits": fits.tolist(),
            "boundaries_gens": [int(b) for b in boundaries],
            "rescored_trajectory": np.round(seg_fits, 6).tolist(),
            "generations_to_converge": {
                key: gens_to_converge(seg_fits, boundaries, t) for key, t in thr_items
            },
            "seconds": seconds,
            **extra,
        }
        gtc = results[name]["generations_to_converge"]
        print("%-16s median=%.1f mean=%.1f [%.1f, %.1f]  %s  (%d seeds @%d, %.1fs; rescored "
              "in f32)" % (
                  name, np.median(fits), fits.mean(), fits.min(), fits.max(),
                  "  ".join(f"gens-to-{k}: median={v.get('median_gens')} "
                            f"({100 * v['frac_converged']:.0f}%)" for k, v in gtc.items()),
                  args.seeds, args.seed_offset, seconds), flush=True)

    run_meta = dict(gens=args.gens, pop=pop, mu=args.mu, segment_gens=args.segment_gens,
                    thresholds={k: v for k, v in thr_items},
                    thresholds_rel=args.thresholds_rel, mutation_noise=args.mutation_noise,
                    topology=args.topology,
                    true_genes=list(TRUE_GENES_BY_TOPOLOGY[args.topology]),
                    paired="the same init_state seed per seed index across variants "
                           "(within a split)",
                    scoring="recovered params re-evaluated by the unfused true-f32 engine "
                            "(torch.sin, TF32 off)",
                    device=card(dev))
    doc = {"meta": {}, "splits": {}}
    if args.json:
        try:
            with open(args.json) as f:
                loaded = json.load(f)
            if "splits" in loaded:
                doc = loaded
        except (OSError, json.JSONDecodeError):
            pass
        existing = doc["splits"].get(split, {})
        if existing.get("seed_offset") == args.seed_offset and existing.get("seeds") == args.seeds:
            # pair only with stored variants of the same settings
            stored = existing.get("meta") or doc.get("meta") or {}
            keys = ("gens", "pop", "mu", "topology", "mutation_noise")
            mismatch = {k: (stored.get(k), run_meta[k]) for k in keys
                        if k in stored and stored.get(k) != run_meta[k]}
            if mismatch:
                print(f"NOT merging stored split '{split}': settings differ {mismatch}")
            else:
                for k, v in existing.get("results", {}).items():
                    results.setdefault(k, v)

    if "f32" in results:
        base_fits = np.asarray(results["f32"]["fits"])
        for name in results:
            if name == "f32":
                continue
            st = paired_stats(np.asarray(results[name]["fits"]), base_fits)
            results[name]["paired_vs_f32"] = st
            verdict = ("PASS (parity not rejected)"
                       if st["sign_test_p"] > 0.05 and st["wilcoxon_p"] > 0.05
                       else ("PASS (variant better)" if st["median_ratio"] < 1.0 else "FAIL"))
            print("%-16s vs f32: median ratio=%.3f CI95=[%.3f, %.3f] better=%.0f%% "
                  "sign_p=%.3f wilcoxon_p=%.3f -> %s" % (
                      name, st["median_ratio"], *st["median_ratio_ci95"],
                      100 * st["frac_variant_better"], st["sign_test_p"], st["wilcoxon_p"],
                      verdict), flush=True)

    if args.json:
        doc["meta"] = run_meta
        doc["splits"][split] = {"seed_offset": args.seed_offset, "seeds": args.seeds,
                                "meta": run_meta, "results": results}
        with open(args.json, "w") as f:
            json.dump(doc, f, separators=(",", ":"))
        print(f"wrote {args.json} (split={split})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
