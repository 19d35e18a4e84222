"""On-card smoke test of the PyTorch/CUDA port (pmfm_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels with nvcc, holds each kernel against its plain
PyTorch version at the bench shapes (population 2^15, mu 256, fm3_series,
n 1024, K 512, int8 folded DFT, sine order 7), drives the bench ES through
``pmfm_tpu_torch.es.pipeline.evolve`` under fused_generation (kernel B2) and
fused_kernel (kernel B1), and times each kernel. One flushed line per phase;
every time is printed beside the card's name and power limit.

The second-to-last line is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``, printed only when every phase
passed. Without a CUDA device the script exits 2 and prints no result. A
watchdog ends a hung run with a traceback and a non-zero code.
"""
import faulthandler
import json
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
PLAIN_RUNS = 3
SEED = 20261017

# B1 fitness: kernel and plain version make the same int8 audio and exact
# int32 DFT sums and differ only in the order of the float32 sum over bins,
# so errors should sit at float32 rounding (~1e-7). The bound also admits
# the rare int8 rounding flip that a different phase summation order would
# cause: the tolerance tests/test_torch_kernels.py holds against the
# reference.
FIT_MAX_REL, FIT_MEDIAN_REL = 1e-3, 1e-5
# B2 steps: exp/pow may differ by an ulp or two between libm builds.
STEP_MAX_REL = 1e-6

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, int8 ops/s, f32 FLOP/s
PEAK_BYTES, PEAK_INT8, PEAK_F32 = 3.35e12, 1979e12, 67e12

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
    one synchronise at the end, so the device does not wait on the host
    between them and each interval is one call's device time."""
    fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(runs + 1)]
    events[0].record()
    for e in events[1:]:
        fn()
        e.record()
    events[-1].synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in zip(events, events[1:]))


def rel_err(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return (x - ref).abs() / ref.abs().clamp_min(1e-30)


def synth_ops_f32(pop: int, n: int, k: int, kn: int, ncoef: int) -> float:
    """float32 operations of the fused evaluation, counted from the kernel:
    per sample the phase (2), per modulating oscillator its sine
    (5 + 2*(ncoef-1)) plus gain, bias and two prefix adds (4), the output sine
    and rounding; per bin the edge term, magnitude, rescale and L2 (12)."""
    sine = 5 + 2 * (ncoef - 1)
    per_sample = 2 + (kn - 1) * (sine + 4) + sine + 1
    return float(pop) * (n * per_sample + 12 * k)


def bound(bytes_moved: float, int8_ops: float, f32_ops: float):
    times = {
        "bytes": bytes_moved / PEAK_BYTES,
        "operations": max(int8_ops / PEAK_INT8, f32_ops / PEAK_F32),
    }
    by = max(times, key=times.get)
    return times[by] * 1e3, by


class Smoke:
    def __init__(self, device: str = "cuda"):
        self.dev = torch.device(device)
        self.kernels = {}
        self.failed = []

    def phase(self, name, fn):
        log(f"phase {name}: start")
        try:
            fn()
            log(f"phase {name}: ok")
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
        log(f"nvcc: built={res['built']} in {res['seconds']:.1f}s -> {res['path']}")
        for ln in res["log"].splitlines():
            if any(w in ln for w in ("Compiling entry", "registers", "spill", "smem")):
                print("  ptxas " + ln.strip(), flush=True)
        _build.library()

    # -- shared inputs --------------------------------------------------------
    def setup(self):
        from pmfm_tpu_torch.es import ESConfig, make_spectrum_ops
        from pmfm_tpu_torch.ops import synthesize_single, target_spectrum

        self.cfg = ESConfig(
            num_parents=MU, num_offspring=POP - MU, num_dimensions=D, topology=TOPOLOGY,
            audio_length_log2=LOG2N, synthesis_engine="scanless", spectrum_method="dft",
            dft_dtype="int8", mutation_noise="clt12", sine_order=7, fused_kernel=True,
            fused_generation=True, fused_evolve=False, pop_block=1024,
        )
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
        c = self.cfg
        return dict(
            pop=POP, param_mins=c.param_mins, param_maxs=c.param_maxs,
            alpha=c.alpha, beta=c.beta, beta_scale=c.beta_scale,
            root_two_over_pi=c.root_two_over_pi, clamp_values=c.clamp_values,
            min_step=c.min_step, **self.b1_kwargs(pop_block),
        )

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
        gm, gv = float(g.mean()), float(g.var())
        log(f"B2 draws: CLT gaussian mean {gm:.3e} var {gv:.5f} (expect 0, {1 / 36:.5f}); "
            f"coin mean {coin:.4f}; parent-index chi2 {chi2:.1f} on {MU - 1} dof")
        m = POP * D  # draws of each kind; bounds at 6 standard errors
        require(abs(gm) < 6 * (1 / 36 / m) ** 0.5, "CLT draw mean off")
        require(abs(gv - 1 / 36) < 6 * (1 / 36) * (2 / m) ** 0.5, "CLT draw variance off")
        require(abs(coin - 0.5) < 6 * 0.5 / m**0.5, "coin not fair")
        require(chi2 < (MU - 1) + 6 * (2 * (MU - 1)) ** 0.5, "parent index not uniform")
        self.kernels["fused_generation"] = {"max_abs_err": float((fk - fp).abs().max())}

    # -- 5 ------------------------------------------------------------------
    def evolve_run(self, cfg, name):
        from pmfm_tpu_torch.es import evolve, init_state
        from pmfm_tpu_torch.kernels import fused_generation, fused_synth_fitness

        evolve(init_state(1, cfg, device=self.dev), self.target, 2, self.so, cfg)  # warm-up
        state = init_state(7, cfg, device=self.dev)
        torch.cuda.synchronize()
        fused_generation.launches = 0
        fused_synth_fitness.launches = 0
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        final, traj = evolve(state, self.target, GENERATIONS, self.so, cfg, record_trajectory=True)
        b.record()
        b.synchronize()
        launches = {"fused_generation": fused_generation.launches,
                    "fused_synth_fitness": fused_synth_fitness.launches}
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
        return launches

    def evolve_both(self):
        la = self.evolve_run(self.cfg, "a: fused_generation -> B2")
        require(la["fused_generation"] == GENERATIONS, "B2 launches != generations")
        require(la["fused_synth_fitness"] == 0, "setting (a) launched B1")
        cfg_b = self.cfg.replace(fused_generation=False)
        lb = self.evolve_run(cfg_b, "b: fused_kernel -> torch offspring + B1")
        require(lb["fused_synth_fitness"] >= GENERATIONS, "B1 launches < generations")
        require(lb["fused_generation"] == 0, "setting (b) launched B2")
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
                "pmfm_tpu_torch/csrc/fused_eval.cu", "pmfm_tpu/kernels/synth_fitness.py:767",
            ),
            "fused_generation": (
                b2, b2_plain, 2 * MU * D * 4 + operand + k * 4 + POP * 4 + 2 * POP * D * 4,
                POP * D * 12 * 2.0,  # CLT sums and the mutation, f32
                "pmfm_tpu_torch/csrc/fused_eval.cu", "pmfm_tpu/kernels/generation.py:438",
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

    def kernels_line(self):
        keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms")
        out = []
        for name in ("fused_synth_fitness", "fused_generation"):
            row = dict(self.kernels.get(name, {}), name=name)
            missing = [k for k in keys if k not in row]
            require(not missing, f"{name}: no {missing}")
            out.append({k: row[k] for k in keys})
        return {"kernels": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    import pmfm_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    s = Smoke()
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
    s.phase("5 evolve", s.evolve_both)
    s.phase("6 kernel times", s.timings)
    line = None
    try:
        line = s.kernels_line()
    except AssertionError:
        s.failed.append("7 kernels line")
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
