"""The port's benchmark suite (``pmfm_tpu_torch.bench_suite``) against the
reference's (``pmfm_tpu.bench_suite``), and the operand disk cache, on the
CPU.

* Every suite of both packages runs with its timing and its runs stubbed out
  (``_steady_time``, ``_make_runner``, ``make_spectrum_ops``, ``match_many``
  and, in the reference, ``jax.jit``, monkeypatched on the modules without
  editing them): the rows each would write (names in order, workloads) and
  the runs behind them (every ``ESConfig`` field and the generations) are
  equal, field by field. The stated exceptions are the engine annotations
  of chunk_size's rows (``ENGINE_EXCEPTIONS``): the reference names its
  fused_generation engine ``fused_kernel`` on its CPU backend. Elsewhere
  the two ladders agree on the suite's frames (ROADMAP lists the bf16
  configs where they part).
* ``main`` runs four suites on the CPU at a tiny size and writes the
  reference's CSV columns.
* The operand cache: a file written by either package loads in the other
  bit for bit (int8, bf16 and f32 operands, at a small n through the
  private functions), a truncated or stale file is rebuilt, and
  ``es.pipeline.make_spectrum_ops`` passes ``cfg.operand_cache_dir``.
"""
import csv
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pmfm_tpu.bench_suite as jbs
import pmfm_tpu.es as jes
import pmfm_tpu.es.pipeline as jpipeline
import pmfm_tpu.kernels.evolve  # noqa: F401  (imported before jax.jit is stubbed)
import pmfm_tpu.kernels.synth_fold  # noqa: F401
import pmfm_tpu.kernels.synth_stream  # noqa: F401
from pmfm_tpu.ops import spectral as jspec
from pmfm_tpu.utils import CSV_FIELDS as J_CSV_FIELDS
import pmfm_tpu_torch.bench_suite as tbs
import pmfm_tpu_torch.es as tes
import pmfm_tpu_torch.es.pipeline as tpipeline
from pmfm_tpu_torch.es import ESConfig
from pmfm_tpu_torch.ops import spectral as tspec
from pmfm_tpu_torch.utils import stage_bench

ARGS = ["--pop", "64", "--parents", "8", "--log2", "8", "--gens", "2", "--fused"]


class _Recorder:
    """A Benchmarker that records what a suite writes."""

    def __init__(self, events):
        self.events = events

    def add_timer(self, name, ms):
        self.events.append(("row", name))

    def set_workload(self, name, population=None, generations=None):
        self.events.append(("workload", name, population, generations))

    def elapsed_timer(self, name):
        return {}


def _stand_in(cfg, ref: bool):
    """SpectrumOps holding only what the suites and the engine gates read:
    a one-element folded operand of the config's dtype where the real one
    would exist (the real operands at n >= 8192 take seconds to minutes)."""
    n, bins = cfg.n_samples, cfg.num_bins or cfg.n_samples // 2
    method = tspec.resolve_method(n, bins, cfg.spectrum_method, cfg.dft_dtype)
    dft = method == "dft"
    scale = 1e-6 if dft and cfg.dft_dtype == "int8" else 0.0
    if ref:
        jdt = {"int8": jnp.int8, "bfloat16": jnp.bfloat16, "float32": jnp.float32}[cfg.dft_dtype]
        one = jnp.zeros(1, jnp.bfloat16) if dft else None
        return jspec.SpectrumOps(
            n=n, num_bins=bins, window=jnp.ones(1), norm=0.0, dft_cos=one, dft_sin=one,
            method=method, dft_dtype=jnp.bfloat16, dft_packed=jnp.zeros(1, jdt) if dft else None,
            dft_packed_scale=scale, factored=object() if method == "dft_factored" else None)
    tdt = {"int8": torch.int8, "bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dft_dtype]
    one = torch.zeros(1, dtype=torch.bfloat16) if dft else None
    return tspec.SpectrumOps(
        n=n, num_bins=bins, window=torch.ones(1), norm=0.0, dft_cos=one, dft_sin=one,
        method=method, dft_dtype=torch.bfloat16,
        dft_packed=torch.zeros(1, dtype=tdt) if dft else None, dft_packed_scale=scale,
        factored=object() if method == "dft_factored" else None)


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _capture(monkeypatch, ref: bool, suite: str, argv):
    """The events of one suite of one package: its rows and workloads, and
    each run (``("run", config fields, generations)``), spectrum build
    (``("ops", fields)``) and ``match_many`` call (with its target count)."""
    mod, es, pipe = (jbs, jes, jpipeline) if ref else (tbs, tes, tpipeline)
    events = []

    def runner(cfg, gens, so=None, **kw):
        events.append(("run", _fields(cfg), gens))
        return lambda: None

    def ops(cfg, **kw):
        events.append(("ops", _fields(cfg)))
        return _stand_in(cfg, ref)

    def many(targets, cfg, *a, num_generations=1000, **kw):
        events.append(("match_many", _fields(cfg), num_generations, len(targets)))

    monkeypatch.setattr(mod, "_steady_time", lambda fn, *a, reps=3: 1.0)
    monkeypatch.setattr(mod, "_make_runner", runner)
    monkeypatch.setattr(es, "make_spectrum_ops", ops)
    monkeypatch.setattr(pipe, "match_many", many)
    args = tbs.parse_args(argv)  # the reference's flags: its suites read the same args
    if ref:  # the reference's stage and frame loops are jitted closures
        def jit(f):  # a closure's jit (a module's decorators ran at its import)
            return lambda *a, **k: jnp.float32(0.0)

        monkeypatch.setattr(jax, "jit", jit)
    else:
        args.device = torch.device("cpu")
        monkeypatch.setattr(stage_bench, "timed_loop", lambda fn, x, iters=20: 1.0)
    mod.SUITES[suite](args, _Recorder(events))
    return events


# chunk_size row names that differ, (reference, port): the reference names
# the fused_generation engine fused_kernel on its CPU backend
ENGINE_EXCEPTIONS = {
    ("[fused_kernel]", "[fused_generation]"),
}


def _compare(ref_events, got_events):
    assert len(ref_events) == len(got_events)
    for r, g in zip(ref_events, got_events):
        assert r[0] == g[0], (r, g)
        if r[0] in ("run", "ops", "match_many"):
            rf, gf = r[1], g[1]
            common = set(rf) & set(gf)
            assert common >= set(gf) - {"operand_cache_dir"}, set(gf) - set(rf)
            for k in sorted(common):
                assert rf[k] == gf[k], (k, rf[k], gf[k])
            assert r[2:] == g[2:], (r[2:], g[2:])
        elif r != g:
            ref_tag, got_tag = r[1][r[1].find("["):], g[1][g[1].find("["):]
            assert r[1][: r[1].find("[")] == g[1][: g[1].find("[")], (r, g)
            assert (ref_tag.split(",")[0] + "]" if "," in ref_tag else ref_tag,
                    got_tag.split(",")[0] + "]" if "," in got_tag else got_tag) in \
                ENGINE_EXCEPTIONS, (r, g)
            assert r[2:] == g[2:]


@pytest.mark.parametrize("engine", ["default", "flagship"])
@pytest.mark.parametrize("suite", list(jbs.SUITES))
def test_suite_rows_match_reference(monkeypatch, suite, engine):
    """Each suite writes the reference's rows over the reference's runs:
    names, workloads, every config field and the generations."""
    assert list(tbs.SUITES) == list(jbs.SUITES)
    argv = ARGS + ["--engine", engine, "--operand-cache", "/nonexistent/cache"]
    ref = _capture(monkeypatch, True, suite, argv)
    monkeypatch.undo()
    got = _capture(monkeypatch, False, suite, argv)
    assert any(e[0] == "row" for e in got)
    _compare(ref, got)


def test_suite_tables_are_the_references():
    """The port's copies of the reference's tables."""
    assert tbs.ENGINES == jbs.ENGINES
    assert list(tbs.TOPOLOGIES) == ["fm2", "fm3_series", "fm3_parallel", "fm4_series",
                                    "fm5_series", "fm4_parallel"]
    assert [list(t) for t in tbs.TRUE_SETS] == [
        [3078.0, 2.0, 3015.0, 1.5, 3141.0, 1.0], [2400.0, 3.0, 1800.0, 2.0, 900.0, 4.0],
        [440.0, 6.0, 880.0, 1.2, 1760.0, 2.5], [3520.0, 1.0, 2637.0, 3.3, 1975.0, 0.8]]


@pytest.mark.parametrize("suite", ["overall", "stages", "optimizations", "topologies"])
def test_main_on_the_cpu_writes_the_csv(tmp_path, capsys, suite):
    """``main`` at a tiny size on the CPU (the kernels' plain versions): one
    CSV row a timer, in the reference's columns, with positive times."""
    path = tmp_path / "suite.csv"
    assert tbs.main(["--suite", suite, *ARGS, "--csv", str(path)], device="cpu") == 0
    out = capsys.readouterr().out
    assert f"=== {suite} ===" in out and f"wrote {path}" in out
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    assert tuple(rows[0]) == J_CSV_FIELDS and len(J_CSV_FIELDS) == 9
    want = {"overall": 1, "stages": 6, "optimizations": len(tbs.OPT_VARIANTS),
            "topologies": len(tbs.TOPOLOGIES)}[suite]
    assert len(rows) == 1 + want
    for row in rows[1:]:
        assert len(row) == 9 and float(row[1]) > 0.0
    if suite == "stages":
        assert [r[0] for r in rows[1:]] == ["recombinePopulation", "mutatePopulation",
                                             "synthesisePopulation", "applyWindow+FFT",
                                             "fitness+sort(topk)", "evaluateFused"]


def test_main_needs_a_card_unless_asked_for_the_cpu():
    """The suite runs on the card by default: without one it raises rather
    than timing the CPU under a device's name."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tbs.main(["--suite", "overall", *ARGS])


# ---- the operand disk cache ------------------------------------------------------

CACHE_N, CACHE_BINS = 256, 96


def _build(pkg, n, dtype):
    """``_build_dft_operands`` of a package at ``dtype`` ("int8", "bfloat16"
    or "float32"), as its make_spectrum_ops calls it."""
    w = tspec.hann_window(n)
    norm = 1.0 / (n * tspec.window_factor(n))
    int8 = dtype == "int8"
    if pkg == "ref":
        out = np.dtype(jnp.bfloat16) if dtype != "float32" else np.dtype(np.float32)
        return jspec._build_dft_operands(n, CACHE_BINS, w, norm, int8, out), out
    out = "bfloat16" if dtype != "float32" else "float32"
    return tspec._build_dft_operands(n, CACHE_BINS, w, norm, int8, out), out


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_operand_cache_files_are_interchangeable(tmp_path, dtype):
    """A file the reference writes loads in the port, and the other way
    round, bit for bit and under the same name."""
    int8 = dtype == "int8"
    (rc, rs, rp), rout = _build("ref", CACHE_N, dtype)
    (tc, ts, tp), tout = _build("port", CACHE_N, dtype)
    for a, b in ((rc, tc), (rs, ts), (rp, tp)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert (jspec._operand_cache_file("d", CACHE_N, CACHE_BINS, rout, int8)
            == tspec._operand_cache_file("d", CACHE_N, CACHE_BINS, tout, int8))
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    jspec._save_operand_cache(str(ref_dir), CACHE_N, CACHE_BINS, rout, int8, rc, rs, rp)
    got = tspec._load_operand_cache(str(ref_dir), CACHE_N, CACHE_BINS, tout, int8)
    assert got is not None
    for a, b in zip(got, (tc, ts, tp)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    tspec._save_operand_cache(str(port_dir), CACHE_N, CACHE_BINS, tout, int8, tc, ts, tp)
    back = jspec._load_operand_cache(str(port_dir), CACHE_N, CACHE_BINS, rout, int8)
    assert back is not None
    for a, b in zip(back, (rc, rs, rp)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert not list(port_dir.glob("*.tmp"))  # the atomic write leaves no temporary


def test_operand_cache_rebuilds_a_bad_file(tmp_path):
    """A truncated file, or one whose operand has another dtype or shape,
    loads as nothing: make_spectrum_ops builds anew and overwrites it."""
    (c, s, p), out = _build("port", CACHE_N, "bfloat16")
    tspec._save_operand_cache(str(tmp_path), CACHE_N, CACHE_BINS, out, False, c, s, p)
    path = tspec._operand_cache_file(str(tmp_path), CACHE_N, CACHE_BINS, out, False)
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[: len(data) // 2])
    assert tspec._load_operand_cache(str(tmp_path), CACHE_N, CACHE_BINS, out, False) is None
    np.savez(path, cos=c.view(np.uint16), sin=s.view(np.uint16))  # no packed
    assert tspec._load_operand_cache(str(tmp_path), CACHE_N, CACHE_BINS, out, False) is None
    np.savez(path, cos=c.view(np.uint16), sin=s.view(np.uint16), packed=p.view(np.uint16)[:, :8])
    assert tspec._load_operand_cache(str(tmp_path), CACHE_N, CACHE_BINS, out, False) is None
    # make_spectrum_ops above the cache's size floor rebuilds and rewrites it
    monkey = tspec.OPERAND_CACHE_MIN_N
    try:
        tspec.OPERAND_CACHE_MIN_N = CACHE_N
        so = tspec.make_spectrum_ops(CACHE_N, CACHE_BINS, dft_dtype="bfloat16",
                                     cache_dir=str(tmp_path), device="cpu")
    finally:
        tspec.OPERAND_CACHE_MIN_N = monkey
    fresh = tspec._load_operand_cache(str(tmp_path), CACHE_N, CACHE_BINS, out, False)
    assert fresh is not None and np.array_equal(fresh[2], p)
    assert torch.equal(so.dft_packed.view(torch.int16), torch.from_numpy(p))


def test_make_spectrum_ops_reads_and_writes_the_cache(monkeypatch, tmp_path):
    """Above ``OPERAND_CACHE_MIN_N`` a second build loads the file instead
    of building; below it no file is written; ``es.pipeline`` passes
    ``cfg.operand_cache_dir``."""
    monkeypatch.setattr(tspec, "OPERAND_CACHE_MIN_N", CACHE_N)
    calls = []
    build = tspec._build_dft_operands
    monkeypatch.setattr(tspec, "_build_dft_operands",
                        lambda *a: calls.append(a[0]) or build(*a))
    first = tspec.make_spectrum_ops(CACHE_N, dft_dtype="int8", cache_dir=str(tmp_path),
                                    device="cpu")
    second = tspec.make_spectrum_ops(CACHE_N, dft_dtype="int8", cache_dir=str(tmp_path),
                                     device="cpu")
    assert calls == [CACHE_N]
    assert torch.equal(first.dft_packed, second.dft_packed)
    assert torch.equal(first.dft_cos.view(torch.int16), second.dft_cos.view(torch.int16))
    assert len(list(tmp_path.glob("dftops_v1_n256_k128_bfloat16_int8.npz"))) == 1
    tspec.make_spectrum_ops(CACHE_N // 2, dft_dtype="int8", cache_dir=str(tmp_path / "small"),
                            device="cpu")
    assert not (tmp_path / "small").exists()
    seen = []
    monkeypatch.setattr(tspec, "make_spectrum_ops",
                        lambda *a, **k: seen.append(k.get("cache_dir")))
    cfg = ESConfig(num_parents=4, num_offspring=12, num_dimensions=6, audio_length_log2=8,
                   operand_cache_dir=str(tmp_path))
    tpipeline.make_spectrum_ops(cfg, device="cpu")
    assert seen == [str(tmp_path)]
