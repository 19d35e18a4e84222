"""The unfused engines of pmfm_tpu_torch (``xla_dft``, ``xla_folded_dft`` in
int8 and bf16, ``xla_rfft``; ROADMAP Queue A item 3) against pmfm_tpu's
``evaluate`` and spectra, the spectrum-method resolution, recombine's
``compat_shuffle`` and ``off`` modes, the oracle against the scan and
scanless synthesis, and the scan kernel's launch, all on the CPU.

Inputs are made with numpy from fixed seeds and handed to both packages.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmfm_tpu.es import ESConfig as JConfig
from pmfm_tpu.es import strategy as jstrategy
from pmfm_tpu.ops import oracle as joracle
from pmfm_tpu.ops import spectral as jspec
from pmfm_tpu.ops import synthesis as jsyn
from pmfm_tpu_torch import interop
from pmfm_tpu_torch.es import ESConfig as TConfig
from pmfm_tpu_torch.es import strategy as tstrategy
from pmfm_tpu_torch.kernels import scan as tscan
from pmfm_tpu_torch.ops import oracle as toracle
from pmfm_tpu_torch.ops import spectral as tspec
from pmfm_tpu_torch.ops import synthesis as tsyn

POP = 64
# mild-index parameter ranges: full-range fm3_series is chaotic, and a sine
# ulp that moves the scan's floor() then changes the audio by more than the
# spectra's own rounding
MAXS = {
    "fm2": (2000.0, 2.0, 2000.0, 1.0),
    "fm3_series": (2000.0, 2.0) * 3,
    "fm3_parallel": (2000.0, 2.0, 2000.0, 1.0) * 3,
}
ENGINES = {  # engine -> (spectrum_method, dft_dtype)
    "xla_dft": ("dft", "float32"),
    "xla_folded_dft_int8": ("dft", "int8"),
    "xla_folded_dft_bf16": ("dft", "bfloat16"),
    "xla_rfft": ("rfft", "float32"),
}
# fitness of the port against the reference, max / median relative. The
# median is the gate on the engine's arithmetic; the max admits a candidate
# whose audio moved by a float32 ulp (the scan: a sine ulp moving a floor()
# by one table step, ROADMAP Queue C; the scanless synthesis: prefix sums in
# another order, on another device), which the quantised engines can turn
# into a flipped int8 or bf16 step. Measured: max 1.1e-4, median 4.0e-7 here
# against the reference; the card against the CPU (chip_smoke.py phase 18,
# tests/test_torch_gpu.py, which use these limits) up to 6.9e-4 for int8
# on the scanless synthesis (an NVIDIA H100 80GB HBM3 at 700 W).
TOL = {
    "xla_dft": (1e-3, 1e-6),
    "xla_folded_dft_int8": (2e-3, 1e-6),
    "xla_folded_dft_bf16": (2e-3, 1e-6),
    "xla_rfft": (1e-3, 1e-6),
}


def _configs(engine, topology, synth, n):
    method, dtype = ENGINES[engine]
    d = jsyn.topology_dims(topology)
    kw = dict(num_parents=8, num_offspring=POP - 8, num_dimensions=d, topology=topology,
              param_mins=(0.0,) * d, param_maxs=MAXS[topology],
              audio_length_log2=n.bit_length() - 1, synthesis_engine=synth,
              spectrum_method=method, dft_dtype=dtype)
    return JConfig(**kw), TConfig(**kw)


def _inputs(topology, n, seed):
    d = jsyn.topology_dims(topology)
    rng = np.random.default_rng(seed)
    values = rng.random((POP, d)).astype(np.float32)
    target = (rng.random(n // 2) * 5.0).astype(np.float32)
    return values, target


def _rel(got, want):
    return np.abs(got - want) / np.maximum(np.abs(want), 1e-30)


@pytest.mark.parametrize("synth", ["scan", "scanless"])
@pytest.mark.parametrize("topology", ["fm2", "fm3_series", "fm3_parallel"])
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_unfused_evaluate_matches_reference(engine, topology, synth):
    """Each unfused engine's evaluate against the reference's on the same
    values and target, n 256."""
    _evaluate_case(engine, topology, synth, 256)


@pytest.mark.parametrize("synth", ["scan", "scanless"])
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_unfused_evaluate_matches_reference_n1024(engine, synth):
    """The same at n 1024, fm3_series (the bench's frame and chain)."""
    _evaluate_case(engine, "fm3_series", synth, 1024)


def _evaluate_case(engine, topology, synth, n):
    jc, tc = _configs(engine, topology, synth, n)
    jso = jspec.make_spectrum_ops(n, method=jc.spectrum_method, dft_dtype=jnp.dtype(jc.dft_dtype))
    tso = tspec.make_spectrum_ops(n, method=tc.spectrum_method, dft_dtype=tc.dft_dtype,
                                  device="cpu")
    assert jstrategy.active_engine(jc, jso) == tstrategy.active_engine(tc, tso) == \
        engine.removesuffix("_int8").removesuffix("_bf16")
    values, target = _inputs(topology, n, seed=n + len(topology))
    want = np.asarray(jstrategy.evaluate(jnp.asarray(values), jnp.asarray(target), jso, jc))
    got = tstrategy.evaluate(torch.from_numpy(values), torch.from_numpy(target), tso, tc).numpy()
    assert got.shape == want.shape == (POP,) and np.isfinite(got).all()
    e = _rel(got, want)
    max_rel, median_rel = TOL[engine]
    assert e.max() <= max_rel and np.median(e) <= median_rel, (e.max(), np.median(e))


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_folded_spectrum_same_audio(dtype):
    """``magnitude_spectrum_folded`` on the same audio as the reference's: the
    int8 quantisation and its int32 sums are exact, so the int8 spectra agree
    to float32 rounding of the rescale; bf16 to float32 sums in another
    order."""
    n = 1024
    audio = (np.random.default_rng(4).standard_normal((n, POP)) * 300.0).astype(np.float32)
    jso = jspec.make_spectrum_ops(n, dft_dtype=jnp.dtype(dtype))
    tso = tspec.make_spectrum_ops(n, dft_dtype=dtype, device="cpu")
    want = np.asarray(jspec.magnitude_spectrum_folded(jnp.asarray(audio), jso))
    got = tspec.magnitude_spectrum_folded(torch.from_numpy(audio), tso).numpy()
    peak = np.abs(want).max()
    assert np.abs(got - want).max() <= (1e-6 if dtype == "int8" else 1e-5) * peak


def test_folded_int8_samples_from_the_scan_gap():
    """The share of folded int8 samples that differ between the port's and
    the reference's xla_folded_dft on the scan synthesis (fm3_series, n 1024)
    comes from the scan's known sine-ulp gap alone: with the reference's
    audio fed to both quantisers the samples are bit-equal, and with each
    package's own audio at most 0.1% differ, by one step."""
    n = 1024
    d = 6
    rng = np.random.default_rng(21)
    p = (rng.random((POP, d)) * np.asarray(MAXS["fm3_series"], np.float32)).astype(np.float32)
    ja = np.asarray(jsyn.synthesize(jnp.asarray(p), n, "fm3_series"))
    ta = tsyn.synthesize(torch.from_numpy(p), n, "fm3_series").numpy()

    def quantise(audio):  # the folded int8 samples magnitude_spectrum_folded contracts
        x = audio.astype(np.float32)
        xr = np.concatenate([x[:1], x[1:][::-1]])[: n // 2]
        ap, am, edge = x[: n // 2] + xr, x[: n // 2] - xr, x[n // 2]
        peak = np.maximum(np.abs(ap).max(0), np.maximum(np.abs(am).max(0), np.abs(edge)))
        scale = np.float32(127.0) / np.maximum(peak, np.float32(1e-30))
        return np.rint(ap * scale).astype(np.int8), np.rint(am * scale).astype(np.int8)

    same = quantise(ja)
    own = quantise(ta)
    diff = sum(int((a != b).sum()) for a, b in zip(same, own))
    share = diff / (2 * POP * n // 2)
    assert share <= 1e-3, share
    assert max(int(np.abs(a.astype(int) - b.astype(int)).max()) for a, b in zip(same, own)) <= 1


@pytest.mark.parametrize("n", [256, 512, 1024, 2048, 4096, 8192, 12288, 16384, 24576, 32768,
                               65536])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("method", ["auto", "rfft", "dft"])
def test_spectrum_method_matches_reference(monkeypatch, method, dtype, n):
    """``resolve_method`` against the method the reference's
    ``make_spectrum_ops`` builds (its O(N^2) operand build stubbed out: only
    the resolution is compared), and the port's ops of the cheap methods."""
    half = n // 2
    monkeypatch.setattr(
        jspec, "_build_dft_operands",
        lambda n_, k, w, norm, int8_mode, out_dtype: (np.zeros((1, 1), np.float32),) * 2 + (None,))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jspec.make_spectrum_ops(n, method=method, dft_dtype=jnp.dtype(dtype)).method
        got = tspec.resolve_method(n, half, method, dtype)
        assert got == want
        if got in ("rfft", "dft_factored"):
            assert tspec.make_spectrum_ops(n, method=method, dft_dtype=dtype,
                                           device="cpu").method == want


@pytest.mark.parametrize("n", [1024, 24576])
def test_rfft_spectrum_matches_reference(n):
    """The rfft method's magnitudes (torch.fft.rfft; cuFFT on the card)
    against the reference's jnp.fft.rfft, float32, within 1e-5 of the peak."""
    audio = (np.random.default_rng(n).standard_normal((n, 8)) * 100.0).astype(np.float32)
    jso = jspec.make_spectrum_ops(n, method="rfft")
    tso = tspec.make_spectrum_ops(n, method="rfft", device="cpu")
    want = np.asarray(jspec.magnitude_spectrum(jnp.asarray(audio), jso))
    got = tspec.magnitude_spectrum(torch.from_numpy(audio), tso).numpy()
    assert got.shape == want.shape == (8, n // 2)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("pop,dims,wg,mu", [(32, 6, 32, 16), (64, 6, 8, 16), (256, 4, 32, 64),
                                            (96, 12, 16, 32)])
def test_compat_shuffle_index_bit_equal(pop, dims, wg, mu):
    np.testing.assert_array_equal(tstrategy._compat_shuffle_index(pop, dims, wg, mu),
                                  jstrategy._compat_shuffle_index(pop, dims, wg, mu))


@pytest.mark.parametrize("mode", ["compat_shuffle", "off"])
def test_recombine_deterministic_modes_bit_equal(mode):
    """compat_shuffle and off draw nothing, so the port's offspring equal the
    reference's exactly."""
    kw = dict(num_parents=16, num_offspring=48, recombine_mode=mode, workgroup_size=8)
    jc, tc = JConfig(**kw), TConfig(**kw)
    rng = np.random.default_rng(5)
    pv = rng.random((16, 6)).astype(np.float32)
    ps = rng.random((16, 6)).astype(np.float32)
    wv, ws = jstrategy.recombine(jax.random.PRNGKey(0), jnp.asarray(pv), jnp.asarray(ps), jc)
    gv, gs = tstrategy.recombine(torch.Generator(), torch.from_numpy(pv), torch.from_numpy(ps), tc)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


def test_compat_shuffle_rejects_what_reference_rejects():
    with pytest.raises(ValueError):
        jstrategy._compat_shuffle_index(30, 6, 8, 16)
    with pytest.raises(ValueError):
        tstrategy._compat_shuffle_index(30, 6, 8, 16)


@pytest.mark.parametrize("topology", ["fm2", "fm3_series", "fm4_series", "fm3_parallel"])
def test_oracle_copy_equals_reference(topology):
    """The port's numpy oracle is the reference's, sample for sample."""
    d = jsyn.topology_dims(topology)
    maxs = np.asarray(MAXS.get(topology, (2000.0, 2.0) * (d // 2)), np.float32)
    p = (np.random.default_rng(d).random(d) * maxs).astype(np.float32)
    want = joracle.OracleObjective(512).synthesize(p, topology)
    got = toracle.OracleObjective(512).synthesize(p, topology)
    np.testing.assert_array_equal(got, want)
    spec = toracle.OracleObjective(512).magnitude_spectrum(got)
    np.testing.assert_array_equal(spec, joracle.OracleObjective(512).magnitude_spectrum(want))


@pytest.mark.parametrize("engine", ["scan", "scanless"])
@pytest.mark.parametrize("topology", ["fm2", "fm3_series", "fm3_parallel"])
def test_oracle_against_scan_and_scanless(topology, engine):
    """The oracle (a float32 table, truncating lookups, one candidate at a
    time) is the ground truth for both synthesis engines, as in the
    reference's tests: the scan audio within 1e-3 of the amplitude at n 1024
    on mild-index candidates (the same recurrence; sine rounding against a
    table entry can move a floor() by one table step; measured 1.9e-4); the
    scanless engine's exact-phase oscillator drifts from the table's
    staircase, so its magnitude spectrum is held to the oracle's within 5e-2
    (relative L2) with the same peak bin."""
    n = 1024
    d = jsyn.topology_dims(topology)
    maxs = np.asarray(MAXS[topology], np.float32)
    p = (np.random.default_rng(13).random((4, d)) * maxs).astype(np.float32)
    got = tsyn.synthesize(torch.from_numpy(p), n, topology, engine=engine).numpy()
    oracle = toracle.OracleObjective(n)
    for i in range(4):
        want = oracle.synthesize(p[i], topology)
        if engine == "scan":
            assert np.abs(got[:, i] - want).max() <= 1e-3 * (np.abs(want).max() + 1e-6)
        else:
            sg = oracle.magnitude_spectrum(got[:, i])
            sw = oracle.magnitude_spectrum(want)
            assert np.linalg.norm(sg - sw) <= 5e-2 * np.linalg.norm(sw)
            assert np.argmax(sg) == np.argmax(sw)


@pytest.mark.parametrize("topology,want_topo,want_k", [
    ("fm2", 0, 1), ("fm3_series", 1, 3), ("fm8_series", 1, 8), ("fm12_series", 1, 12),
    ("fm3_parallel", 2, 3), ("fm6_parallel", 2, 6)])
def test_scan_launch(monkeypatch, topology, want_topo, want_k):
    """The scan kernel's launch (csrc/scan_synth.cu): a thread a candidate in
    blocks of 128 (its rule made to refuse the time-parallel layout, whose
    geometry is tests/test_torch_scan_tp.py's), the topology code and chain
    length, and the float32 constants the plain loop uses."""
    monkeypatch.setattr(tscan, "scan_tp_faster", lambda pop: False)
    la = tscan.scan_launch(1000, 2048, topology, "table", torch.bfloat16)
    assert (la["grid"], la["block"]) == (8, 128)
    assert (la["topo"], la["k"], la["osc"], la["bf16"]) == (want_topo, want_k, 2, 1)
    assert la["inv_k"] == float(np.float32(1.0 / want_k))
    assert la["w2sr"] == float(np.float32(32768 / 44100.0))
    assert la["scale"] == float(np.float32(2.0 * np.pi / 32767.0)) and la["table_max"] == 32767
    assert tscan.scan_launch(1, 256, topology, "floor", torch.float32)["grid"] == 1
    with pytest.raises(ValueError):
        tscan.scan_launch(8, 256, topology, "cubic", torch.float32)
    with pytest.raises(ValueError):
        tscan.scan_launch(8, 256, topology, "floor", torch.float16)


def test_scan_plain_bf16_is_the_float32_audio_rounded():
    p = torch.from_numpy((np.random.default_rng(2).random((8, 6)) * 1000.0).astype(np.float32))
    f = tscan.scan_synth_plain(p, 256, "fm3_series")
    b = tscan.scan_synth_plain(p, 256, "fm3_series", out_dtype=torch.bfloat16)
    assert b.dtype == torch.bfloat16 and torch.equal(b, f.to(torch.bfloat16))


def test_unfused_engine_config_fields_reach_the_port():
    """The ESConfig fields the unfused engines read exist on both sides with
    the same defaults (interop carries the state; these carry the engine)."""
    names = ("synthesis_engine", "osc_mode", "spectrum_method", "dft_dtype", "recombine_mode",
             "workgroup_size", "num_frames")
    jd = {f.name: f.default for f in dataclasses.fields(JConfig)}
    td = {f.name: f.default for f in dataclasses.fields(TConfig)}
    assert {k: td[k] for k in names} == {k: jd[k] for k in names}


def test_interop_carries_rfft_ops():
    """The reference's rfft SpectrumOps (no DFT operands) carried into the
    port give the port's own rfft spectra."""
    n = 2048
    jso = jspec.make_spectrum_ops(n, method="rfft")
    so = interop.spectrum_ops_from_numpy(
        n=jso.n, num_bins=jso.num_bins, window=np.asarray(jso.window), norm=jso.norm,
        dft_cos=None, dft_sin=None, dft_packed=None, dft_packed_scale=0.0, method=jso.method,
        device="cpu")
    audio = torch.from_numpy(np.random.default_rng(3).standard_normal((n, 4)).astype(np.float32))
    own = tspec.make_spectrum_ops(n, method="rfft", device="cpu")
    assert so.method == "rfft" and so.dft_dtype == torch.float32
    assert torch.equal(tspec.magnitude_spectrum(audio, so), tspec.magnitude_spectrum(audio, own))
