"""The port's large-frame path on the CPU against the reference: kernels B3
(``fused_synth_fold``) and B4 (``fused_synth_stream``) in their plain PyTorch
versions against the pmfm_tpu Pallas kernels in interpret mode (as
tests/test_ops.py::TestSynthFoldHybrid and tests/test_synth_stream.py run
them), the spectra that follow them, the scanless synthesis, the engine
routing and the factored operands carried by ``interop``.

Tolerances, and why:
* B3 int8 a+/-: at most 1 apart on under 1% of samples; mag_scale bit-equal
  (a bank's within one float32 ulp: the reference's mean of |amp_j| is not
  always the correctly rounded one).
  Both sides quantise the same turns-domain recurrence, but the reference
  sums each 128-sample block's phase increments with a triangular matmul and
  the port in sample order, so a few int8 roundings flip (ROADMAP Queue C).
* Prefolded spectrum on the same a+/-: the int8 sums are integers and must
  be bit-equal; spectra within 1e-6 relative (float32 epilogue).
* Factored spectrum: 1e-6 relative in float32 and in bf16. The port runs
  the reference's stages, casts included, on the same operands; the
  measured gaps are 1.3e-7 (float32) and 1.2e-8 (bf16), while a port that
  dropped one of the reference's bf16 casts would land near 2.8e-3, the
  reference's own gap to a float64 FFT.
* B4 f32 audio within 1e-3 of the amplitude (the phase-sum order again);
  spectra at tests/test_synth_stream.py's bounds.
* Scanless synthesis: 2e-3 relative, tests/test_scanless.py's bound.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmfm_tpu.es import ESConfig as JConfig
from pmfm_tpu.es import strategy as jstrategy
from pmfm_tpu.kernels.synth_fold import fused_synth_fold as j_fold
from pmfm_tpu.kernels.synth_stream import fused_synth_stream as j_stream
from pmfm_tpu.ops import scanless as jscanless
from pmfm_tpu.ops import spectral as jspec
from pmfm_tpu.ops import synthesis as jsyn
from pmfm_tpu_torch import interop
from pmfm_tpu_torch.es import ESConfig, active_engine, evaluate, make_spectrum_ops
from pmfm_tpu_torch.kernels import synth_fold as tfold
from pmfm_tpu_torch.kernels import synth_stream as tstream
from pmfm_tpu_torch.kernels.synth_fitness import bank_amp
from pmfm_tpu_torch.ops import scanless as tscanless
from pmfm_tpu_torch.ops import spectral as tspec
from pmfm_tpu_torch.ops import synthesis as tsyn

MAXS = {"fm2": (3520.0, 8.0) * 2, "fm3_series": (3520.0, 8.0) * 3,
        "fm3_parallel": (3520.0, 8.0, 3520.0, 1.0) * 3}
N, POP = 2048, 128


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _row_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b, axis=1) / (np.linalg.norm(b, axis=1) + 1e-30)


def _params(topology, pop=POP, seed=0, mild=False):
    maxs = np.asarray(MAXS[topology], np.float32).copy()
    if mild:
        maxs[1::2] = 0.5
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.1, 0.9, (pop, len(maxs))) * maxs).astype(np.float32)


def _ref_fold(params, topology, n, dft_scale, sine_order):
    out = j_fold(jnp.asarray(params), topology=topology, n=n, pop_block=params.shape[0],
                 interpret=True, dft_scale=dft_scale, sine_order=sine_order)
    return [np.array(x) for x in out]


def _port_fold(params, topology, n, dft_scale, sine_order, pop_block=POP):
    before = tfold.fused_synth_fold.launches
    out = tfold.fused_synth_fold(torch.from_numpy(params), topology=topology, n=n,
                                 dft_scale=dft_scale, sine_order=sine_order,
                                 pop_block=pop_block)
    assert tfold.fused_synth_fold.launches == before  # CPU tensors: the plain version
    return out


# -- B3 -----------------------------------------------------------------------

@pytest.mark.parametrize("topology", ["fm2", "fm3_series", "fm3_parallel"])
@pytest.mark.parametrize("sine_order", [7, 9])
def test_b3_plain_matches_reference_int8(topology, sine_order):
    _check_b3_int8(topology, sine_order, POP)


# the port's plain version in blocks of one candidate: the blocks an odd
# population above the block size is halved to, where a+ and a- once aliased
# the frame
@pytest.mark.parametrize("topology", ["fm2", "fm3_series"])
@pytest.mark.parametrize("sine_order", [7, 9])
def test_b3_plain_blocks_of_one_match_reference_int8(topology, sine_order):
    _check_b3_int8(topology, sine_order, 1)


def _check_b3_int8(topology, sine_order, pop_block):
    jso = jspec.make_spectrum_ops(N, dft_dtype=jnp.int8)
    p = _params(topology, seed=sine_order)
    ref = _ref_fold(p, topology, N, jso.dft_packed_scale, sine_order)
    ap, am, edge, ms = _port_fold(p, topology, N, jso.dft_packed_scale, sine_order, pop_block)
    assert ap.dtype == torch.int8 and am.dtype == torch.int8
    assert ap.shape == (N // 2, POP) and edge.shape == (POP,) and ms.shape == (POP,)
    assert ap.T.is_contiguous() and am.T.is_contiguous()  # candidate-major, as the kernel
    for got, want in ((ap, ref[0]), (am, ref[1])):
        d = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() < 0.01
    assert np.abs(edge.numpy() - ref[2]).max() <= 1.0
    if "parallel" in topology:
        # a bank's s = mean |amp_j|: the reference's lands one float32 ulp
        # off the correctly rounded mean (the port's, as its kernels') on
        # some candidates; B1/B2's bank rescales by the same s
        np.testing.assert_allclose(ms.numpy(), ref[3], rtol=2.0**-23, atol=0)
    else:
        np.testing.assert_array_equal(ms.numpy(), ref[3])


def test_b3_plain_matches_reference_bf16():
    _check_b3_bf16(POP)


def test_b3_plain_blocks_of_one_match_reference_bf16():
    _check_b3_bf16(1)


def test_b3_bank_plain_matches_reference_bf16():
    """An fm3_parallel bank in the bf16 mode: the pair mean rounded to bf16,
    as the reference's bank, in the chains' limits."""
    _check_b3_bf16(POP, "fm3_parallel")


def _check_b3_bf16(pop_block, topology="fm3_series"):
    """bf16 mode: bf16 audio, fold sums rounded once more, unit mag_scale;
    the spectra of both sides agree to the bf16 rounding flips."""
    jso = jspec.make_spectrum_ops(N, dft_dtype=jnp.bfloat16)
    tso = tspec.make_spectrum_ops(N, dft_dtype="bfloat16", device="cpu")
    p = _params(topology, seed=3)
    ref = _ref_fold(p, topology, N, 0.0, 9)
    ap, am, edge, ms = _port_fold(p, topology, N, 0.0, 9, pop_block)
    assert ap.dtype == torch.bfloat16 and np.all(ms.numpy() == 1.0)
    # the reference's interpret mode carries bf16-rounded values in f32
    np.testing.assert_array_equal(ref[0], ref[0].astype(jnp.bfloat16).astype(np.float32))
    want = np.asarray(jspec.magnitude_spectrum_prefolded(*map(jnp.asarray, ref), jso))
    got = tspec.magnitude_spectrum_prefolded(ap, am, edge, ms, tso).numpy()
    assert np.median(_row_rel(got, want)) < 1e-3 and _rel(got, want) < 1e-2


# -- the spectrum after B3 ------------------------------------------------------

def test_prefolded_int8_sums_bit_equal():
    jso = jspec.make_spectrum_ops(N, dft_dtype=jnp.int8)
    tso = tspec.make_spectrum_ops(N, dft_dtype="int8", device="cpu")
    assert torch.equal(tso.dft_packed, torch.from_numpy(np.array(jso.dft_packed)))
    p = _params("fm3_series", seed=5)
    ref = _ref_fold(p, "fm3_series", N, jso.dft_packed_scale, 7)
    k = jso.num_bins
    dn = (((1,), (0,)), ((), ()))
    import jax

    u_ref = np.asarray(jax.lax.dot_general(jso.dft_packed[:k], jnp.asarray(ref[0]), dn,
                                           preferred_element_type=jnp.int32))
    v_ref = np.asarray(jax.lax.dot_general(jso.dft_packed[k:], jnp.asarray(ref[1]), dn,
                                           preferred_element_type=jnp.int32))
    ap, am = torch.from_numpy(ref[0]), torch.from_numpy(ref[1])
    u, v = tspec.prefolded_uv(ap, am, tso)  # (P, K): the spectra's layout
    assert u.dtype == torch.int32 and u.shape == (POP, k)
    np.testing.assert_array_equal(u.numpy(), u_ref.T)
    np.testing.assert_array_equal(v.numpy(), v_ref.T)
    want = np.asarray(jspec.magnitude_spectrum_prefolded(*map(jnp.asarray, ref), jso))
    got = tspec.magnitude_spectrum_prefolded(
        ap, am, torch.from_numpy(ref[2]), torch.from_numpy(ref[3]), tso).numpy()
    assert got.shape == (POP, k)
    assert _row_rel(got, want).max() < 1e-6


@pytest.mark.parametrize("dft_dtype", ["bfloat16", "float32"])
def test_prefolded_bf16_matches_reference(dft_dtype):
    """bf16 a+/- against a bf16 operand, or against the refine tail's float32
    operand, which both sides round to bf16 before the product."""
    jso = jspec.make_spectrum_ops(N, dft_dtype=getattr(jnp, dft_dtype))
    tso = tspec.make_spectrum_ops(N, dft_dtype=dft_dtype, device="cpu")
    if dft_dtype == "float32":
        assert torch.equal(tso.dft_packed_bf16, tso.dft_packed.to(torch.bfloat16))
        # the reference casts the operand to a+'s dtype, which interpret mode
        # carries as f32: round it to bf16 as it does on the chip
        jso = jso._replace(dft_packed=jso.dft_packed.astype(jnp.bfloat16).astype(jnp.float32))
    p = _params("fm2", seed=6)
    ref = _ref_fold(p, "fm2", N, 0.0, 9)
    want = np.asarray(jspec.magnitude_spectrum_prefolded(*map(jnp.asarray, ref), jso))
    a = [torch.from_numpy(x) for x in ref]
    got = tspec.magnitude_spectrum_prefolded(a[0].to(torch.bfloat16), a[1].to(torch.bfloat16),
                                             a[2], a[3], tso).numpy()
    assert _row_rel(got, want).max() < 1e-5


# -- factored spectrum ----------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 1e-6)])
@pytest.mark.parametrize("prewindowed", [False, True])
def test_factored_spectrum_matches_reference(dtype, tol, prewindowed):
    jso = jspec.make_spectrum_ops(N, method="dft_factored", dft_dtype=jnp.dtype(dtype))
    tso = tspec.make_spectrum_ops(N, method="dft_factored", dft_dtype=dtype, device="cpu")
    assert tso.method == "dft_factored" and tso.dft_cos is None and tso.dft_packed is None
    assert (tso.factored.n1, tso.factored.n2) == (jso.factored.n1, jso.factored.n2)
    for name in ("c1", "s1n", "tw_re", "tw_imn", "c2", "s2n"):
        np.testing.assert_array_equal(getattr(tso.factored, name).numpy(),
                                      np.asarray(getattr(jso.factored, name)))
    audio = np.random.default_rng(7).standard_normal((N, 16)).astype(np.float32)
    want = np.asarray(jspec.magnitude_spectrum_factored(jnp.asarray(audio), jso,
                                                        prewindowed=prewindowed))
    got = tspec.magnitude_spectrum_factored(torch.from_numpy(audio), tso,
                                            prewindowed=prewindowed).numpy()
    assert got.shape == (16, N // 2)
    assert _rel(got, want) < tol


def test_factored_population_chunks(monkeypatch):
    tso = tspec.make_spectrum_ops(1024, method="dft_factored", device="cpu")
    audio = torch.from_numpy(np.random.default_rng(8).standard_normal((1024, 512)).astype(np.float32))
    whole = tspec.magnitude_spectrum_factored(audio, tso)
    monkeypatch.setattr(tspec, "FACTORED_CHUNK_BYTES", 28 * 1024 * 128)  # chunks of 128
    assert tspec._factored_chunk(1024, 512) == 128
    chunked = tspec.magnitude_spectrum_factored(audio, tso)
    assert _rel(chunked.numpy(), whole.numpy()) < 1e-6


def test_method_resolution():
    for n in (32768, 65536, 131072):
        assert tspec.resolve_method(n, n // 2, "dft", "int8") == "dft_factored"
        assert tspec.resolve_method(n, n // 2, "auto", "float32") == "dft_factored"
    assert tspec.resolve_method(16384, 8192, "dft", "int8") == "dft"
    assert tspec.resolve_method(16384, 8192, "auto", "int8") == "dft"
    so = tspec.make_spectrum_ops(65536, dft_dtype="int8", device="cpu")
    assert so.method == "dft_factored" and so.factored.n1 == 256 and so.dft_dtype == torch.bfloat16
    # where the reference picks rfft, so does the port
    assert tspec.resolve_method(8192, 4096, "auto", "float32") == "rfft"
    assert tspec.resolve_method(1024, 512, "rfft", "float32") == "rfft"


# -- B4 -----------------------------------------------------------------------

@pytest.mark.parametrize("topology,spec_tol", [("fm2", 2e-4), ("fm3_series", 2e-3),
                                               ("fm3_parallel", 2e-3)])
def test_b4_plain_matches_reference_f32(topology, spec_tol):
    """n = 2048: two 1024-sample chunks, so the phase carry is live."""
    jso = jspec.make_spectrum_ops(N, method="dft_factored", dft_dtype=jnp.float32)
    tso = tspec.make_spectrum_ops(N, method="dft_factored", device="cpu")
    p = _params(topology, seed=7)
    want = np.asarray(j_stream(jnp.asarray(p), jso.window, topology=topology, n=N,
                               pop_block=POP, interpret=True, audio_f32=True))
    assert tstream.stream_chunk(N) == 1024
    before = tstream.fused_synth_stream.launches
    got = tstream.fused_synth_stream(torch.from_numpy(p), tso.window, topology=topology, n=N,
                                     audio_f32=True)
    assert tstream.fused_synth_stream.launches == before
    assert got.dtype == torch.float32 and got.shape == (N, POP)
    amp = np.abs(_amp(p, topology))
    assert (np.abs(got.numpy() - want).max(axis=0) / amp).max() < 1e-3
    s_ref = np.asarray(jspec.magnitude_spectrum_factored(jnp.asarray(want), jso, prewindowed=True))
    s_got = tspec.magnitude_spectrum_factored(got, tso, prewindowed=True).numpy()
    rel = _row_rel(s_got, s_ref)
    assert np.median(rel) < spec_tol and np.mean(rel) < 10 * spec_tol


def _amp(p, topology):
    """The audio's amplitude: a chain's output amplitude, a bank's 1 (its
    audio is the mean of its pairs, each within its amplitude <= 1)."""
    return bank_amp(torch.from_numpy(p), topology, False).numpy()


def test_b4_plain_bf16_close():
    """bf16 emission stays within the bf16 envelope of the reference's f32
    audio (tests/test_synth_stream.py::test_bf16_stream_close's bound)."""
    jso = jspec.make_spectrum_ops(N, method="dft_factored", dft_dtype=jnp.float32)
    tso = tspec.make_spectrum_ops(N, method="dft_factored", dft_dtype="bfloat16", device="cpu")
    p = _params("fm3_series", seed=3)
    want = np.asarray(j_stream(jnp.asarray(p), jso.window, topology="fm3_series", n=N,
                               pop_block=POP, interpret=True, audio_f32=True))
    got = tstream.fused_synth_stream(torch.from_numpy(p), tso.window, topology="fm3_series", n=N)
    assert got.dtype == torch.bfloat16
    s_ref = np.asarray(jspec.magnitude_spectrum_factored(jnp.asarray(want), jso, prewindowed=True))
    s_got = tspec.magnitude_spectrum_factored(got, tso, prewindowed=True).numpy()
    assert _rel(s_got, s_ref) < 1.5e-2


# -- scanless synthesis -----------------------------------------------------------

SCANLESS_PARAMS = {
    "fm2": (880.0, 2.0, 2500.0, 0.9),
    "fm3_series": (3078.0, 2.0, 3015.0, 1.5, 3141.0, 1.0),
    "fm3_parallel": (880.0, 2.0, 2500.0, 0.9, 440.0, 1.0, 1200.0, 0.5, 660.0, 3.0, 800.0, 0.7),
}


@pytest.mark.parametrize("topology", list(SCANLESS_PARAMS))
def test_scanless_matches_reference(topology):
    p = np.asarray(SCANLESS_PARAMS[topology], np.float32)[None]
    want = np.asarray(jsyn.synthesize(jnp.asarray(p), 4096, topology, engine="scanless"))
    got = tsyn.synthesize(torch.from_numpy(p), 4096, topology, engine="scanless")
    assert got.shape == (4096, 1) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) < 2e-3


def test_exclusive_cumsum_mod_matches_reference():
    x = np.random.default_rng(4).uniform(-5e4, 5e4, (1024, 8)).astype(np.float32)
    want = np.asarray(jscanless.exclusive_cumsum_mod(jnp.asarray(x), 32768.0))
    got = tscanless.exclusive_cumsum_mod(torch.from_numpy(x), 32768.0).numpy()
    assert got.min() >= 0.0 and got.max() < 32768.0
    d = np.abs(got - want)
    d = np.minimum(d, 32768.0 - d)  # equal modulo the wavetable size
    # the intra-block sums reach 128 * 32768 ~ 4.2e6, where a float32 ulp is
    # 0.5: the two summation orders may differ by a few ulps
    assert d.max() <= 2.0 and np.median(d) <= 0.25


# -- routing ----------------------------------------------------------------------

FLAGSHIP = dict(num_dimensions=6, topology="fm3_series", dft_dtype="int8", sine_order=7,
                fused_generation=True, pop_block=1024, synthesis_engine="scanless",
                mutation_noise="clt12")


def _stand_ins(n):
    """SpectrumOps of both packages holding only what the gates read: a
    one-element operand of the right dtype where the real one would exist.
    (The real operands at n >= 8192 take minutes to build.)"""
    dft = n <= jspec.DFT_MAX_MATERIALIZE_N
    method = "dft" if dft else "dft_factored"
    assert tspec.resolve_method(n, n // 2, "dft", "int8") == method
    one8 = np.zeros((1,), np.int8)
    jso = jspec.SpectrumOps(
        n=n, num_bins=n // 2, window=None, norm=0.0, dft_cos=one8 if dft else None,
        dft_sin=one8 if dft else None, method=method, dft_dtype=jnp.bfloat16,
        dft_packed=jnp.asarray(one8) if dft else None, dft_packed_scale=1e-6 if dft else 0.0,
        factored=None if dft else object(),
    )
    tso = tspec.SpectrumOps(
        n=n, num_bins=n // 2, window=None, norm=0.0, dft_cos=None, dft_sin=None, method=method,
        dft_dtype=torch.bfloat16, dft_packed=torch.zeros(1, dtype=torch.int8) if dft else None,
        dft_packed_scale=1e-6 if dft else 0.0, factored=None if dft else object(),
    )
    return jso, tso


@pytest.mark.parametrize("topology", ["fm3_series", "fm3_parallel"])
@pytest.mark.parametrize("log2n", [10, 11, 12, 13, 14, 15, 16])
def test_routing_matches_reference(log2n, topology):
    """The flagship engine at every frame size the reference routes, for a
    chain and a bank (B2 to n 3584, synth_fold to 16384, synth_stream
    above). One stated exception: the reference names its fused_generation
    engine ``fused_kernel`` on its CPU backend (the in-kernel PRNG is
    hardware-only there); the port names the engine it runs on any device."""
    pop = 1 << (13 if log2n == 16 else 15)
    d = 12 if topology == "fm3_parallel" else 6
    kw = dict(FLAGSHIP, num_parents=256, num_offspring=pop - 256, audio_length_log2=log2n,
              topology=topology, num_dimensions=d, param_mins=(0.0,) * d,
              param_maxs=MAXS[topology])
    jc, tc = JConfig(**kw), ESConfig(**kw)
    jso, tso = _stand_ins(1 << log2n)
    want = jstrategy.active_engine(jc, jso)
    got = active_engine(tc, tso)
    if want == "fused_kernel":
        assert got == "fused_generation"
    else:
        assert got == want
    assert got == {10: "fused_generation", 11: "fused_generation", 12: "synth_fold",
                   13: "synth_fold", 14: "synth_fold", 15: "synth_stream",
                   16: "synth_stream"}[log2n]


# -- a planted truth ranks first through evaluate ---------------------------------

@pytest.mark.parametrize("log2n,method,engine", [(12, "dft", "synth_fold"),
                                                  (11, "dft_factored", "synth_stream")])
def test_planted_truth_ranks_first(log2n, method, engine):
    cfg = ESConfig(num_parents=4, num_offspring=124, num_dimensions=6, topology="fm3_series",
                   audio_length_log2=log2n, synthesis_engine="scanless", spectrum_method=method,
                   dft_dtype="int8", fused_kernel=True, fused_generation=True, pop_block=128)
    so = make_spectrum_ops(cfg, device="cpu")
    assert active_engine(cfg, so) == engine
    genes = np.random.default_rng(1).uniform(0.1, 0.9, (128, 6)).astype(np.float32)
    mins, maxs = np.asarray(cfg.param_mins, np.float32), np.asarray(cfg.param_maxs, np.float32)
    truth = torch.from_numpy(mins + genes[17] * (maxs - mins))
    audio = tsyn.synthesize(truth[None], cfg.n_samples, cfg.topology, engine="scanless")[:, 0]
    target = tspec.target_spectrum(audio, so)
    fits = evaluate(torch.from_numpy(genes), target, so, cfg)
    assert fits.shape == (128,) and torch.isfinite(fits).all()
    assert int(torch.argmin(fits)) == 17


# -- interop ----------------------------------------------------------------------

def test_interop_carries_factored_operands():
    jso = jspec.make_spectrum_ops(N, method="dft_factored", dft_dtype=jnp.bfloat16)
    t = interop.spectrum_ops_from_numpy(
        n=jso.n, num_bins=jso.num_bins, window=jso.window, norm=jso.norm, dft_cos=jso.dft_cos,
        dft_sin=jso.dft_sin, dft_packed=jso.dft_packed, dft_packed_scale=jso.dft_packed_scale,
        method=jso.method, dft_dtype=np.dtype(jso.dft_dtype).name,
        factored=jso.factored._asdict(), device="cpu",
    )
    mine = tspec.make_spectrum_ops(N, method="dft_factored", dft_dtype="bfloat16", device="cpu")
    assert t.method == mine.method == "dft_factored" and t.dft_dtype == mine.dft_dtype
    assert t.dft_cos is None and t.dft_packed is None
    assert (t.factored.n1, t.factored.n2) == (mine.factored.n1, mine.factored.n2)
    for name in ("c1", "s1n", "tw_re", "tw_imn", "c2", "s2n"):
        assert torch.equal(getattr(t.factored, name), getattr(mine.factored, name))
    assert torch.equal(t.window, mine.window) and t.norm == mine.norm


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_interop_carries_the_bf16_folded_operand(dtype):
    """A float32 folded operand comes with its bf16 rounding (what B3's bf16
    mode contracts with), from both constructors; the int8 and bf16 ones
    need none."""
    n = 256
    jso = jspec.make_spectrum_ops(n, dft_dtype=getattr(jnp, dtype))
    t = interop.spectrum_ops_from_numpy(
        n=jso.n, num_bins=jso.num_bins, window=jso.window, norm=jso.norm, dft_cos=jso.dft_cos,
        dft_sin=jso.dft_sin, dft_packed=jso.dft_packed, dft_packed_scale=jso.dft_packed_scale,
        method=jso.method, dft_dtype=dtype, device="cpu",
    )
    mine = tspec.make_spectrum_ops(n, dft_dtype=dtype, device="cpu")
    assert torch.equal(t.dft_packed, mine.dft_packed)
    if dtype != "float32":
        assert t.dft_packed_bf16 is None and mine.dft_packed_bf16 is None
        return
    want = torch.from_numpy(np.array(jso.dft_packed.astype(jnp.bfloat16)).view(np.int16))
    assert torch.equal(mine.dft_packed_bf16.view(torch.int16), want)
    assert torch.equal(t.dft_packed_bf16, mine.dft_packed_bf16)


def test_matmul_f32_batched_equals_each_product():
    """The factored DFT's stage 2: a batched bf16 product with float32 sums
    is the 2-D product of each batch entry, bit for bit."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(4, 8, 16, generator=g).to(torch.bfloat16)
    b = torch.randn(4, 16, 32, generator=g).to(torch.bfloat16)
    got = tspec.matmul_f32(a, b)
    assert got.dtype == torch.float32 and got.shape == (4, 8, 32)
    for i in range(4):
        assert torch.equal(got[i], tspec.matmul_f32(a[i], b[i]))
