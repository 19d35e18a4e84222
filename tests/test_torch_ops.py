"""pmfm_tpu_torch ops and config against the pmfm_tpu reference, on the CPU.

Inputs are made with numpy and handed to both packages as arrays.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmfm_tpu.es import ESConfig as JConfig
from pmfm_tpu.ops import spectral as jspec
from pmfm_tpu.ops import synthesis as jsyn
from pmfm_tpu.ops import wavetable as jwt
from pmfm_tpu_torch.es import ESConfig as TConfig
from pmfm_tpu_torch.ops import spectral as tspec
from pmfm_tpu_torch.ops import synthesis as tsyn
from pmfm_tpu_torch.ops import wavetable as twt

TRUTH = {
    "fm2": (3078.0, 2.0, 3015.0, 1.5),
    "fm3_series": (3078.0, 2.0, 3015.0, 1.5, 3141.0, 1.0),
}


def _bits(a):
    """Raw bytes of a numpy array or torch tensor (bf16 as int16 bits)."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("n", [256, 1024])
@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_dft_operands_byte_equal(n, dtype):
    ref = jspec.make_spectrum_ops(n, dft_dtype=jnp.dtype(dtype))
    got = tspec.make_spectrum_ops(n, dft_dtype=dtype, device="cpu")
    assert np.array_equal(_bits(ref.dft_packed), _bits(got.dft_packed))
    assert np.array_equal(_bits(ref.dft_cos), _bits(got.dft_cos))
    assert np.array_equal(_bits(ref.dft_sin), _bits(got.dft_sin))
    assert got.dft_packed_scale == ref.dft_packed_scale
    assert got.norm == ref.norm and got.num_bins == ref.num_bins
    np.testing.assert_array_equal(got.window.numpy(), np.asarray(ref.window))


def test_window_helpers_equal():
    for n in (256, 1024, 2048):
        np.testing.assert_array_equal(tspec.hann_window(n), jspec.hann_window(n))
        assert tspec.window_factor(n) == jspec.window_factor(n)
        assert tspec.default_num_bins(n) == jspec.default_num_bins(n)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_target_spectrum_same_audio(dtype):
    """Same audio in -> f32 target spectrum within 1e-5 of its peak (float32
    sums in another order)."""
    n = 1024
    rng = np.random.default_rng(3)
    audio = (rng.standard_normal(n) * 1000).astype(np.float32)
    ref = np.asarray(jspec.target_spectrum(jnp.asarray(audio), jspec.make_spectrum_ops(n, dft_dtype=jnp.dtype(dtype))))
    got = tspec.target_spectrum(torch.from_numpy(audio), tspec.make_spectrum_ops(n, dft_dtype=dtype, device="cpu"))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert np.max(np.abs(got.numpy() - ref)) <= 1e-5 * np.max(ref)


@pytest.mark.parametrize("topology", ["fm2", "fm3_series"])
@pytest.mark.parametrize("n", [256, 1024])
def test_known_params_target_int8(topology, n):
    """The slice's target: scan-engine audio of the known params through the
    int8 config's spectrum, end to end in each package. The scan audio itself
    may differ by a few floor() flips of the wavetable index (libm sine
    ulps), which bf16 rounding of the audio hides: within 1e-5 of the peak."""
    truth = TRUTH[topology]
    ref_audio = np.asarray(jsyn.synthesize_single(jnp.asarray(truth), n, topology))
    got_audio = tsyn.synthesize_single(torch.tensor(truth), n, topology)
    amp = abs(truth[-2] * truth[-1]) if topology != "fm2" else abs(truth[3])
    assert np.max(np.abs(got_audio.numpy() - ref_audio)) <= 1e-3 * amp
    ref = np.asarray(jspec.target_spectrum(jnp.asarray(ref_audio), jspec.make_spectrum_ops(n, dft_dtype=jnp.int8)))
    got = tspec.target_spectrum(got_audio, tspec.make_spectrum_ops(n, dft_dtype="int8", device="cpu")).numpy()
    assert np.max(np.abs(got - ref)) <= 1e-5 * np.max(ref)


@pytest.mark.parametrize("osc_mode", ["floor", "exact", "table"])
@pytest.mark.parametrize("topology", ["fm2", "fm3_series", "fm4_series", "fm3_parallel"])
def test_scan_synthesis_matches_reference(osc_mode, topology):
    """Scan synthesis of mild-index candidates: within 1e-3 of the output
    amplitude (sine ulps can move a floor() by one table step)."""
    d = jsyn.topology_dims(topology)
    rng = np.random.default_rng(11)
    p = (rng.random((5, d)) * np.tile([2000.0, 2.0], d // 2)).astype(np.float32)
    ref = np.asarray(jsyn.synthesize(jnp.asarray(p), 256, topology, osc_mode=osc_mode))
    got = tsyn.synthesize(torch.from_numpy(p), 256, topology, osc_mode=osc_mode).numpy()
    assert got.shape == ref.shape == (256, 5)
    scale = np.max(np.abs(ref)) + 1e-6
    assert np.max(np.abs(got - ref)) <= 1e-3 * scale


def test_topology_helpers_and_wavetable():
    for topo in ("fm2", "fm3_series", "fm5_series", "fm3_parallel", "fm4_parallel"):
        assert tsyn.topology_dims(topo) == jsyn.topology_dims(topo)
        assert tsyn.series_ops(topo) == jsyn.series_ops(topo)
        assert tsyn.parallel_pairs(topo) == jsyn.parallel_pairs(topo)
    with pytest.raises(ValueError):
        tsyn.topology_dims("fm1_series")
    np.testing.assert_array_equal(twt.build_wavetable(4096), jwt.build_wavetable(4096))
    x = np.array([-5.0, 0.0, 10.0, 32767.0, 32768.0, 40000.0], np.float32)
    np.testing.assert_array_equal(twt.wrap_pos(torch.from_numpy(x), 32768.0).numpy(), np.asarray(jwt.wrap_pos(jnp.asarray(x), 32768.0)))
    np.testing.assert_array_equal(twt.wrap_pos_both(torch.from_numpy(x), 32768.0).numpy(), np.asarray(jwt.wrap_pos_both(jnp.asarray(x), 32768.0)))
    lo, hi = np.float32([0, 0, 0, 0]), np.float32([3520, 8, 3520, 8])
    v = np.random.default_rng(0).random((3, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        tsyn.scale_params(torch.from_numpy(v), torch.from_numpy(lo), torch.from_numpy(hi)).numpy(),
        np.asarray(jsyn.scale_params(jnp.asarray(v), jnp.asarray(lo), jnp.asarray(hi))),
    )


CONFIGS = [
    dict(),
    dict(num_parents=256, num_offspring=32512, audio_length_log2=10, dft_dtype="int8",
         sine_order=7, fused_generation=True, pop_block=1024),
    dict(topology="fm2", num_dimensions=4, param_mins=(0.0,) * 4, param_maxs=(3520.0, 8.0) * 2,
         mutation_noise="clt12_neutral", min_step=1e-4, restart_patience=100),
    dict(mutation_noise="normal_unit", alpha=1.2, refine_generations=100),
    dict(mutation_noise="normal"),
]


@pytest.mark.parametrize("kw", CONFIGS)
def test_config_fields_and_derived_values(kw):
    ref, got = JConfig(**kw), TConfig(**kw)
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(ref)]
    for name in ("population_size", "n_samples", "one_over_alpha", "beta_scale", "beta",
                 "gauss_sigma", "root_two_over_pi"):
        assert getattr(got, name) == getattr(ref, name), name
    assert dataclasses.asdict(got.refine_config()) == dataclasses.asdict(ref.refine_config())


@pytest.mark.parametrize("bad", [dict(sine_order=6), dict(num_dimensions=5), dict(pop_block=0),
                                 dict(mutation_noise="x"), dict(recombine_mode="y")])
def test_config_rejects_what_reference_rejects(bad):
    with pytest.raises(ValueError):
        JConfig(**bad)
    with pytest.raises(ValueError):
        TConfig(**bad)


def test_unported_spectrum_methods_raise():
    """The rfft method and the reference's fallbacks to it are ported: rfft
    on request, and 'dft' above DFT_MAX_MATERIALIZE_N at a size that does not
    factor (with the reference's warning); a power of two factors."""
    assert tspec.make_spectrum_ops(256, method="rfft", device="cpu").method == "rfft"
    with pytest.warns(UserWarning, match="falling back to rfft"):
        so = tspec.make_spectrum_ops(24576, device="cpu")
    assert so.method == "rfft" and so.dft_cos is None and so.dft_packed is None
    assert tspec.make_spectrum_ops(32768, device="cpu").method == "dft_factored"
    with pytest.raises(ValueError):
        tspec.make_spectrum_ops(256, method="stft", device="cpu")
