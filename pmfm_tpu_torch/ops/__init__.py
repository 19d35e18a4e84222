"""Primitive ops: wavetable oscillators, FM synthesis, spectral analysis."""
from .scanless import exclusive_cumsum_mod, synthesize_scanless
from .spectral import (
    FactoredOps,
    SpectrumOps,
    default_num_bins,
    evaluate_fitness,
    hann_window,
    magnitude_spectrum,
    magnitude_spectrum_factored,
    magnitude_spectrum_prefolded,
    make_spectrum_ops,
    spectral_fitness,
    target_spectrum,
    window_factor,
)
from .synthesis import TOPOLOGY_DIMS, scale_params, synthesize, synthesize_single
from .wavetable import (
    DEFAULT_SAMPLE_RATE,
    DEFAULT_WAVETABLE_SIZE,
    build_wavetable,
    make_osc,
    wrap_pos,
    wrap_pos_both,
)

__all__ = [
    "DEFAULT_SAMPLE_RATE",
    "DEFAULT_WAVETABLE_SIZE",
    "TOPOLOGY_DIMS",
    "FactoredOps",
    "SpectrumOps",
    "build_wavetable",
    "default_num_bins",
    "evaluate_fitness",
    "exclusive_cumsum_mod",
    "hann_window",
    "magnitude_spectrum",
    "magnitude_spectrum_factored",
    "magnitude_spectrum_prefolded",
    "make_osc",
    "make_spectrum_ops",
    "scale_params",
    "spectral_fitness",
    "synthesize",
    "synthesize_scanless",
    "synthesize_single",
    "target_spectrum",
    "window_factor",
    "wrap_pos",
    "wrap_pos_both",
]
