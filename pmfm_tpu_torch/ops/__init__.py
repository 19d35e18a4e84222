"""Primitive ops: wavetable oscillators, FM synthesis, spectral analysis."""
from .spectral import (
    SpectrumOps,
    default_num_bins,
    evaluate_fitness,
    hann_window,
    magnitude_spectrum,
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
    "SpectrumOps",
    "build_wavetable",
    "default_num_bins",
    "evaluate_fitness",
    "hann_window",
    "magnitude_spectrum",
    "make_osc",
    "make_spectrum_ops",
    "scale_params",
    "spectral_fitness",
    "synthesize",
    "synthesize_single",
    "target_spectrum",
    "window_factor",
    "wrap_pos",
    "wrap_pos_both",
]
