"""Evolutionary-strategy engine: config, stage primitives, generation loop."""
from .config import ESConfig
from .pipeline import evolve, generation_step, kernel_seed, make_spectrum_ops
from .strategy import (
    ESState,
    active_engine,
    evaluate,
    init_state,
    mutate,
    recombine,
    select,
)

__all__ = [
    "ESConfig",
    "ESState",
    "active_engine",
    "evaluate",
    "evolve",
    "generation_step",
    "init_state",
    "kernel_seed",
    "make_spectrum_ops",
    "mutate",
    "recombine",
    "select",
]
