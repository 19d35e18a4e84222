"""Evolutionary-strategy engine: config, stage primitives, generation loop,
and the staged (pursuit) solvers."""
from .config import ESConfig
from .pipeline import (
    ChunkResult,
    MatchResult,
    evolve,
    generation_step,
    kernel_seed,
    make_spectrum_ops,
    match_audio,
    match_audio_stft,
    match_many,
    refine_boundary,
)
from .staged import PursuitResult, match_parallel_pursuit, match_series_pursuit
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
    "ChunkResult",
    "ESConfig",
    "ESState",
    "active_engine",
    "evaluate",
    "evolve",
    "generation_step",
    "init_state",
    "kernel_seed",
    "make_spectrum_ops",
    "match_audio",
    "match_audio_stft",
    "match_many",
    "MatchResult",
    "match_parallel_pursuit",
    "match_series_pursuit",
    "mutate",
    "PursuitResult",
    "recombine",
    "refine_boundary",
    "select",
]
