"""Static configuration for the evolutionary strategy (port of
``pmfm_tpu/es/config.py``).

The same frozen dataclass, field for field, so one configuration describes
a run of either package. ES constants follow the reference: alpha = 1.4,
beta = sqrt(1/D), betaScale = 1/D, rootTwoOverPi = sqrt(2/pi). The
reference package's field comments carry the measurements behind each
default; they were taken on a TPU and are not repeated here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

from ..ops.synthesis import topology_dims
from ..ops.wavetable import DEFAULT_SAMPLE_RATE, DEFAULT_WAVETABLE_SIZE

RECOMBINE_MODES = ("gather", "compat_shuffle", "off")
# clt12/normal: reference parity (sigma = 1/6 noise against the sigma = 1
# constant sqrt(2/pi), so steps contract every generation);
# *_neutral / normal_unit: neutral-drift self-adaptation (E[ln Es] = 0).
MUTATION_NOISE_MODES = ("clt12", "normal", "clt12_neutral", "normal_unit")


@dataclasses.dataclass(frozen=True)
class ESConfig:
    """All static knobs of the matcher (defaults follow parameters.json)."""

    num_parents: int = 16  # mu
    num_offspring: int = 16  # lambda; population = mu + lambda
    num_dimensions: int = 6
    topology: str = "fm3_series"
    param_mins: Tuple[float, ...] = (0.0,) * 6
    param_maxs: Tuple[float, ...] = (3520.0, 8.0, 3520.0, 8.0, 3520.0, 8.0)
    audio_length_log2: int = 11
    sample_rate: int = DEFAULT_SAMPLE_RATE
    wavetable_size: int = DEFAULT_WAVETABLE_SIZE

    alpha: float = 1.4

    # engine knobs
    fused_kernel: bool = False  # fused synth+DFT+fitness kernel (B1)
    fused_generation: bool = False  # whole generation in one kernel (B2)
    fused_evolve: bool = False  # all generations in one kernel (B5)
    gens_per_step: int = 1  # fused_evolve only; no effect on the results
    pop_block: int = 512  # candidates per block of the plain versions
    synthesis_engine: str = "scan"  # "scan" | "scanless"
    osc_mode: str = "floor"  # "floor" | "exact" | "table" (scan engine only)
    spectrum_method: str = "dft"  # "dft" | "rfft"
    num_bins: int | None = None  # default N//2
    recombine_mode: str = "gather"  # "gather" | "compat_shuffle" | "off"
    mutation_noise: str = "clt12"
    clamp_values: bool = False  # the reference leaves retried values unclamped
    min_step: float = 0.0  # step floor (0 = reference behaviour: none)
    workgroup_size: int = 32  # compat_shuffle recombination only
    scan_unroll: int = 8
    dft_dtype: str = "float32"  # "float32" | "bfloat16" | "int8"
    sine_order: int = 9  # odd sine polynomial order in the fused kernels

    # precision annealing: the last refine_generations run under the f32
    # engine, with the steps re-opened to refine_step_floor
    refine_generations: int = 0
    refine_step_floor: float = 0.01

    operand_cache_dir: str | None = None

    fitness_threshold: float = 0.0  # 0 disables early stop
    num_frames: int = 1  # > 1: multi-frame STFT fitness
    restart_patience: int = 0  # > 0: fresh parents after this many stalled generations

    def __post_init__(self):
        if self.pop_block < 1:
            raise ValueError(f"pop_block must be >= 1, got {self.pop_block}")
        if self.gens_per_step < 1:
            raise ValueError(f"gens_per_step must be >= 1, got {self.gens_per_step}")
        want = topology_dims(self.topology)
        if self.num_dimensions != want:
            raise ValueError(
                f"topology {self.topology} needs {want} dims, got {self.num_dimensions}"
            )
        if len(self.param_mins) != self.num_dimensions or len(self.param_maxs) != self.num_dimensions:
            raise ValueError("param_mins/param_maxs length must equal num_dimensions")
        if self.synthesis_engine not in ("scan", "scanless"):
            raise ValueError("synthesis_engine must be 'scan' or 'scanless'")
        if self.recombine_mode not in RECOMBINE_MODES:
            raise ValueError(f"recombine_mode must be one of {RECOMBINE_MODES}")
        if self.mutation_noise not in MUTATION_NOISE_MODES:
            raise ValueError(f"mutation_noise must be one of {MUTATION_NOISE_MODES}")
        if self.num_parents <= 0 or self.num_offspring < 0:
            raise ValueError("need num_parents > 0 and num_offspring >= 0")
        if self.num_frames < 1:
            raise ValueError("num_frames must be >= 1")
        if self.sine_order not in (5, 7, 9):
            raise ValueError("sine_order must be 5, 7 or 9")
        if self.refine_generations < 0:
            raise ValueError("refine_generations must be >= 0")

    @property
    def population_size(self) -> int:
        """populationLength = numParents + numOffspring."""
        return self.num_parents + self.num_offspring

    @property
    def n_samples(self) -> int:
        return 1 << self.audio_length_log2

    @property
    def one_over_alpha(self) -> float:
        return 1.0 / self.alpha

    @property
    def beta_scale(self) -> float:
        return 1.0 / self.num_dimensions

    @property
    def beta(self) -> float:
        return math.sqrt(self.beta_scale)

    @property
    def gauss_sigma(self) -> float:
        """Mutation noise scale: the reference CLT gaussian is sigma = 1/6."""
        return 1.0 if self.mutation_noise == "normal_unit" else 1.0 / 6.0

    @property
    def root_two_over_pi(self) -> float:
        """The Es offset of step adaptation; scaled to E|g| of the noise in
        the *_neutral modes so that E[ln Es] = 0."""
        base = math.sqrt(2.0 / math.pi)
        if self.mutation_noise == "clt12_neutral":
            return base * self.gauss_sigma
        return base

    def replace(self, **kw) -> "ESConfig":
        return dataclasses.replace(self, **kw)

    def refine_config(self) -> "ESConfig":
        """The f32 engine of the refine tail: the parent config's fused flags,
        the true-f32 operand, the order-9 sine and neutral-drift noise."""
        noise = self.mutation_noise
        if noise in ("clt12", "normal"):
            noise = "clt12_neutral"
        return self.replace(
            dft_dtype="float32", fused_evolve=False, sine_order=9,
            refine_generations=0, refine_step_floor=0.0, mutation_noise=noise,
        )
