"""(mu+lambda)-ES stage primitives (port of ``pmfm_tpu/es/strategy.py``).

Only the mu parents persist between generations; the full population exists
inside a generation. Random draws come from an explicit ``torch.Generator``
carried in the state, so they differ from ``jax.random``'s by design; the
kernels' in-kernel draws use Philox (kernels/generation.py).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device
from ..kernels.synth_fitness import TIME_BLOCK, fused_synth_fitness
from ..ops import spectral, synthesis
from .config import ESConfig

INITIAL_STEP = 0.1  # initPopulation: step = 0.1


class ESState(NamedTuple):
    """Inter-generation ES state. Tensors live on one device; ``generation``
    is a host integer because the kernels' seed is derived from it."""

    parent_values: torch.Tensor  # (mu, D) in [0, 1]
    parent_steps: torch.Tensor  # (mu, D)
    parent_fitness: torch.Tensor  # (mu,)
    best_values: torch.Tensor  # (D,) best-ever candidate
    best_fitness: torch.Tensor  # () best-ever fitness
    seed: int  # int32 base word of the kernels' per-generation seed
    generation: int
    stall: torch.Tensor  # () int32, generations since the best improved
    generator: torch.Generator  # host-side draws: recombine, mutate, restarts


def init_state(seed: int, cfg: ESConfig, *, device: str | torch.device = "cuda") -> ESState:
    """Fresh random parents: values ~ U[0, 1), steps = 0.1, fitness +inf."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    mu, d = cfg.num_parents, cfg.num_dimensions
    word = int(torch.randint(0, 2**31, (1,), generator=gen, device=dev).item())
    values = torch.rand((mu, d), generator=gen, device=dev)
    return ESState(
        parent_values=values,
        parent_steps=torch.full((mu, d), INITIAL_STEP, dtype=torch.float32, device=dev),
        parent_fitness=torch.full((mu,), float("inf"), dtype=torch.float32, device=dev),
        best_values=values[0].clone(),
        best_fitness=torch.tensor(float("inf"), dtype=torch.float32, device=dev),
        seed=word,
        generation=0,
        stall=torch.zeros((), dtype=torch.int32, device=dev),
        generator=gen,
    )


def recombine(gen: torch.Generator, parent_values, parent_steps, cfg: ESConfig):
    """Discrete recombination ("gather" mode): every gene of every offspring
    is copied from a uniformly random parent. Other modes are not ported."""
    if cfg.recombine_mode != "gather":
        raise NotImplementedError(f"recombine_mode {cfg.recombine_mode!r} is not ported yet")
    pop, d = cfg.population_size, cfg.num_dimensions
    mu = parent_values.shape[0]
    idx = torch.randint(0, mu, (pop, d), generator=gen, device=parent_values.device)
    col = torch.arange(d, device=parent_values.device)[None, :]
    return parent_values[idx, col], parent_steps[idx, col]


def _gauss(gen: torch.Generator, shape, mode: str, device) -> torch.Tensor:
    """The reference's "gaussian": mean of 12 U(-1, 1) (sigma = 1/6) for
    ``clt12``/``clt12_neutral``; N(0, 1/6) for ``normal``; N(0, 1) for
    ``normal_unit``."""
    if mode in ("clt12", "clt12_neutral"):
        u = torch.rand((*shape, 12), generator=gen, device=device) * 2.0 - 1.0
        return torch.sum(u, dim=-1) / 12.0
    sigma = 1.0 if mode == "normal_unit" else 1.0 / 6.0
    return torch.randn(shape, generator=gen, device=device) * sigma


def mutate(gen: torch.Generator, values, steps, cfg: ESConfig):
    """Log-normal self-adaptive mutation (mutatePopulation):

      Ek = coin ? alpha : 1/alpha;  x' = x + Ek*s*g
      out-of-[0, 1]: retry once with g := -0.5 g
      s' = s * Ek^beta * exp(|g| - rootTwoOverPi)^betaScale
    """
    coin = torch.rand(values.shape, generator=gen, device=values.device) < 0.5
    ek = torch.where(coin, cfg.alpha, cfg.one_over_alpha).to(torch.float32)
    g = _gauss(gen, values.shape, cfg.mutation_noise, values.device)
    new_x = values + ek * steps * g
    out = (new_x < 0.0) | (new_x > 1.0)
    g = torch.where(out, g * -0.5, g)
    new_x = torch.where(out, values + ek * steps * g, new_x)
    if cfg.clamp_values:
        new_x = torch.clamp(new_x, 0.0, 1.0)
    es = torch.exp(torch.abs(g) - cfg.root_two_over_pi)
    new_steps = steps * ek**cfg.beta * es**cfg.beta_scale
    if cfg.min_step > 0.0:
        new_steps = torch.clamp_min(new_steps, cfg.min_step)
    return new_x, new_steps


def _fused_ok(cfg: ESConfig, spectrum_ops: spectral.SpectrumOps) -> bool:
    """Whether the fused kernels (B1/B2) apply. The TPU's VMEM gate and
    128-lane rule do not carry over; the kernels' own limits are checked by
    their wrappers."""
    return (
        (cfg.fused_kernel or cfg.fused_generation)
        and cfg.spectrum_method == "dft"
        and cfg.n_samples % (2 * TIME_BLOCK) == 0
        and spectrum_ops.dft_packed is not None
    )


def active_engine(cfg: ESConfig, spectrum_ops: spectral.SpectrumOps) -> str:
    """The engine a generation runs: ``fused_generation`` (kernel B2) or
    ``fused_kernel`` (torch recombine/mutate + kernel B1). The XLA-path
    engines of the reference are not ported and raise."""
    if _fused_ok(cfg, spectrum_ops):
        if cfg.fused_generation and cfg.gauss_sigma == 1.0 / 6.0:
            return "fused_generation"
        return "fused_kernel"
    raise NotImplementedError(
        "only the fused engines are ported: set fused_kernel or fused_generation with "
        "spectrum_method='dft' and n a multiple of 256"
    )


def evaluate(values, target_spectrum, spectrum_ops: spectral.SpectrumOps, cfg: ESConfig):
    """Scale -> synthesise -> window + DFT + magnitude -> L2, through B1."""
    active_engine(cfg, spectrum_ops)
    dev = values.device
    mins = torch.tensor(cfg.param_mins, dtype=torch.float32, device=dev)
    maxs = torch.tensor(cfg.param_maxs, dtype=torch.float32, device=dev)
    return fused_synth_fitness(
        synthesis.scale_params(values, mins, maxs),
        target_spectrum,
        dft_packed=spectrum_ops.dft_packed,
        dft_scale=spectrum_ops.dft_packed_scale,
        topology=cfg.topology,
        n=cfg.n_samples,
        wavetable_size=cfg.wavetable_size,
        sample_rate=cfg.sample_rate,
        pop_block=cfg.pop_block,
        num_frames=cfg.num_frames,
        sine_order=cfg.sine_order,
    )


def select(values, steps, fitness, mu: int):
    """Truncation selection by top-k: the mu best, best first."""
    neg_fit, idx = torch.topk(-fitness, mu)
    return values[idx], steps[idx], -neg_fit
