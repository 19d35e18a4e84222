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
from ..kernels.synth_fitness import TIME_BLOCK, fits_shared_memory, fused_synth_fitness
from ..kernels.synth_fold import fused_synth_fold
from ..kernels.synth_stream import fused_synth_stream
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


def _fused_flags(cfg: ESConfig) -> bool:
    return cfg.fused_kernel or cfg.fused_generation


def _fused_ok(cfg: ESConfig, spectrum_ops: spectral.SpectrumOps) -> bool:
    """Whether the fused kernels (B1/B2) apply: the reference's gate with the
    port's own size limit (``fits_shared_memory``, n <= 3584 in the int8 and
    the true-f32 mode) in place of the TPU's VMEM estimate. The 128-lane rule
    on the bins does not carry over (the wrappers check what the kernels
    take)."""
    return (
        _fused_flags(cfg)
        and cfg.spectrum_method == "dft"
        and spectrum_ops.dft_packed is not None
        and cfg.n_samples % (2 * TIME_BLOCK) == 0
        and fits_shared_memory(cfg.n_samples, f32=spectrum_ops.dft_packed.dtype == torch.float32)
    )


def _synth_fold_ok(cfg: ESConfig, spectrum_ops: spectral.SpectrumOps) -> bool:
    """Whether the large-frame route applies: B3 (synthesis + fold) with the
    folded DFT outside it. Above the fused kernels' limit, up to 32768 (in
    practice ``DFT_MAX_MATERIALIZE_N``, above which ``dft_packed`` is None).
    The reference's VMEM gate (``fold_vmem_ok``) is dropped because B3
    writes a+/- to device memory; its 128-lane pop-block rule is dropped
    because a thread per candidate takes any population."""
    return (
        _fused_flags(cfg)
        and cfg.spectrum_method == "dft"
        and spectrum_ops.dft_packed is not None
        and cfg.num_frames == 1
        and cfg.n_samples % (2 * TIME_BLOCK) == 0
        and cfg.n_samples <= 32768
    )


def _synth_stream_ok(cfg: ESConfig, spectrum_ops: spectral.SpectrumOps) -> bool:
    """Whether the huge-frame route applies: B4 (streamed synthesis + window)
    feeding the four-step factored DFT. The reference's 128-lane pop-block
    rule (``_final_pop_block_ok``) is dropped: a thread per candidate takes
    any population."""
    return (
        _fused_flags(cfg)
        and spectrum_ops.method == "dft_factored"
        and spectrum_ops.factored is not None
        and cfg.num_frames == 1
        and cfg.n_samples % TIME_BLOCK == 0
    )


def active_engine(cfg: ESConfig, spectrum_ops: spectral.SpectrumOps) -> str:
    """The engine a generation runs, named as the reference names it:

      fused_generation -- kernel B2 (offspring + evaluation in one launch);
      fused_kernel -- torch recombine/mutate + kernel B1;
      synth_fold -- torch offspring, kernel B3, folded DFT in torch;
      synth_stream -- torch offspring, kernel B4, factored DFT in torch.

    The reference's XLA-path engines are not ported and raise. Unlike the
    reference, which reports ``fused_kernel`` for a fused_generation config
    on its CPU backend, the port names ``fused_generation`` on any device
    (its CPU path runs B2's plain version)."""
    if _fused_ok(cfg, spectrum_ops):
        if cfg.fused_generation and cfg.gauss_sigma == 1.0 / 6.0:
            return "fused_generation"
        return "fused_kernel"
    if _synth_fold_ok(cfg, spectrum_ops):
        return "synth_fold"
    if _synth_stream_ok(cfg, spectrum_ops):
        return "synth_stream"
    raise NotImplementedError(
        "only the kernel engines are ported: set fused_kernel or fused_generation with "
        "spectrum_method 'dft' and n a multiple of 256 (of 128 above 16384)"
    )


def evaluate(values, target_spectrum, spectrum_ops: spectral.SpectrumOps, cfg: ESConfig):
    """Scale -> synthesise -> window + DFT + magnitude -> L2, on the engine
    ``active_engine`` names: B1 (fused), B3 + the folded DFT (synth_fold) or
    B4 + the factored DFT (synth_stream)."""
    engine = active_engine(cfg, spectrum_ops)
    dev = values.device
    mins = torch.tensor(cfg.param_mins, dtype=torch.float32, device=dev)
    maxs = torch.tensor(cfg.param_maxs, dtype=torch.float32, device=dev)
    scaled = synthesis.scale_params(values, mins, maxs)
    kw = dict(topology=cfg.topology, n=cfg.n_samples, wavetable_size=cfg.wavetable_size,
              sample_rate=cfg.sample_rate, pop_block=cfg.pop_block, sine_order=cfg.sine_order)
    if engine in ("fused_generation", "fused_kernel"):
        return fused_synth_fitness(
            scaled, target_spectrum, dft_packed=spectrum_ops.dft_packed,
            dft_scale=spectrum_ops.dft_packed_scale, num_frames=cfg.num_frames, **kw,
        )
    if engine == "synth_fold":
        ap, am, edge, ms = fused_synth_fold(scaled, dft_scale=spectrum_ops.dft_packed_scale, **kw)
        spectra = spectral.magnitude_spectrum_prefolded(ap, am, edge, ms, spectrum_ops)
    else:
        # f32 audio for the true-f32 engine; the bf16 and int8 configs stream
        # bf16 (the factored DFT has no int8 operand, as in the reference)
        audio_w = fused_synth_stream(
            scaled, spectrum_ops.window,
            audio_f32=spectrum_ops.dft_dtype == torch.float32, **kw,
        )
        spectra = spectral.magnitude_spectrum_factored(audio_w, spectrum_ops, prewindowed=True)
    return spectral.spectral_fitness(spectra, target_spectrum)


def select(values, steps, fitness, mu: int):
    """Truncation selection by top-k: the mu best, best first."""
    neg_fit, idx = torch.topk(-fitness, mu)
    return values[idx], steps[idx], -neg_fit
