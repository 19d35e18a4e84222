"""(mu+lambda)-ES stage primitives (port of ``pmfm_tpu/es/strategy.py``).

Only the mu parents persist between generations; the full population exists
inside a generation. Random draws come from an explicit ``torch.Generator``
carried in the state, so they differ from ``jax.random``'s by design; the
kernels' in-kernel draws use Philox (kernels/generation.py).

The run axis (``match_many``, the reference's ``vmap`` over whole runs): a
state made from a sequence of seeds holds B independent runs, every tensor
with a leading B and ``seed`` a tuple of B words; ``recombine``, ``mutate``,
``select`` and ``evaluate`` take the leading axis too. Its targets are
``(B, F, K)``, or ``(B, K)`` at one frame, so that row r is what a lone run
takes.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import numpy as np
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
    is a host integer because the kernels' seed is derived from it. A state
    of B runs (``init_state`` of B seeds) has a leading run axis on every
    tensor and one seed, generation and generator a run (tuples)."""

    parent_values: torch.Tensor  # (mu, D) in [0, 1]
    parent_steps: torch.Tensor  # (mu, D)
    parent_fitness: torch.Tensor  # (mu,)
    best_values: torch.Tensor  # (D,) best-ever candidate
    best_fitness: torch.Tensor  # () best-ever fitness
    seed: int | tuple  # int32 base word of the kernels' per-generation seed (one a run)
    generation: int | tuple  # (one a run)
    stall: torch.Tensor  # () int32, generations since the best improved
    generator: torch.Generator | tuple  # host-side draws: recombine, mutate, restarts


def init_state(seed: int | Sequence[int], cfg: ESConfig, *,
               device: str | torch.device = "cuda") -> ESState:
    """Fresh random parents: values ~ U[0, 1), steps = 0.1, fitness +inf.

    A sequence of B seeds makes a state of B runs: run r starts from the
    state ``init_state(seed[r])`` makes and keeps its generator, so that it
    draws what that lone state draws (``draws``)."""
    if not isinstance(seed, int):
        lone = [init_state(int(s), cfg, device=device) for s in seed]
        if not lone:
            raise ValueError("a state of runs needs at least one seed")
        stack = lambda name: torch.stack([getattr(s, name) for s in lone])  # noqa: E731
        return ESState(
            parent_values=stack("parent_values"), parent_steps=stack("parent_steps"),
            parent_fitness=stack("parent_fitness"), best_values=stack("best_values"),
            best_fitness=stack("best_fitness"), seed=tuple(s.seed for s in lone),
            generation=(0,) * len(lone), stall=stack("stall"),
            generator=tuple(s.generator for s in lone),
        )
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


def _compat_shuffle_index(pop: int, dims: int, wg_size: int, num_parents: int) -> np.ndarray:
    """The reference's deterministic workgroup shuffle as one flat gather
    index (a copy of ``pmfm_tpu/es/strategy.py::_compat_shuffle_index``):
    offspring workgroup ``g`` aliases parent block ``g % NUM_WGS_FOR_PARENTS``;
    within the block, flat gene ``j`` of lane ``l`` moves to
    ``(l*D + shift) % (WG*D)`` with ``shift = D * (i * (g+1))`` for dimension
    counter ``i``. The workgroup shrinks to mu where it is larger, as in the
    reference, so that the aliasing is defined."""
    wg_size = min(wg_size, num_parents)
    if pop % wg_size or num_parents % wg_size:
        raise ValueError(
            f"compat_shuffle needs wg_size|pop and wg_size|num_parents, "
            f"got wg={wg_size}, pop={pop}, mu={num_parents}"
        )
    num_wgs_for_parents = max(num_parents // wg_size, 1)
    block = wg_size * dims
    src = np.empty(pop * dims, np.int64)
    for g in range(pop // wg_size):
        base_src = (g % num_wgs_for_parents) * block  # parent block this group reads
        base_dst = g * block
        # invert the scatter: dst[new_idx] = src[start_idx]
        for lane in range(wg_size):
            start = lane * dims
            for i in range(dims):
                new_idx = (start + i + dims * (i * (g + 1))) % block
                src[base_dst + new_idx] = base_src + start + i
    return src


@functools.lru_cache(maxsize=8)
def _compat_index_on(pop: int, dims: int, wg_size: int, num_parents: int, device: str):
    return torch.from_numpy(_compat_shuffle_index(pop, dims, wg_size, num_parents)).to(device)


def draws(gen, shape, fn) -> torch.Tensor:
    """``fn(gen, shape)``, a draw of ``shape`` from the generator ``gen``;
    with the run axis (``gen`` a tuple of generators, one a run, and
    ``shape[0]`` the runs) each run's ``fn(gen[r], shape[1:])``, stacked, so
    that run r draws what a lone run with its generator draws."""
    if isinstance(gen, torch.Generator):
        return fn(gen, shape)
    return torch.stack([fn(g, shape[1:]) for g in gen])


def _rand(gen, shape, device) -> torch.Tensor:
    return draws(gen, shape, lambda g, s: torch.rand(s, generator=g, device=device))


def recombine(gen, parent_values, parent_steps, cfg: ESConfig):
    """Recombination of the mu parents (``(mu, D)``, or ``(B, mu, D)`` with
    the run axis) into ``P`` offspring each, by ``cfg.recombine_mode``:
    ``"gather"``, every gene of every offspring copied from a uniformly
    random parent of its run; ``"compat_shuffle"``, the reference OpenCL
    kernel's deterministic workgroup shuffle (``_compat_shuffle_index``; no
    draws); ``"off"``, the parents tiled (an ablation)."""
    pop, d = cfg.population_size, cfg.num_dimensions
    mu = parent_values.shape[-2]
    lead = parent_values.shape[:-2]
    dev = parent_values.device
    if cfg.recombine_mode == "gather":
        idx = draws(gen, (*lead, pop, d),
                    lambda g, s: torch.randint(0, mu, s, generator=g, device=dev))
        return (torch.gather(parent_values, -2, idx), torch.gather(parent_steps, -2, idx))
    if cfg.recombine_mode == "compat_shuffle":
        # source indices address only the parent slice, so gather straight
        # from the flattened parents
        flat = _compat_index_on(pop, d, cfg.workgroup_size, cfg.num_parents, str(dev))
        return (parent_values.reshape(*lead, -1)[..., flat].reshape(*lead, pop, d),
                parent_steps.reshape(*lead, -1)[..., flat].reshape(*lead, pop, d))
    reps = -(-pop // mu)
    tile = (*(1,) * len(lead), reps, 1)
    return (parent_values.repeat(tile)[..., :pop, :], parent_steps.repeat(tile)[..., :pop, :])


def _gauss(gen, shape, mode: str, device) -> torch.Tensor:
    """The reference's "gaussian": mean of 12 U(-1, 1) (sigma = 1/6) for
    ``clt12``/``clt12_neutral``; N(0, 1/6) for ``normal``; N(0, 1) for
    ``normal_unit``."""
    if mode in ("clt12", "clt12_neutral"):
        u = _rand(gen, (*shape, 12), device) * 2.0 - 1.0
        return torch.sum(u, dim=-1) / 12.0
    sigma = 1.0 if mode == "normal_unit" else 1.0 / 6.0
    return draws(gen, shape, lambda g, s: torch.randn(s, generator=g, device=device)) * sigma


def mutate(gen, values, steps, cfg: ESConfig):
    """Log-normal self-adaptive mutation (mutatePopulation):

      Ek = coin ? alpha : 1/alpha;  x' = x + Ek*s*g
      out-of-[0, 1]: retry once with g := -0.5 g
      s' = s * Ek^beta * exp(|g| - rootTwoOverPi)^betaScale
    """
    coin = _rand(gen, values.shape, values.device) < 0.5
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
    port's own size limit (``fits_shared_memory`` of the operand's dtype,
    n <= 3584 in the int8, bf16 and true-f32 modes, and a block's staged
    parameters at the config's D) in place of the TPU's VMEM estimate, which
    sends some bf16 configs the port runs on B1/B2 (the bf16 operand at
    n 3584, 12.8 MB, over its 12 MB budget) to synth_fold.
    The 128-lane rule on the bins does not carry over (the wrappers check
    what the kernels take)."""
    return (
        _fused_flags(cfg)
        and cfg.spectrum_method == "dft"
        and spectrum_ops.dft_packed is not None
        and cfg.n_samples % (2 * TIME_BLOCK) == 0
        and fits_shared_memory(cfg.n_samples, spectrum_ops.dft_packed.dtype,
                               cfg.num_dimensions)
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
      synth_stream -- torch offspring, kernel B4, factored DFT in torch;
      xla_folded_dft -- scan or scanless synthesis (the scan kernel on the
        card), the folded bf16 or int8 DFT in torch;
      xla_dft / xla_dft_factored / xla_rfft -- the same synthesis, the
        spectrum method's plain path (cuBLAS, cuFFT).

      xla_stft -- multi-frame fitness (``cfg.num_frames > 1``) where the
        fused kernels do not apply: F n samples of the same synthesis, the
        framewise spectra of the spectrum method (``spectral.stft_fitness``).

    Unlike the reference, which reports ``fused_kernel`` for a
    fused_generation config on its CPU backend, the port names
    ``fused_generation`` on any device (its CPU path runs B2's plain
    version). The fused kernels take any frame count here, where the
    reference's VMEM estimate sends some multi-frame configs (int8 at
    n 2048, F 8) to ``xla_stft``."""
    if _fused_ok(cfg, spectrum_ops):
        if cfg.fused_generation and cfg.gauss_sigma == 1.0 / 6.0:
            return "fused_generation"
        return "fused_kernel"
    if _synth_fold_ok(cfg, spectrum_ops):
        return "synth_fold"
    if _synth_stream_ok(cfg, spectrum_ops):
        return "synth_stream"
    if cfg.num_frames > 1:
        return "xla_stft"
    if (cfg.spectrum_method == "dft" and spectrum_ops.dft_packed is not None
            and cfg.dft_dtype in ("bfloat16", "int8")):
        return "xla_folded_dft"
    return f"xla_{spectrum_ops.method}"


def evaluate(values, target_spectrum, spectrum_ops: spectral.SpectrumOps, cfg: ESConfig):
    """Scale -> synthesise -> window + DFT + magnitude -> L2, on the engine
    ``active_engine`` names: B1 (fused), B3 + the folded DFT (synth_fold),
    B4 + the factored DFT (synth_stream), or the unfused engines: synthesis by
    ``cfg.synthesis_engine`` (bf16 audio in the bf16 and int8 configs, as the
    reference emits it) and the folded DFT, the matmul DFT, the factored DFT,
    rfft or, at several frames, their framewise spectra (xla_stft).

    With the run axis (values ``(B, P, D)``, targets ``(B, F, K)`` or
    ``(B, K)``) B1 takes every run in one launch; the other engines evaluate
    the runs one after another."""
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
    if values.dim() == 3:
        return torch.stack([evaluate(values[r], target_spectrum[r], spectrum_ops, cfg)
                            for r in range(values.shape[0])])
    if engine == "synth_fold":
        ap, am, edge, ms = fused_synth_fold(scaled, dft_scale=spectrum_ops.dft_packed_scale, **kw)
        spectra = spectral.magnitude_spectrum_prefolded(ap, am, edge, ms, spectrum_ops)
        return spectral.spectral_fitness(spectra, target_spectrum)
    if engine == "synth_stream":
        # f32 audio for the true-f32 engine; the bf16 and int8 configs stream
        # bf16 (the factored DFT has no int8 operand, as in the reference)
        audio_w = fused_synth_stream(
            scaled, spectrum_ops.window,
            audio_f32=spectrum_ops.dft_dtype == torch.float32, **kw,
        )
        spectra = spectral.magnitude_spectrum_factored(audio_w, spectrum_ops, prewindowed=True)
        return spectral.spectral_fitness(spectra, target_spectrum)
    audio = synthesis.synthesize(
        scaled, cfg.n_samples * cfg.num_frames, cfg.topology, wavetable_size=cfg.wavetable_size,
        sample_rate=cfg.sample_rate, osc_mode=cfg.osc_mode, engine=cfg.synthesis_engine,
        out_dtype=torch.bfloat16 if cfg.dft_dtype in ("bfloat16", "int8") else torch.float32,
    )
    if engine == "xla_stft":
        return spectral.stft_fitness(audio, target_spectrum, spectrum_ops)
    if engine == "xla_folded_dft":
        spectra = spectral.magnitude_spectrum_folded(audio, spectrum_ops)
        return spectral.spectral_fitness(spectra, target_spectrum)
    return spectral.evaluate_fitness(audio, target_spectrum, spectrum_ops)


def select(values, steps, fitness, mu: int):
    """Truncation selection by top-k: the mu best, best first (of each run,
    with the run axis)."""
    neg_fit, idx = torch.topk(-fitness, mu)
    if fitness.dim() == 1:  # one run: indexing costs the host less than take_along_dim
        return values[idx], steps[idx], -neg_fit
    take = idx[..., None]
    return (torch.take_along_dim(values, take, dim=-2),
            torch.take_along_dim(steps, take, dim=-2), -neg_fit)
