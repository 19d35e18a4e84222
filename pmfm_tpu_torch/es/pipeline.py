"""The per-generation step and the generation loop (port of
``pmfm_tpu/es/pipeline.py``: ``make_spectrum_ops``, ``kernel_seed``,
``generation_step``, ``evolve``).

Where the reference scans ``generation_step`` inside one jitted program,
``evolve`` here is a Python loop over generations. A generation launches one
kernel (B2) under ``fused_generation``, or torch recombine/mutate plus B1
under ``fused_kernel``; selection is ``torch.topk``. Nothing in the loop
reads a device value back unless ``fitness_threshold`` asks for early stop.
"""
from __future__ import annotations

import torch

from ..kernels.generation import fused_generation
from ..ops import spectral
from .config import ESConfig
from .strategy import ESState, active_engine, evaluate, mutate, recombine, select


def make_spectrum_ops(cfg: ESConfig, *, device: str | torch.device = "cuda") -> spectral.SpectrumOps:
    """The DFT operands of ``cfg`` on ``device``."""
    return spectral.make_spectrum_ops(
        cfg.n_samples,
        num_bins=cfg.num_bins,
        method=cfg.spectrum_method,
        dft_dtype=cfg.dft_dtype,
        device=device,
    )


def _i32(x: int) -> int:
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x & 0x80000000 else x


def kernel_seed(seed: int, generation: int, shard: int | None = None) -> int:
    """Per-generation seed of the kernels' PRNG, in the reference's exact
    int32 arithmetic: the run's base word (``seed & 0x7FFFFFFF``) plus a
    murmur-style hash of the generation index (plus an odd-stride shard term).
    ``seed`` is the reference key's first word, taken as int32."""
    base = seed & 0x7FFFFFFF
    g = _i32(generation * -862048943)  # 0xCC9E2D51
    g = _i32(g ^ ((g & 0xFFFFFFFF) >> 15))
    g = _i32(g * 0x27D4EB2F)
    if shard is not None:
        g = _i32(g + shard * -1028477387)  # 0xC2B2AE35
    return _i32(base + g)


def generation_step(
    state: ESState,
    target_spectrum: torch.Tensor,
    spectrum_ops: spectral.SpectrumOps,
    cfg: ESConfig,
) -> ESState:
    """One ES generation: offspring -> evaluate -> select -> best-ever,
    stall count and the optional stall-triggered restart."""
    gen = state.generator
    if active_engine(cfg, spectrum_ops) == "fused_generation":
        fitness, values, steps = fused_generation(
            kernel_seed(state.seed, state.generation),
            state.parent_values,
            state.parent_steps,
            target_spectrum,
            pop=cfg.population_size,
            param_mins=cfg.param_mins,
            param_maxs=cfg.param_maxs,
            dft_packed=spectrum_ops.dft_packed,
            dft_scale=spectrum_ops.dft_packed_scale,
            topology=cfg.topology,
            n=cfg.n_samples,
            wavetable_size=cfg.wavetable_size,
            sample_rate=cfg.sample_rate,
            pop_block=cfg.pop_block,
            num_frames=cfg.num_frames,
            alpha=cfg.alpha,
            beta=cfg.beta,
            beta_scale=cfg.beta_scale,
            root_two_over_pi=cfg.root_two_over_pi,
            clamp_values=cfg.clamp_values,
            min_step=cfg.min_step,
            sine_order=cfg.sine_order,
        )
    else:
        values, steps = recombine(gen, state.parent_values, state.parent_steps, cfg)
        values, steps = mutate(gen, values, steps, cfg)
        fitness = evaluate(values, target_spectrum, spectrum_ops, cfg)
    pv, ps, pf = select(values, steps, fitness, cfg.num_parents)
    improved = pf[0] < state.best_fitness
    stall = torch.where(improved, 0, state.stall + 1).to(torch.int32)
    if cfg.restart_patience > 0:
        # fresh random parents after restart_patience stalled generations;
        # best-ever is kept
        restart = stall >= cfg.restart_patience
        fresh_v = torch.rand(pv.shape, generator=gen, device=pv.device)
        pv = torch.where(restart, fresh_v, pv)
        ps = torch.where(restart, torch.full_like(ps, 0.1), ps)
        pf = torch.where(restart, torch.full_like(pf, float("inf")), pf)
        stall = torch.where(restart, 0, stall).to(torch.int32)
    return ESState(
        parent_values=pv,
        parent_steps=ps,
        parent_fitness=pf,
        best_values=torch.where(improved, pv[0], state.best_values),
        best_fitness=torch.where(improved, pf[0], state.best_fitness),
        seed=state.seed,
        generation=state.generation + 1,
        stall=stall,
        generator=gen,
    )


def evolve(
    state: ESState,
    target_spectrum: torch.Tensor,
    num_generations: int,
    spectrum_ops: spectral.SpectrumOps,
    cfg: ESConfig,
    record_trajectory: bool = False,
):
    """Run ``num_generations`` generations.

    With ``cfg.fitness_threshold > 0`` (and no trajectory) the loop stops
    once best-ever fitness drops to the threshold. Returns
    ``(final_state, trajectory)``; the trajectory is the best-ever fitness
    after each generation, ``(num_generations,)``, or None.
    """
    early_stop = cfg.fitness_threshold > 0.0 and not record_trajectory
    traj = []
    for _ in range(num_generations):
        if early_stop and float(state.best_fitness) <= cfg.fitness_threshold:
            break
        state = generation_step(state, target_spectrum, spectrum_ops, cfg)
        if record_trajectory:
            traj.append(state.best_fitness)
    if not record_trajectory:
        return state, None
    if not traj:
        return state, torch.zeros((0,), dtype=torch.float32, device=state.best_fitness.device)
    return state, torch.stack(traj)
