"""Population-sharded ES generations over a process mesh (port of
``pmfm_tpu/parallel/sharded.py``).

The population axis is sharded over the mesh's ``pop`` axis; selection is
the only stage that communicates, as a sharded top-mu merge:

  1. each rank makes and evaluates its local population shard (P/n
     candidates) on its own device;
  2. each rank keeps its local top mu (fitness, values, steps);
  3. one ``dist.all_gather`` over the ``pop`` group moves mu (2D + 1)
     float32 values a rank, whatever P is;
  4. every rank merges the gathered n mu candidates into the same global
     top mu (``merge``: the reference's ``select``, ties to the lower index).

The state (parents, best-ever, stall count, the restart generator) is
replicated: every rank computes the same merge and draws the same restarts,
so no second collective is needed, and under early stop every rank reads
the same best-ever and stops at the same generation.

Two paths, as in the reference:

* fused: where ``sharded_engine`` names ``fused_generation`` (B2 at a pop
  shard's population, on a mesh without a frame axis), each rank launches
  B2 at its local population with the kernel seed ``kernel_seed(seed,
  generation, shard=pop index)``; shard 0's seed is the unsharded one, so
  a world of one computes what ``evolve`` does, bit for bit. The whole-run
  kernel B5 is never called.
* unfused: the offspring come from a generator seeded each generation from
  the run's seed, the generation and the pop index only (not the restart
  generator, so the replicated state cannot diverge), so every frame rank
  of one pop shard draws the same offspring; each evaluates them on the
  engine ``evaluate`` picks, or on a frame axis synthesises all F n samples
  and scores only its window of frames (``_evaluate_frames_local``), and
  ``all_reduce(SUM)`` over the frame group rebuilds the fitness. This
  stream differs from the unsharded one by design, in the reference too.
"""
from __future__ import annotations

import torch

from ..es.config import ESConfig
from ..es.pipeline import advance, fused_generation_kwargs, kernel_seed, run_generations
from ..es.strategy import ESState, active_engine, evaluate, mutate, recombine, select
from ..kernels.generation import fused_generation
from ..ops import spectral, synthesis
from ..utils.debug import check_finite
from .mesh import FRAME_AXIS, POP_AXIS, Mesh


def _local_cfg(cfg: ESConfig, n_shards: int) -> ESConfig:
    """``cfg`` at one shard's population (mu unchanged, the offspring
    count shrunk)."""
    if cfg.population_size % n_shards:
        raise ValueError(
            f"population {cfg.population_size} not divisible by mesh size {n_shards}")
    local_pop = cfg.population_size // n_shards
    if local_pop < cfg.num_parents:
        raise ValueError(
            f"local population {local_pop} smaller than num_parents {cfg.num_parents}; "
            f"use fewer shards or more offspring")
    return cfg.replace(num_offspring=local_pop - cfg.num_parents)


def _frames_local(cfg: ESConfig, n_frame_shards: int) -> int:
    """The frames a rank scores on a frame axis of ``n_frame_shards``."""
    if cfg.num_frames % n_frame_shards:
        raise ValueError(f"num_frames {cfg.num_frames} not divisible by frame-axis size "
                         f"{n_frame_shards}")
    return cfg.num_frames // n_frame_shards


def _evaluate_frames_local(values, target_frames, spectrum_ops: spectral.SpectrumOps,
                           cfg: ESConfig, frames_local: int, frame_index: int):
    """The fitness over frame window ``frame_index`` (``frames_local``
    frames from ``frame_index * frames_local``): the candidates' whole
    F n samples synthesised (the phase recurrence runs across frames), only
    the window's framewise spectra and errors computed. The windows' sum is
    the unsharded multi-frame fitness up to float reassociation. Values
    ``(P, D)``, targets ``(F, K)``; with the run axis ``(B, P, D)`` and
    ``(B, F, K)``."""
    if values.dim() == 3:
        return torch.stack([
            _evaluate_frames_local(values[r], target_frames[r], spectrum_ops, cfg,
                                   frames_local, frame_index)
            for r in range(values.shape[0])])
    dev = values.device
    mins = torch.tensor(cfg.param_mins, dtype=torch.float32, device=dev)
    maxs = torch.tensor(cfg.param_maxs, dtype=torch.float32, device=dev)
    n = cfg.n_samples
    audio = synthesis.synthesize(
        synthesis.scale_params(values, mins, maxs), n * cfg.num_frames, cfg.topology,
        wavetable_size=cfg.wavetable_size, sample_rate=cfg.sample_rate, osc_mode=cfg.osc_mode,
        engine=cfg.synthesis_engine,
        out_dtype=torch.bfloat16 if cfg.dft_dtype in ("bfloat16", "int8") else torch.float32,
    )  # (F n, P)
    f0 = frame_index * frames_local
    local = audio[f0 * n:(f0 + frames_local) * n]
    return spectral.stft_fitness(local, target_frames[f0:f0 + frames_local], spectrum_ops)


def frame_fitness(values, target_frames, spectrum_ops: spectral.SpectrumOps, cfg: ESConfig,
                  mesh: Mesh):
    """The multi-frame fitness of ``values`` on a mesh with a frame axis:
    this rank's window (``_evaluate_frames_local``), summed over the frame
    group by one ``all_reduce``."""
    frames_local = _frames_local(cfg, mesh.axis_size(FRAME_AXIS))
    part = _evaluate_frames_local(values, target_frames, spectrum_ops, cfg, frames_local,
                                  mesh.index(FRAME_AXIS))
    return mesh.all_reduce_sum(part, FRAME_AXIS)


def merge(values, steps, fitness, mu: int):
    """The global top mu of the gathered candidates, best first: the
    reference's ``select`` (``lax.top_k`` of -fitness), whose ties go to the
    lower index, as a stable sort; a rank's sorted top mu keeps its order,
    so a world of one merges to its own selection bit for bit."""
    idx = torch.sort(-fitness, dim=-1, descending=True, stable=True).indices[..., :mu]
    take = idx[..., None]
    return (torch.take_along_dim(values, take, dim=-2),
            torch.take_along_dim(steps, take, dim=-2),
            torch.take_along_dim(fitness, idx, dim=-1))


def shard_seeds(state: ESState, shard: int):
    """The kernel seed of this generation on pop shard ``shard``
    (``kernel_seed``'s shard term; shard 0's is the unsharded seed): one
    int32, or with the run axis one a run."""
    if isinstance(state.seed, tuple):
        return [kernel_seed(s, g, shard) for s, g in zip(state.seed, state.generation)]
    return kernel_seed(state.seed, state.generation, shard)


def offspring_generator(state: ESState, shard: int, device: torch.device):
    """The unfused path's offspring generator of this generation and pop
    shard: seeded from the run's seed, the generation and the shard only
    (one a run, with the run axis)."""
    def make(seed: int) -> torch.Generator:
        g = torch.Generator(device=device)
        g.manual_seed(seed & 0xFFFFFFFF)
        return g

    seeds = shard_seeds(state, shard)
    return tuple(make(s) for s in seeds) if isinstance(seeds, list) else make(seeds)


def sharded_engine(cfg: ESConfig, spectrum_ops: spectral.SpectrumOps, mesh: Mesh) -> str:
    """The engine a sharded generation of ``cfg`` runs on ``mesh``: that of
    a pop shard's population (``active_engine``: B2's ``fused_generation``
    on the fused path), or on a frame axis ``xla_stft (frame-sharded)``,
    whatever engine the config would pick unsharded. Raises the
    ``ValueError``s of a population or frame count the mesh does not
    divide."""
    lcfg = _local_cfg(cfg, mesh.axis_size(POP_AXIS))
    if mesh.axis_size(FRAME_AXIS) > 1:
        _frames_local(cfg, mesh.axis_size(FRAME_AXIS))
        return "xla_stft (frame-sharded)"
    return active_engine(lcfg, spectrum_ops)


def sharded_generation_step(state: ESState, target_spectrum: torch.Tensor,
                            spectrum_ops: spectral.SpectrumOps, cfg: ESConfig,
                            mesh: Mesh) -> ESState:
    """One ES generation with the population sharded over ``mesh`` (the
    module docstring: the fused or the unfused path, then the top-mu
    all-gather and the replicated merge). The state in and out is the same
    on every rank of the mesh."""
    if not mesh.member:
        raise ValueError(f"rank {mesh.rank} is not a rank of the mesh {mesh.shape}")
    engine = sharded_engine(cfg, spectrum_ops, mesh)
    lcfg = _local_cfg(cfg, mesh.axis_size(POP_AXIS))
    mu, d = cfg.num_parents, cfg.num_dimensions
    shard = mesh.index(POP_AXIS)
    pv, ps = state.parent_values, state.parent_steps
    if engine == "fused_generation":
        fitness, values, steps = fused_generation(
            shard_seeds(state, shard), pv, ps, target_spectrum,
            **fused_generation_kwargs(lcfg, spectrum_ops))
    else:
        gen = offspring_generator(state, shard, pv.device)
        values, steps = recombine(gen, pv, ps, lcfg)
        values, steps = mutate(gen, values, steps, lcfg)
        if mesh.axis_size(FRAME_AXIS) > 1:
            fitness = frame_fitness(values, target_spectrum, spectrum_ops, lcfg, mesh)
        else:
            fitness = evaluate(values, target_spectrum, spectrum_ops, lcfg)
    check_finite("offspring values", values)
    check_finite("fitness", fitness)
    lv, ls, lf = select(values, steps, fitness, mu)
    parts = mesh.all_gather(torch.cat([lv, ls, lf[..., None]], dim=-1), POP_AXIS)
    g = torch.cat(parts, dim=-2)  # (n mu, 2D + 1), or (B, n mu, 2D + 1)
    pv, ps, pf = merge(g[..., :d], g[..., d:2 * d], g[..., 2 * d], mu)
    return advance(state, pv.contiguous(), ps.contiguous(), pf.contiguous(), cfg)


def evolve_sharded(state: ESState, target_spectrum: torch.Tensor, num_generations: int,
                   spectrum_ops: spectral.SpectrumOps, cfg: ESConfig, mesh: Mesh,
                   record_trajectory: bool = False):
    """``evolve`` over ``mesh`` (the multi-device run): ``num_generations``
    sharded generations, relative to the input state, with ``evolve``'s
    early stop and trajectory. Returns ``(final_state, trajectory or
    None)``."""
    return run_generations(
        state, num_generations, cfg, record_trajectory,
        lambda s: sharded_generation_step(s, target_spectrum, spectrum_ops, cfg, mesh))
