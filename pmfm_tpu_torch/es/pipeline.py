"""The per-generation step, the generation loop and the chunked audio
matcher (port of ``pmfm_tpu/es/pipeline.py``: ``make_spectrum_ops``,
``kernel_seed``, ``generation_step``, ``evolve`` and its whole-run path
``_evolve_mega``, the refine tail ``refine_boundary`` /
``_evolve_on_target``, ``match_audio``).

Where the reference scans ``generation_step`` inside one jitted program,
``evolve`` here is a Python loop over generations. A generation launches one
kernel (B2) under ``fused_generation``, or torch recombine/mutate plus one
kernel: B1 (``fused_kernel``), B3 (``synth_fold``, 4096 <= n <= 16384) or B4
(``synth_stream``, n >= 32768); selection is ``torch.topk``. With
``fused_evolve`` on a CUDA device the whole run is one call of B5, which
enqueues every generation's kernels from C. Nothing in the loop reads a
device value back unless ``fitness_threshold`` asks for early stop.

``match_audio`` has no ``checkpoint_dir`` or ``mesh`` argument yet (ROADMAP
Queue A items 9 and 10). Inside ``utils.debug.debug_nans(True)`` (the
config's ``general.isDebug``) each generation's offspring and fitness and
each chunk's best candidate are checked for NaN.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.evolve import fused_evolve
from ..kernels.generation import fused_generation
from ..ops import spectral, synthesis
from ..utils.debug import check_finite
from .config import ESConfig
from .strategy import (
    ESState,
    _fused_ok,
    active_engine,
    evaluate,
    init_state,
    mutate,
    recombine,
    select,
)


def make_spectrum_ops(cfg: ESConfig, *, device: str | torch.device = "cuda") -> spectral.SpectrumOps:
    """The spectrum operands of ``cfg`` on ``device``; ``cfg.spectrum_method``
    resolves as the reference resolves it (``"dft"`` above 16384 samples is
    the factored DFT)."""
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


def fused_generation_kwargs(cfg: ESConfig, spectrum_ops: spectral.SpectrumOps) -> dict:
    """The keyword arguments that B2 (``fused_generation``) and B5
    (``fused_evolve``) take from ``cfg`` and its operands."""
    return dict(
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
            **fused_generation_kwargs(cfg, spectrum_ops),
        )
    else:
        values, steps = recombine(gen, state.parent_values, state.parent_steps, cfg)
        values, steps = mutate(gen, values, steps, cfg)
        fitness = evaluate(values, target_spectrum, spectrum_ops, cfg)
    check_finite("offspring values", values)
    check_finite("fitness", fitness)
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


def _fused_evolve_ok(cfg: ESConfig, spectrum_ops: spectral.SpectrumOps,
                     device: torch.device) -> bool:
    """Whether the whole-run kernel B5 applies: the reference's gate, with
    a CUDA device in place of its ``default_backend() != "cpu"``."""
    return (
        cfg.fused_evolve
        and cfg.fused_generation
        and _fused_ok(cfg, spectrum_ops)
        and cfg.gauss_sigma == 1.0 / 6.0
        and cfg.restart_patience == 0
        and cfg.fitness_threshold <= 0.0
        and device.type == "cuda"
    )


def _evolve_mega(
    state: ESState,
    target_spectrum: torch.Tensor,
    num_generations: int,
    spectrum_ops: spectral.SpectrumOps,
    cfg: ESConfig,
    record_trajectory: bool,
):
    """``evolve`` through the whole-run kernel: one B5 call for all
    generations (its plain version on CPU tensors). Generation g draws the
    seed ``generation_step`` would, ``kernel_seed(state.seed,
    state.generation + g)``; the stall count is recovered from the best-ever
    trajectory, as the reference does."""
    if num_generations == 0:
        traj0 = torch.zeros((0,), dtype=torch.float32, device=state.best_fitness.device)
        return state, (traj0 if record_trajectory else None)
    g = num_generations
    pv, ps, pf, bv, bf, traj = fused_evolve(
        [kernel_seed(state.seed, state.generation + i) for i in range(g)],
        state.parent_values,
        state.parent_steps,
        state.best_values,
        state.best_fitness,
        target_spectrum,
        gens_per_step=cfg.gens_per_step,
        **fused_generation_kwargs(cfg, spectrum_ops),
    )
    # stall = generations since the best improved, from the trajectory
    prev = torch.cat([state.best_fitness.reshape(1), traj[:-1]])
    idx = torch.arange(g, device=traj.device)
    last = torch.max(torch.where(traj < prev, idx, -1))
    stall = torch.where(last < 0, state.stall + g, g - 1 - last).to(torch.int32)
    final = ESState(
        parent_values=pv,
        parent_steps=ps,
        parent_fitness=pf,
        best_values=bv,
        best_fitness=bf,
        seed=state.seed,
        generation=state.generation + g,
        stall=stall,
        generator=state.generator,
    )
    return final, (traj if record_trajectory else None)


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
    once best-ever fitness drops to the threshold. Under ``cfg.fused_evolve``
    on a CUDA device (``_fused_evolve_ok``) the run is one call of B5.
    Returns ``(final_state, trajectory)``; the trajectory is the best-ever
    fitness after each generation, ``(num_generations,)``, or None.
    """
    if _fused_evolve_ok(cfg, spectrum_ops, state.parent_values.device):
        return _evolve_mega(state, target_spectrum, num_generations, spectrum_ops, cfg,
                            record_trajectory)
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


def refine_boundary(
    final: ESState,
    tspec_r: torch.Tensor,
    so_r: spectral.SpectrumOps,
    cfg: ESConfig,
    cfg_r: ESConfig,
) -> ESState:
    """The fast-engine -> f32 transition of the refine tail: best-ever is
    rescored under the refine engine, injected into parent slot 0, and the
    steps re-open to ``cfg.refine_step_floor``."""
    bf = evaluate(final.best_values[None], tspec_r, so_r, cfg_r)[0]
    pv = final.parent_values.clone()
    pv[0] = final.best_values
    ps = final.parent_steps
    if cfg.refine_step_floor > 0.0:
        ps = torch.clamp_min(ps, cfg.refine_step_floor)
    return final._replace(best_fitness=bf, parent_values=pv, parent_steps=ps)


def _evolve_on_target(state, target_audio, num_generations, so, cfg, record_trajectory,
                      refine_ops=None):
    """``evolve`` against ``target_audio`` (N,), with the optional refine
    tail: the last ``cfg.refine_generations`` run under ``refine_ops``
    (``(cfg.refine_config(), its SpectrumOps)``) against the target's f32
    spectrum, seeded at the best-ever candidate (``refine_boundary``).
    Returns ``(final, trajectory, best-ever rescored at the boundary or
    None)``."""
    refine = min(cfg.refine_generations, num_generations) if cfg.refine_generations > 0 else 0
    tspec = spectral.target_spectrum(target_audio, so)
    final, traj = evolve(state, tspec, num_generations - refine, so, cfg, record_trajectory)
    if not refine:
        return final, traj, None
    cfg_r, so_r = refine_ops
    tspec_r = spectral.target_spectrum(target_audio, so_r)
    final = refine_boundary(final, tspec_r, so_r, cfg, cfg_r)
    start = final.best_fitness
    final, traj_r = evolve(final, tspec_r, refine, so_r, cfg_r, record_trajectory)
    if traj is not None:
        traj = torch.cat([traj, traj_r])
    return final, traj, start


class ChunkResult(NamedTuple):
    best_params_scaled: np.ndarray  # (D,)
    best_params_norm: np.ndarray  # (D,) in [0, 1]
    best_fitness: float
    generations_run: int
    trajectory: np.ndarray | None  # (G,) best-ever fitness per generation
    # best-ever rescored by the refine engine where the refine tail starts
    # (None without a tail); best_fitness is never above it
    refine_start_fitness: float | None = None


@dataclasses.dataclass
class MatchResult:
    """Output of one chunked match."""

    chunks: list[ChunkResult]
    output_audio: np.ndarray  # resynthesised best candidate per chunk, concatenated
    config: ESConfig

    @property
    def best_chunk(self) -> ChunkResult:
        return min(self.chunks, key=lambda c: c.best_fitness)


def _chunk_seed(seed: int, chunk: int) -> int:
    """The ``init_state`` seed of chunk ``chunk`` of a match seeded ``seed``."""
    return int(np.random.SeedSequence([seed & 0xFFFFFFFF, chunk]).generate_state(1)[0])


def match_audio(
    target_audio: np.ndarray,
    cfg: ESConfig,
    seed: int = 0,
    num_generations: int = 1000,
    record_trajectory: bool = False,
    benchmarker=None,
    *,
    device: str | torch.device = "cuda",
) -> MatchResult:
    """Match FM parameters chunk by chunk over a target waveform: chunks of
    ``cfg.n_samples`` (a remainder is ignored, as in the reference), a fresh
    population per chunk, the best candidate of each chunk resynthesised with
    ``cfg.synthesis_engine`` into the output audio.

    ``benchmarker`` (a ``utils.benchmarker.Benchmarker``) records each
    chunk's wall time under "chunk" and the whole match under "Total Audio
    Analysis Time", as the reference does; a chunk's time ends when its
    results are on the host."""
    dev = resolve_device(device)
    n = cfg.n_samples
    num_chunks = len(target_audio) // n
    if num_chunks == 0:
        raise ValueError(f"target audio ({len(target_audio)} samples) shorter than one chunk ({n})")
    so = make_spectrum_ops(cfg, device=dev)
    active_engine(cfg, so)
    refine_ops = None
    if cfg.refine_generations > 0:
        cfg_r = cfg.refine_config()
        refine_ops = (cfg_r, make_spectrum_ops(cfg_r, device=dev))
        active_engine(*refine_ops)
    mins = torch.tensor(cfg.param_mins, dtype=torch.float32, device=dev)
    maxs = torch.tensor(cfg.param_maxs, dtype=torch.float32, device=dev)
    target = np.asarray(target_audio, np.float32)
    results, out_audio = [], []
    if benchmarker is not None:
        benchmarker.start_timer("Total Audio Analysis Time")
    for i in range(num_chunks):
        if benchmarker is not None:
            benchmarker.start_timer("chunk")
        frame = torch.from_numpy(np.ascontiguousarray(target[i * n : (i + 1) * n])).to(dev)
        state = init_state(_chunk_seed(seed, i), cfg, device=dev)
        final, traj, start = _evolve_on_target(
            state, frame, num_generations, so, cfg, record_trajectory, refine_ops
        )
        check_finite("best candidate", final.best_values)
        best_scaled = synthesis.scale_params(final.best_values, mins, maxs)
        best_audio = synthesis.synthesize(
            best_scaled[None, :], n, cfg.topology, wavetable_size=cfg.wavetable_size,
            sample_rate=cfg.sample_rate, osc_mode=cfg.osc_mode, engine=cfg.synthesis_engine,
        )[:, 0]
        results.append(ChunkResult(
            best_params_scaled=best_scaled.cpu().numpy(),
            best_params_norm=final.best_values.cpu().numpy(),
            best_fitness=float(final.best_fitness),
            generations_run=final.generation,
            trajectory=None if traj is None else traj.cpu().numpy(),
            refine_start_fitness=None if start is None else float(start),
        ))
        out_audio.append(best_audio.cpu().numpy())
        if benchmarker is not None:
            benchmarker.pause_timer("chunk")
    if benchmarker is not None:
        benchmarker.pause_timer("Total Audio Analysis Time")
    return MatchResult(chunks=results, output_audio=np.concatenate(out_audio), config=cfg)
