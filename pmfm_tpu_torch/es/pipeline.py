"""The per-generation step, the generation loop and the audio matchers
(port of ``pmfm_tpu/es/pipeline.py``: ``make_spectrum_ops``,
``kernel_seed``, ``generation_step``, ``evolve`` and its whole-run path
``_evolve_mega``, the refine tail ``refine_boundary`` /
``_evolve_on_target``, ``match_audio``, the multi-frame ``match_audio_stft``
and the batched ``match_many``).

Where the reference scans ``generation_step`` inside one jitted program,
``evolve`` here is a Python loop over generations. A generation launches one
kernel (B2) under ``fused_generation``, or torch recombine/mutate plus one
kernel: B1 (``fused_kernel``), B3 (``synth_fold``, 4096 <= n <= 16384) or B4
(``synth_stream``, n >= 32768); selection is ``torch.topk``. With
``fused_evolve`` on a CUDA device the whole run is one call of B5, which
enqueues every generation's kernels from C. Nothing in the loop reads a
device value back unless ``fitness_threshold`` asks for early stop.

``match_many`` runs B independent runs as one batched state (the run axis of
``es.strategy``): each generation is one launch of B2 (or one B5 call for the
whole run) for all runs, where the reference ``vmap``s its jitted matcher;
each run keeps its own seeds, generator, generation count, restarts, stall
count and best-ever, and under early stop a run that has met the threshold
stops while the others go on, so that run r computes what it would alone.

The matchers have no ``checkpoint_dir`` or ``mesh`` argument yet (ROADMAP
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
    _rand,
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


def state_seeds(state: ESState, ahead: int = 0):
    """The kernels' seed for the generation ``ahead`` generations past
    ``state``'s: one int32, or with the run axis a list of them, run r's
    from its own seed and generation."""
    if isinstance(state.seed, tuple):
        return [kernel_seed(s, g + ahead) for s, g in zip(state.seed, state.generation)]
    return kernel_seed(state.seed, state.generation + ahead)


def _advanced(generation, by: int):
    """``generation`` (an int, or one a run) ``by`` generations on."""
    if isinstance(generation, tuple):
        return tuple(g + by for g in generation)
    return generation + by


def generation_step(
    state: ESState,
    target_spectrum: torch.Tensor,
    spectrum_ops: spectral.SpectrumOps,
    cfg: ESConfig,
) -> ESState:
    """One ES generation: offspring -> evaluate -> select -> best-ever,
    stall count and the optional stall-triggered restart; with the run
    axis, of every run at once (one B2 launch for all of them), each run
    with its own best-ever, stall count and restart."""
    gen = state.generator
    if active_engine(cfg, spectrum_ops) == "fused_generation":
        fitness, values, steps = fused_generation(
            state_seeds(state),
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
    # each run's best parent, and a per-run flag's view over its parents;
    # one run keeps plain indexing and 0-dim flags, since this loop's host
    # time bounds a generation of the bench (PERF.md §6)
    if pv.dim() == 2:
        best_v, best_f, per_run = pv[0], pf[0], (lambda x, k: x)
    else:
        best_v, best_f = pv[:, 0], pf[:, 0]
        per_run = lambda x, k: x.reshape(*x.shape, *(1,) * k)  # noqa: E731
    improved = best_f < state.best_fitness
    stall = torch.where(improved, 0, state.stall + 1).to(torch.int32)
    if cfg.restart_patience > 0:
        # fresh random parents after restart_patience stalled generations;
        # best-ever is kept
        restart = stall >= cfg.restart_patience
        fresh_v = _rand(gen, pv.shape, pv.device)
        pv = torch.where(per_run(restart, 2), fresh_v, pv)
        ps = torch.where(per_run(restart, 2), torch.full_like(ps, 0.1), ps)
        pf = torch.where(per_run(restart, 1), torch.full_like(pf, float("inf")), pf)
        stall = torch.where(restart, 0, stall).to(torch.int32)
    return ESState(
        parent_values=pv,
        parent_steps=ps,
        parent_fitness=pf,
        best_values=torch.where(per_run(improved, 1), best_v, state.best_values),
        best_fitness=torch.where(improved, best_f, state.best_fitness),
        seed=state.seed,
        generation=_advanced(state.generation, 1),
        stall=stall,
        generator=gen,
    )


def _fused_evolve_ok(cfg: ESConfig, spectrum_ops: spectral.SpectrumOps,
                     device: torch.device) -> bool:
    """Whether the whole-run kernel B5 applies: the reference's gate, with
    a CUDA device in place of its ``default_backend() != "cpu"``. An
    ``fm{k}_parallel`` config passes it, and B5 then raises
    ``NotImplementedError`` (ROADMAP Queue B item 3) rather than run B2 in
    its place."""
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
    generations (its plain version on CPU tensors), of every run with the
    run axis. Generation g draws the seed ``generation_step`` would,
    ``state_seeds(state, g)``; the stall count is recovered from the
    best-ever trajectory, as the reference does."""
    if num_generations == 0:
        traj0 = torch.zeros((*state.best_fitness.shape, 0), dtype=torch.float32,
                            device=state.best_fitness.device)
        return state, (traj0 if record_trajectory else None)
    g = num_generations
    seeds = [state_seeds(state, i) for i in range(g)]
    if isinstance(state.seed, tuple):  # (G, B) -> B lists of G, one a run
        seeds = [list(run) for run in zip(*seeds)]
    pv, ps, pf, bv, bf, traj = fused_evolve(
        seeds,
        state.parent_values,
        state.parent_steps,
        state.best_values,
        state.best_fitness,
        target_spectrum,
        gens_per_step=cfg.gens_per_step,
        **fused_generation_kwargs(cfg, spectrum_ops),
    )
    # stall = generations since the best improved, from the trajectory
    prev = torch.cat([state.best_fitness[..., None], traj[..., :-1]], dim=-1)
    idx = torch.arange(g, device=traj.device)
    last = torch.max(torch.where(traj < prev, idx, -1), dim=-1).values
    stall = torch.where(last < 0, state.stall + g, g - 1 - last).to(torch.int32)
    final = ESState(
        parent_values=pv,
        parent_steps=ps,
        parent_fitness=pf,
        best_values=bv,
        best_fitness=bf,
        seed=state.seed,
        generation=_advanced(state.generation, g),
        stall=stall,
        generator=state.generator,
    )
    return final, (traj if record_trajectory else None)


def _hold(met: np.ndarray, state: ESState, step) -> ESState:
    """``step(state)`` for the runs of ``state`` not marked in ``met`` (host
    bools, one a run): a marked run, which has met the threshold, keeps its
    state, generation count and generator's position, as a lone run that
    has stopped does."""
    held = met.tolist()
    saved = [(g, g.get_state()) for g, h in zip(state.generator, held) if h]
    new = step(state)
    for g, position in saved:
        g.set_state(position)
    m = torch.from_numpy(met).to(new.parent_values.device)
    keep = lambda a, b: torch.where(m.reshape(-1, *(1,) * (b.dim() - 1)), a, b)  # noqa: E731
    return new._replace(
        generation=tuple(a if h else b for a, b, h in zip(state.generation, new.generation, held)),
        **{f: keep(getattr(state, f), getattr(new, f)) for f in (
            "parent_values", "parent_steps", "parent_fitness", "best_values", "best_fitness",
            "stall")},
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
    once best-ever fitness drops to the threshold; with the run axis a run
    that has met it stops (``_hold``) and the loop once every run has. Under
    ``cfg.fused_evolve`` on a CUDA device (``_fused_evolve_ok``) the run is
    one call of B5. Returns ``(final_state, trajectory)``; the trajectory is
    the best-ever fitness after each generation, ``(num_generations,)``
    (``(B, num_generations)`` with the run axis), or None.
    """
    if _fused_evolve_ok(cfg, spectrum_ops, state.parent_values.device):
        return _evolve_mega(state, target_spectrum, num_generations, spectrum_ops, cfg,
                            record_trajectory)
    early_stop = cfg.fitness_threshold > 0.0 and not record_trajectory
    step = lambda s: generation_step(s, target_spectrum, spectrum_ops, cfg)  # noqa: E731
    traj = []
    for _ in range(num_generations):
        held = False
        if early_stop:  # one copy to the host a generation, as for one run
            met = state.best_fitness.cpu().numpy() <= cfg.fitness_threshold
            if met.all():
                break
            held = met.ndim > 0 and met.any()  # some runs of many met it
        state = _hold(met, state, step) if held else step(state)
        if record_trajectory:
            traj.append(state.best_fitness)
    if not record_trajectory:
        return state, None
    if not traj:
        return state, torch.zeros((*state.best_fitness.shape, 0), dtype=torch.float32,
                                  device=state.best_fitness.device)
    return state, torch.stack(traj, dim=-1)


def refine_boundary(
    final: ESState,
    tspec_r: torch.Tensor,
    so_r: spectral.SpectrumOps,
    cfg: ESConfig,
    cfg_r: ESConfig,
) -> ESState:
    """The fast-engine -> f32 transition of the refine tail: best-ever is
    rescored under the refine engine, injected into parent slot 0, and the
    steps re-open to ``cfg.refine_step_floor`` (of each run, with the run
    axis: one B1 launch rescores every run's best)."""
    bf = evaluate(final.best_values.unsqueeze(-2), tspec_r, so_r, cfg_r)[..., 0]
    pv = final.parent_values.clone()
    pv[..., 0, :] = final.best_values
    ps = final.parent_steps
    if cfg.refine_step_floor > 0.0:
        ps = torch.clamp_min(ps, cfg.refine_step_floor)
    return final._replace(best_fitness=bf, parent_values=pv, parent_steps=ps)


def target_spectra(target_audio: torch.Tensor, so: spectral.SpectrumOps, cfg: ESConfig,
                   stft: bool) -> torch.Tensor:
    """The target a run is scored against: the spectrum of ``target_audio``
    (N,), or with ``stft`` its framewise spectra (F, K), which at one frame
    (``cfg.num_frames == 1``) is the frame's (K,), as the reference takes it.
    ``target_audio`` (B, N) or (B, F N) gives one target a run."""
    if target_audio.dim() == 2:
        return torch.stack([target_spectra(a, so, cfg, stft) for a in target_audio])
    if not stft:
        return spectral.target_spectrum(target_audio, so)
    t = spectral.target_spectrum_frames(target_audio, so)
    return t[0] if cfg.num_frames == 1 else t


def _evolve_on_target(state, target_audio, num_generations, so, cfg, record_trajectory,
                      refine_ops=None, stft=False):
    """``evolve`` against ``target_audio`` (N,), or with ``stft`` against its
    F = ``cfg.num_frames`` frames (F N,) (``target_spectra``; (B, ...) with
    the run axis), with the optional refine tail: the last
    ``cfg.refine_generations`` run under ``refine_ops``
    (``(cfg.refine_config(), its SpectrumOps)``) against the target's f32
    spectra, seeded at the best-ever candidate (``refine_boundary``).
    Returns ``(final, trajectory, best-ever rescored at the boundary or
    None)``."""
    refine = min(cfg.refine_generations, num_generations) if cfg.refine_generations > 0 else 0
    tspec = target_spectra(target_audio, so, cfg, stft)
    final, traj = evolve(state, tspec, num_generations - refine, so, cfg, record_trajectory)
    if not refine:
        return final, traj, None
    cfg_r, so_r = refine_ops
    tspec_r = target_spectra(target_audio, so_r, cfg_r, stft)
    final = refine_boundary(final, tspec_r, so_r, cfg, cfg_r)
    start = final.best_fitness
    final, traj_r = evolve(final, tspec_r, refine, so_r, cfg_r, record_trajectory)
    if traj is not None:
        traj = torch.cat([traj, traj_r], dim=-1)
    return final, traj, start


def _match_ops(cfg: ESConfig, dev):
    """A matcher's spectrum operands and, with a refine tail, ``(its config,
    its operands)``; each engine is checked (``active_engine`` raises for
    one not ported) before any generation runs."""
    so = make_spectrum_ops(cfg, device=dev)
    active_engine(cfg, so)
    refine_ops = None
    if cfg.refine_generations > 0:
        cfg_r = cfg.refine_config()
        refine_ops = (cfg_r, make_spectrum_ops(cfg_r, device=dev))
        active_engine(*refine_ops)
    return so, refine_ops


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
    so, refine_ops = _match_ops(cfg, dev)
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


def _frames_of(samples: int, cfg: ESConfig) -> int:
    frames = samples // cfg.n_samples
    if frames == 0:
        raise ValueError(f"target audio ({samples} samples) shorter than one frame "
                         f"({cfg.n_samples})")
    return frames


def match_audio_stft(
    target_audio: np.ndarray,
    cfg: ESConfig,
    seed: int = 0,
    num_generations: int = 1000,
    record_trajectory: bool = False,
    *,
    device: str | torch.device = "cuda",
) -> MatchResult:
    """Match one parameter set against all frames of the target at once
    (multi-frame STFT fitness, the reference's BASELINE.json config 2): the
    target's F = len // ``cfg.n_samples`` frames (a remainder is ignored)
    are scored together (``cfg.num_frames`` = F, the kernels' multi-frame
    mode on the fused engines), where ``match_audio`` starts a fresh
    population for each chunk. The run is seeded as ``match_audio``'s first
    chunk (``_chunk_seed(seed, 0)``); the best candidate is resynthesised
    over all F frames. Returns a ``MatchResult`` of one chunk."""
    dev = resolve_device(device)
    frames = _frames_of(len(target_audio), cfg)
    cfg = cfg.replace(num_frames=frames)
    n = cfg.n_samples * frames
    so, refine_ops = _match_ops(cfg, dev)
    audio = torch.from_numpy(np.ascontiguousarray(target_audio[:n], np.float32)).to(dev)
    state = init_state(_chunk_seed(seed, 0), cfg, device=dev)
    final, traj, start = _evolve_on_target(state, audio, num_generations, so, cfg,
                                           record_trajectory, refine_ops, stft=True)
    check_finite("best candidate", final.best_values)
    mins = torch.tensor(cfg.param_mins, dtype=torch.float32, device=dev)
    maxs = torch.tensor(cfg.param_maxs, dtype=torch.float32, device=dev)
    best_scaled = synthesis.scale_params(final.best_values, mins, maxs)
    best_audio = synthesis.synthesize(
        best_scaled[None, :], n, cfg.topology, wavetable_size=cfg.wavetable_size,
        sample_rate=cfg.sample_rate, osc_mode=cfg.osc_mode, engine=cfg.synthesis_engine,
    )[:, 0]
    chunk = ChunkResult(
        best_params_scaled=best_scaled.cpu().numpy(),
        best_params_norm=final.best_values.cpu().numpy(),
        best_fitness=float(final.best_fitness),
        generations_run=final.generation,
        trajectory=None if traj is None else traj.cpu().numpy(),
        refine_start_fitness=None if start is None else float(start),
    )
    return MatchResult(chunks=[chunk], output_audio=best_audio.cpu().numpy(), config=cfg)


def match_many(
    targets: np.ndarray,
    cfg: ESConfig,
    seed: int = 0,
    num_generations: int = 1000,
    *,
    device: str | torch.device = "cuda",
) -> list[MatchResult]:
    """Batched multi-target matching (the reference's BASELINE.json config
    5): B independent runs, one a target row of ``targets`` (B, samples),
    each scored over the targets' F = samples // ``cfg.n_samples`` frames,
    as one batched state (``init_state`` of B seeds, run r seeded
    ``_chunk_seed(seed, r)``: run r starts where ``match_audio_stft`` of its
    target with ``seed`` would when r = 0). A generation is one B2 launch
    for all runs (or the whole run one B5 call), the refine boundary one B1
    launch; each output array comes to the host in one copy. Returns one
    ``MatchResult`` a target."""
    dev = resolve_device(device)
    targets = np.asarray(targets, np.float32)
    if targets.ndim != 2 or targets.shape[0] < 1:
        raise ValueError("targets must be (batch, samples)")
    frames = _frames_of(targets.shape[1], cfg)
    cfg = cfg.replace(num_frames=frames)
    n = cfg.n_samples * frames
    runs = targets.shape[0]
    so, refine_ops = _match_ops(cfg, dev)
    audio = torch.from_numpy(np.ascontiguousarray(targets[:, :n])).to(dev)
    state = init_state([_chunk_seed(seed, r) for r in range(runs)], cfg, device=dev)
    final, _, start = _evolve_on_target(state, audio, num_generations, so, cfg, False,
                                        refine_ops, stft=True)
    check_finite("best candidate", final.best_values)
    mins = torch.tensor(cfg.param_mins, dtype=torch.float32, device=dev)
    maxs = torch.tensor(cfg.param_maxs, dtype=torch.float32, device=dev)
    best_scaled = synthesis.scale_params(final.best_values, mins, maxs)
    best_audio = synthesis.synthesize(
        best_scaled, n, cfg.topology, wavetable_size=cfg.wavetable_size,
        sample_rate=cfg.sample_rate, osc_mode=cfg.osc_mode, engine=cfg.synthesis_engine,
    )
    bs, bv = best_scaled.cpu().numpy(), final.best_values.cpu().numpy()
    bf, ba = final.best_fitness.cpu().numpy(), best_audio.T.cpu().numpy()
    st = None if start is None else start.cpu().numpy()
    return [
        MatchResult(chunks=[ChunkResult(
            best_params_scaled=bs[r], best_params_norm=bv[r], best_fitness=float(bf[r]),
            generations_run=final.generation[r], trajectory=None,
            refine_start_fitness=None if st is None else float(st[r]),
        )], output_audio=ba[r], config=cfg)
        for r in range(runs)
    ]
