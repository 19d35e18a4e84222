"""The staged (pursuit) solvers for ``fm{k}_parallel`` and ``fm{k>=4}_series``
targets (port of ``pmfm_tpu/es/staged.py``).

The direct ES stalls on these families (35-55% relative spectral error on
fm{k}_parallel at every engine precision, 12-26% on the 8-gene chain, by the
reference's own measurements); the reference's README names this solver as
the one that recovers them. The algorithms are the reference's:

``match_parallel_pursuit`` (k pairs, D = 4k genes; fm2 is a bank of one):
  peel stages   -- the first k-2 pairs one at a time: a block ES over the
                   pair's 4 genes, the others frozen, unfit pairs silent,
                   best of ``peel_tries``;
  joint tail    -- the last two pairs' 8 genes jointly, best of
                   ``tail_tries``;
  repair rounds -- (k >= 4) every unordered pair of pair blocks re-fit
                   jointly while a round improves;
  alias rounds  -- reflected folded-comb proposals (``alias_variants``),
                   each short-polished with the configured engine;
  final polish  -- the configured engine with its refine tail, seeded
                   around the estimate.

``match_series_pursuit`` (fm{k}_series, k >= 4): core (the outer three
operators with the inner genes frozen at zero, an exact fm3_series
reduction), grow inward a 4-gene window at a time with a repair pass after
each step, then the configured engine's polish and an f32-elitist guard.

Both wrap their attempts in a self-scored multi-start (``_multi_start``).

The block stages score candidates embedded into the frozen full-model genes
with the unfused f32 engine (``_eval_cfg``: ``xla_dft``, or
``xla_dft_factored`` above 16384 samples, on the configured synthesis); the
polishes run the configured engine: B2 (``fused_generation``) in int8 for
the examples, with the refine tail's f32 B1/B2 after it, or B4 + the
factored DFT at n 65536.

PyTorch idiom in place of JAX's:

* an integer seed and a ``torch.Generator`` on the run's device in place of
  a key; sub-seeds come from ``np.random.SeedSequence`` (``_sub_seed``), as
  ``pipeline._chunk_seed`` derives a chunk's; attempt 0 of ``_multi_start``
  runs on the caller's seed unchanged;
* the reference's vmap over a stage's tries is one evaluation a generation
  over the R tries stacked along the population axis, (R P, D), each try's
  top-mu taken on the (R, P) view, so no candidate of one try reaches
  another try's parents (``_block_runner_batch``); the tries of a batch draw
  from one generator;
* a batch of polishes runs its members one after another: B2's
  recombination draws parents from one parent set (the reference does the
  same at ``_batch_width_cap == 1``).

``PursuitResult`` adds ``seconds`` to the reference's fields: wall seconds
of each part of the attempts (block stages, alias polishes, final polish,
the multi-start's scoring), summed over the attempts.
"""
from __future__ import annotations

import functools
import time
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops import spectral
from ..ops.synthesis import parallel_pairs, series_ops
from .config import ESConfig
from .pipeline import _evolve_on_target, evolve, make_spectrum_ops
from .strategy import ESState, evaluate, mutate, recombine

# "tpu"."pursuit" config block (camelCase, io/config.py) -> kwargs
CONFIG_KEY_MAP = {
    "stagePopulation": "stage_population",
    "peelGenerations": "peel_generations",
    "peelTries": "peel_tries",
    "tailGenerations": "tail_generations",
    "tailTries": "tail_tries",
    "aliasRounds": "alias_rounds",
    "aliasGenerations": "alias_generations",
    "jointGenerations": "joint_generations",
    "jointSpread": "joint_spread",
    "jointStep": "joint_step",
    "repairRounds": "repair_rounds",
    "repairGenerations": "repair_generations",
    "targetRel": "target_rel",
    "maxAttempts": "max_attempts",
}

# series pursuit config keys (tpu.pursuit block) -> kwargs
SERIES_CONFIG_KEY_MAP = {
    "stagePopulation": "stage_population",
    "coreGenerations": "core_generations",
    "coreTries": "core_tries",
    "growGenerations": "grow_generations",
    "growTries": "grow_tries",
    "repairRounds": "repair_rounds",
    "repairGenerations": "repair_generations",
    "jointGenerations": "joint_generations",
    "jointSpread": "joint_spread",
    "jointStep": "joint_step",
    "targetRel": "target_rel",
    "maxAttempts": "max_attempts",
}

_FLOAT_KEYS = ("joint_spread", "joint_step", "target_rel")
_ATTEMPT_TAG = 0x41545450  # the multi-start's sub-seed path (JAX's fold_in)

# _batch_width_cap: live bytes a block-stage candidate takes per sample in
# the f32 engine (_eval_cfg: the scanless synthesis's float32 temporaries,
# the f32 audio and the matmul or factored DFT's products), and the share of
# the card's memory the stacked tries may hold (_batch_width_cap's
# docstring gives the calibration).
F32_ENGINE_BYTES_PER_SAMPLE = 48
CARD_MEMORY_SHARE = 0.5
# the reference's CPU budget (its TPU HBM cap, kept for the CPU)
CPU_BUDGET_BYTES = 6 << 30
MAX_BATCH_WIDTH = 8


def _items_to_kwargs(items, key_map: dict, what: str) -> dict:
    out = {}
    for k, v in dict(items).items():
        if k not in key_map:
            raise ValueError(f"unknown tpu.pursuit key {k!r}{what}; options {list(key_map)}")
        snake = key_map[k]
        out[snake] = float(v) if snake in _FLOAT_KEYS else int(v)
    return out


def pursuit_kwargs_from_config(items) -> dict:
    """Map the config's camelCase pursuit block (RunConfig.pursuit, stored
    as sorted (key, value) tuples) to match_parallel_pursuit kwargs."""
    return _items_to_kwargs(items, CONFIG_KEY_MAP, "")


def series_pursuit_kwargs_from_config(items) -> dict:
    """Map the config's camelCase pursuit block to match_series_pursuit
    kwargs (series-chain key set)."""
    return _items_to_kwargs(items, SERIES_CONFIG_KEY_MAP, " for a series topology")


class PursuitResult(NamedTuple):
    best_values: np.ndarray  # (D,) normalised genes
    best_fitness: float  # under cfg's scoring engine (f32 if refine tail)
    stage_fitness: np.ndarray  # joint fitness after each block stage
    alias_fitness: np.ndarray  # joint fitness after each alias round
    generations_used: int  # total ES generations across all phases
    attempts: int = 1  # outer self-scored restarts consumed (target_rel)
    seconds: dict | None = None  # wall seconds by part, summed over attempts


def _sub_seed(seed: int, *path: int) -> int:
    """A 32-bit seed derived from ``seed`` and the integers ``path``."""
    words = [seed & 0xFFFFFFFF, *(p & 0xFFFFFFFF for p in path)]
    return int(np.random.SeedSequence(words).generate_state(1)[0])


def _block_topology(d: int) -> str:
    """ANY topology whose dimension count matches ``d`` — only the ES
    hyper-parameter scaling (beta = sqrt(1/D)) reads it; evaluation always
    embeds the block into the FULL model (see _block_runner)."""
    if d == 4:
        return "fm2"
    if d >= 6 and d % 2 == 0 and d % 4 != 0:
        return f"fm{d // 2}_series"
    if d >= 8 and d % 4 == 0:
        return f"fm{d // 4}_parallel"
    raise ValueError(f"no topology with {d} dimensions")


def _block_cfg(cfg: ESConfig, block: tuple, pop: int) -> ESConfig:
    """ES-hyperparameter config for a block stage (beta = sqrt(1/|block|)
    etc. follow the BLOCK dimension, the proper Schwefel scaling)."""
    mu = max(16, pop // 64)
    return cfg.replace(
        topology=_block_topology(len(block)),
        num_dimensions=len(block),
        param_mins=tuple(cfg.param_mins[i] for i in block),
        param_maxs=tuple(cfg.param_maxs[i] for i in block),
        num_parents=mu,
        num_offspring=pop - mu,
        mutation_noise="clt12_neutral",
        min_step=1e-4,
        restart_patience=100,
        refine_generations=0,
        fused_kernel=False,
        fused_generation=False,
        fused_evolve=False,
    )


def _eval_cfg(cfg: ESConfig) -> ESConfig:
    """The block stages' scoring engine: the unfused f32 engine (any
    population size), never the fused true-f32 kernels (the reference
    measured their sub-ULP differences degrade the fm4_series recipe)."""
    return cfg.replace(
        dft_dtype="float32", fused_kernel=False, fused_generation=False,
        fused_evolve=False, refine_generations=0,
    )


@functools.lru_cache(maxsize=8)
def _spectrum_ops(cfg: ESConfig, device: torch.device) -> spectral.SpectrumOps:
    """``make_spectrum_ops(cfg)`` on ``device``, built once per config."""
    return make_spectrum_ops(cfg, device=device)


def _embed(frozen: torch.Tensor, block: tuple, values: torch.Tensor) -> torch.Tensor:
    """Block candidates ``values`` (P, |block|) embedded into the frozen
    full-model genes ``frozen`` (D,): (P, D), as the block stages score them."""
    full = frozen.expand(values.shape[0], frozen.shape[0]).clone()
    full[:, list(block)] = values
    return full


def _recombine_batch(gen, pv, ps, bcfg: ESConfig):
    """``strategy.recombine`` of each try's parents (R, mu, B) into its
    offspring (R, P, B); ``gather`` draws every try's indices at once, and
    each try reads only its own parents."""
    r, mu, b = pv.shape
    if bcfg.recombine_mode != "gather":
        outs = [recombine(gen, pv[i], ps[i], bcfg) for i in range(r)]
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
    idx = torch.randint(0, mu, (r, bcfg.population_size, b), generator=gen, device=pv.device)
    return torch.gather(pv, 1, idx), torch.gather(ps, 1, idx)


def _block_runner_batch(cfg: ESConfig, block: tuple, pop: int, gens: int):
    """``run(seeds, frozen (D,), center (|block|,), tspec) -> (best (R,
    |block|), fitness (R,))``: R = len(seeds) independent block-ES tries over
    ``block``'s genes of the FULL model, genes outside the block at
    ``frozen``, each elitist (the incumbent block holds a parent slot and
    initialises best-ever, so a stage never regresses) with stall restarts.
    A generation evaluates the tries' (R, P) candidates in one call of the
    f32 engine; the draws come from one generator seeded from ``seeds``."""
    bcfg = _block_cfg(cfg, block, pop)
    ecfg = _eval_cfg(cfg)
    mu, nb = bcfg.num_parents, len(block)

    def run(seeds, frozen, center, tspec):
        dev = frozen.device
        so = _spectrum_ops(ecfg, dev)
        r = len(seeds)
        gen = torch.Generator(device=dev)
        gen.manual_seed(_sub_seed(*seeds))

        def eval_fn(values):  # (R', P', B) -> (R', P')
            full = _embed(frozen, block, values.reshape(-1, nb))
            return evaluate(full, tspec, so, ecfg).reshape(values.shape[:2])

        pv = torch.rand((r, mu, nb), generator=gen, device=dev)
        pv[:, 0] = center
        ps = torch.full((r, mu, nb), 0.1, dtype=torch.float32, device=dev)
        best_v = center.expand(r, nb).clone()
        best_f = eval_fn(center[None, None]).reshape(1).expand(r).clone()
        stall = torch.zeros((r,), dtype=torch.int32, device=dev)
        for _ in range(gens):
            v, s = _recombine_batch(gen, pv, ps, bcfg)
            v, s = mutate(gen, v, s, bcfg)
            fit = eval_fn(v)
            neg, top = torch.topk(-fit, mu, dim=1)
            top3 = top[..., None].expand(r, mu, nb)
            pv, ps, pf = torch.gather(v, 1, top3), torch.gather(s, 1, top3), -neg
            improved = pf[:, 0] < best_f
            best_v = torch.where(improved[:, None], pv[:, 0], best_v)
            best_f = torch.where(improved, pf[:, 0], best_f)
            stall = torch.where(improved, 0, stall + 1).to(torch.int32)
            restart = stall >= bcfg.restart_patience
            fresh = torch.rand(pv.shape, generator=gen, device=dev)
            pv = torch.where(restart[:, None, None], fresh, pv)
            ps = torch.where(restart[:, None, None], torch.full_like(ps, 0.1), ps)
            stall = torch.where(restart, 0, stall).to(torch.int32)
        return best_v, best_f

    return run


def _block_runner(cfg: ESConfig, block: tuple, pop: int, gens: int):
    """``run(seed, frozen, center, tspec) -> (best (|block|,), fitness ())``:
    one try of ``_block_runner_batch``."""
    batch = _block_runner_batch(cfg, block, pop, gens)

    def run(seed, frozen, center, tspec):
        bv, bf = batch([seed], frozen, center, tspec)
        return bv[0], bf[0]

    return run


def _batch_width_cap(n_samples: int, pop: int, device: str | torch.device = "cpu") -> int:
    """Most tries of a block stage evaluated together, (R P) candidates a
    generation: each takes ``F32_ENGINE_BYTES_PER_SAMPLE`` x n x P bytes of
    the f32 engine's live tensors, and the stacked tries may hold
    ``CARD_MEMORY_SHARE`` of the card's memory (``torch.cuda.mem_get_info``'s
    total); on the CPU the reference's 6 GB. At the examples' n 1024 and
    stage population 8192 this is the reference's width 8 on an 80 GB card;
    at n 65536 (huge_frame_match.json) it is 1.

    Calibration (``chip_smoke.py`` phase 21: ``torch.cuda.max_memory_allocated``
    over one ``evaluate`` of 8192 candidates, an H100 80GB HBM3 at 700 W):
    45.1 bytes a candidate sample for fm3_parallel at n 1024, 37.1 for fm2
    at n 65536 (18.5 GiB a try)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        budget = CARD_MEMORY_SHARE * torch.cuda.mem_get_info(dev)[1]
    else:
        budget = CPU_BUDGET_BYTES
    per = F32_ENGINE_BYTES_PER_SAMPLE * n_samples * pop
    return int(max(1, min(MAX_BATCH_WIDTH, budget // per)))


def _seeded_state(seed: int, est: torch.Tensor, best_fitness: torch.Tensor, cfg: ESConfig,
                  spread: float, step: float) -> ESState:
    """ES state of cfg's engine around the estimate ``est`` (D,): parents
    ``clip(est + spread * N(0, 1), 0, 1)`` with ``est`` itself in slot 0,
    steps ``step``, best-ever ``(est, best_fitness)``; the generator and the
    kernels' seed word from ``seed``."""
    dev = est.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    mu, d = cfg.num_parents, cfg.num_dimensions
    word = int(torch.randint(0, 2**31, (1,), generator=gen, device=dev).item())
    noise = torch.randn((mu, d), generator=gen, device=dev)
    pv = torch.clamp(est[None] + spread * noise, 0.0, 1.0).to(torch.float32)
    pv[0] = est
    return ESState(
        parent_values=pv,
        parent_steps=torch.full((mu, d), step, dtype=torch.float32, device=dev),
        parent_fitness=torch.full((mu,), float("inf"), dtype=torch.float32, device=dev),
        best_values=est.clone(),
        best_fitness=best_fitness.reshape(()).to(torch.float32),
        seed=word,
        generation=0,
        stall=torch.zeros((), dtype=torch.int32, device=dev),
        generator=gen,
    )


def _polish_runner(cfg: ESConfig, gens: int, spread: float, step: float):
    """``run(seed, est (D,), tspec) -> (best (D,), fitness ())``: joint ES
    with the CONFIGURED engine, parents seeded around ``est``, which is
    rescored on that engine as the incumbent."""

    def run(seed, est, tspec):
        so = _spectrum_ops(cfg, est.device)
        st = _seeded_state(seed, est, evaluate(est[None], tspec, so, cfg)[0], cfg, spread, step)
        fin, _ = evolve(st, tspec, gens, so, cfg)
        return fin.best_values, fin.best_fitness

    return run


def _polish_runner_batch(cfg: ESConfig, gens: int, spread: float, step: float):
    """``run(seeds, ests (R, D), tspec) -> (best (R, D), fitness (R,))``: the
    polishes of ``_polish_runner`` one after another (B2 draws every
    offspring's parents from one parent set, so polishes do not stack)."""
    one = _polish_runner(cfg, gens, spread, step)

    def run(seeds, ests, tspec):
        outs = [one(s, ests[i], tspec) for i, s in enumerate(seeds)]
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])

    return run


def alias_variants(est: np.ndarray, k: int, freq_scale: np.ndarray) -> list:
    """Reflected folded-comb proposals (diagnostics item 3): per pair,
    carrier moved by +-1/+-2 mod-freq multiples, the mod freq reflected
    through twice the carrier, and the (fm, fc) swap. ``freq_scale`` maps
    each gene to Hz (param_maxs for the fm/fc slots; mins assumed 0)."""
    out = []
    for j in range(k):
        fm_i, fc_i = 4 * j, 4 * j + 2
        fm = est[fm_i] * freq_scale[fm_i]
        fc = est[fc_i] * freq_scale[fc_i]
        cands = [
            (fm, fc + fm), (fm, abs(fc - fm)),
            (fm, fc + 2 * fm), (fm, abs(fc - 2 * fm)),
            (fm + 2 * fc, fc), (abs(fm - 2 * fc), fc),
            (fc, fm),  # swap
        ]
        seen = set()
        for fm2, fc2 in cands:
            if not (0.0 < fm2 <= freq_scale[fm_i]):
                continue
            if not (0.0 <= fc2 <= freq_scale[fc_i]):
                continue
            if abs(fm2 - fm) < 1.0 and abs(fc2 - fc) < 1.0:
                continue
            sig = (round(fm2, 1), round(fc2, 1))
            if sig in seen:
                continue
            seen.add(sig)
            v = est.copy()
            v[fm_i] = fm2 / freq_scale[fm_i]
            v[fc_i] = fc2 / freq_scale[fc_i]
            out.append(v)
    return out


class _Stages:
    """The block stages of one attempt: the estimate, the stage fitness
    list, generation and seed counters, and the wall seconds by part."""

    def __init__(self, cfg: ESConfig, seed: int, est: np.ndarray, tspec, stage_population: int):
        self.cfg, self.seed, self.est, self.tspec = cfg, seed, est, tspec
        self.pop = stage_population
        self.stage_fit, self.gens_used, self.calls = [], 0, 0
        self.seconds = {"block": 0.0, "alias": 0.0, "final": 0.0}

    def next_seeds(self, count: int) -> list:
        self.calls += 1
        return [_sub_seed(self.seed, self.calls, i) for i in range(count)]

    def run_block(self, block: tuple, tries: int, gens: int) -> None:
        """All tries of a stage, in batches of ``_batch_width_cap``; the best
        try's block goes into the estimate."""
        t0 = time.perf_counter()
        dev = self.tspec.device
        runner = _block_runner_batch(self.cfg, block, self.pop, gens)
        frozen = torch.from_numpy(self.est).to(dev)
        center = frozen[list(block)].clone()
        seeds = self.next_seeds(tries)
        cap = _batch_width_cap(self.cfg.n_samples, self.pop, dev)
        bvs, bfs = [], []
        for s in range(0, tries, cap):
            bv, bf = runner(seeds[s : s + cap], frozen, center, self.tspec)
            bvs.append(bv.cpu().numpy())
            bfs.append(bf.cpu().numpy())
        bvs, bfs = np.concatenate(bvs), np.concatenate(bfs)
        self.gens_used += gens * tries
        i = int(np.argmin(bfs))
        self.est[list(block)] = bvs[i]
        self.stage_fit.append(float(bfs[i]))
        self.seconds["block"] += time.perf_counter() - t0

    def final_polish(self, target_audio, joint_generations, joint_spread, joint_step,
                     best_fitness: float):
        """cfg's engine with its refine tail around the estimate
        (``_evolve_on_target``), best-ever starting at ``best_fitness``;
        returns the final state."""
        t0 = time.perf_counter()
        dev, cfg = self.tspec.device, self.cfg
        so_p = _spectrum_ops(cfg, dev)
        refine_ops = None
        if cfg.refine_generations > 0:
            cfg_r = cfg.refine_config()
            refine_ops = (cfg_r, _spectrum_ops(cfg_r, dev))
        est = torch.from_numpy(self.est).to(dev)
        state = _seeded_state(self.next_seeds(1)[0], est,
                              torch.tensor(best_fitness, dtype=torch.float32, device=dev), cfg,
                              joint_spread, joint_step)
        final, _, _ = _evolve_on_target(state, target_audio, joint_generations, so_p, cfg, False,
                                        refine_ops)
        self.gens_used += joint_generations
        final.best_fitness.item()  # the polish's time ends with its result
        self.seconds["final"] += time.perf_counter() - t0
        return final


def _target_on(target_audio, cfg: ESConfig, device) -> torch.Tensor:
    target = torch.as_tensor(np.asarray(target_audio, np.float32)).to(device)
    if target.shape != (cfg.n_samples,):
        raise ValueError(f"target must be one frame of {cfg.n_samples} samples")
    return target


def _pursuit_attempt(
    target_audio,
    cfg: ESConfig,
    seed: int,
    *,
    device: str | torch.device = "cuda",
    stage_population: int = 1 << 13,
    peel_generations: int = 300,
    peel_tries: int = 3,
    tail_generations: int = 600,
    tail_tries: int = 2,
    alias_rounds: int = 4,
    alias_generations: int = 150,
    joint_generations: int = 500,
    joint_spread: float = 0.01,
    joint_step: float = 0.005,
    repair_rounds: int = 0,
    repair_generations: int = 400,
) -> PursuitResult:
    """One pursuit attempt (module docstring: peel -> joint tail ->
    pairwise repair -> alias jumps -> final polish). See
    ``match_parallel_pursuit`` for the public wrapper."""
    k = parallel_pairs(cfg.topology)
    if k is None and cfg.topology == "fm2":
        # the 2-op family IS a 1-pair bank (same gene layout: fm, index, fc,
        # amp): no peel, the "tail" is the whole problem, and the alias jumps
        # are the point (at n = 2^16 the direct ES locks onto the folded
        # comb |fc - fm|, whose escape is the (fm, |fc-fm|) proposal)
        k = 1
    if k is None:
        raise ValueError(
            f"match_parallel_pursuit needs an fm{{k}}_parallel (or fm2) "
            f"topology, got {cfg.topology!r}"
        )
    dev = resolve_device(device)
    target = _target_on(target_audio, cfg, dev)
    ecfg = _eval_cfg(cfg)
    tspec_e = spectral.target_spectrum(target, _spectrum_ops(ecfg, dev))
    tspec_p = spectral.target_spectrum(target, _spectrum_ops(cfg, dev))

    d = cfg.num_dimensions
    st = _Stages(cfg, seed, np.zeros(d, np.float32), tspec_e, stage_population)  # amps 0: silent

    # peel the first k-2 pairs one at a time (1-vs->=3 is won by the dominant
    # true pair; 1-vs-2 is not), then the last two pairs' 8 genes jointly
    for j in range(max(k - 2, 0)):
        st.run_block(tuple(range(4 * j, 4 * j + 4)), peel_tries, peel_generations)
    st.run_block(tuple(range(4 * max(k - 2, 0), d)), tail_tries, tail_generations)

    # pairwise joint repair (k >= 4): the first peel can merge two true pairs
    # into one compromise pair, which single-block refits cannot leave; re-fit
    # every unordered pair of pair blocks jointly while a round improves (k <=
    # 3 has one such pair, the joint tail it just ran)
    for _ in range(repair_rounds if k >= 4 else 0):
        before = st.stage_fit[-1]
        for j1 in range(k):
            for j2 in range(j1 + 1, k):
                block = tuple(range(4 * j1, 4 * j1 + 4)) + tuple(range(4 * j2, 4 * j2 + 4))
                st.run_block(block, 1, repair_generations)
        if st.stage_fit[-1] >= before * (1.0 - 1e-3):
            break

    # alias-jump rounds with the configured engine; the incumbent leads the
    # candidate list so it gets the same polish budget as the proposals (and
    # moves cur onto the cfg engine's fitness scale on the first round)
    freq_scale = np.asarray(cfg.param_maxs, np.float32)
    polish_b = _polish_runner_batch(cfg, alias_generations, joint_spread, joint_step)
    est, cur = st.est, np.inf
    alias_fit = []
    for _ in range(alias_rounds):
        t0 = time.perf_counter()
        cands = [est.copy()] + alias_variants(est, k, freq_scale)
        stack = torch.from_numpy(np.stack(cands)).to(dev)
        bv, bf = polish_b(st.next_seeds(len(cands)), stack, tspec_p)
        st.gens_used += alias_generations * len(cands)
        bvs, bfs = bv.cpu().numpy(), bf.cpu().numpy()
        i = int(np.argmin(bfs))
        best_v, best_f = est, cur
        if float(bfs[i]) < best_f:
            best_v, best_f = bvs[i], float(bfs[i])
        improved = best_f < cur * (1.0 - 1e-4)
        est, cur = best_v.astype(np.float32), best_f
        alias_fit.append(cur)
        st.seconds["alias"] += time.perf_counter() - t0
        if not improved:
            break
    st.est = est

    final = st.final_polish(target, joint_generations, joint_spread, joint_step, cur)
    return PursuitResult(
        best_values=final.best_values.cpu().numpy(),
        best_fitness=float(final.best_fitness),
        stage_fitness=np.asarray(st.stage_fit, np.float32),
        alias_fitness=np.asarray(alias_fit, np.float32),
        generations_used=st.gens_used,
        seconds=st.seconds,
    )


def match_parallel_pursuit(
    target_audio,
    cfg: ESConfig,
    seed: int = 0,
    *,
    device: str | torch.device = "cuda",
    target_rel: float = 0.0,
    max_attempts: int = 1,
    **attempt_kwargs,
) -> PursuitResult:
    """Recover ``fm{k}_parallel`` (or fm2) parameters for one target frame
    (module docstring: peel -> joint tail -> pairwise repair -> alias jumps
    -> final polish), with optional SELF-SCORED multi-start.

    A single attempt's success depends on its seed. The solver judges its
    own outcome without ground truth, by the relative spectral error
    ``sqrt(f32 fitness / ||target spectrum||^2)`` under the unfused f32
    engine: with ``target_rel > 0`` it restarts with a fresh seed (up to
    ``max_attempts`` in all) until the estimate crosses the line, and
    returns the best attempt either way. Attempt 0 runs on ``seed``.

    Args:
      target_audio: ``(cfg.n_samples,)`` target frame.
      cfg: an ``fm{k}_parallel`` (or fm2) ESConfig; the alias polishes and
        the final polish run exactly this engine (fused kernels, restarts,
        refine tail as configured); the block stages derive 4/8-gene
        sub-configs.
      seed: the run's integer seed.
      device: ``"cuda"`` (the default) or ``"cpu"`` (the kernels' plain
        versions).
      target_rel: accept threshold on the self-scored relative spectral
        error (0 disables multi-start).
      max_attempts: total attempt budget when ``target_rel > 0``.

    ``best_fitness`` is scored by the polish engine (the f32 refine engine
    when cfg.refine_generations > 0); ``generations_used`` and ``seconds``
    accumulate across attempts.
    """
    return _multi_start(
        _pursuit_attempt, target_audio, cfg, seed, device=device,
        target_rel=target_rel, max_attempts=max_attempts, **attempt_kwargs,
    )


def _series_attempt(
    target_audio,
    cfg: ESConfig,
    seed: int,
    *,
    device: str | torch.device = "cuda",
    stage_population: int = 1 << 13,
    core_generations: int = 600,
    core_tries: int = 2,
    grow_generations: int = 300,
    grow_tries: int = 2,
    repair_rounds: int = 3,
    repair_generations: int = 300,
    joint_generations: int = 500,
    joint_spread: float = 0.01,
    joint_step: float = 0.005,
) -> PursuitResult:
    """One staged attempt for ``fm{k}_series`` chains (k >= 4).

    EXACT-REDUCTION HOMOTOPY. Zeroing genes (2j, 2j+1) silences operator
    ``j``'s modulation output exactly, so freezing the first 2(k-3) genes at
    zero reduces the chain exactly to fm3_series on the remaining six genes,
    the family the direct ES cracks. The solver therefore:

      core   -- block-ES the LAST six genes against the full target with the
                inner genes frozen at zero, best of ``core_tries``;
      grow   -- unfreeze inward one operator at a time (j = k-4 .. 0): fit
                genes (2j .. 2j+3), the new operator and its downstream
                neighbour, others frozen, elitist; after each step a repair
                pass over the active suffix;
      repair -- sliding-window joint re-fits over adjacent operator pairs,
                repeated while a round improves;
      polish -- the configured engine (fused int8 kernels, restarts, refine
                tail) seeded around the assembled estimate, then an
                f32-elitist guard.

    No alias-jump stage: chain spectra are chirp-like, not folded combs.
    """
    k = series_ops(cfg.topology)
    if k is None or k < 4:
        raise ValueError(
            f"match_series_pursuit needs an fm{{k}}_series topology with "
            f"k >= 4 (the direct ES handles k = 3), got {cfg.topology!r}"
        )
    dev = resolve_device(device)
    target = _target_on(target_audio, cfg, dev)
    ecfg = _eval_cfg(cfg)
    so_e = _spectrum_ops(ecfg, dev)
    tspec_e = spectral.target_spectrum(target, so_e)

    d = cfg.num_dimensions
    # frozen-at-zero = exact chain reduction
    st = _Stages(cfg, seed, np.zeros(d, np.float32), tspec_e, stage_population)

    def repair_pass(first_gene):
        """Sliding-window joint re-fits over the ACTIVE suffix's adjacent
        operator pairs, repeated while a round improves."""
        for _ in range(repair_rounds):
            before = st.stage_fit[-1]
            for g0 in range(first_gene, d - 2, 2):
                st.run_block(tuple(range(g0, g0 + 4)), 1, repair_generations)
            if st.stage_fit[-1] >= before * (1.0 - 1e-3):
                break

    # core: outer three operators (exact fm3_series reduction); then grow
    # inward a 4-gene window at a time (a 6-gene window measured worse in
    # the reference), each growth step followed by a full repair pass
    st.run_block(tuple(range(2 * k - 6, 2 * k)), core_tries, core_generations)
    for j in range(k - 4, -1, -1):
        st.run_block(tuple(range(2 * j, 2 * j + 4)), grow_tries, grow_generations)
        repair_pass(2 * j)

    est = torch.from_numpy(st.est).to(dev)
    start = evaluate(est[None], tspec_e, so_e, ecfg)[0]
    final = st.final_polish(target, joint_generations, joint_spread, joint_step, float(start))
    # f32-elitist guard: the polish's own fitness is on its engine's scale
    # (optimistic for quantised engines); keep whichever of (polish output,
    # staged estimate) rescores better under f32
    final_f32 = float(evaluate(final.best_values[None], tspec_e, so_e, ecfg)[0])
    if final_f32 <= st.stage_fit[-1]:
        best_values, best_fitness = final.best_values.cpu().numpy(), final_f32
    else:
        best_values, best_fitness = st.est.copy(), float(st.stage_fit[-1])
    return PursuitResult(
        best_values=best_values,
        best_fitness=best_fitness,
        stage_fitness=np.asarray(st.stage_fit, np.float32),
        alias_fitness=np.zeros(0, np.float32),
        generations_used=st.gens_used,
        seconds=st.seconds,
    )


def match_series_pursuit(
    target_audio,
    cfg: ESConfig,
    seed: int = 0,
    *,
    device: str | torch.device = "cuda",
    target_rel: float = 0.0,
    max_attempts: int = 1,
    **attempt_kwargs,
) -> PursuitResult:
    """Recover ``fm{k}_series`` (k >= 4) parameters for one target frame
    via the exact-reduction homotopy (``_series_attempt``), with the same
    self-scored multi-start as ``match_parallel_pursuit``."""
    return _multi_start(
        _series_attempt, target_audio, cfg, seed, device=device,
        target_rel=target_rel, max_attempts=max_attempts, **attempt_kwargs,
    )


def _multi_start(
    attempt_fn,
    target_audio,
    cfg: ESConfig,
    seed: int,
    *,
    device: str | torch.device = "cuda",
    target_rel: float,
    max_attempts: int,
    **attempt_kwargs,
):
    """Shared self-scored multi-start: attempt 0 runs on ``seed`` unchanged,
    attempt a on ``_sub_seed(seed, _ATTEMPT_TAG, a)``; acceptance and the
    best-of-attempts comparison both run on the f32 engine's scale (the
    accept threshold lives on the target spectrum's energy, and a quantised
    polish engine's own fitness is optimistic)."""
    dev = resolve_device(device)
    accept = score = None
    scoring = 0.0
    if target_rel > 0.0:
        ecfg = _eval_cfg(cfg)
        so_e = _spectrum_ops(ecfg, dev)
        tspec = spectral.target_spectrum(_target_on(target_audio, cfg, dev), so_e)
        energy = float(np.sum(tspec.cpu().numpy().astype(np.float64) ** 2))
        accept = target_rel * target_rel * energy

        def score(r):
            v = torch.from_numpy(np.asarray(r.best_values, np.float32)).to(dev)
            return float(evaluate(v[None], tspec, so_e, ecfg)[0])

    best, best_score = None, np.inf
    gens, seconds = 0, {}
    for attempt in range(max(1, max_attempts)):
        aseed = seed if attempt == 0 else _sub_seed(seed, _ATTEMPT_TAG, attempt)
        r = attempt_fn(target_audio, cfg, aseed, device=dev, **attempt_kwargs)
        gens += r.generations_used
        for part, s in (r.seconds or {}).items():
            seconds[part] = seconds.get(part, 0.0) + s
        t0 = time.perf_counter()
        s = score(r) if score is not None else r.best_fitness
        scoring += time.perf_counter() - t0
        if best is None or s < best_score:
            best, best_score = r, s
        if accept is None or best_score <= accept:
            break
    seconds["score"] = scoring
    return best._replace(generations_used=gens, attempts=attempt + 1, seconds=seconds)
