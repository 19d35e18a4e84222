"""B5: the whole run — G generations of B2 with exact comma selection,
best-ever tracking and the best-ever trajectory.

Replaces ``pmfm_tpu/kernels/evolve.py::fused_evolve`` (``_evolve_kernel``,
``_merge_topmu``). ``csrc/evolve.cu``'s ``pmfm_fused_evolve`` is a loop on the
host that enqueues, for each generation, B2's own kernels and then one
selection kernel (``select_kernel``, one block) on the stream, with no
synchronisation between generations; the file's note says what bounds it
and how the selection works. In int8 and bf16 its generations run B2's
kernel in the layout B2's wrapper takes at the same arguments
(``generation.takes_time_parallel``: ``time_parallel`` with B5's population
and runs; the one-warp kernel or the time-parallel one, bit-equal to each
other). ``fused_evolve_plain`` is its plain PyTorch
version: a loop of B2 (``fused_generation_plain``) with a stable (fitness,
index) selection.

Semantics, as the reference's: generation g's offspring are B2's for the
seed ``seeds[g]`` (``es.pipeline.kernel_seed(state.seed, state.generation +
g)``, so one B5 generation makes the offspring one B2 launch makes, bit for
bit); comma selection keeps the mu best of the whole offspring population in
the order (fitness, candidate index), NaN after +inf after every finite
value (what ``_merge_topmu``'s stable enumeration rank gives); best-ever
improves only on a strictly smaller fitness. The reference's finite 3e38
sentinel and one-hot extraction are Mosaic workarounds: survivors here keep
their fitness, inf and NaN included. No restarts, early stop or sharding.
B5 takes every topology B2 takes, ``fm{k}_parallel`` banks and the long
code above 32 genes included: its generations are B2's launches
(``check_supported_topology``), sharing one long scratch, which each
launch's synthesis rewrites from the start.

B5 takes B2's multi-frame mode (``num_frames``) and its run axis: parents
``(B, mu, D)``, best-ever ``(B, D)`` and ``(B,)``, targets ``(B, F, K)`` and
one seed list a run give each generation one B2 launch for all runs and one
selection block a run, so run r is bit-equal to a lone B5 call with its own
seeds.
"""
from __future__ import annotations

import collections
import ctypes
import math

import torch

from ..ops.wavetable import DEFAULT_SAMPLE_RATE, DEFAULT_WAVETABLE_SIZE
from .generation import (
    _check_b2,
    fused_generation_plain,
    layout_key,
    mutate_params_struct,
    seeds_tensor,
    takes_time_parallel,
)
from .synth_fitness import (
    DEFAULT_POP_BLOCK,
    MAX_SHARED_BYTES,
    alloc_scratch,
    check_supported_topology,
    f32_launch,
    f32_scratch_floats,
    inv_sample_rate,
    launch_mode,
    long_rows,
    long_scratch,
    operand_mode,
    runs_of,
    synth_params_struct,
)

SELECT_THREADS = 1024  # csrc SEL_THREADS: the selection's one block
EVOLVE_MODES = {"int8": 0, "f32": 1, "bf16": 2}  # csrc pmfm_fused_evolve's `mode`
SELECT_BINS = 256  # csrc SEL_BINS: a radix pass's histogram, one per warp


def select_geometry(pop: int, mu: int) -> dict:
    """The selection kernel's shared memory for ``pop`` offspring and ``mu``
    survivors (csrc ``select_smem_bytes``): the warps' histograms, the bin
    totals, the warps' counts, a broadcast and the survivors' (key, index)
    pairs and order, plus the keys of all ``pop`` candidates (padded to 16
    bytes) when they fit (``keys_in_shared``; else each pass streams them
    from L2). ``smem_bytes`` is what the launch asks for; above
    ``MAX_SHARED_BYTES`` (mu above ~16k) the kernel does not take the run."""
    warps = SELECT_THREADS // 32
    base = 4 * (warps * SELECT_BINS + SELECT_BINS + 2 * warps + 4 + 3 * mu)
    keys = 4 * (-(-pop // 4) * 4)
    in_shared = base + keys <= MAX_SHARED_BYTES
    return dict(keys_in_shared=in_shared, smem_bytes=base + keys if in_shared else base)


def stable_order(fitness: torch.Tensor) -> torch.Tensor:
    """Indices of ``fitness`` in the order (fitness, index), NaN last."""
    return torch.sort(fitness, stable=True).indices


def merge_topmu_plain(pool: torch.Tensor, block: torch.Tensor, mu: int) -> torch.Tensor:
    """Exact top-``mu`` of the union of ``pool`` and ``block``, the plain
    counterpart of the reference's ``_merge_topmu``: both are ``(R, *)``
    stacks ``[values(d); steps(d); fitness(1)]``, fitness in the last row.
    Returns ``(R, mu)`` best first, ties by column (pool before block)."""
    cat = torch.cat([pool, block], dim=1)
    return cat[:, stable_order(cat[-1])[:mu]]


def select_stable(values, steps, fitness, mu: int):
    """Comma selection of the ``mu`` best in the order (fitness, index)."""
    idx = stable_order(fitness)[:mu]
    return values[idx], steps[idx], fitness[idx]


def fused_evolve_plain(seeds, parent_values, parent_steps, best_values, best_fitness,
                       target_spectrum, *, generation=fused_generation_plain, **kw):
    """The plain PyTorch version of ``fused_evolve``: for each seed one
    generation of B2, a stable selection and the best-ever update.
    ``generation`` is B2's plain version; a check on the card passes the B2
    wrapper itself to hold the kernel against G B2 launches. With a run
    axis it is the lone version run by run, run r with ``seeds[r]``."""
    if runs_of(parent_values) is not None:
        outs = [fused_evolve_plain(sd, parent_values[r], parent_steps[r], best_values[r],
                                   best_fitness[r], target_spectrum[r], generation=generation,
                                   **kw)
                for r, sd in enumerate(seeds)]
        return tuple(torch.stack(x) for x in zip(*outs))
    mu = parent_values.shape[0]
    pv, ps = parent_values.to(torch.float32), parent_steps.to(torch.float32)
    bv, bf = best_values.to(torch.float32), best_fitness.to(torch.float32)
    traj = []
    for seed in seeds:
        fitness, values, steps = generation(seed, pv, ps, target_spectrum, **kw)
        pv, ps, pf = select_stable(values, steps, fitness, mu)
        improved = pf[0] < bf
        bv = torch.where(improved, pv[0], bv)
        bf = torch.where(improved, pf[0], bf)
        traj.append(bf)
    return pv, ps, pf, bv, bf, torch.stack(traj)


def fused_evolve(
    seeds,
    parent_values: torch.Tensor,
    parent_steps: torch.Tensor,
    best_values: torch.Tensor,
    best_fitness: torch.Tensor,
    target_spectrum: torch.Tensor,
    *,
    pop: int,
    param_mins: tuple,
    param_maxs: tuple,
    dft_packed: torch.Tensor,
    dft_scale: float,
    topology: str = "fm3_series",
    n: int = 1024,
    wavetable_size: int = DEFAULT_WAVETABLE_SIZE,
    sample_rate: int = DEFAULT_SAMPLE_RATE,
    pop_block: int = DEFAULT_POP_BLOCK,
    num_frames: int = 1,
    alpha: float = 1.4,
    beta: float = math.sqrt(1.0 / 6.0),
    beta_scale: float = 1.0 / 6.0,
    root_two_over_pi: float = math.sqrt(2.0 / math.pi),
    clamp_values: bool = False,
    min_step: float = 0.0,
    sine_order: int = 9,
    gens_per_step: int = 1,
):
    """Run ``len(seeds)`` generations, generation g with the int32 Philox
    seed ``seeds[g]``.

    Returns ``(parent_values (mu, D), parent_steps (mu, D), parent_fitness
    (mu,), best_values (D,), best_fitness (), trajectory (G,))``; the
    trajectory is best-ever per generation. With the run axis (parents
    ``(B, mu, D)``, best-ever ``(B, D)`` and ``(B,)``, targets ``(B, F, K)``
    or ``(B, K)``, ``seeds`` B lists of G seeds) every output gains the
    leading B and the trajectory is ``(B, G)``. ``gens_per_step`` is kept for
    the reference's interface and changes nothing. On CUDA tensors this is
    one call of the B5 launcher, which enqueues every generation's kernels
    (counted once in ``fused_evolve.launches``, by mode in
    ``fused_evolve.launches_by[launch_mode(...)]``; int8 and bf16, by B2's
    layout in ``fused_evolve.launches_by_layout`` (``layout_key`` of
    ``takes_time_parallel``'s pick, B2's wrapper's at the same arguments);
    true f32, by route and synthesis layout in
    ``fused_evolve.launches_by_f32``, B2's ``synth_fitness.f32_launch``); a
    time-parallel layout the kernel refuses raises. On CPU tensors it runs
    the plain version.
    """
    kw = dict(
        pop=pop, param_mins=param_mins, param_maxs=param_maxs, dft_packed=dft_packed,
        dft_scale=dft_scale, topology=topology, n=n, wavetable_size=wavetable_size,
        sample_rate=sample_rate, pop_block=pop_block, num_frames=num_frames, alpha=alpha,
        beta=beta, beta_scale=beta_scale, root_two_over_pi=root_two_over_pi,
        clamp_values=clamp_values, min_step=min_step, sine_order=sine_order,
    )
    runs = runs_of(parent_values)
    if runs is None:
        seeds = [int(s) for s in seeds]
        gens = len(seeds)
    else:
        seeds = [[int(s) for s in run] for run in seeds]
        gens = len(seeds[0]) if seeds else 0
        if len(seeds) != runs or any(len(run) != gens for run in seeds):
            raise ValueError(f"need {runs} seed lists of one length, one a run")
    mu, d = parent_values.shape[-2:]
    check_supported_topology(topology)
    if not gens:
        raise ValueError("fused_evolve needs at least one generation")
    if pop < mu:
        raise ValueError(f"population {pop} smaller than mu {mu}")
    dev = parent_values.device
    if dev.type == "cpu":
        return fused_evolve_plain(seeds, parent_values, parent_steps, best_values, best_fitness,
                                  target_spectrum, **kw)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    k = _check_b2(parent_values, parent_steps, target_spectrum, dft_packed, dft_scale, topology,
                  n, num_frames)
    if select_geometry(pop, mu)["smem_bytes"] > MAX_SHARED_BYTES:
        raise ValueError(f"mu={mu}: the selection's survivors exceed one block's shared memory")
    mode = operand_mode(dft_packed.dtype, dft_scale)
    f32 = mode == "f32"
    lead = parent_values.shape[:-2]
    if tuple(best_values.shape) != (*lead, d) or best_fitness.numel() != (runs or 1):
        raise ValueError(f"best_values must be {(*lead, d)} and best_fitness one value a run")
    from ._build import check, library

    f = dict(dtype=torch.float32, device=dev)
    nruns = runs or 1
    pv = parent_values.to(torch.float32).contiguous().clone()
    ps = parent_steps.to(torch.float32).contiguous().clone()
    pf = torch.empty((*lead, mu), **f)
    bv = best_values.to(torch.float32).contiguous().clone()
    bf = best_fitness.to(torch.float32).reshape(nruns).clone()
    traj = torch.empty((*lead, gens), **f)
    fit_s = torch.empty((*lead, pop), **f)
    val_s = torch.empty((*lead, pop, d), **f)
    step_s = torch.empty((*lead, pop, d), **f)
    scratch = alloc_scratch(f32_scratch_floats(pop, n, num_frames, nruns) if f32 else 0, dev,
                            "the f32 scratch")
    if runs is None:
        seeds_h = (ctypes.c_uint32 * gens)(*(s & 0xFFFFFFFF for s in seeds))
        seeds_d = None
    else:  # (G, B): generation g's seeds of every run, in device memory
        seeds_h = None
        seeds_d = seeds_tensor([seeds[r][g] for g in range(gens) for r in range(runs)], dev)
    sp = synth_params_struct(
        topology=topology, n=n, k=k, d=d, inv_sr=inv_sample_rate(wavetable_size, sample_rate),
        dft_scale=dft_scale, sine_order=sine_order, frames=num_frames,
    )
    mp = mutate_params_struct(mu, param_mins, param_maxs, alpha, beta, beta_scale,
                              root_two_over_pi, clamp_values, min_step, dev)
    lscratch = long_scratch(sp, topology, long_rows(pop, nruns), dev)  # noqa: F841 (kept)
    if f32:
        f32_keys = f32_launch(sp, topology, pop, nruns, dev)
    tp = takes_time_parallel(pv, **kw)
    err = library().pmfm_fused_evolve(
        seeds_h, None if seeds_d is None else seeds_d.data_ptr(), gens, pop, nruns, sp, mp,
        dft_packed.data_ptr(), target_spectrum.data_ptr(), pv.data_ptr(), ps.data_ptr(),
        pf.data_ptr(), bv.data_ptr(), bf.data_ptr(), traj.data_ptr(), fit_s.data_ptr(),
        val_s.data_ptr(), step_s.data_ptr(), scratch.data_ptr(), scratch.numel(),
        EVOLVE_MODES[mode], int(tp), torch.cuda.current_stream(dev).cuda_stream,
    )
    check(err, "fused_evolve" + (" (time-parallel layout)" if tp else ""))
    fused_evolve.launches += 1
    fused_evolve.launches_by[
        launch_mode(topology, dft_scale, num_frames, runs, dft_packed.dtype)] += 1
    if f32:
        fused_evolve.launches_by_f32.update(f32_keys)
    else:
        fused_evolve.launches_by_layout[layout_key(mode, tp)] += 1
    return pv, ps, pf, bv, (bf[0] if runs is None else bf), traj


fused_evolve.launches = 0
fused_evolve.launches_by = collections.Counter()
fused_evolve.launches_by_layout = collections.Counter()
fused_evolve.launches_by_f32 = collections.Counter()
