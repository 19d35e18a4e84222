"""B2: one whole generation in one kernel — offspring + synthesis + folded
DFT + fitness, in B1's int8 or true-f32 mode.

Replaces ``pmfm_tpu/kernels/generation.py::fused_generation`` (``_gen_kernel``
over ``_offspring_block``, ``_recombine_flat``/``_recombine_hier``,
``_uniform01`` and ``_scale_rows``, then B1's ``_evaluate_block``). The CUDA
kernels are ``csrc/fused_eval.cu::fused_generation_int8_kernel`` and, in the
true-f32 mode, ``csrc/fused_f32.cu``'s (the synthesis kernel with the
prologue, then B1's f32 DFT and group sum); each runs the offspring prologue
below (``csrc/evaluate.cuh::offspring_gene``, the block's genes spread over
all its threads) and then B1's evaluation in the mode the operand selects.
``fused_generation_plain`` is its plain PyTorch version. It takes every
topology B1 takes, ``fm{k}_parallel`` (D = 8 .. 16) included: the prologue
spreads the block's candidates x D genes over its threads whatever D is,
and the launch geometry does not depend on D.

Offspring semantics (``_offspring_block``): per gene a uniform parent index
and an exact copy of that parent's value and step; an Ek coin; a CLT-12
gaussian (mean of 12 U(-1, 1), sigma 1/6); ``x' = x + Ek*s*g`` with one retry
at ``g := -0.5 g`` when x' leaves [0, 1]; ``s' = s * Ek^beta * Es^betaScale``
with ``Es = exp(|g| - rootTwoOverPi)``; the ``min_step`` floor and the
optional clamp. The TPU kernel's one-hot gathers and its transposed (VR, P)
output layout do not carry over: offspring come out as (P, D).

Random bits. The TPU's hardware PRNG cannot be reproduced. Both the CUDA
kernel and ``philox4x32`` below use Philox4x32-10 with key ``(seed, 0)`` —
``seed`` from ``es.pipeline.kernel_seed`` — and counter ``(candidate,
dimension, call, 0)``; calls 0..3 give 16 words per gene: the parent index
``(w0 & 0x7FFFFFFF) % mu``, the coin ``w1 & 1`` and 12 uniforms
``(w >> 8) * 2^-24``. So on the card the kernel and its plain version make
the same offspring bits. The plain version also takes injected draws
(``draws=``) so tests can feed it the bits a reference run used.

The run axis: a batched launch (parents ``(B, mu, D)``) gives run r its own
key ``(seed_r, 0)`` with the counter of its own candidate index, so run r
draws what a lone launch with ``seed_r`` draws and no run's counters alias
another run's under a different key; two runs draw alike only if their seeds
are equal (``es.pipeline`` seeds run r from ``_chunk_seed(seed, r)``).
"""
from __future__ import annotations

import collections
import math

import numpy as np
import torch

from ..ops.synthesis import topology_dims
from ..ops.wavetable import DEFAULT_SAMPLE_RATE, DEFAULT_WAVETABLE_SIZE
from .synth_fitness import (
    DEFAULT_POP_BLOCK,
    _evaluate_plain,
    check_kernel_shapes,
    check_supported,
    f32_scratch_floats,
    inv_sample_rate,
    launch_mode,
    runs_of,
    synth_params_struct,
)

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
CLT_TERMS = 12


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of ``m * x`` for a 32-bit constant ``m`` and
    32-bit values ``x`` held in int64, by 16-bit limbs (no int64 overflow)."""
    m1, m0 = m >> 16, m & 0xFFFF
    x1, x0 = x >> 16, x & 0xFFFF
    p00, p01, p10, p11 = x0 * m0, x0 * m1, x1 * m0, x1 * m1
    mid = (p00 >> 16) + (p01 & 0xFFFF) + (p10 & 0xFFFF)
    lo = ((mid & 0xFFFF) << 16) | (p00 & 0xFFFF)
    hi = p11 + (p01 >> 16) + (p10 >> 16) + (mid >> 16)
    return hi, lo


def philox4x32(c0, c1, c2, c3, key: int):
    """Philox4x32-10 of int64 tensors holding 32-bit counter words, key
    ``(key, 0)``; returns the four 32-bit output words as int64 tensors."""
    k0, k1 = key & _MASK32, 0
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def philox_draws(seed: int, pop: int, d: int, device) -> tuple:
    """The kernel's draws for a whole population: parent-index bits and coin
    bits (P, D) int64, and 12 uniform words (12, P, D) int64."""
    cand = torch.arange(pop, dtype=torch.int64, device=device)[:, None].expand(pop, d)
    dim = torch.arange(d, dtype=torch.int64, device=device)[None, :].expand(pop, d)
    zero = torch.zeros_like(cand)
    words = []
    for call in range(4):
        words.extend(philox4x32(cand, dim, zero + call, zero, seed))
    return words[0], words[1], torch.stack(words[2:2 + CLT_TERMS])


def uniform01(bits: torch.Tensor) -> torch.Tensor:
    """U[0, 1) from 32-bit words: the top 24 bits times 2^-24 (exact)."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def step_factors(alpha: float, beta: float):
    """float32 ``alpha^beta`` and ``(1/alpha)^beta``, computed once on the host
    and shared by the kernel and its plain version."""
    ek = torch.tensor([alpha, 1.0 / alpha], dtype=torch.float32)
    ekb = ek ** float(np.float32(beta))
    return float(ekb[0]), float(ekb[1])


def offspring_plain(parent_values, parent_steps, *, pop, seed=None, draws=None, alpha,
                    beta, beta_scale, root_two_over_pi, clamp_values, min_step):
    """Offspring values and steps (P, D) from parents (mu, D).

    ``draws`` = ``(index_bits (P, D), coin_bits (P, D), uniforms (12, P, D))``
    replaces the Philox draws of ``seed``: index bits are reduced modulo mu,
    coin bits masked to their lowest bit, uniforms are U[0, 1) floats.
    """
    mu, d = parent_values.shape
    dev = parent_values.device
    if draws is None:
        ib, cb, uw = philox_draws(seed, pop, d, dev)
        u = uniform01(uw)
    else:
        ib, cb, u = (torch.as_tensor(a, device=dev) for a in draws)
        u = u.to(torch.float32)
    idx = (ib.to(torch.int64) & 0x7FFFFFFF) % mu
    coin = (cb.to(torch.int64) & 1) != 0
    col = torch.arange(d, device=dev)[None, :]
    x = parent_values[idx, col]
    s = parent_steps[idx, col]
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    ek = torch.where(coin, f32(1.0 / alpha), f32(alpha))
    ekb_a, ekb_i = step_factors(alpha, beta)
    ekb = torch.where(coin, ekb_i, ekb_a)
    g = torch.zeros_like(x)
    for j in range(CLT_TERMS):
        g = g + (u[j] * 2.0 - 1.0)
    g = g * f32(1.0 / 12.0)
    new_x = x + ek * s * g
    out = (new_x < 0.0) | (new_x > 1.0)
    g = torch.where(out, g * -0.5, g)
    new_x = torch.where(out, x + ek * s * g, new_x)
    if clamp_values:
        new_x = torch.clamp(new_x, 0.0, 1.0)
    es = torch.exp(torch.abs(g) - f32(root_two_over_pi))
    new_s = s * ekb * es ** f32(beta_scale)
    if min_step > 0.0:
        new_s = torch.clamp_min(new_s, f32(min_step))
    return new_x, new_s


def scale_rows(new_x: torch.Tensor, mins: tuple, maxs: tuple) -> torch.Tensor:
    """Normalised genes -> scaled params with per-dimension float32 constants
    ``mins[d]`` and ``maxs[d] - mins[d]`` (formed in float64, then rounded)."""
    lo = torch.tensor([float(m) for m in mins], dtype=torch.float32, device=new_x.device)
    span = torch.tensor(
        [float(b) - float(a) for a, b in zip(mins, maxs)], dtype=torch.float32, device=new_x.device
    )
    return lo + new_x * span


def mutate_params_struct(mu, param_mins, param_maxs, alpha, beta, beta_scale, root_two_over_pi,
                         clamp_values, min_step):
    """The kernels' ``MutateParams`` argument (B2 and B5)."""
    from ._build import MutateParams

    d = len(param_mins)
    mp = MutateParams()
    mp.mu, mp.clamp = mu, int(clamp_values)
    mp.alpha, mp.inv_alpha = alpha, 1.0 / alpha
    mp.ekb_alpha, mp.ekb_inv_alpha = step_factors(alpha, beta)
    mp.beta_scale, mp.root_two_over_pi, mp.min_step = beta_scale, root_two_over_pi, min_step
    mp.mins[:d] = [float(m) for m in param_mins]
    mp.ranges[:d] = [float(b) - float(a) for a, b in zip(param_mins, param_maxs)]
    return mp


def _check_b2(parent_values, parent_steps, target_spectrum, dft_packed, dft_scale, topology, n,
              num_frames):
    check_supported(topology, dft_packed, dft_scale, num_frames)
    runs = runs_of(parent_values)
    mu, d = parent_values.shape[-2:]
    if d != topology_dims(topology) or parent_steps.shape != parent_values.shape:
        lead = "" if runs is None else "B, "
        raise ValueError(f"{topology} needs parents of shape ({lead}mu, {topology_dims(topology)})")
    k = dft_packed.shape[0] // 2
    check_kernel_shapes(n, k, dft_packed, target_spectrum, num_frames, runs)
    for t in (parent_steps, dft_packed, target_spectrum):
        if t.device != parent_values.device:
            raise ValueError(f"operands must be on {parent_values.device}, got {t.device}")
    return k


def run_seeds(seed, runs):
    """The per-run Philox seeds of a B2/B5 launch: ``seed`` itself for one
    run (``runs`` None), else a sequence of ``runs`` int32 seeds (run r's)."""
    if runs is None:
        return int(seed)
    seeds = [int(x) for x in seed]
    if len(seeds) != runs:
        raise ValueError(f"need one seed per run: {runs} runs, {len(seeds)} seeds")
    return seeds


def seeds_tensor(seeds, device) -> torch.Tensor:
    """int32 seeds as their uint32 bits in an int32 tensor on ``device``: the
    kernels' ``run_seeds`` (device memory)."""
    words = np.asarray([s & 0xFFFFFFFF for s in seeds], np.uint32).view(np.int32)
    return torch.from_numpy(words.copy()).to(device)


def fused_generation_plain(
    seed: int,
    parent_values: torch.Tensor,
    parent_steps: torch.Tensor,
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
    draws=None,
):
    """The plain PyTorch version of ``fused_generation``, on any device; it
    alone accepts injected ``draws`` (see ``offspring_plain``), for one run.
    With a run axis it is the lone version run by run, run r with seed
    ``seed[r]``."""
    _check_b2(parent_values, parent_steps, target_spectrum, dft_packed, dft_scale, topology, n,
              num_frames)
    runs = runs_of(parent_values)
    if runs is not None:
        if draws is not None:
            raise ValueError("injected draws are an input of a lone run only")
        kw = dict(pop=pop, param_mins=param_mins, param_maxs=param_maxs, dft_packed=dft_packed,
                  dft_scale=dft_scale, topology=topology, n=n, wavetable_size=wavetable_size,
                  sample_rate=sample_rate, pop_block=pop_block, num_frames=num_frames,
                  alpha=alpha, beta=beta, beta_scale=beta_scale,
                  root_two_over_pi=root_two_over_pi, clamp_values=clamp_values,
                  min_step=min_step, sine_order=sine_order)
        outs = [fused_generation_plain(sd, parent_values[r], parent_steps[r], target_spectrum[r],
                                       **kw)
                for r, sd in enumerate(run_seeds(seed, runs))]
        return tuple(torch.stack(x) for x in zip(*outs))
    new_x, new_s = offspring_plain(
        parent_values.to(torch.float32), parent_steps.to(torch.float32), pop=pop, seed=seed,
        draws=draws, alpha=alpha, beta=beta, beta_scale=beta_scale,
        root_two_over_pi=root_two_over_pi, clamp_values=clamp_values, min_step=min_step,
    )
    fitness = _evaluate_plain(
        scale_rows(new_x, param_mins, param_maxs), dft_packed, target_spectrum,
        topology=topology, n=n, inv_sr=inv_sample_rate(wavetable_size, sample_rate),
        dft_scale=dft_scale, sine_order=sine_order, pop_block=pop_block, num_frames=num_frames,
    )
    return fitness, new_x, new_s


def fused_generation(
    seed: int,
    parent_values: torch.Tensor,
    parent_steps: torch.Tensor,
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
    draws=None,
):
    """One generation's offspring and fitness.

    Returns ``(fitness (P,), values (P, D), steps (P, D))``. ``seed`` is the
    int32 from ``es.pipeline.kernel_seed``. ``target_spectrum`` is (K,), or
    (F, K) with ``num_frames`` = F. With the run axis, parents ``(B, mu,
    D)``, targets ``(B, F, K)`` (or ``(B, K)`` at one frame) and ``seed`` a
    sequence of B seeds give ``(B, P)``, ``(B, P, D)``, ``(B, P, D)``: run r
    is what a lone launch with ``seed[r]`` makes, bit for bit. On CUDA
    tensors this launches the B2 kernel once for all runs (counted in
    ``fused_generation.launches``, and by mode in
    ``fused_generation.launches_by[launch_mode(...)]``); on CPU tensors it
    runs the plain version, which alone accepts injected ``draws``.
    """
    kw = dict(
        pop=pop, param_mins=param_mins, param_maxs=param_maxs, dft_packed=dft_packed,
        dft_scale=dft_scale, topology=topology, n=n, wavetable_size=wavetable_size,
        sample_rate=sample_rate, pop_block=pop_block, num_frames=num_frames, alpha=alpha,
        beta=beta, beta_scale=beta_scale, root_two_over_pi=root_two_over_pi,
        clamp_values=clamp_values, min_step=min_step, sine_order=sine_order,
    )
    dev = parent_values.device
    if dev.type == "cpu":
        return fused_generation_plain(seed, parent_values, parent_steps, target_spectrum,
                                      draws=draws, **kw)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if draws is not None:
        raise ValueError("injected draws are an input of the plain version only")
    k = _check_b2(parent_values, parent_steps, target_spectrum, dft_packed, dft_scale, topology,
                  n, num_frames)
    from ._build import check, library

    runs = runs_of(parent_values)
    seeds = run_seeds(seed, runs)
    pv = parent_values.to(torch.float32).contiguous()
    ps = parent_steps.to(torch.float32).contiguous()
    mu, d = pv.shape[-2:]
    lead = pv.shape[:-2]
    sp = synth_params_struct(
        topology=topology, n=n, k=k, d=d, inv_sr=inv_sample_rate(wavetable_size, sample_rate),
        dft_scale=dft_scale, sine_order=sine_order, frames=num_frames,
    )
    mp = mutate_params_struct(mu, param_mins, param_maxs, alpha, beta, beta_scale,
                              root_two_over_pi, clamp_values, min_step)
    fitness = torch.empty((*lead, pop), dtype=torch.float32, device=dev)
    values = torch.empty((*lead, pop, d), dtype=torch.float32, device=dev)
    steps = torch.empty((*lead, pop, d), dtype=torch.float32, device=dev)
    rs = None if runs is None else seeds_tensor(seeds, dev)
    nruns = runs or 1
    args = (0 if runs else seeds & 0xFFFFFFFF, None if rs is None else rs.data_ptr(),
            pv.data_ptr(), ps.data_ptr(), pop, nruns, sp, mp, dft_packed.data_ptr(),
            target_spectrum.data_ptr(), fitness.data_ptr(), values.data_ptr(), steps.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dft_scale == 0.0:
        scratch = torch.empty((f32_scratch_floats(pop, n, num_frames, nruns),),
                              dtype=torch.float32, device=dev)
        err = library().pmfm_fused_generation_f32(*args, scratch.data_ptr(), scratch.numel(),
                                                  stream)
    else:
        err = library().pmfm_fused_generation(*args, stream)
    check(err, "fused_generation")
    fused_generation.launches += 1
    fused_generation.launches_by[launch_mode(topology, dft_scale, num_frames, runs)] += 1
    return fitness, values, steps


fused_generation.launches = 0
fused_generation.launches_by = collections.Counter()
