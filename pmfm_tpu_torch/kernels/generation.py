"""B2: one whole generation in one kernel — offspring + synthesis + folded
DFT + fitness, in B1's int8, bf16 or true-f32 mode.

Replaces ``pmfm_tpu/kernels/generation.py::fused_generation`` (``_gen_kernel``
over ``_offspring_block``, ``_recombine_flat``/``_recombine_hier``,
``_uniform01`` and ``_scale_rows``, then B1's ``_evaluate_block``). The CUDA
kernels are ``csrc/fused_eval.cu::fused_generation_int8_kernel``, in the
bf16 mode ``csrc/fused_bf16.cu::fused_generation_bf16_kernel`` (both
``csrc/tc_eval.cuh``'s one-warp kernel), for int8 and bf16 on a fixed
chain or a fixed bank of 2-5 pairs, where ``time_parallel`` picks it,
``csrc/fused_tp.cuh::fused_generation_int8_tp_kernel`` and
``csrc/fused_tp_bf16.cuh::fused_generation_bf16_tp_kernel`` (the
time-parallel layouts, bit-equal to the one-warp kernel)
and, in the true-f32 mode, ``csrc/fused_f32.cu``'s (the synthesis kernel
with the prologue, one thread a candidate or ``csrc/fused_f32_tp.cu``'s
time-parallel one, then B1's f32 FFT or DFT, ``synth_fitness.f32_route``,
and the sum over frames or groups); each runs the offspring prologue
below (``csrc/evaluate.cuh::offspring_gene``, the block's genes spread over
all its threads) and then B1's evaluation in the mode the operand selects.
``fused_generation_plain`` is its plain PyTorch version. It takes every
topology B1 takes, at any D: the prologue spreads the block's candidates x
D genes over its threads whatever D is, the launch geometry does not depend
on D, and the per-gene ``mins`` and ``ranges`` reach the kernels as device
arrays (``scale_tensor``).

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
import functools
import math

import numpy as np
import torch

from ..ops.synthesis import parallel_pairs, topology_dims
from ..ops.wavetable import DEFAULT_SAMPLE_RATE, DEFAULT_WAVETABLE_SIZE
from .synth_fitness import (
    CUDA_BLOCK,
    DEFAULT_POP_BLOCK,
    MAX_SHARED_BYTES,
    SMS,
    TIME_BLOCK,
    _evaluate_plain,
    alloc_scratch,
    chain_length,
    check_kernel_shapes,
    check_supported,
    f32_launch,
    f32_scratch_floats,
    inv_sample_rate,
    launch_mode,
    long_rows,
    long_scratch,
    operand_mode,
    runs_of,
    shared_bytes_tp,
    shared_bytes_tp_bf16,
    synth_params_struct,
    uses_long_code,
)

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
CLT_TERMS = 12

# The fixed codes that B2 int8 and bf16 can run in their time-parallel
# layouts (csrc/fused_tp.cuh, csrc/fused_tp_bf16.cuh): the chains fm2,
# fm3_series .. fm8_series (codes 2 .. 8) and the banks of 2-5 pairs
# (BANK_KN + 2 .. + 5), at any frame count and on the run axis.
TP_CHAINS = frozenset(["fm2"] + [f"fm{k}_series" for k in range(3, 9)])
TP_BANKS = frozenset(f"fm{k}_parallel" for k in range(2, 6))
# tp_faster's constants, from both layouts' times on an NVIDIA H100 80GB
# HBM3 (PERF.md §6; tools/torch_b2_layout_probe.py's sweep in int8,
# tools/torch_bf16_probe.py's in bf16)
SM_SHARED_BYTES = 233472  # shared memory an SM holds (1 KB of it reserved a block)
ONE_WARP_REG_BLOCKS = 8  # one-warp blocks an SM its ~255 registers a thread allow
TP_MAX_WARPS = 8  # csrc fused_tp.cuh: warps a time-parallel block
TP_K = 4.0  # the levels' sines times the one-warp layout's warps an SM, at most
TP_MAX_WAVES = 8  # one-warp waves past which the one-warp layout keeps the card busy
TP_BF16_K = 2.47  # bf16: the levels' share x (one-warp warps an SM)^2 / (time-parallel / 16)^1.5
TP_BF16_DFT_SINES = 32.0  # bf16: the DFT's work a sample at n 1024, in synthesis sines
TP_BF16_BANK = 0.7  # bf16: a bank's level (a sine a pair) weighed against a chain's sines
TP_BF16_MIN_WARPS = 2.0  # bf16: below this many one-warp warps an SM, time-parallel
ELEMENT_BYTES = {"int8": 1, "bf16": 2}  # a one-warp block's a+/-: 32 n elements


def tp_takes(n: int, k: int, d: int, topology: str, mode: str, frames: int = 1) -> bool:
    """Whether a time-parallel kernel takes the shape: int8 or bf16
    (``operand_mode``), a fixed chain or bank not on the long code, n a
    multiple of 256 (two time blocks, two warps at least) and a block's
    shared memory (``shared_bytes_tp``, ``shared_bytes_tp_bf16``) within
    ``MAX_SHARED_BYTES``."""
    if mode not in ELEMENT_BYTES:
        return False
    smem = (shared_bytes_tp(n, k, d, frames) if mode == "int8"
            else shared_bytes_tp_bf16(n, d, topology, frames))
    return ((topology in TP_CHAINS or topology in TP_BANKS) and n % (2 * TIME_BLOCK) == 0
            and not uses_long_code(topology) and smem <= MAX_SHARED_BYTES)


def tp_faster(n: int, topology: str, pop: int = CUDA_BLOCK, runs: int = 1,
              mode: str = "int8") -> bool:
    """The rule by which B1/B2 take a time-parallel layout where its kernel
    takes the shape, from both layouts' times on an H100 (PERF.md §6, the
    sweeps of tools/torch_b2_layout_probe.py and tools/torch_bf16_probe.py).
    The one-warp layout loses by its few warps an SM: a grid of
    ceil(pop / 32) x runs one-warp blocks gives each SM ``warps`` =
    blocks / SMS of them, at most as many as an SM holds at n (its shared
    memory, 32 n elements a block: int8 or bf16, and its registers). The
    time-parallel one pays its levels: ``extra`` sines a sample for each of
    the synthesis' (a chain of KN: (KN - 1) / 2; a bank: 1 / 2).

    int8: it wins where ``extra`` x ``warps`` < TP_K x (its warps a block
    / 8; at n < 1024 it has only n / 128), and while the one-warp grid is at
    most TP_MAX_WAVES waves of the card (beyond, the one-warp tail is small
    and its warps keep the SMs busy). The frame count does not enter: at F 8
    the card ranked the int8 layouts as at F 1 at every shape measured.

    bf16 (two one-warp blocks an SM at n 1024, one at 2048): ``warps`` is
    averaged over the one-warp grid's waves (a last wave part full idles
    SMs), and the levels' sines (a bank's weighed by TP_BF16_BANK) are
    weighed against a sample's whole work, the synthesis' sines and the
    DFT's (TP_BF16_DFT_SINES x n / 1024 sines' worth): their ``share``. It
    wins where the one-warp grid holds fewer than TP_BF16_MIN_WARPS warps an
    SM, or where ``share`` x ``warps`` ^ 2 < TP_BF16_K x (its own warps an SM
    / 16) ^ 1.5, those warps being its block's (min(n / 128, 8)) times the
    blocks its shared memory lets an SM hold (16 at n 512 and 1024, 12 at n
    768, 8 at n 2048): at every swept shape at n 2048 and every shape of the
    reference suite; the one-warp layout keeps synthesis-heavy shapes on
    full grids (fm6-8_series at n 1024; at n 512 fm3_series, fm3_parallel
    and longer; at n 768 fm3_series and longer chains). Its misses at the
    sweep's 308 shapes: fm7_series at P 8192, n 512 and 768, where the
    one-warp layout is faster though fm6 and fm8_series there are not."""
    blocks = -(-pop // CUDA_BLOCK) * runs
    cap = min(ONE_WARP_REG_BLOCKS,
              SM_SHARED_BYTES // (CUDA_BLOCK * n * ELEMENT_BYTES[mode] + 1024))
    warps = min(blocks / SMS, cap)
    extra = 0.5 if parallel_pairs(topology) else (chain_length(topology) - 1) / 2
    if mode == "bf16":
        waves = blocks / (SMS * cap)
        if waves > 1:
            warps *= waves / math.ceil(waves)
        pairs = parallel_pairs(topology)
        sines = 2 * pairs if pairs else chain_length(topology)
        share = (extra * sines * (TP_BF16_BANK if pairs else 1.0)
                 / (sines + TP_BF16_DFT_SINES * n / 1024))
        tp_blocks = SM_SHARED_BYTES // (shared_bytes_tp_bf16(n, topology_dims(topology), topology)
                                        + 1024)
        tp_sm = min(n // TIME_BLOCK, TP_MAX_WARPS) * tp_blocks / 16
        return (warps < TP_BF16_MIN_WARPS
                or share * warps ** 2 < TP_BF16_K * tp_sm ** 1.5)
    tp_warps = min(n // TIME_BLOCK, TP_MAX_WARPS)
    return extra * warps < TP_K * tp_warps / TP_MAX_WARPS and blocks <= TP_MAX_WAVES * SMS * cap


def time_parallel(n: int, k: int, d: int, topology: str, mode: str, frames: int = 1,
                  pop: int = CUDA_BLOCK, runs: int = 1) -> bool:
    """Whether B1/B2 take their time-parallel layout (32 candidates a block
    on min(n / 128, 8) warps) in ``mode`` (``operand_mode``: int8 or bf16)
    for ``topology`` at ``frames`` frames of ``n`` samples, ``k`` bins,
    ``d`` genes, ``pop`` candidates (one block by default) and ``runs``
    runs: where the kernel takes the shape (``tp_takes``) and the card's
    rule says it is the faster (``tp_faster``). Else the one-warp layout
    (int8 and bf16; true f32 runs ``f32_geometry``'s kernels instead)."""
    return (tp_takes(n, k, d, topology, mode, frames)
            and tp_faster(n, topology, pop, runs, mode))


def layout_key(mode: str, tp: bool) -> str:
    """The key a B1/B2 int8 or bf16 launch in the time-parallel layout
    (``tp``) or the one-warp one is counted under in the wrappers'
    ``launches_by_layout``: int8 ``"time_parallel"`` or ``"one_warp"``, bf16
    ``"bf16_time_parallel"`` or ``"bf16_one_warp"``."""
    return ("bf16_" if mode == "bf16" else "") + ("time_parallel" if tp else "one_warp")


def takes_time_parallel(parent_values: torch.Tensor, *, dft_packed: torch.Tensor,
                        dft_scale: float, pop: int, topology: str = "fm3_series", n: int = 1024,
                        num_frames: int = 1, **_) -> bool:
    """Whether a B2 or B5 call with these arguments (the wrappers' own:
    parents ``(mu, D)`` or ``(B, mu, D)`` and their keyword arguments) runs
    B2's kernel in the time-parallel layout on the card: ``time_parallel``
    at the operand's mode and bins, the parents' genes, ``pop`` and the
    runs. False in true f32, whose layouts ``f32_launch`` names."""
    mode = operand_mode(dft_packed.dtype, dft_scale)
    return time_parallel(n, dft_packed.shape[0] // 2, parent_values.shape[-1], topology, mode,
                         num_frames, pop, runs_of(parent_values) or 1)


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


@functools.lru_cache(maxsize=64)
def scale_tensor(param_mins: tuple, param_maxs: tuple, device: str) -> torch.Tensor:
    """(2, D) float32 on ``device``: the per-gene ``mins`` and ``maxs -
    mins`` (formed in float64, then rounded, as ``scale_rows``) that the
    kernels' offspring prologue scales by. Cached, so a run of launches
    copies them once and the cache keeps them alive for the launches."""
    span = [float(b) - float(a) for a, b in zip(param_mins, param_maxs)]
    return torch.tensor([[float(m) for m in param_mins], span], dtype=torch.float32,
                        device=device)


def mutate_params_struct(mu, param_mins, param_maxs, alpha, beta, beta_scale, root_two_over_pi,
                         clamp_values, min_step, device):
    """The kernels' ``MutateParams`` argument (B2 and B5), its ``mins`` and
    ``ranges`` pointing at ``scale_tensor``'s rows on ``device``."""
    from ._build import MutateParams

    mp = MutateParams()
    mp.mu, mp.clamp = mu, int(clamp_values)
    mp.alpha, mp.inv_alpha = alpha, 1.0 / alpha
    mp.ekb_alpha, mp.ekb_inv_alpha = step_factors(alpha, beta)
    mp.beta_scale, mp.root_two_over_pi, mp.min_step = beta_scale, root_two_over_pi, min_step
    scale = scale_tensor(tuple(map(float, param_mins)), tuple(map(float, param_maxs)),
                         str(torch.device(device)))
    mp.mins, mp.ranges = scale[0].data_ptr(), scale[1].data_ptr()
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
    check_kernel_shapes(n, k, dft_packed, target_spectrum, num_frames, runs, d)
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
    ``fused_generation.launches``, by mode in
    ``fused_generation.launches_by[launch_mode(...)]`` and, int8 and bf16,
    by layout in ``fused_generation.launches_by_layout`` (``layout_key`` of
    ``takes_time_parallel``'s pick); true f32, by
    route and synthesis layout in ``fused_generation.launches_by_f32``,
    ``synth_fitness.f32_launch``); on CPU tensors
    it runs the plain version whatever the layout, and alone accepts
    injected ``draws``.
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
                              root_two_over_pi, clamp_values, min_step, dev)
    fitness = torch.empty((*lead, pop), dtype=torch.float32, device=dev)
    values = torch.empty((*lead, pop, d), dtype=torch.float32, device=dev)
    steps = torch.empty((*lead, pop, d), dtype=torch.float32, device=dev)
    rs = None if runs is None else seeds_tensor(seeds, dev)
    nruns = runs or 1
    lscratch = long_scratch(sp, topology, long_rows(pop, nruns), dev)  # noqa: F841 (kept)
    args = (0 if runs else seeds & 0xFFFFFFFF, None if rs is None else rs.data_ptr(),
            pv.data_ptr(), ps.data_ptr(), pop, nruns, sp, mp, dft_packed.data_ptr(),
            target_spectrum.data_ptr(), fitness.data_ptr(), values.data_ptr(), steps.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    mode = operand_mode(dft_packed.dtype, dft_scale)
    tp = takes_time_parallel(pv, **kw)
    if mode == "f32":
        f32_keys = f32_launch(sp, topology, pop, nruns, dev)
        scratch = alloc_scratch(f32_scratch_floats(pop, n, num_frames, nruns), dev,
                                "the f32 scratch")
        err = library().pmfm_fused_generation_f32(*args, scratch.data_ptr(), scratch.numel(),
                                                  stream)
    elif mode == "bf16" and tp:
        err = library().pmfm_fused_generation_bf16_tp(*args, stream)
    elif mode == "bf16":
        err = library().pmfm_fused_generation_bf16(*args, stream)
    elif tp:
        err = library().pmfm_fused_generation_tp(*args, stream)
    else:
        err = library().pmfm_fused_generation(*args, stream)
    check(err, "fused_generation" + (" (time-parallel layout)" if tp else ""))
    fused_generation.launches += 1
    if mode == "f32":
        fused_generation.launches_by_f32.update(f32_keys)
    else:
        fused_generation.launches_by_layout[layout_key(mode, tp)] += 1
    fused_generation.launches_by[
        launch_mode(topology, dft_scale, num_frames, runs, dft_packed.dtype)] += 1
    return fitness, values, steps


fused_generation.launches = 0
fused_generation.launches_by = collections.Counter()
fused_generation.launches_by_layout = collections.Counter()
fused_generation.launches_by_f32 = collections.Counter()
