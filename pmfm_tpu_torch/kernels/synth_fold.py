"""B3: fused FM synthesis + window fold, emit only (the synth_fold route,
4096 <= n <= 16384).

Replaces ``pmfm_tpu/kernels/synth_fold.py::fused_synth_fold`` (the Pallas
kernel ``_fold_kernel`` over ``synth_fitness._evaluate_block`` in emit-only
mode and ``_synth_emit_looped``). The CUDA kernels are in
``csrc/large_frame.cu``, whose note gives their bound on an H100 and their
design: below ``FOLD_TP_BELOW_POP`` candidates (by chain length and mode)
``synth_fold_tp_kernel``, a warp a candidate with time split across its
lanes (phase offsets found exactly level by level) and the frame folded
from shared memory; from there up ``synth_fold_kernel``, a thread a
candidate (``fold_geometry`` mirrors the choice). ``fused_synth_fold_plain`` here is their plain PyTorch version,
which the wrapper runs for CPU tensors.

Outputs, as the reference's: ``a_plus``, ``a_minus`` (N/2, P) with
``a+/-[r] = q[r] +- q[N-r]`` and ``a+/-[0] = q[0]``; ``edge`` (P,) f32, the
sample ``q[N/2]``; ``mag_scale`` (P,) f32. The a's are stored candidate-major:
each is the ``.T`` view of a contiguous (P, N/2) tensor, the layout in which
the int8 DFT that follows runs on the tensor cores (``csrc/large_frame.cu``'s
note has the measurement). With ``dft_scale > 0`` (the int8
engine) ``q = round(63 * sin)`` is int8, the a's are int8 (|a| <= 126) and
``mag_scale = |amp| * dft_scale``. Otherwise ``q`` is the bf16-rounded audio
``sin * amp``, the fold sum is rounded to bf16 once more (the reference's
``fold_cast``) and ``mag_scale`` is 1. The spectrum is
``ops.spectral.magnitude_spectrum_prefolded``.

Every topology B1/B2 take (``check_supported_topology``): an
``fm{k}_parallel`` bank emits what B1/B2's bank emits, int8 ``round(sum_j
gain_j sin_j)`` with ``mag_scale = s * dft_scale`` (``bank_gains``), bf16
the pair mean rounded to bf16 with ``mag_scale`` 1. In the time-parallel
layout a bank's pairs are independent chains of two: one level a pair
finds its carrier's offsets, and one emitting pass sums the pairs in pair
order. Above 32 genes the long code (``synth_fitness.uses_long_code``)
takes the single pass at every population: a long chain's levels would
recompute kn (kn + 1) / 2 oscillators a sample.

Not ported, because they work around Mosaic's VMEM and compile time and
Hopper has neither limit here: ``fold_pop_block``, ``fold_vmem_ok``,
``_fold_budget`` (the kernel writes a+/- to device memory, so there is no
on-chip budget to fit) and ``LOOPED_ABOVE_N`` (the unrolled and looped time
loops are one loop in the thread).
"""
from __future__ import annotations

import torch

from ..ops.synthesis import parallel_pairs, topology_dims
from ..ops.wavetable import DEFAULT_SAMPLE_RATE, DEFAULT_WAVETABLE_SIZE
from .synth_fitness import (
    DEFAULT_POP_BLOCK,
    MAX_SHARED_BYTES,
    TIME_BLOCK,
    bank_amp,
    chain_length,
    check_supported_topology,
    inv_sample_rate,
    long_scratch,
    resolve_pop_block,
    synth_blocks_plain,
    synth_params_struct,
    uses_long_code,
)


# (shape, int8) -> the population from which the single pass is taken
# instead of the time-parallel layout. The shape is a chain's length (2 for
# fm2, k for fm{k}_series) or an fm{k}_parallel bank's name (``fold_shape``).
# Each is the smallest population of chip_smoke.py's FOLD_LAYOUT_POPS
# (2048 .. 2^16) at which the single pass was the faster at n 8192 on an
# H100 (its phase 11; the banks' rows its phase 34); fm2's time-parallel
# layout was the faster at all of them. The frame did not move it
# (fm3_series at n 4096 and 16384). The time-parallel layout computes
# kn(kn+1)/2 sines a sample where the single pass computes kn, so longer
# chains cross lower, though not in order: the single pass's own time does
# not grow in order with the chain. A bank's level pass adds one sine a
# pair to the pair's two, and its single pass (the runtime-length bank) is
# slower than a chain's: the time-parallel layout stayed the faster up to
# 2^16 but for fm5_parallel in bf16, which crossed at 2^15 (chip_smoke.py
# phase 34 at n 8192, and fm3_parallel at n 4096 and 16384). Chains past
# fm8_series and banks past fm5_parallel (the wide instantiations, named
# only by tests) take the longest timed row of their kind.
FOLD_TP_BELOW_POP = {
    (2, True): 1 << 17, (3, True): 1 << 14, (4, True): 1 << 14, (5, True): 1 << 14,
    (6, True): 1 << 14, (7, True): 1 << 12, (8, True): 1 << 13,
    (2, False): 1 << 17, (3, False): 1 << 15, (4, False): 1 << 15, (5, False): 1 << 14,
    (6, False): 1 << 13, (7, False): 1 << 13, (8, False): 1 << 13,
    ("fm2_parallel", True): 1 << 17, ("fm3_parallel", True): 1 << 17,
    ("fm4_parallel", True): 1 << 17, ("fm5_parallel", True): 1 << 17,
    ("fm2_parallel", False): 1 << 17, ("fm3_parallel", False): 1 << 17,
    ("fm4_parallel", False): 1 << 17, ("fm5_parallel", False): 1 << 15,
}
TIMED_CHAIN, TIMED_BANK = 8, 5  # the longest chain and largest bank with a row of their own


def fold_shape(topology: str):
    """``topology``'s key in FOLD_TP_BELOW_POP: its chain length (fm2: 2),
    or its bank's name; past the timed rows, the longest of its kind."""
    k = parallel_pairs(topology)
    if k is not None:
        return f"fm{min(k, TIMED_BANK)}_parallel"
    return min(chain_length(topology), TIMED_CHAIN)


def fold_geometry(pop: int, n: int, int8: bool, topology: str) -> dict:
    """The B3 launch for ``pop`` candidates of ``topology`` and frames of
    ``n`` (csrc ``pmfm_synth_fold``). Below
    ``FOLD_TP_BELOW_POP[fold_shape(topology), int8]`` candidates, while
    the frame (n int8 or bf16 elements) and the level totals (n/128 floats)
    fit a block's ``shared_bytes`` of shared memory: the time-parallel
    layout, a CUDA block a candidate, one warp whose lanes split the time
    blocks. Else, and for the long code at every population, the single
    pass: 32 candidates a block, one thread each, no shared memory."""
    smem = n * (1 if int8 else 2) + 4 * (n // TIME_BLOCK)
    if (not uses_long_code(topology) and pop < FOLD_TP_BELOW_POP[fold_shape(topology), int8]
            and smem <= MAX_SHARED_BYTES):
        return dict(time_parallel=True, blocks=pop, threads=32, shared_bytes=smem)
    return dict(time_parallel=False, blocks=-(-pop // 32), threads=32, shared_bytes=0)


def _check(params_scaled, topology, n):
    check_supported_topology(topology)
    d = params_scaled.shape[1]
    if d != topology_dims(topology):
        raise ValueError(f"{topology} needs {topology_dims(topology)} params, got {d}")
    if n % (2 * TIME_BLOCK):
        raise ValueError(f"n={n} must be a multiple of {2 * TIME_BLOCK} (the fold pairs blocks)")


def _fold_plain_block(p, *, topology, n, inv_sr, dft_scale, sine_order):
    int8 = dft_scale > 0.0
    pop = p.shape[0]
    q = torch.empty((n, pop), dtype=torch.int8 if int8 else torch.bfloat16, device=p.device)
    amp = bank_amp(p, topology, int8)
    blocks = synth_blocks_plain(p, topology=topology, n=n, inv_sr=inv_sr,
                                sine_order=sine_order, int8=int8)
    for b, y in enumerate(blocks):
        rows = slice(b * TIME_BLOCK, (b + 1) * TIME_BLOCK)
        q[rows] = torch.round(y).to(torch.int8) if int8 else (y * amp).to(torch.bfloat16)
    half = n // 2
    # the fold in float32: exact for int8, one rounding to bf16 otherwise
    qf = q.to(torch.float32).T  # (P, N): candidate-major, as the kernel stores it
    rev = qf[:, half + 1 :].flip(1)  # q[N-r] for r = 1 .. N/2-1
    # copies, never views: with one candidate qf[:, :half] is already
    # contiguous, and .contiguous() would hand back views of qf itself
    a_plus, a_minus = qf[:, :half].clone(), qf[:, :half].clone()
    a_plus[:, 1:] += rev
    a_minus[:, 1:] -= rev
    if int8:  # a bank's amp is s (bank_gains), the bf16 mode's 1
        mag_scale = torch.abs(amp) * torch.tensor(dft_scale, dtype=torch.float32)
    else:
        mag_scale = torch.ones((pop,), dtype=torch.float32, device=p.device)
    return a_plus.to(q.dtype), a_minus.to(q.dtype), qf[:, half].contiguous(), mag_scale


def fused_synth_fold_plain(
    params_scaled: torch.Tensor,
    *,
    topology: str = "fm3_series",
    n: int = 8192,
    wavetable_size: int = DEFAULT_WAVETABLE_SIZE,
    sample_rate: int = DEFAULT_SAMPLE_RATE,
    pop_block: int = DEFAULT_POP_BLOCK,
    dft_scale: float = 0.0,
    sine_order: int = 9,
):
    """The plain PyTorch version of ``fused_synth_fold``, on any device, one
    block of ``resolve_pop_block`` candidates at a time."""
    _check(params_scaled, topology, n)
    p = params_scaled.to(torch.float32)
    pop = p.shape[0]
    pb = resolve_pop_block(pop, pop_block)
    inv_sr = inv_sample_rate(wavetable_size, sample_rate)
    parts = [
        _fold_plain_block(p[i : i + pb], topology=topology, n=n, inv_sr=inv_sr,
                          dft_scale=dft_scale, sine_order=sine_order)
        for i in range(0, pop, pb)
    ]
    return (
        torch.cat([x[0] for x in parts]).T, torch.cat([x[1] for x in parts]).T,
        torch.cat([x[2] for x in parts]), torch.cat([x[3] for x in parts]),
    )


def fused_synth_fold(
    params_scaled: torch.Tensor,
    *,
    topology: str = "fm3_series",
    n: int = 8192,
    wavetable_size: int = DEFAULT_WAVETABLE_SIZE,
    sample_rate: int = DEFAULT_SAMPLE_RATE,
    pop_block: int = DEFAULT_POP_BLOCK,
    dft_scale: float = 0.0,
    sine_order: int = 9,
):
    """Synthesise and fold the whole population (one frame).

    Returns ``(a_plus (N/2, P), a_minus (N/2, P), edge (P,), mag_scale (P,))``,
    the a's int8 (``dft_scale > 0``) or bf16 and candidate-major (``.T``
    views of (P, N/2) tensors); feed them to
    ``ops.spectral.magnitude_spectrum_prefolded``. On CUDA tensors this
    launches the B3 kernel (counted in ``fused_synth_fold.launches``), in
    the layout ``fold_geometry`` picks (both give the same bits); on CPU
    tensors it runs the plain version, whose blocks ``pop_block`` sizes.
    """
    dev = params_scaled.device
    if dev.type == "cpu":
        return fused_synth_fold_plain(
            params_scaled, topology=topology, n=n, wavetable_size=wavetable_size,
            sample_rate=sample_rate, pop_block=pop_block, dft_scale=dft_scale,
            sine_order=sine_order,
        )
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check(params_scaled, topology, n)
    from ._build import check, library

    params = params_scaled.to(torch.float32).contiguous()
    pop, d = params.shape
    int8 = dft_scale > 0.0
    geo = fold_geometry(pop, n, int8, topology)
    dtype = torch.int8 if int8 else torch.bfloat16
    a_plus = torch.empty((pop, n // 2), dtype=dtype, device=dev)
    a_minus = torch.empty((pop, n // 2), dtype=dtype, device=dev)
    edge = torch.empty((pop,), dtype=torch.float32, device=dev)
    mag_scale = torch.empty((pop,), dtype=torch.float32, device=dev)
    sp = synth_params_struct(
        topology=topology, n=n, k=0, d=d, inv_sr=inv_sample_rate(wavetable_size, sample_rate),
        dft_scale=dft_scale, sine_order=sine_order,
    )
    lscratch = long_scratch(sp, topology, pop, dev)  # noqa: F841 (kept until enqueued)
    err = library().pmfm_synth_fold(
        params.data_ptr(), pop, sp, a_plus.data_ptr(), a_minus.data_ptr(), edge.data_ptr(),
        mag_scale.data_ptr(), int(int8), int(geo["time_parallel"]),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check(err, "fused_synth_fold")
    fused_synth_fold.launches += 1
    return a_plus.T, a_minus.T, edge, mag_scale


fused_synth_fold.launches = 0
