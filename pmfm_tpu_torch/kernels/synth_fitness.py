"""B1: fused FM synthesis + folded DFT + spectral fitness, int8, bf16 and true f32.

Replaces ``pmfm_tpu/kernels/synth_fitness.py::fused_synth_fitness`` (the
Pallas kernel ``_kernel`` over ``_evaluate_block``, ``_make_block_synth``,
``_dft_uv`` and ``_fit_epilogue``). The CUDA kernels are
``csrc/fused_eval.cu::fused_synth_fitness_int8_kernel`` (the folded DFT on
the int8 tensor cores), in the bf16 mode
``csrc/fused_bf16.cu::fused_synth_fitness_bf16_kernel`` (the same one-warp
design, ``csrc/tc_eval.cuh``, on the bf16 tensor cores) and, in the
true-f32 mode, ``csrc/fused_f32.cu``'s kernels (the synthesis into rows of
f32 samples in scratch, one thread a candidate or, where ``f32_time_parallel``
says, ``csrc/fused_f32_tp.cu``'s time-parallel layout; then at a power-of-two
frame a shared-memory FFT with the fitness epilogue, at any other a fold and
the register-tiled folded DFT, ``f32_route``; then the sum over frames or bin
groups); each file's note says what bounds
it on an H100 and how the design meets that.
``fused_synth_fitness_plain`` here is their plain PyTorch version, which the
wrapper runs for CPU tensors.

The numerics carried over from the TPU kernel:

* turns-domain phases (phase / wavetable size) in blocks of C = 128 samples,
  with the block's phase offsets carried through ``frac``; within a block the
  exclusive prefix sum is a running f32 sum in sample order (the semantics of
  the TPU kernel's ``_tri_strict`` matmul, in another summation order);
* the oscillator is an odd polynomial in turns (``_sin_turn_coeffs``);
* the fold ``a+/-[n] = x[n] +- x[N-n]`` (``a+/-[0] = x[0]``) and the edge
  sample ``x[N/2]`` entering as ``edge_norm * (-1)^k * x[N/2]``;
* two (K, N/2) contractions against ``dft_packed``;
* fitness = ``sum_k (mag - target)^2``.

Three modes, chosen by the operand as in the reference:

* int8 (``dft_scale > 0``, int8 operand): the output oscillator emits
  ``63 * sin`` and ``x = q = round(63 sin)``; the contractions are exact in
  int32; ``edge_norm = 127``; ``mag = sqrt(u^2 + v^2) * |amp| * dft_scale``
  with ``amp`` the last operator's ``freq * index``.
* bf16 (``dft_scale == 0``, bfloat16 operand; the reference's default
  fused engine): ``x = bf16(sin * amp)`` (a pair bank: its pair sum divided
  by k, then rounded), each fold sum ``x[n] +- x[N-n]`` formed in float32
  and rounded to bf16 once more (``_evaluate_block``'s ``fold_cast``), the
  contractions against the bf16 operand accumulated in float32 (the
  products of bf16 values are exact), ``edge_norm = 2 * norm`` on the bf16
  ``x[N/2]`` and no magnitude rescale (the operand carries window and norm).
* true f32 (``dft_scale == 0``, float32 operand; ``_evaluate_block``'s
  ``audio_f32``, the refine tail's engine): ``x = sin * amp`` unquantised,
  f32 contractions (TF32 off: the reference's ``Precision.HIGHEST``),
  ``edge_norm = 2 * norm`` (the operand carries window and norm), no
  magnitude rescale. The reference caps its f32 pop block
  (``F32_MAX_POP_BLOCK``) for VMEM; here the kernels write each frame's
  samples to scratch that the wrapper allocates (``f32_scratch_floats``)
  and take its rows in blocks of their own (``f32_geometry``); at a
  power-of-two frame the spectrum is an FFT of the windowed samples in
  float32 (``f32_route``: the same function, the sums in another order),
  and ``pop_block`` only sizes the plain version's blocks.

The Mosaic workarounds (one-hot gathers and reversal matmuls, the (D, P)
transposed layout, 128-lane pop blocks, VMEM gates) do not carry over.
The ``fm{k}_parallel`` bank (k independent fm2 pairs, genes ``4j .. 4j+3``
= (fm, index, fc, amp) of pair j, two phase carries a pair) changes only the
synthesis (``_make_block_synth``'s pair branch): in the int8 mode the bank
factors out ``s = (sum_j |amp_j|) / k`` (summed in pair order), each pair
emits the unit sine times ``gain_j = amp_j * 63 / (k s + 1e-30)``, the sum
over pairs (in pair order) is rounded to int8 and ``s`` takes the place of
``|amp|`` in the magnitude rescale; in the true-f32 mode each pair emits
``sin * amp_j`` and the sum is divided by the float32 k.

Multi-frame fitness (``num_frames`` = F > 1, the reference's STFT fitness):
a candidate synthesises F n continuous samples (the phase carries live on
from one frame to the next, as from one time block to the next), each frame
is folded and transformed against its own target row, and the frames' L2
totals are added in float32 in frame order. The target is then ``(F, K)``,
frame f at row f (the reference's kernel keeps it transposed, a TPU layout).

The run axis (the port's counterpart of the reference's ``vmap`` over the
``pallas_call`` in ``match_many``): parameters ``(B, P, D)`` and targets
``(B, F, K)`` (or ``(B, K)`` at one frame) evaluate B independent runs in one
launch, ``(B, P)`` out; run r's fitness is bit-equal to a lone launch on run
r's candidates and target.

Ported: ``fm2``, every ``fm{k}_series`` (k >= 3) and every
``fm{k}_parallel`` (k >= 2), at any frame count and with the run axis, in
all three modes; every kernel (B1-B5) takes the same topologies
(``check_supported_topology``). Chains up to fm8_series and banks up to
fm5_parallel have a compile-time instantiation each; longer chains and
larger banks up to 32 genes share one runtime-length instantiation a
kernel, mode and sine order (csrc ``WIDE_CHAIN``, ``WIDE_BANK``), and above
``LONG_ABOVE_GENES`` the long code takes any length (csrc ``LONG_CODE``,
``synth_common.cuh::LongSynth``: segments of oscillators or pairs over each
time block, the carries in a scratch the wrapper allocates,
``long_scratch``). The only limit is memory: a block's staged parameters
must fit its shared memory (``shared_bytes``) and the scratch the card's
memory, else the wrapper raises ``ValueError`` naming the bytes.
"""
from __future__ import annotations

import collections
import functools

import numpy as np
import torch

from ..device import exact_f32_matmul
from ..ops.spectral import fft_tables, window_factor
from ..ops.synthesis import parallel_pairs, series_ops, topology_dims
from ..ops.wavetable import DEFAULT_SAMPLE_RATE, DEFAULT_WAVETABLE_SIZE

DEFAULT_POP_BLOCK = 512
TIME_BLOCK = 128
# above this many genes every kernel takes the long synthesis code (csrc
# LONG_CODE); at or below it the fixed and wide codes (csrc MAX_D: fm16_series
# and fm8_parallel). A check on the card lowers it to hold the long code bit
# for bit against the fixed and wide ones.
LONG_ABOVE_GENES = 32
LONG_ROW_PAD = 128  # csrc LONG_ROW_PAD: a run's rows of the B1/B2 long scratch
CUDA_BLOCK = 32  # csrc TC_CPB: int8 B1/B2 candidates per CUDA block (one warp)
F32_GROUPS = 8  # csrc DF_GROUPS: the f32 DFT fitness's bin groups
F32_SYNTH_THREADS = 128  # csrc SY_TPB: B1/B2 f32 synthesis, candidates (threads) per block
F32_ROW_PAD = 128  # csrc ROW_PAD: the f32 scratch's rows a row block, the population padded
F32_FFT_THREADS = 256  # csrc FFT_THREADS
F32_FFT_TILE = 16384  # csrc FFT_TILE: floats of an FFT block's tile of frames
F32_FFT_SHARED_BYTES = 4 * F32_FFT_TILE  # the FFT block's tile, whatever the frame
F32_FFT_N = (256, 512, 1024, 2048)  # csrc fft_takes: the frames the FFT takes
# The true-f32 route of a frame of n samples (f32_route): the FFT where
# F32_FFT and n is a power of two, else the folded DFT. The card's checks set
# it False to time and check the DFT at the same shapes (chip_smoke.py phase
# 44); it is never a fallback.
F32_FFT = True
# The true-f32 synthesis' time-parallel layout where f32_time_parallel picks
# it; False keeps one thread a candidate at every shape (the card checks hold
# the two against each other).
F32_TIME_PARALLEL = True
F32_DFT_BM = 128  # csrc DF_BM: B1/B2 f32 DFT, candidates per block
SMS = 132  # the H100 SXM's SMs
# f32_tp_faster's constant, from both synthesis layouts' times on an NVIDIA
# H100 80GB HBM3 (PERF.md §6; tools/torch_f32_probe.py's sweep, 252 shapes):
# the levels' extra sines times the one-thread layout's warps an SM, below
# which the time-parallel layout is the faster
F32_TP_K = 3.5
F32_DFT_THREADS = 128  # csrc DF_THREADS
F32_DFT_PASS_TILES = 8  # csrc DF_TILES: bin tiles of 8 per pass of a DFT block
F32_SUM_THREADS = 256  # csrc SUM_TPB
F32_DFT_SHARED_BYTES = 92160  # csrc DF_SMEM: the f32 DFT block's stages, whatever the frame
F32_DFT_SPLIT_ABOVE = 512  # csrc DF_SPLIT_ABOVE: the f32 DFT splits the samples where N/2 is above
F32_DFT_SEG = 128  # csrc DF_SEG: samples a segment of the split
F32_DFT_LEVELS = 4  # csrc DF_LEVELS: running tiles of the pairwise segment sum
F32_DFT_RUN = 128  # csrc DF_RUN: floats of a DFT thread's running tile (its 16 x 8 U or V)
MAX_SHARED_BYTES = 232448  # shared memory one block of an H100 can use
# the fused kernels' frame limit: the reference routes larger frames to B3
# (synth_fold, n 4096-16384) and B4, and so does the port
MAX_FUSED_N = 3584


def resolve_pop_block(pop: int, pop_block: int) -> int:
    """Clamp ``pop_block`` to the population, then halve until it divides it.
    The plain versions process the population in blocks of this size."""
    pb = min(pop_block, pop)
    while pop % pb:
        pb //= 2
    return pb


@functools.lru_cache(maxsize=None)
def _sin_turn_coeffs(order: int = 9) -> tuple:
    """Odd-power coefficients (c1, c3, ..., c_order) of sin(2*pi*w) on
    w in [-0.5, 0.5], least-squares on Chebyshev nodes (the reference's fit,
    copied; the kernels take these values as arguments)."""
    w = 0.5 * np.cos(np.pi * (np.arange(2000) + 0.5) / 2000)
    target = np.sin(2 * np.pi * w)
    A = np.stack([w**j for j in range(1, order + 1, 2)], axis=1)
    coef, *_ = np.linalg.lstsq(A, target, rcond=None)
    return tuple(coef.astype(np.float32).tolist())


def sin_coeffs(order: int, scale: float = 1.0) -> tuple:
    """float32 coefficients of ``scale * sin(2*pi*w)``: the scale is folded
    into each coefficient in float64 and rounded once, as the TPU kernel's
    ``_sin_turns`` does."""
    return tuple(float(np.float32(v * scale)) for v in _sin_turn_coeffs(order))


def _sin_turns(x: torch.Tensor, cs: tuple) -> torch.Tensor:
    """``sum_j cs[j] w^(2j+1)`` for ``w = x - floor(x + 0.5)``, Horner in w^2."""
    w = x - torch.floor(x + 0.5)
    w2 = w * w
    acc = cs[-2] + w2 * cs[-1]
    for cj in reversed(cs[:-2]):
        acc = cj + w2 * acc
    return w * acc


def _frac(x: torch.Tensor) -> torch.Tensor:
    return x - torch.floor(x)


_F32_TINY = float(np.float32(1e-30))  # the int8 bank's guard against k s = 0


def _div(x: torch.Tensor, y) -> torch.Tensor:
    """``x / y`` correctly rounded, as the kernels' ``__fdiv_rn``: a tensor
    divisor, since torch multiplies by the reciprocal of a Python number (on
    CUDA tensors) and of a dividend's (``63.0 / x``)."""
    return torch.div(x, y if torch.is_tensor(y) else torch.full_like(x, y))


def inv_sample_rate(wavetable_size: int, sample_rate: int) -> float:
    """``1 / sample_rate`` as the reference forms it: (wts/sr)/wts in float64,
    rounded to float32."""
    w2sr = wavetable_size / float(sample_rate)
    return float(np.float32(w2sr / float(wavetable_size)))


OPERAND_DTYPES = (torch.int8, torch.bfloat16, torch.float32)


def operand_mode(dtype: torch.dtype, dft_scale: float) -> str:
    """The B1/B2 mode an operand of ``dtype`` selects: ``int8`` (with
    ``dft_scale > 0``), ``bf16`` or ``f32``."""
    if dft_scale > 0.0:
        return "int8"
    return "bf16" if dtype == torch.bfloat16 else "f32"


def check_supported(topology: str, dft_packed: torch.Tensor, dft_scale: float,
                    num_frames: int) -> None:
    """Raise for a B1/B2 variant the kernels do not take: ``ValueError`` for
    an int8 scale without the int8 operand, an operand of another dtype or
    a frame count below 1, ``NotImplementedError`` for a topology not ported
    yet."""
    if dft_scale > 0.0:
        if dft_packed.dtype != torch.int8:
            raise ValueError("the int8 engine (dft_scale > 0) needs the int8 dft_packed")
    elif dft_packed.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(
            f"a dft_packed of {dft_packed.dtype} with dft_scale 0: the bf16 and true-f32 "
            f"engines take a bfloat16 or float32 operand")
    if num_frames < 1:
        raise ValueError(f"num_frames must be >= 1, got {num_frames}")
    check_supported_topology(topology)


def check_supported_topology(topology: str) -> None:
    """Raise ``NotImplementedError`` for a topology the kernels do not take:
    every kernel (B1-B5) takes fm2, fm{k}_series and fm{k}_parallel at any
    length, as the reference's kernels do."""
    if topology != "fm2" and parallel_pairs(topology) is None and series_ops(topology) is None:
        raise NotImplementedError(f"{topology}: only fm2, fm{{k}}_series and fm{{k}}_parallel "
                                  f"are ported")


def uses_long_code(topology: str) -> bool:
    """Whether the kernels run ``topology`` with the long synthesis code:
    above ``LONG_ABOVE_GENES`` genes (fm2 never)."""
    return topology != "fm2" and topology_dims(topology) > LONG_ABOVE_GENES


def alloc_scratch(floats: int, device, what: str) -> torch.Tensor:
    """``floats`` float32 of device scratch; ``ValueError`` naming the bytes
    asked for and the bytes free when the card does not have them."""
    try:
        return torch.empty((floats,), dtype=torch.float32, device=device)
    except torch.OutOfMemoryError:
        free = torch.cuda.mem_get_info(device)[0] if torch.device(device).type == "cuda" else 0
        raise ValueError(f"{what}: needs {4 * floats} bytes of device memory, "
                         f"{free} free") from None


def long_rows(pop: int, runs: int = 1) -> int:
    """Rows of the B1/B2 long scratch: a row a synthesising thread, each
    run's population padded to ``LONG_ROW_PAD`` (csrc ``long_row``)."""
    return runs * -(-pop // LONG_ROW_PAD) * LONG_ROW_PAD


def long_scratch(sp, topology: str, rows: int, device):
    """Set ``sp`` (the kernels' ``SynthParams``) to the long code when
    ``topology`` takes it, with a scratch of ``rows`` rows of 2 x D floats
    (a row's scaled parameters, then its carries: csrc ``LongSynth``), and
    return the scratch (None for the other codes), which the caller keeps
    until the launch is enqueued."""
    if not uses_long_code(topology):
        return None
    scratch = alloc_scratch(2 * sp.d * rows, device, f"{topology}'s long-code scratch")
    sp.long_code, sp.lrows, sp.lscr = 1, rows, scratch.data_ptr()
    return scratch


def _chain_rows(p: torch.Tensor, topology: str, inv_sr: float):
    """(inc1, ims, ics, amp) per candidate from scaled params ``p`` (D, P):
    the chain's constants of ``_make_block_synth``. fm2 is a chain of two;
    an ``fm{k}_parallel`` bank is k fm2 chains (``_pair_rows``)."""
    if topology == "fm2":
        return (
            _frac(inv_sr * p[0]), [inv_sr * (p[0] * p[1])], [inv_sr * p[2]], p[3],
        )
    kn = series_ops(topology)
    ims = [inv_sr * (p[2 * j] * p[2 * j + 1]) for j in range(kn - 1)]
    ics = [inv_sr * p[2 * j + 3] for j in range(kn - 1)]
    return _frac(inv_sr * p[1]), ims, ics, p[2 * kn - 2] * p[2 * kn - 1]


def _pair_rows(p: torch.Tensor, topology: str, inv_sr: float) -> list:
    """The k fm2 chains of an ``fm{k}_parallel`` bank: ``_chain_rows`` of
    genes ``4j .. 4j+3`` of scaled params ``p`` (D, P), for each pair j."""
    return [_chain_rows(p[4 * j : 4 * j + 4], "fm2", inv_sr)
            for j in range(parallel_pairs(topology))]


def bank_gains(amps: list, int8: bool):
    """The output gains of a pair bank with amplitudes ``amps`` (k rows) and
    the amplitude its magnitudes are rescaled by: int8, ``s = (sum_j
    |amp_j|) / k`` summed in pair order, ``gain_j = amp_j * (63 / (k s +
    1e-30))`` and ``s``; true f32, the amplitudes themselves and 1 (the
    sum over pairs is divided by k instead)."""
    if not int8:
        return list(amps), torch.ones_like(amps[0])
    k = float(len(amps))
    s = torch.abs(amps[0])
    for a in amps[1:]:
        s = s + torch.abs(a)
    s = _div(s, k)
    inv_s = _div(torch.full_like(s, 63.0), k * s + _F32_TINY)
    return [a * inv_s for a in amps], s


def _exclusive_prefix(x: torch.Tensor):
    """Exclusive prefix sum over axis 0 and the total, summed in sample order
    in float32 (the CUDA kernel's running sum)."""
    pre = torch.empty_like(x)
    acc = torch.zeros_like(x[0])
    for t in range(x.shape[0]):
        pre[t] = acc
        acc = acc + x[t]
    return pre, acc


def synth_blocks_plain(p: torch.Tensor, *, topology: str, n: int, inv_sr: float,
                       sine_order: int, int8: bool):
    """Turns-domain synthesis of scaled params ``p`` (P, D), one block of
    ``TIME_BLOCK`` samples at a time: yields each block's output oscillator
    ``y`` (C, P) in time order. ``int8`` gives ``63 * sin`` (the int8
    engine's q before rounding), else the unit sine that the float engines
    multiply by the amplitude (``chain_amp``). An ``fm{k}_parallel`` bank
    yields the sum over its pairs with their gains (``bank_gains``), divided
    by k in the float mode: its q before rounding, or its audio.

    This is the plain version of ``csrc/synth_common.cuh::synth_run`` (its
    ``synth_span`` over the whole frame) and of ``synth_bank_span``, the
    recurrences every kernel of the port runs; the phase carries are the
    offsets of ``_chain_rows``'s chain, one per oscillator. ``n`` = F times
    the frame gives F frames of one continuous synthesis, as
    ``CandidateSynth`` runs them frame after frame."""
    rows = p.T.to(torch.float32)
    if parallel_pairs(topology):
        yield from _bank_blocks_plain(rows, topology=topology, n=n, inv_sr=inv_sr,
                                      sine_order=sine_order, int8=int8)
        return
    inc1, ims, ics, _ = _chain_rows(rows, topology, inv_sr)
    cs = sin_coeffs(sine_order)
    cs_out = sin_coeffs(sine_order, 63.0) if int8 else cs
    inc_blk = _frac(float(TIME_BLOCK) * inc1)
    t_block = torch.arange(TIME_BLOCK, dtype=torch.float32, device=p.device)[:, None]
    offs = [torch.zeros_like(inc1) for _ in range(len(ims) + 1)]
    for _ in range(n // TIME_BLOCK):
        pos = t_block * inc1 + offs[0]
        for j in range(len(ims)):
            x = _sin_turns(pos, cs) * ims[j] + ics[j]
            pre, tot = _exclusive_prefix(x)
            pos = pre + offs[j + 1]
            offs[j + 1] = _frac(offs[j + 1] + tot)
        yield _sin_turns(pos, cs_out)
        offs[0] = _frac(offs[0] + inc_blk)


def _bank_blocks_plain(rows, *, topology, n, inv_sr, sine_order, int8):
    """``synth_blocks_plain`` of an ``fm{k}_parallel`` bank (rows (D, P)):
    pair j is an fm2 chain with its own two carries and emits the unit sine
    times ``gain_j``; the pairs are added in pair order."""
    pairs = _pair_rows(rows, topology, inv_sr)
    gains, _ = bank_gains([pr[3] for pr in pairs], int8)
    k = float(len(pairs))
    cs = sin_coeffs(sine_order)
    t_block = torch.arange(TIME_BLOCK, dtype=torch.float32, device=rows.device)[:, None]
    incs_blk = [_frac(float(TIME_BLOCK) * pr[0]) for pr in pairs]
    o1 = [torch.zeros_like(pr[0]) for pr in pairs]
    o2 = [torch.zeros_like(pr[0]) for pr in pairs]
    for _ in range(n // TIME_BLOCK):
        y = None
        for j, (inc1, ims, ics, _) in enumerate(pairs):
            x = _sin_turns(t_block * inc1 + o1[j], cs) * ims[0] + ics[0]
            pre, tot = _exclusive_prefix(x)
            o = _sin_turns(pre + o2[j], cs) * gains[j]
            y = o if y is None else y + o
            o2[j] = _frac(o2[j] + tot)
            o1[j] = _frac(o1[j] + incs_blk[j])
        yield y if int8 else _div(y, k)


def chain_amp(p: torch.Tensor, topology: str) -> torch.Tensor:
    """The output amplitude (P,) of scaled params ``p`` (P, D): the last
    operator's freq * index (fm2: its amp parameter). Chains only: B1/B2
    take a pair bank's from ``bank_amp``."""
    return _chain_rows(p.T.to(torch.float32), topology, 1.0)[3]


def bank_amp(p: torch.Tensor, topology: str, int8: bool) -> torch.Tensor:
    """What B1/B2 multiply ``synth_blocks_plain``'s y by (the true-f32 mode)
    or rescale the magnitudes by (the int8 mode) for scaled params ``p``
    (P, D): ``chain_amp`` for a chain; for an ``fm{k}_parallel`` bank ``s``
    (int8) or 1 (true f32; ``bank_gains``)."""
    k = parallel_pairs(topology)
    if not k:
        return chain_amp(p, topology)
    rows = p.T.to(torch.float32)
    return bank_gains([rows[4 * j + 3] for j in range(k)], int8)[1]


def synth_int8_plain(p: torch.Tensor, *, topology: str, n: int, inv_sr: float, sine_order: int):
    """Turns-domain synthesis of scaled params ``p`` (P, D) into int8 audio
    ``q`` (N, P) = round(63 * unit audio), and the output amplitude (P,)
    (``bank_amp``: a pair bank's ``s``)."""
    q = torch.empty((n, p.shape[0]), dtype=torch.int8, device=p.device)
    blocks = synth_blocks_plain(p, topology=topology, n=n, inv_sr=inv_sr,
                                sine_order=sine_order, int8=True)
    for b, y in enumerate(blocks):
        q[b * TIME_BLOCK : (b + 1) * TIME_BLOCK] = torch.round(y).to(torch.int8)
    return q, bank_amp(p, topology, True)


def synth_f32_plain(p: torch.Tensor, *, topology: str, n: int, inv_sr: float, sine_order: int):
    """Turns-domain synthesis of scaled params ``p`` (P, D) into the true-f32
    engine's audio ``x`` (N, P) = unit audio * amplitude, unquantised (a
    pair bank's audio times 1)."""
    x = torch.empty((n, p.shape[0]), dtype=torch.float32, device=p.device)
    amp = bank_amp(p, topology, False)
    blocks = synth_blocks_plain(p, topology=topology, n=n, inv_sr=inv_sr,
                                sine_order=sine_order, int8=False)
    for b, y in enumerate(blocks):
        x[b * TIME_BLOCK : (b + 1) * TIME_BLOCK] = y * amp
    return x


def fold(q: torch.Tensor):
    """Audio (N, P) -> folded ``a+, a-`` (N/2, P) and the edge sample
    ``q[N/2]`` (P,): int32 for int8 audio (exact), float32 for float32
    audio (one rounding of each sum and difference), and for bf16 audio
    float32 sums rounded once to bf16 (``fold_cast``), held as float32."""
    half = q.shape[0] // 2
    qi = q.to(torch.int32) if q.dtype == torch.int8 else q.to(torch.float32)
    rev = qi[half + 1 :].flip(0)  # q[N-r] for r = 1 .. N/2-1
    a_plus = qi[:half].clone()
    a_minus = qi[:half].clone()
    a_plus[1:] += rev
    a_minus[1:] -= rev
    if q.dtype == torch.bfloat16:
        a_plus = a_plus.to(torch.bfloat16).to(torch.float32)
        a_minus = a_minus.to(torch.bfloat16).to(torch.float32)
    return a_plus, a_minus, qi[half]


@functools.lru_cache(maxsize=None)
def edge_norm(n: int, int8: bool) -> float:
    """Size of the x[N/2] edge coefficient ``edge_norm * (-1)^k`` as float32:
    127 in int8 mode (the quantised 63.5 * w[N/2]), else 2 * norm =
    2 / (N * windowFactor) (the float operand carries window and norm)."""
    return 127.0 if int8 else float(np.float32(2.0 / (n * window_factor(n))))


def dft_fitness_plain(a_plus, a_minus, edge_q, amp, dft_packed, dft_scale, target):
    """Folded DFT, magnitudes and L2 fitness (``_dft_uv`` + ``_fit_epilogue``).

    int8 (``dft_scale > 0``): the contraction runs in float32 with TF32 off.
    Its partial sums are integers bounded by N/2 * 127 * 126, which stays
    below 2^24 (so the sum is exact) only for n <= 2048; at 2048 < n <= 3584,
    which B1 also takes, the plain version may round where the kernel's
    int32 sum does not. The magnitude is rescaled by ``|amp| * dft_scale``.
    bf16 and true f32 (``dft_scale == 0``): float32 contractions with TF32
    off (of bf16 values in the bf16 mode, whose products are exact), no
    rescale (``amp`` is unused)."""
    k = dft_packed.shape[0] // 2
    n = 2 * dft_packed.shape[1]
    int8 = dft_scale > 0.0
    op = dft_packed.to(torch.float32)
    with exact_f32_matmul():
        u = op[:k] @ a_plus.to(torch.float32)
        v = op[k:] @ a_minus.to(torch.float32)
    en = edge_norm(n, int8)
    ec = torch.where(torch.arange(k, device=u.device) % 2 == 0, en, -en).to(torch.float32)
    u = u + ec[:, None] * edge_q.to(torch.float32)[None, :]
    mag = torch.sqrt(u * u + v * v)
    if int8:
        mag = mag * (torch.abs(amp) * float(np.float32(dft_scale)))[None, :]
    d = mag - target.to(torch.float32)[:, None]
    return torch.sum(d * d, dim=0)


def _evaluate_plain(params_scaled, dft_packed, target, *, topology, n, inv_sr, dft_scale,
                    sine_order, pop_block, num_frames=1):
    """Plain PyTorch version of the B1 kernel: fitness (P,) of scaled params
    (P, D) against ``target`` (K,) or (F, K), one block of
    ``resolve_pop_block`` candidates at a time, in the int8 (``dft_scale >
    0``), the bf16 (a bfloat16 operand) or the true-f32 mode. Each block synthesises ``num_frames`` n
    continuous samples; frame f is folded and scored against target row f,
    and the frames' totals are added in frame order."""
    pop = params_scaled.shape[0]
    pb = resolve_pop_block(pop, pop_block)
    rows = target.reshape(num_frames, -1)
    out = torch.empty((pop,), dtype=torch.float32, device=params_scaled.device)
    kw = dict(topology=topology, n=num_frames * n, inv_sr=inv_sr, sine_order=sine_order)
    for i in range(0, pop, pb):
        p = params_scaled[i : i + pb]
        if dft_scale > 0.0:
            q, amp = synth_int8_plain(p, **kw)
        else:
            q, amp = synth_f32_plain(p, **kw), None
            if dft_packed.dtype == torch.bfloat16:
                q = q.to(torch.bfloat16)
        fit = None
        for f in range(num_frames):
            ap, am, edge = fold(q[f * n : (f + 1) * n])
            frame = dft_fitness_plain(ap, am, edge, amp, dft_packed, dft_scale, rows[f])
            fit = frame if fit is None else fit + frame
        out[i : i + pb] = fit
    return out


def chain_length(topology: str) -> int:
    """Oscillators in a ported chain: 2 for fm2 and for each pair of an
    fm{k}_parallel bank, k for fm{k}_series."""
    return 2 if topology == "fm2" or parallel_pairs(topology) else series_ops(topology)


def synth_params_struct(*, topology, n, k, d, inv_sr, dft_scale, sine_order, frames=1):
    """The kernels' ``SynthParams`` argument."""
    from ._build import SynthParams

    sp = SynthParams()
    cs, cs63 = sin_coeffs(sine_order), sin_coeffs(sine_order, 63.0)
    sp.sin_c[: len(cs)] = cs
    sp.sin_c63[: len(cs63)] = cs63
    sp.ncoef = len(cs)
    sp.n, sp.k, sp.d = n, k, d
    sp.kn = chain_length(topology)
    sp.fm2 = int(topology == "fm2")
    sp.inv_sr = inv_sr
    sp.dft_scale = dft_scale
    sp.edge_norm = edge_norm(n, dft_scale > 0.0)
    sp.npair = parallel_pairs(topology) or 0  # csrc: a bank of npair fm2 chains
    sp.frames = frames
    return sp


def f32_pop_pad(pop: int) -> int:
    """The population padded to whole row blocks of the f32 scratch (``F32_ROW_PAD``)."""
    return -(-pop // F32_ROW_PAD) * F32_ROW_PAD


def f32_route(n: int) -> str:
    """The true-f32 route of frames of ``n`` samples, one test on n: ``"fft"``
    (csrc ``f32_fft_kernel``) where n is a power of two (every frame a
    user's configuration gives: ``audioLengthLog2`` 8-11 in B1/B2; n 256
    to 2048, ``F32_FFT_N``), else ``"dft"`` (the fold and
    ``f32_dft_kernel``: n 1280, 3584, ..., which only the tests reach).
    ``F32_FFT`` False sends every frame to the DFT (the card's checks)."""
    return "fft" if F32_FFT and n in F32_FFT_N else "dft"


def f32_tp_takes(n: int, topology: str) -> bool:
    """Whether the true-f32 synthesis' time-parallel kernel (csrc
    ``fused_f32_tp.cu``) takes the shape: a fixed chain (fm2, fm3_series ..
    fm8_series) or a fixed bank of 2-5 pairs, not on the long code, n a
    multiple of 256 (two time blocks, two warps at least)."""
    pairs = parallel_pairs(topology)
    fixed = 2 <= pairs <= 5 if pairs else topology == "fm2" or 3 <= series_ops(topology) <= 8
    return fixed and not uses_long_code(topology) and n % (2 * TIME_BLOCK) == 0


def f32_tp_faster(n: int, topology: str, pop: int, runs: int = 1) -> bool:
    """The rule by which the true-f32 synthesis takes its time-parallel
    layout where its kernel takes the shape, from both layouts' times on an
    H100 (PERF.md §6, the sweep of tools/torch_f32_probe.py). The one-thread
    layout runs ceil(pop / 128) x runs blocks of four warps, each thread's
    chain of dependent operations over all its samples, and loses by its few
    warps an SM, ``warps``. The time-parallel one pays its levels: ``extra``
    sines a sample for each of the synthesis' (a chain of KN: (KN - 1) / 2;
    a bank: 1 / 2), each level a barrier of a block of only min(n / 128, 8)
    warps ``W``. So it wins where ``extra`` <= W / 2 (at n 256, W 2, fm4
    and longer chains lost at every population) and ``extra`` x ``warps``
    < ``F32_TP_K``. The frame count does not enter: each layout's time grows
    with it alike."""
    extra = 0.5 if parallel_pairs(topology) else (chain_length(topology) - 1) / 2
    warps = f32_pop_pad(pop) // F32_SYNTH_THREADS * runs * (F32_SYNTH_THREADS // 32) / SMS
    return extra <= min(n // TIME_BLOCK, 8) / 2 and extra * warps < F32_TP_K


def f32_time_parallel(n: int, topology: str, pop: int, runs: int = 1) -> bool:
    """Whether B1/B2/B5 true f32 synthesise in the time-parallel layout (32
    candidates a block on min(n / 128, 8) warps) for ``pop`` candidates of
    ``runs`` runs: where the kernel takes the shape (``f32_tp_takes``) and
    the card's rule says it is the faster (``f32_tp_faster``)."""
    return (F32_TIME_PARALLEL and f32_tp_takes(n, topology)
            and f32_tp_faster(n, topology, pop, runs))


def shared_bytes_f32_tp(n: int, topology: str, frames: int = 1) -> int:
    """Dynamic shared memory of a block of the true-f32 time-parallel
    synthesis (csrc ``fused_f32_tp.cu::f32_tp_smem``): its warps' staging
    buffers (32 x 20 floats a warp), the level totals (levels x n / 128 x
    32 floats: a chain of KN has KN - 1 levels, a bank one a pair), the
    staged genes (32 x d floats) and at ``frames`` > 1 the carries (32 x
    d / 2 floats)."""
    d = topology_dims(topology)
    pairs = parallel_pairs(topology)
    levels = pairs if pairs else chain_length(topology) - 1
    warps = min(n // TIME_BLOCK, 8)
    carries = CUDA_BLOCK * (d // 2) if frames > 1 else 0
    return 4 * (warps * 32 * (16 + 4) + levels * (n // TIME_BLOCK) * CUDA_BLOCK
                + CUDA_BLOCK * d + carries)


def f32_dft_segments(n: int) -> int:
    """Segments the f32 DFT sums each bin's U and V in (csrc
    ``f32_dft_kernel``): 1 where N/2 <= ``F32_DFT_SPLIT_ABOVE``, else
    ``F32_DFT_SEG``-sample segments (the last may be shorter), each a chain
    from 0, added pairwise through ``F32_DFT_LEVELS`` running tiles in
    scratch."""
    half = n // 2
    return 1 if half <= F32_DFT_SPLIT_ABOVE else -(-half // F32_DFT_SEG)


def f32_scratch_floats(pop: int, n: int, frames: int = 1, runs: int = 1) -> int:
    """Floats of scratch the true-f32 B1/B2 take (csrc ``f32_scratch_floats``)
    for ``runs`` runs of ``pop`` candidates at ``frames`` frames of n on its
    route (``f32_route``): for each of the runs x frames row blocks, the
    samples (padded pop x n), the DFT's a+ and a- (padded pop x N/2 each),
    edge samples and ``F32_GROUPS`` double group sums a padded candidate
    and, where the DFT splits the samples, ``F32_DFT_LEVELS`` running tiles
    of ``F32_DFT_RUN`` floats for each thread of each DFT block
    (``F32_GROUPS`` x ``F32_DFT_LEVELS`` x ``F32_DFT_RUN`` a padded
    candidate); on the FFT route (whose exact matches the DFT scores again)
    then each row's frame value, the row block's list of exact matches and
    their count (3 a padded candidate)."""
    run = F32_GROUPS * F32_DFT_LEVELS * F32_DFT_RUN if f32_dft_segments(n) > 1 else 0
    per_row = 2 * n + 1 + 2 * F32_GROUPS + run + (3 if f32_route(n) == "fft" else 0)
    return runs * frames * f32_pop_pad(pop) * per_row


def f32_geometry(pop: int, n: int, k: int, frames: int = 1, runs: int = 1,
                 topology: str = "fm3_series") -> dict:
    """The true-f32 B1/B2 launches for ``runs`` runs of ``pop`` candidates of
    ``topology`` at ``frames`` frames of ``n`` samples and ``k`` bins (csrc
    ``launch_f32``): the route (``f32_route``) and the synthesis layout
    (``"time_parallel"`` or ``"one_thread"``, ``f32_time_parallel``), and
    blocks and threads of each kernel's grid's first dimension: the
    synthesis (its second is ``runs``); on the FFT route the FFT (a block a
    tile of ``F32_FFT_TILE / n`` of the runs x frames x padded pop rows) and
    ``exact``, the blocks of the exact matches' values; the fold (a block
    per ``F32_DFT_BM`` rows) and the DFT (a block per ``F32_DFT_BM``
    candidates and bin group), each with the second dimension
    ``row_blocks``, runs x frames (on the FFT route their blocks past a row
    block's exact matches return at once), ``passes`` (the most passes of
    ``F32_DFT_PASS_TILES`` tiles a DFT block makes: group 0 has the most
    tiles) and ``segments`` (``f32_dft_segments``); the sum over frames or
    groups (its second dimension ``runs``); and ``scratch_bytes``."""
    pad = f32_pop_pad(pop)
    route = f32_route(n)
    tp = f32_time_parallel(n, topology, pop, runs)
    rows = runs * frames * pad
    geo = dict(
        pop_pad=pad, route=route, layout="time_parallel" if tp else "one_thread",
        synth=((pad // CUDA_BLOCK, 32 * min(n // TIME_BLOCK, 8)) if tp
               else (pad // F32_SYNTH_THREADS, F32_SYNTH_THREADS)),
        sum=(-(-pop // F32_SUM_THREADS), F32_SUM_THREADS),
        runs=runs, row_blocks=runs * frames,
        scratch_bytes=4 * f32_scratch_floats(pop, n, frames, runs),
    )
    if route == "fft":
        geo.update(fft=(rows // (F32_FFT_TILE // n), F32_FFT_THREADS),
                   exact=(-(-rows // F32_SUM_THREADS), F32_SUM_THREADS))
    tiles0 = -(-(k // 8) // F32_GROUPS)
    geo.update(fold=(pad // F32_DFT_BM, 256),
               dft=(pad // F32_DFT_BM * F32_GROUPS, F32_DFT_THREADS),
               passes=-(-tiles0 // F32_DFT_PASS_TILES), segments=f32_dft_segments(n))
    return geo


@functools.lru_cache(maxsize=None)
def _fft_table(n: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(fft_tables(n)).to(device)


def f32_launch(sp, topology: str, pop: int, runs: int, device) -> tuple:
    """Set the true-f32 route and synthesis layout in the kernels'
    ``SynthParams``: ``sp.fft``, the FFT's tables on ``device`` (kept on the
    device for the process: ``fft_tables``) on the FFT route, else null;
    ``sp.f32_tp``. Returns ``(route, layout)``, the keys the launch is
    counted under in ``launches_by_f32``."""
    route = f32_route(sp.n)
    tp = f32_time_parallel(sp.n, topology, pop, runs)
    sp.fft = _fft_table(sp.n, torch.device(device)).data_ptr() if route == "fft" else None
    sp.f32_tp = int(tp)
    return route, "time_parallel" if tp else "one_thread"


def shared_bytes(n: int, dtype: torch.dtype, d: int = 0) -> int:
    """Dynamic shared memory of a B1/B2 block at frames of ``n`` samples and
    ``d`` genes in the mode of an operand of ``dtype`` (csrc
    ``tc_eval.cuh::tc_smem`` and ``fused_f32.cu``'s spectrum kernels): int8 and
    bf16, the larger of the folded audio of its ``CUDA_BLOCK`` candidates,
    ``CUDA_BLOCK`` x n elements (at n 3584 in bf16, 229,376 of the block's
    232,448 bytes), and their ``CUDA_BLOCK`` x d scaled parameters, staged in
    the same space before the synthesis writes it (the larger above d = n x
    element / 4: 64 genes at int8 n 256); true f32, the larger of the
    spectrum kernels' fixed blocks, the DFT's stages (the FFT's tile of
    frames takes ``F32_FFT_SHARED_BYTES``; the samples live in scratch, the
    one-thread synthesis block stages at most 32 genes in static shared
    memory, the long code reads its parameters from the long scratch, and
    the time-parallel synthesis block takes at most ~38 KB,
    ``shared_bytes_f32_tp``). B5 runs these kernels, and its selection block
    does not grow with the frame."""
    if dtype == torch.float32:
        return F32_DFT_SHARED_BYTES
    return max(n * CUDA_BLOCK * (2 if dtype == torch.bfloat16 else 1), CUDA_BLOCK * d * 4)


def shared_bytes_tp(n: int, k: int, d: int, frames: int = 1) -> int:
    """Dynamic shared memory of a block of B2's time-parallel layout (csrc
    ``fused_tp.cuh::tp_smem``) at ``frames`` frames of ``n`` samples, ``k``
    bins and ``d`` genes: a+/- of its ``CUDA_BLOCK`` candidates (``CUDA_BLOCK``
    x n int8, which first hold the level totals), then the largest of three
    tenants of one region, each dead before the next is written: the int8
    frame (``CUDA_BLOCK`` x n), the bins' terms (``CUDA_BLOCK`` x k floats)
    and the staged genes (``CUDA_BLOCK`` x d floats); at ``frames`` > 1 a
    third region holds the staged genes for every frame and the carries the
    last warp hands to the next frame (``CUDA_BLOCK`` x (d + d / 2) floats).
    98,304 bytes at n 1024, K 512 (two blocks an SM); 196,608 at n 2048,
    K 1024, and 197,760 there for fm3_series at F > 1."""
    carries = CUDA_BLOCK * (d + d // 2) * 4 if frames > 1 else 0
    return CUDA_BLOCK * n + max(CUDA_BLOCK * n, CUDA_BLOCK * k * 4, CUDA_BLOCK * d * 4) + carries


def tp_bf16_ring(n: int) -> int:
    """Rows of the ring of terms of a block of B1/B2 bf16's time-parallel
    layout (csrc ``fused_tp_bf16.cuh::tp_bf16_ring``) at frames of ``n``
    samples: two rounds of its warps' (min(n / 128, 8)) 16 bins each,
    rounded up to a power of two, so that bin k's row is k & (rows - 1)
    and two consecutive rounds never share a row (256 at n 768, six warps)."""
    rows = 1
    while rows < 2 * min(n // TIME_BLOCK, 8) * 16:
        rows <<= 1
    return rows


def shared_bytes_tp_bf16(n: int, d: int, topology: str, frames: int = 1) -> int:
    """Dynamic shared memory of a block of B1/B2 bf16's time-parallel layout
    (csrc ``fused_tp_bf16.cuh::tp_bf16_smem``) at ``frames`` frames of ``n``
    samples and ``d`` genes of ``topology``: a+/- (``CUDA_BLOCK`` x n bf16
    each; at one frame they first hold the staged genes), then the larger
    of the ring of a round's terms (``tp_bf16_ring`` rows of ``CUDA_BLOCK``
    floats) and the synthesis' level totals (levels x n / 128 x
    ``CUDA_BLOCK`` floats: a chain's length - 1, a bank's pairs), the edge
    samples (``CUDA_BLOCK`` floats) and, at ``frames`` > 1, the staged
    genes and the carries (``CUDA_BLOCK`` x (d + d / 2) floats). 98,432
    bytes at n 1024 (two blocks an SM); 163,968 at n 2048."""
    pairs = parallel_pairs(topology)
    levels = pairs if pairs else chain_length(topology) - 1
    terms = tp_bf16_ring(n) * CUDA_BLOCK
    carries = CUDA_BLOCK * (d + d // 2) if frames > 1 else 0
    return (2 * CUDA_BLOCK * n
            + 4 * (max(terms, levels * (n // TIME_BLOCK) * CUDA_BLOCK) + CUDA_BLOCK + carries))


def fits_shared_memory(n: int, dtype: torch.dtype, d: int = 0) -> bool:
    """Whether B1/B2/B5 take frames of ``n`` samples (and ``d`` genes) in the
    mode of an operand of ``dtype`` (int8, bf16 or f32): n <= ``MAX_FUSED_N``
    (3584) in all three, the port's stated frame limit, under which a
    block's shared memory also holds, and a block's staged parameters within
    it (``shared_bytes``: above ~1800 genes in int8 and bf16). The frame
    limit is the reference's engine ladder, not the card's: the int8 and f32
    blocks would fit larger frames, but n >= 4096 stays with B3 as in the
    reference. The one definition of the fused kernels' size limit, read by
    the wrappers (B5's through ``generation._check_b2``) and by
    ``es.strategy._fused_ok``."""
    return n <= MAX_FUSED_N and shared_bytes(n, dtype, d) <= MAX_SHARED_BYTES


def check_kernel_shapes(n: int, k: int, dft_packed: torch.Tensor, target: torch.Tensor,
                        frames: int = 1, runs: int | None = None, d: int = 0) -> None:
    """Raise on operands the CUDA kernels do not take: the folded operand
    (2K, N/2), int8, bfloat16 or float32, and a contiguous float32 target:
    (K,) or (F, K) for one run, (B, F, K) (or (B, K) at one frame) for
    ``runs`` = B; ``ValueError`` naming the bytes where a block's ``d``
    staged parameters do not fit its shared memory (``shared_bytes``)."""
    if n % (2 * TIME_BLOCK):
        raise ValueError(f"n={n} must be a multiple of {2 * TIME_BLOCK} (the fold pairs blocks)")
    if not fits_shared_memory(n, dft_packed.dtype):
        raise NotImplementedError(
            f"n={n}: above the fused kernels' frame limit {MAX_FUSED_N} "
            f"(larger frames take the synth_fold route, kernel B3)"
        )
    need = shared_bytes(n, dft_packed.dtype, d)
    if need > MAX_SHARED_BYTES:
        raise ValueError(f"{d} genes at n={n}: a B1/B2 block needs {need} bytes of shared "
                         f"memory, has {MAX_SHARED_BYTES}")
    if k % 8:
        raise ValueError(f"num_bins={k} must be a multiple of 8")
    if dft_packed.dtype not in OPERAND_DTYPES or tuple(dft_packed.shape) != (2 * k, n // 2):
        raise ValueError(
            f"need the int8, bfloat16 or float32 folded operand (2K, N/2) = {(2 * k, n // 2)}, "
            f"got "
            f"{tuple(dft_packed.shape)} {dft_packed.dtype}"
        )
    if not dft_packed.is_contiguous() or dft_packed.data_ptr() % 16:
        raise ValueError("dft_packed must be contiguous and 16-byte aligned")
    lead = () if runs is None else (runs,)
    shape = tuple(target.shape)
    if (target.dtype != torch.float32 or not target.is_contiguous()
            or (shape != lead + (frames, k) and (frames > 1 or shape != lead + (k,)))):
        want = " or ".join(map(str, [lead + (frames, k)] + ([lead + (k,)] if frames == 1 else [])))
        raise ValueError(f"target must be a contiguous float32 tensor of shape {want}, got {shape}")


def runs_of(operand: torch.Tensor):
    """The run axis of a B1/B2/B5 operand: None for a (P, D) or (mu, D)
    operand (one run), else B of a (B, P, D) or (B, mu, D) one."""
    if operand.dim() == 2:
        return None
    if operand.dim() != 3 or operand.shape[0] < 1:
        raise ValueError(f"need a (P, D) operand or a (B, P, D) one of B runs, got "
                         f"{tuple(operand.shape)}")
    return operand.shape[0]


def _check_b1(params_scaled, target_spectrum, dft_packed, dft_scale, topology, n, num_frames):
    check_supported(topology, dft_packed, dft_scale, num_frames)
    runs = runs_of(params_scaled)
    d = params_scaled.shape[-1]
    if d != topology_dims(topology):
        raise ValueError(f"{topology} needs {topology_dims(topology)} params, got {d}")
    k = dft_packed.shape[0] // 2
    check_kernel_shapes(n, k, dft_packed, target_spectrum, num_frames, runs, d)
    for t in (dft_packed, target_spectrum):
        if t.device != params_scaled.device:
            raise ValueError(f"operands must be on {params_scaled.device}, got {t.device}")
    return k


def launch_mode(topology: str, dft_scale: float, frames: int = 1, runs=None,
                dtype: torch.dtype = torch.float32) -> str:
    """The key a B1/B2 launch is counted under in the wrappers'
    ``launches_by``: ``int8``, ``bf16`` or ``f32`` (``operand_mode`` of the
    operand's ``dtype``), after ``parallel_`` for an ``fm{k}_parallel``
    bank, then ``_frames`` for a multi-frame launch and ``_runs`` for a
    launch with the run axis."""
    mode = operand_mode(dtype, dft_scale)
    mode = f"parallel_{mode}" if parallel_pairs(topology) else mode
    return mode + ("_frames" if frames > 1 else "") + ("" if runs is None else "_runs")


def b1_entry(mode: str, n: int, k: int, d: int, topology: str, frames: int = 1,
             pop: int = CUDA_BLOCK, runs: int = 1) -> tuple:
    """The library entry B1 launches in ``mode`` (``operand_mode``) and the
    key its launch is counted under in ``launches_by_layout``: int8 and
    bf16 in the time-parallel layouts of ``csrc/fused_tp.cuh`` and
    ``csrc/fused_tp_bf16.cuh`` where B2's rule takes it
    (``generation.time_parallel``, the same function, so B1 and B2 take one
    layout at a shape), else one warp a block; true f32 its own kernels
    (layout None: ``f32_launch`` counts them)."""
    from .generation import layout_key, time_parallel  # generation imports this module

    if mode == "f32":
        return "pmfm_fused_synth_fitness_f32", None
    tp = time_parallel(n, k, d, topology, mode, frames, pop, runs)
    entry = "pmfm_fused_synth_fitness" + ("_bf16" if mode == "bf16" else "") + ("_tp" if tp else "")
    return entry, layout_key(mode, tp)


def fused_synth_fitness_plain(
    params_scaled: torch.Tensor,
    target_spectrum: torch.Tensor,
    *,
    dft_packed: torch.Tensor,
    dft_scale: float,
    topology: str = "fm3_series",
    n: int = 1024,
    wavetable_size: int = DEFAULT_WAVETABLE_SIZE,
    sample_rate: int = DEFAULT_SAMPLE_RATE,
    pop_block: int = DEFAULT_POP_BLOCK,
    num_frames: int = 1,
    sine_order: int = 9,
) -> torch.Tensor:
    """The plain PyTorch version of ``fused_synth_fitness``, on any device:
    with a run axis, the lone version run by run."""
    _check_b1(params_scaled, target_spectrum, dft_packed, dft_scale, topology, n, num_frames)
    kw = dict(topology=topology, n=n, inv_sr=inv_sample_rate(wavetable_size, sample_rate),
              dft_scale=dft_scale, sine_order=sine_order, pop_block=pop_block,
              num_frames=num_frames)
    params = params_scaled.to(torch.float32)
    if params.dim() == 2:
        return _evaluate_plain(params, dft_packed, target_spectrum, **kw)
    return torch.stack([_evaluate_plain(params[r], dft_packed, target_spectrum[r], **kw)
                        for r in range(params.shape[0])])


def fused_synth_fitness(
    params_scaled: torch.Tensor,
    target_spectrum: torch.Tensor,
    *,
    dft_packed: torch.Tensor,
    dft_scale: float,
    topology: str = "fm3_series",
    n: int = 1024,
    wavetable_size: int = DEFAULT_WAVETABLE_SIZE,
    sample_rate: int = DEFAULT_SAMPLE_RATE,
    pop_block: int = DEFAULT_POP_BLOCK,
    num_frames: int = 1,
    sine_order: int = 9,
) -> torch.Tensor:
    """Fitness ``(P,)`` float32 of scaled candidates ``(P, D)``, or ``(B, P)``
    of B runs' candidates ``(B, P, D)`` (the run axis).

    ``dft_packed`` is ``SpectrumOps.dft_packed`` ((2K, N/2), int8, bfloat16
    or float32) and ``dft_scale`` its ``dft_packed_scale``: an int8 operand
    with ``dft_scale > 0`` runs the int8 mode, a bfloat16 one the bf16 mode
    and a float32 one with ``dft_scale`` 0 the true-f32 mode. ``target_spectrum`` is (K,), or (F, K) with
    ``num_frames`` = F (multi-frame fitness); with the run axis (B, F, K),
    or (B, K) at one frame. On CUDA tensors this launches the B1 kernel once
    for all runs (counted in ``fused_synth_fitness.launches``, by mode in
    ``fused_synth_fitness.launches_by[launch_mode(...)]``, int8 and bf16 by
    layout in ``fused_synth_fitness.launches_by_layout`` under
    ``generation.layout_key``: int8 ``"time_parallel"`` (where B2's rule,
    ``generation.time_parallel``, takes it) or ``"one_warp"``, bf16
    ``"bf16_time_parallel"`` or ``"bf16_one_warp"``; true f32, by route and
    synthesis layout in
    ``fused_synth_fitness.launches_by_f32``: ``"fft"`` or ``"dft"``, and
    ``"time_parallel"`` or ``"one_thread"``, ``f32_launch``); on CPU tensors
    it runs the plain version whatever the layout. ``pop_block`` sizes the
    plain version's blocks.
    """
    dev = params_scaled.device
    if dev.type == "cpu":
        return fused_synth_fitness_plain(
            params_scaled, target_spectrum, dft_packed=dft_packed, dft_scale=dft_scale,
            topology=topology, n=n, wavetable_size=wavetable_size, sample_rate=sample_rate,
            pop_block=pop_block, num_frames=num_frames, sine_order=sine_order,
        )
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    k = _check_b1(params_scaled, target_spectrum, dft_packed, dft_scale, topology, n, num_frames)
    from ._build import check, library

    runs = runs_of(params_scaled)
    params = params_scaled.to(torch.float32).contiguous()
    pop, d = params.shape[-2:]
    fitness = torch.empty(params.shape[:-1], dtype=torch.float32, device=dev)
    sp = synth_params_struct(
        topology=topology, n=n, k=k, d=d, inv_sr=inv_sample_rate(wavetable_size, sample_rate),
        dft_scale=dft_scale, sine_order=sine_order, frames=num_frames,
    )
    stream = torch.cuda.current_stream(dev).cuda_stream
    nruns = runs or 1
    lscratch = long_scratch(sp, topology, long_rows(pop, nruns), dev)  # noqa: F841 (kept)
    mode = operand_mode(dft_packed.dtype, dft_scale)
    entry, layout = b1_entry(mode, n, k, d, topology, num_frames, pop, nruns)
    if mode == "f32":
        f32_keys = f32_launch(sp, topology, pop, nruns, dev)
        scratch = alloc_scratch(f32_scratch_floats(pop, n, num_frames, nruns), dev,
                                "the f32 scratch")
        err = library().pmfm_fused_synth_fitness_f32(
            params.data_ptr(), pop, nruns, sp, dft_packed.data_ptr(), target_spectrum.data_ptr(),
            fitness.data_ptr(), scratch.data_ptr(), scratch.numel(), stream,
        )
    else:
        err = getattr(library(), entry)(params.data_ptr(), pop, nruns, sp, dft_packed.data_ptr(),
                                        target_spectrum.data_ptr(), fitness.data_ptr(), stream)
    check(err, f"fused_synth_fitness ({entry})")
    fused_synth_fitness.launches += 1
    fused_synth_fitness.launches_by[
        launch_mode(topology, dft_scale, num_frames, runs, dft_packed.dtype)] += 1
    if mode == "f32":
        fused_synth_fitness.launches_by_f32.update(f32_keys)
    else:
        fused_synth_fitness.launches_by_layout[layout] += 1
    return fitness


fused_synth_fitness.launches = 0
fused_synth_fitness.launches_by = collections.Counter()
fused_synth_fitness.launches_by_layout = collections.Counter()
fused_synth_fitness.launches_by_f32 = collections.Counter()
