"""The scan synthesis: the sequential per-sample phase recurrence of the
unfused engines (``ops/synthesis.py::synthesize`` with ``engine="scan"``).

The reference runs this recurrence as one XLA ``lax.scan``
(``pmfm_tpu/ops/synthesis.py::synthesize``); no Pallas kernel corresponds to
it. On CUDA tensors ``scan_synth`` launches ``csrc/scan_synth.cu``'s kernel
(one thread a candidate, counted in ``scan_synth.launches``); on CPU tensors
it runs ``scan_synth_plain``, a PyTorch loop over samples, which the kernel
reproduces bit for bit: every f32 operation in the loop's order, ``sinf``
for ``torch.sin``, and fm{k}_parallel's pair outputs added in pair order and
multiplied by the float32 ``1/k``.

Audio is time-major ``(n_samples, pop)``, float32 or bfloat16.
"""
from __future__ import annotations

import collections
import functools
import math

import numpy as np
import torch

from ..ops.wavetable import (
    DEFAULT_SAMPLE_RATE,
    DEFAULT_WAVETABLE_SIZE,
    OSC_MODES,
    build_wavetable,
    make_osc,
    wrap_pos,
    wrap_pos_both,
)
from .synth_fitness import SMS

SCAN_THREADS = 128  # csrc SCAN_TPB: candidates (threads) per block
# chains with a compile-time instantiation (csrc dispatch_topo's SCAN_CASE);
# any other length reads it at run time, its state in a scratch
SCAN_FIXED = {"fm2": (1,), "series": (3, 4, 5, 6, 7, 8), "parallel": (2, 3, 4)}
_TOPO_KIND = {"fm2": 0, "series": 1, "parallel": 2}  # csrc ScanTopo
# the time-parallel layout (csrc scan_synth_tp_kernel)
SCAN_TP_CHUNK = 64  # samples a chunk
SCAN_TP_MAX_LANES = 32  # (candidate, level) walks a block: warp 0's lanes
# warps a block: warp 0 for the walks, the rest for the sines (at P 256-8192
# eight were within 6% of the fastest count swept at the groups this module
# takes, and up to 1.4x faster than two on fm8_series: PERF.md §6)
SCAN_TP_WARPS = 8
# scan_tp_faster's constant, from both layouts' times on an NVIDIA H100 80GB
# HBM3 (PERF.md §6; tools/torch_scan_b1_probe.py's scan sweep): one-thread
# blocks of SCAN_THREADS up to which the time-parallel layout is the faster
SCAN_TP_MAX_BLOCKS = SMS // 2


def _chain(topology: str):
    """``("fm2", 1)``, ``("series", k)`` or ``("parallel", k)``."""
    from ..ops.synthesis import parallel_pairs, series_ops

    if topology == "fm2":
        return "fm2", 1
    k = series_ops(topology)
    if k is not None:
        return "series", k
    k = parallel_pairs(topology)
    if k is not None:
        return "parallel", k
    raise ValueError(f"unknown topology {topology!r}")


def scan_constants(wavetable_size: int, sample_rate: int) -> dict:
    """The float32 constants of the recurrence: ``w2sr`` (wavetable size /
    sample rate), ``size`` and the oscillator's ``scale`` 2 pi / (size - 1)."""
    return dict(
        w2sr=float(np.float32(wavetable_size / float(sample_rate))),
        size=float(wavetable_size),
        scale=float(np.float32(2.0 * math.pi / (wavetable_size - 1.0))),
    )


def scan_levels(topology: str) -> int:
    """The serial position recurrences a candidate's synthesis has: a chain
    of k oscillators k, a bank of k pairs 2 k, fm2 2."""
    kind, k = _chain(topology)
    return k if kind == "series" else 2 * k


def scan_tp_takes(topology: str) -> bool:
    """Whether the time-parallel kernel takes the chain: at most
    ``SCAN_TP_MAX_LANES`` levels (a candidate's walks on warp 0's lanes);
    longer chains (above fm32_series, fm16_parallel) run one thread a
    candidate."""
    return scan_levels(topology) <= SCAN_TP_MAX_LANES


def scan_tp_group(pop: int, topology: str) -> int:
    """Candidates a time-parallel block: one while the grid has at most two
    blocks an SM, else as many as keep it at two an SM, at most
    ``SCAN_TP_MAX_LANES`` // levels (warp 0's lanes)."""
    return max(1, min(SCAN_TP_MAX_LANES // scan_levels(topology), pop // (2 * SMS)))


def scan_tp_smem(lanes: int) -> int:
    """Dynamic shared memory of a time-parallel block of ``lanes`` walks
    (csrc ``scan_tp_smem``): positions and increments of two chunks, rows of
    ``lanes | 1`` floats, and two constants a walk."""
    return (4 * SCAN_TP_CHUNK * (lanes | 1) + 2 * lanes) * 4


def scan_tp_faster(pop: int) -> bool:
    """The rule by which the scan takes the time-parallel layout where its
    kernel takes the chain, from both layouts' times on an H100 (PERF.md §6,
    the scan sweep of tools/torch_scan_b1_probe.py). The one-thread layout's
    time is one thread's walk of n samples, flat in the population while its
    grid leaves SMs idle; the time-parallel one walks a level a lane, about
    n x one add-and-wrap, but spends more instructions a candidate, so its
    time grows with the population. It won at every chain and n swept up to
    P 8192 (one-thread blocks on half the SMs) and lost at P 2^15: it is
    taken while the one-thread grid has at most ``SCAN_TP_MAX_BLOCKS``
    blocks, whatever n and the chain. Past that the crossover depends on
    the chain (P ~8.5k at fm8_series, ~15k at fm3_parallel), so the rule
    gives up some wins there and takes no loss at a swept point."""
    return -(-pop // SCAN_THREADS) <= SCAN_TP_MAX_BLOCKS


def scan_time_parallel(pop: int, topology: str) -> bool:
    """Whether the scan takes its time-parallel layout for ``pop``
    candidates of ``topology``, at any n: where the kernel takes the chain
    (``scan_tp_takes``) and the card's rule says it is the faster
    (``scan_tp_faster``)."""
    return scan_tp_takes(topology) and scan_tp_faster(pop)


def scan_launch(pop: int, n: int, topology: str, osc_mode: str, out_dtype: torch.dtype, *,
                wavetable_size: int = DEFAULT_WAVETABLE_SIZE,
                sample_rate: int = DEFAULT_SAMPLE_RATE) -> dict:
    """The kernel's launch: ``layout`` (``"time_parallel"`` where
    ``scan_time_parallel`` says, else ``"one_thread"``), ``grid``, ``block``
    and ``smem`` (dynamic shared memory bytes), ``group`` (candidates a
    time-parallel block, ``scan_tp_group``; 1 a thread otherwise) and
    ``warps`` (``SCAN_TP_WARPS``; one thread a candidate: 4), the topology
    kind and chain length, the oscillator and output codes and
    ``ScanParams``' values, and ``state_floats``, the one-thread kernel's
    scratch for a chain of any other length than the compile-time ones
    (``SCAN_FIXED``: above fm8_series and fm4_parallel it keeps each
    candidate's state there, csrc ``scan_state_floats``), 0 for those and
    for the time-parallel layout."""
    kind, k = _chain(topology)
    if osc_mode not in OSC_MODES:
        raise ValueError(f"osc_mode must be one of {OSC_MODES}, got {osc_mode!r}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    c = scan_constants(wavetable_size, sample_rate)
    if scan_time_parallel(pop, topology):
        group = scan_tp_group(pop, topology)
        lanes = group * scan_levels(topology)
        geometry = dict(layout="time_parallel", grid=-(-pop // group), block=32 * SCAN_TP_WARPS,
                        smem=scan_tp_smem(lanes), group=group, warps=SCAN_TP_WARPS,
                        state_floats=0)
    else:
        geometry = dict(layout="one_thread", grid=-(-pop // SCAN_THREADS), block=SCAN_THREADS,
                        smem=0, group=1, warps=SCAN_THREADS // 32,
                        state_floats=0 if k in SCAN_FIXED[kind]
                        else (3 if kind == "series" else 6) * k * pop)
    return dict(
        geometry, topo=_TOPO_KIND[kind], k=k,
        osc=OSC_MODES.index(osc_mode), bf16=int(out_dtype == torch.bfloat16),
        n=n, pop=pop, inv_k=float(np.float32(1.0 / k)), table_max=wavetable_size - 1,
        **c,
    )


def scan_synth_plain(
    params_scaled: torch.Tensor,
    n_samples: int,
    topology: str = "fm3_series",
    *,
    wavetable_size: int = DEFAULT_WAVETABLE_SIZE,
    sample_rate: int = DEFAULT_SAMPLE_RATE,
    osc_mode: str = "floor",
    wavetable: torch.Tensor | None = None,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The plain PyTorch version: the recurrence as a loop over samples."""
    p = params_scaled.to(torch.float32)
    osc = make_osc(osc_mode, wavetable_size, wavetable)
    c = scan_constants(wavetable_size, sample_rate)
    w2sr, size = c["w2sr"], c["size"]
    pop = p.shape[0]
    kind, kc = _chain(topology)
    zeros = torch.zeros((pop,), dtype=torch.float32, device=p.device)

    if kind == "series":
        kn = kc
        ms = [p[:, 2 * j] * p[:, 2 * j + 1] for j in range(kn)]
        cs = [p[:, 2 * j + 3] for j in range(kn - 1)]
        inc1 = w2sr * p[:, 1]

        def step(carry):
            poss = list(carry)
            cur = osc(poss[0]) * ms[0] + cs[0]
            news = [wrap_pos(poss[0] + inc1, size)]
            for j in range(1, kn - 1):
                nxt_cur = osc(poss[j]) * ms[j] + cs[j]
                news.append(wrap_pos_both(poss[j] + w2sr * cur, size))
                cur = nxt_cur
            out = osc(poss[kn - 1]) * ms[kn - 1]
            news.append(wrap_pos_both(poss[kn - 1] + w2sr * cur, size))
            return tuple(news), out

        carry = tuple(zeros for _ in range(kn))
    else:
        kp = kc
        p4 = p.reshape(pop, kp, 4)
        mod_depth = p4[:, :, 0] * p4[:, :, 1]
        carrier_freq = p4[:, :, 2]
        amp = p4[:, :, 3]
        inc1 = w2sr * p4[:, :, 0]
        zerosk = torch.zeros((pop, kp), dtype=torch.float32, device=p.device)
        inv_k = float(np.float32(1.0 / kp))

        def step(carry):
            pos1, pos2 = carry
            cur = osc(pos1) * mod_depth + carrier_freq
            pos1 = wrap_pos(pos1 + inc1, size)
            outs = osc(pos2) * amp
            pos2 = wrap_pos_both(pos2 + w2sr * cur, size)
            out = outs[:, 0]
            for j in range(1, kp):  # pair order, then the float32 1/k
                out = out + outs[:, j]
            return (pos1, pos2), (out * inv_k if kind == "parallel" else out)

        carry = (zerosk, zerosk)

    audio = torch.empty((n_samples, pop), dtype=torch.float32, device=p.device)
    for t in range(n_samples):
        carry, audio[t] = step(carry)
    return audio.to(out_dtype)


@functools.lru_cache(maxsize=None)
def _device_table(size: int, device: str) -> torch.Tensor:
    return torch.from_numpy(build_wavetable(size)).to(device)


def scan_synth(
    params_scaled: torch.Tensor,
    n_samples: int,
    topology: str = "fm3_series",
    *,
    wavetable_size: int = DEFAULT_WAVETABLE_SIZE,
    sample_rate: int = DEFAULT_SAMPLE_RATE,
    osc_mode: str = "floor",
    wavetable: torch.Tensor | None = None,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """``(n_samples, pop)`` audio of scaled params ``(pop, D)``: the scan
    kernel on CUDA tensors, ``scan_synth_plain`` on CPU tensors."""
    dev = params_scaled.device
    if dev.type == "cpu":
        return scan_synth_plain(
            params_scaled, n_samples, topology, wavetable_size=wavetable_size,
            sample_rate=sample_rate, osc_mode=osc_mode, wavetable=wavetable, out_dtype=out_dtype,
        )
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from ._build import ScanParams, check, library
    from .synth_fitness import alloc_scratch

    params = params_scaled.to(torch.float32).contiguous()
    pop = params.shape[0]
    la = scan_launch(pop, n_samples, topology, osc_mode, out_dtype,
                     wavetable_size=wavetable_size, sample_rate=sample_rate)
    table = None
    if osc_mode == "table":
        table = wavetable if wavetable is not None else _device_table(wavetable_size, str(dev))
        table = table.to(device=dev, dtype=torch.float32).contiguous()
        if table.numel() != wavetable_size:
            raise ValueError(f"wavetable must hold {wavetable_size} entries, got {table.numel()}")
    out = torch.empty((n_samples, pop), dtype=out_dtype, device=dev)
    sp = ScanParams(n=n_samples, pop=pop, k=la["k"], w2sr=la["w2sr"], size=la["size"],
                    scale=la["scale"], inv_k=la["inv_k"], table_max=la["table_max"])
    table_ptr = None if table is None else table.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if la["layout"] == "time_parallel":
        err = library().pmfm_scan_synth_tp(
            params.data_ptr(), la["topo"], la["osc"], la["bf16"], sp, table_ptr, la["group"],
            la["warps"], out.data_ptr(), stream)
    else:
        state = alloc_scratch(la["state_floats"], dev, f"{topology}'s scan state")
        err = library().pmfm_scan_synth(
            params.data_ptr(), la["topo"], la["osc"], la["bf16"], sp, table_ptr,
            state.data_ptr(), state.numel(), out.data_ptr(), stream)
    check(err, f"scan_synth ({la['layout']})")
    scan_synth.launches += 1
    scan_synth.launches_by_layout[la["layout"]] += 1
    return out


scan_synth.launches = 0
scan_synth.launches_by_layout = collections.Counter()

CHAIN_PROBE_STEPS = 1 << 20
CHAIN_PROBE_INCREMENTS = (1234.5, -321.25, 2048.75, 7.125, -2999.5, 16000.25, 0.5, -8.75)


def chain_floor_ms(n: int, device, wavetable_size: int = DEFAULT_WAVETABLE_SIZE) -> float:
    """The scan's serial floor at ``n`` samples on the card: n x the latency
    of one level's add-and-wrap, timed on a single thread's bare chain of
    ``CHAIN_PROBE_STEPS`` steps (csrc ``scan_chain_probe_kernel``; CUDA
    events, after one warm-up launch). A measurement, not a path: nothing
    counts it."""
    from ._build import check, library

    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the chain floor is measured on a card, got {dev}")
    d = torch.tensor(CHAIN_PROBE_INCREMENTS, dtype=torch.float32, device=dev)
    out = torch.empty(1, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    launch = lambda: check(library().pmfm_scan_chain_probe(  # noqa: E731
        d.data_ptr(), CHAIN_PROBE_STEPS, float(wavetable_size), out.data_ptr(), stream),
        "scan_chain_probe")
    launch()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    launch()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / CHAIN_PROBE_STEPS * n
