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

SCAN_THREADS = 128  # csrc SCAN_TPB: candidates (threads) per block
SCAN_MAX_K = 32  # csrc SCAN_MAX_K: the longest chain (oscillators or pairs) the kernel takes
_TOPO_KIND = {"fm2": 0, "series": 1, "parallel": 2}  # csrc ScanTopo


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


def scan_launch(pop: int, n: int, topology: str, osc_mode: str, out_dtype: torch.dtype, *,
                wavetable_size: int = DEFAULT_WAVETABLE_SIZE,
                sample_rate: int = DEFAULT_SAMPLE_RATE) -> dict:
    """The kernel's launch: ``grid`` and ``block``, the topology kind and
    chain length, the oscillator and output codes and ``ScanParams``'
    values. Chains of up to ``SCAN_MAX_K`` oscillators or pairs (the kernel
    keeps their state in local memory above fm8_series and fm4_parallel)."""
    kind, k = _chain(topology)
    if k > SCAN_MAX_K:
        raise ValueError(f"{topology}: the scan kernel takes chains of up to {SCAN_MAX_K}")
    if osc_mode not in OSC_MODES:
        raise ValueError(f"osc_mode must be one of {OSC_MODES}, got {osc_mode!r}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    c = scan_constants(wavetable_size, sample_rate)
    return dict(
        grid=-(-pop // SCAN_THREADS), block=SCAN_THREADS, topo=_TOPO_KIND[kind], k=k,
        osc=OSC_MODES.index(osc_mode), bf16=int(out_dtype == torch.bfloat16),
        n=n, pop=pop, inv_k=float(np.float32(1.0 / k)), table_max=wavetable_size - 1, **c,
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
    err = library().pmfm_scan_synth(
        params.data_ptr(), la["topo"], la["osc"], la["bf16"], sp,
        None if table is None else table.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check(err, "scan_synth")
    scan_synth.launches += 1
    return out


scan_synth.launches = 0
