"""B4: streamed FM synthesis + Hann window, emit only (the synth_stream
route, n >= 32768).

Replaces ``pmfm_tpu/kernels/synth_stream.py::fused_synth_stream`` (the Pallas
kernel ``_stream_kernel`` over a (pop-block, time-chunk) grid, its phase
carries kept in scratch across the sequential time-chunk axis). The CUDA
kernel is ``synth_stream_kernel`` in ``csrc/large_frame.cu``; its note gives
its bound on an H100 and its design: time split across the 16 warps of a
block of 32 candidates, each warp's phase offsets found exactly level by
level (``stream_geometry`` mirrors its launch); above 32 genes the long
code's ``synth_stream_long_kernel``, a thread a candidate over the frame.
``fused_synth_stream_plain`` is its plain PyTorch version, which walks the
time axis in chunks of ``stream_chunk(n)`` samples as the TPU grid does.

Output: windowed time-major audio ``sin * amp * w[m]`` (N, P), bf16, or f32
with ``audio_f32`` (the true-f32 engine), for
``ops.spectral.magnitude_spectrum_factored(..., prewindowed=True)``.

The phase carries are the chain's own offsets (``synth_blocks_plain``, one
per oscillator of ``_chain_rows``), or for an ``fm{k}_parallel`` bank its 2k
(two a pair), each counted once; the bank's audio is the pair mean (the sum
over pairs of ``sin * amp_j`` divided by k) times the window.
"""
from __future__ import annotations

import torch

from ..ops.synthesis import topology_dims
from ..ops.wavetable import DEFAULT_SAMPLE_RATE, DEFAULT_WAVETABLE_SIZE
from .synth_fitness import (
    DEFAULT_POP_BLOCK,
    TIME_BLOCK,
    alloc_scratch,
    bank_amp,
    check_supported_topology,
    inv_sample_rate,
    long_scratch,
    resolve_pop_block,
    synth_blocks_plain,
    synth_params_struct,
    uses_long_code,
)

# time blocks per chunk of the plain version's walk (the TPU kernel's
# BLOCKS_PER_CHUNK: one grid step)
BLOCKS_PER_CHUNK = 8
STREAM_CANDIDATES = 32  # csrc: candidates (lanes) a CUDA block
STREAM_WARPS = 16  # csrc ST_WARPS: runs of time blocks (warps) a CUDA block
STREAM_SHARED_MAX = 64 * 1024  # csrc ST_SMEM_MAX: level totals in shared memory up to this


def stream_geometry(pop: int, n: int, topology: str = "fm3_series") -> dict:
    """The B4 launch for ``pop`` candidates of ``topology`` and frames of
    ``n`` (csrc ``pmfm_synth_stream``): CUDA blocks of ``STREAM_CANDIDATES``
    candidates x ``STREAM_WARPS`` warps, the time blocks a warp walks (the
    first warps' count; later warps may take one more), and where the level
    totals live, 32 x n/128 floats a block: ``shared_bytes`` of shared
    memory up to ``STREAM_SHARED_MAX``, else ``scratch_floats`` of device
    memory that the wrapper allocates. The long code (above 32 genes) runs a
    thread a candidate over the whole frame instead, one warp a block, with
    no totals (csrc ``synth_stream_long_kernel``)."""
    if uses_long_code(topology):
        return dict(blocks=-(-pop // STREAM_CANDIDATES), threads=STREAM_CANDIDATES,
                    blocks_per_warp=n // TIME_BLOCK, shared_bytes=0, scratch_floats=0)
    blocks = -(-pop // STREAM_CANDIDATES)
    tot_floats = STREAM_CANDIDATES * (n // TIME_BLOCK)
    in_smem = 4 * tot_floats <= STREAM_SHARED_MAX
    return dict(
        blocks=blocks,
        threads=32 * STREAM_WARPS,
        blocks_per_warp=(n // TIME_BLOCK) // STREAM_WARPS,
        shared_bytes=4 * tot_floats if in_smem else 0,
        scratch_floats=0 if in_smem else blocks * tot_floats,
    )


def stream_chunk(n: int, time_block: int = TIME_BLOCK) -> int:
    """Time-chunk length: ``BLOCKS_PER_CHUNK`` blocks, clipped to the frame."""
    return min(n, BLOCKS_PER_CHUNK * time_block)


def _check(params_scaled, window, topology, n):
    check_supported_topology(topology)
    d = params_scaled.shape[1]
    if d != topology_dims(topology):
        raise ValueError(f"{topology} needs {topology_dims(topology)} params, got {d}")
    if n % TIME_BLOCK:
        raise ValueError(f"n={n} must be a multiple of {TIME_BLOCK}")
    if window.dtype != torch.float32 or tuple(window.shape) != (n,) or not window.is_contiguous():
        raise ValueError(f"window must be a contiguous float32 ({n},) tensor")
    if window.device != params_scaled.device:
        raise ValueError(f"window must be on {params_scaled.device}, got {window.device}")


def fused_synth_stream_plain(
    params_scaled: torch.Tensor,
    window: torch.Tensor,
    *,
    topology: str = "fm3_series",
    n: int = 65536,
    wavetable_size: int = DEFAULT_WAVETABLE_SIZE,
    sample_rate: int = DEFAULT_SAMPLE_RATE,
    pop_block: int = DEFAULT_POP_BLOCK,
    sine_order: int = 9,
    audio_f32: bool = False,
) -> torch.Tensor:
    """The plain PyTorch version of ``fused_synth_stream``, on any device."""
    _check(params_scaled, window, topology, n)
    p = params_scaled.to(torch.float32)
    pop = p.shape[0]
    pb = resolve_pop_block(pop, pop_block)
    inv_sr = inv_sample_rate(wavetable_size, sample_rate)
    out = torch.empty((n, pop), dtype=torch.float32 if audio_f32 else torch.bfloat16,
                      device=p.device)
    tc = stream_chunk(n)
    for i in range(0, pop, pb):
        blk = p[i : i + pb]
        amp = bank_amp(blk, topology, False)
        blocks = synth_blocks_plain(blk, topology=topology, n=n, inv_sr=inv_sr,
                                    sine_order=sine_order, int8=False)
        chunk = []
        for b, y in enumerate(blocks):
            chunk.append(y * amp)
            t1 = (b + 1) * TIME_BLOCK
            if t1 % tc == 0 or t1 == n:  # a chunk is complete: window it, emit it
                t0 = t1 - len(chunk) * TIME_BLOCK
                audio = torch.cat(chunk) * window[t0:t1, None]
                out[t0:t1, i : i + pb] = audio.to(out.dtype)
                chunk = []
    return out


def fused_synth_stream(
    params_scaled: torch.Tensor,
    window: torch.Tensor,
    *,
    topology: str = "fm3_series",
    n: int = 65536,
    wavetable_size: int = DEFAULT_WAVETABLE_SIZE,
    sample_rate: int = DEFAULT_SAMPLE_RATE,
    pop_block: int = DEFAULT_POP_BLOCK,
    sine_order: int = 9,
    audio_f32: bool = False,
) -> torch.Tensor:
    """Synthesise and window the whole population (one frame).

    Returns windowed time-major audio ``(N, P)``: bf16, or f32 when
    ``audio_f32``. On CUDA tensors this launches the B4 kernel (counted in
    ``fused_synth_stream.launches``); on CPU tensors it runs the plain
    version, whose blocks ``pop_block`` sizes.
    """
    dev = params_scaled.device
    if dev.type == "cpu":
        return fused_synth_stream_plain(
            params_scaled, window, topology=topology, n=n, wavetable_size=wavetable_size,
            sample_rate=sample_rate, pop_block=pop_block, sine_order=sine_order,
            audio_f32=audio_f32,
        )
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check(params_scaled, window, topology, n)
    if window.data_ptr() % 16:
        raise ValueError("window must be 16-byte aligned (the kernel reads it in float4s)")
    from ._build import check, library

    params = params_scaled.to(torch.float32).contiguous()
    pop, d = params.shape
    out = torch.empty((n, pop), dtype=torch.float32 if audio_f32 else torch.bfloat16, device=dev)
    scratch = alloc_scratch(stream_geometry(pop, n, topology)["scratch_floats"], dev,
                            "B4's level totals")
    sp = synth_params_struct(
        topology=topology, n=n, k=0, d=d, inv_sr=inv_sample_rate(wavetable_size, sample_rate),
        dft_scale=0.0, sine_order=sine_order,
    )
    lscratch = long_scratch(sp, topology, pop, dev)  # noqa: F841 (kept until enqueued)
    err = library().pmfm_synth_stream(
        params.data_ptr(), pop, sp, window.data_ptr(), out.data_ptr(), int(audio_f32),
        scratch.data_ptr(), scratch.numel(), torch.cuda.current_stream(dev).cuda_stream,
    )
    check(err, "fused_synth_stream")
    fused_synth_stream.launches += 1
    return out


fused_synth_stream.launches = 0
