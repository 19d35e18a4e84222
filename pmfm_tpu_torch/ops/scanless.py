"""Scanless FM synthesis: the phase recurrences as blocked prefix sums (port
of ``pmfm_tpu/ops/scanless.py``).

Every oscillator's phase is an exclusive prefix sum of the previous
oscillator's output,

    pos1[t] = t * inc1
    pos2[t] = w2sr * sum_{s<t} cur1[s]
    pos3[t] = w2sr * sum_{s<t} cur2[s]

so the synthesis is a few rounds of (elementwise sine -> prefix sum over
time), parallel across time and population. The prefix sum is two-level:
a strictly-lower-triangular (C, C) matrix product inside each block of C
samples, then the block sums' own exclusive prefix. Every contribution is
reduced modulo the wavetable size first, so the intermediates stay below
~C * WTS and the float32 phase error stays bounded at any length.

The oscillator is ``sin(2 pi pos / WTS)``, for which the wrap is the
identity: the intended FM synthesis, a period WTS/(WTS-1) from the
reference's table lookup (its module docstring has the details). The large
frame configs synthesise their target and resynthesise their best candidate
this way; the population itself goes through the kernels.
"""
from __future__ import annotations

import math

import torch

from ..device import exact_f32_matmul
from .synthesis import parallel_pairs, series_ops
from .wavetable import DEFAULT_SAMPLE_RATE, DEFAULT_WAVETABLE_SIZE


def _tri(n: int, device) -> torch.Tensor:
    """Strictly-lower-triangular ones (exclusive-prefix matrix)."""
    return torch.tril(torch.ones((n, n), dtype=torch.float32, device=device), diagonal=-1)


def _mod(x: torch.Tensor, m: float) -> torch.Tensor:
    """``x mod m`` in [0, m) for m > 0, as ``jnp.mod``: an exact fmod, then
    ``+ m`` where it is negative."""
    r = torch.fmod(x, m)
    return torch.where(r < 0, r + m, r)


def exclusive_cumsum_mod(x: torch.Tensor, modulus: float, block: int = 128) -> torch.Tensor:
    """Exclusive prefix sum along axis 0 of time-major ``(N, P)``, valid
    modulo ``modulus``; result in ``[0, modulus)``.

    Per element: reduce mod m; inside a block: a (C, C) strictly triangular
    product; across blocks: the block sums mod m, their exclusive prefix, a
    broadcast. The products run in float32 with TF32 off (the reference's
    ``Precision.HIGHEST``).
    """
    n, p = x.shape
    if n % block:
        block = math.gcd(n, block) or 1
    nb = n // block
    m = float(torch.tensor(modulus, dtype=torch.float32))
    xm = _mod(x, m)
    xb = xm.reshape(nb, block, p)
    with exact_f32_matmul():
        intra = torch.matmul(_tri(block, x.device), xb)  # (nb, C, P), < C*m
        sums = _mod(torch.sum(xb, dim=1), m)  # (nb, P), < m
        offsets = _tri(nb, x.device) @ sums  # (nb, P), < nb*m
    return _mod(intra + offsets[:, None, :], m).reshape(n, p)


def synthesize_scanless(
    params_scaled: torch.Tensor,
    n_samples: int,
    topology: str = "fm3_series",
    *,
    wavetable_size: int = DEFAULT_WAVETABLE_SIZE,
    sample_rate: int = DEFAULT_SAMPLE_RATE,
    cumsum_block: int = 128,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Batched FM synthesis without a serial loop. Returns ``(N, pop)``."""
    p = params_scaled.to(torch.float32)
    pop = p.shape[0]
    f32 = lambda v: float(torch.tensor(v, dtype=torch.float32))  # noqa: E731
    w2sr = f32(wavetable_size / float(sample_rate))
    omega = f32(2.0 * math.pi / wavetable_size)
    wts = f32(wavetable_size)
    t = torch.arange(n_samples, dtype=torch.float32, device=p.device)[:, None]

    def osc(pos):  # pos already in [0, wts)
        return torch.sin(omega * pos)

    def cumsum(x):
        return exclusive_cumsum_mod(x, wavetable_size, cumsum_block)

    def two_op(modf, modi, cf, amp):
        m = modf * modi
        pos1 = _mod(t * _mod(w2sr * modf, wts)[None, :], wts)
        cur = osc(pos1) * m[None, :] + cf[None, :]
        pos2 = cumsum(w2sr * cur)
        return osc(pos2) * amp[None, :]

    if topology == "fm2":
        return two_op(p[:, 0], p[:, 1], p[:, 2], p[:, 3]).to(out_dtype)

    kn = series_ops(topology)
    if kn:
        ms = [p[:, 2 * j] * p[:, 2 * j + 1] for j in range(kn)]
        cs = [p[:, 2 * j + 3] for j in range(kn - 1)]
        pos = _mod(t * _mod(w2sr * p[:, 1], wts)[None, :], wts)
        cur = osc(pos) * ms[0][None, :] + cs[0][None, :]
        for j in range(1, kn - 1):
            pos = cumsum(w2sr * cur)
            cur = osc(pos) * ms[j][None, :] + cs[j][None, :]
        pos = cumsum(w2sr * cur)
        return (osc(pos) * ms[kn - 1][None, :]).to(out_dtype)

    kp = parallel_pairs(topology)
    if kp:
        p4 = p.reshape(pop, kp, 4)
        outs = [two_op(p4[:, j, 0], p4[:, j, 1], p4[:, j, 2], p4[:, j, 3]) for j in range(kp)]
        return (sum(outs) / float(kp)).to(out_dtype)

    raise ValueError(f"unknown topology {topology!r}")
