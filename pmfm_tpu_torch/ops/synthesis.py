"""FM synthesis topologies (port of ``pmfm_tpu/ops/synthesis.py``).

Each candidate runs a sequential per-sample phase recurrence; the population
is the batch axis. Audio is time-major ``(n_samples, pop)``.

* ``fm2`` — 2-operator FM, 4 params ``[modFreq, modIdx, carrierFreq, amp]``
* ``fm{k}_series`` — k-operator serial chain (k >= 3), 2k params; op j's
  output modulates op j+1's phase, the last operator's freq*index is the
  amplitude (k = 3 is the reference DoubleSeries)
* ``fm{k}_parallel`` — k independent 2-op pairs averaged (k >= 2), 4k params

Two engines: ``scan``, the sequential recurrence (the reference's bit-parity
path, a Python loop over samples), and ``scanless`` (``ops/scanless.py``),
the blocked prefix-sum form that the large-frame configs use for their
target and their resynthesised best candidate.
"""
from __future__ import annotations

import re

import torch

from .wavetable import (
    DEFAULT_SAMPLE_RATE,
    DEFAULT_WAVETABLE_SIZE,
    make_osc,
    wrap_pos,
    wrap_pos_both,
)

TOPOLOGY_DIMS = {"fm2": 4, "fm3_series": 6, "fm3_parallel": 12}
_SERIES_RE = re.compile(r"^fm(\d+)_series$")
_PARALLEL_RE = re.compile(r"^fm(\d+)_parallel$")


def parallel_pairs(topology: str):
    """Pair count k of ``fm{k}_parallel`` (k >= 2), else None."""
    m = _PARALLEL_RE.match(topology)
    if m and int(m.group(1)) >= 2:
        return int(m.group(1))
    return None


def series_ops(topology: str):
    """Operator count k of ``fm{k}_series`` (k >= 3), else None."""
    m = _SERIES_RE.match(topology)
    if m and int(m.group(1)) >= 3:
        return int(m.group(1))
    return None


def topology_dims(topology: str) -> int:
    """Parameter count for any supported topology (2 per series operator)."""
    if topology in TOPOLOGY_DIMS:
        return TOPOLOGY_DIMS[topology]
    k = series_ops(topology)
    if k is not None:
        return 2 * k
    k = parallel_pairs(topology)
    if k is not None:
        return 4 * k
    raise ValueError(
        f"unknown topology {topology!r}; options {list(TOPOLOGY_DIMS)} "
        f"or 'fm<k>_series' (k >= 3) / 'fm<k>_parallel' (k >= 2)"
    )


def scale_params(values: torch.Tensor, mins: torch.Tensor, maxs: torch.Tensor) -> torch.Tensor:
    """Map normalised genes in [0, 1] to synthesis parameter ranges."""
    return mins + values * (maxs - mins)


def synthesize(
    params_scaled: torch.Tensor,
    n_samples: int,
    topology: str = "fm3_series",
    *,
    wavetable_size: int = DEFAULT_WAVETABLE_SIZE,
    sample_rate: int = DEFAULT_SAMPLE_RATE,
    osc_mode: str = "floor",
    wavetable: torch.Tensor | None = None,
    engine: str = "scan",
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Batched FM synthesis of ``(pop, dims)`` scaled parameters into
    ``(n_samples, pop)`` audio: by the sequential recurrence (``engine="scan"``)
    or the blocked prefix sums of ``ops/scanless.py`` (``"scanless"``, which
    ignores ``osc_mode`` and ``wavetable``)."""
    want = topology_dims(topology)
    if params_scaled.shape[-1] != want:
        raise ValueError(f"topology {topology} needs {want} dims, got {params_scaled.shape[-1]}")
    if engine == "scanless":
        from .scanless import synthesize_scanless

        return synthesize_scanless(
            params_scaled, n_samples, topology, wavetable_size=wavetable_size,
            sample_rate=sample_rate, out_dtype=out_dtype,
        )
    if engine != "scan":
        raise ValueError(f"engine must be 'scan' or 'scanless', got {engine!r}")
    p = params_scaled.to(torch.float32)
    osc = make_osc(osc_mode, wavetable_size, wavetable)
    w2sr = float(torch.tensor(wavetable_size / float(sample_rate), dtype=torch.float32))
    size = float(wavetable_size)
    pop = p.shape[0]
    zeros = torch.zeros((pop,), dtype=torch.float32, device=p.device)

    if topology == "fm2":
        mod_depth = p[:, 0] * p[:, 1]
        carrier_freq = p[:, 2]
        amp = p[:, 3]
        inc1 = w2sr * p[:, 0]

        def step(carry):
            pos1, pos2 = carry
            cur = osc(pos1) * mod_depth + carrier_freq
            pos1 = wrap_pos(pos1 + inc1, size)
            out = osc(pos2) * amp
            pos2 = wrap_pos_both(pos2 + w2sr * cur, size)
            return (pos1, pos2), out

        carry = (zeros, zeros)
    elif series_ops(topology):
        kn = series_ops(topology)
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
        kp = parallel_pairs(topology)
        p4 = p.reshape(pop, kp, 4)
        mod_depth = p4[:, :, 0] * p4[:, :, 1]
        carrier_freq = p4[:, :, 2]
        amp = p4[:, :, 3]
        inc1 = w2sr * p4[:, :, 0]
        zerosk = torch.zeros((pop, kp), dtype=torch.float32, device=p.device)

        def step(carry):
            pos1, pos2 = carry
            cur = osc(pos1) * mod_depth + carrier_freq
            pos1 = wrap_pos(pos1 + inc1, size)
            outs = osc(pos2) * amp
            pos2 = wrap_pos_both(pos2 + w2sr * cur, size)
            return (pos1, pos2), outs.mean(dim=-1)

        carry = (zerosk, zerosk)

    audio = torch.empty((n_samples, pop), dtype=torch.float32, device=p.device)
    for t in range(n_samples):
        carry, audio[t] = step(carry)
    return audio.to(out_dtype)


def synthesize_single(
    params_scaled: torch.Tensor, n_samples: int, topology: str = "fm3_series", **kw
) -> torch.Tensor:
    """Synthesize one candidate; returns ``(n_samples,)``."""
    return synthesize(params_scaled[None, :], n_samples, topology, **kw)[:, 0]
