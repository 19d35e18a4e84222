"""FM synthesis topologies (port of ``pmfm_tpu/ops/synthesis.py``).

Each candidate runs a sequential per-sample phase recurrence; the population
is the batch axis. Audio is time-major ``(n_samples, pop)``.

* ``fm2`` — 2-operator FM, 4 params ``[modFreq, modIdx, carrierFreq, amp]``
* ``fm{k}_series`` — k-operator serial chain (k >= 3), 2k params; op j's
  output modulates op j+1's phase, the last operator's freq*index is the
  amplitude (k = 3 is the reference DoubleSeries)
* ``fm{k}_parallel`` — k independent 2-op pairs averaged (k >= 2), 4k params

Two engines: ``scan``, the sequential recurrence (the reference's bit-parity
path: ``kernels/scan.py``, a CUDA kernel on the card and its plain
loop over samples on the CPU), and ``scanless`` (``ops/scanless.py``), the
blocked prefix-sum form that the large-frame configs use for their target
and their resynthesised best candidate.
"""
from __future__ import annotations

import re

import torch

from .wavetable import DEFAULT_SAMPLE_RATE, DEFAULT_WAVETABLE_SIZE

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
    ``(n_samples, pop)`` audio: by the sequential recurrence (``engine="scan"``,
    ``kernels/scan.py::scan_synth``) or the blocked prefix sums of
    ``ops/scanless.py`` (``"scanless"``, which ignores ``osc_mode`` and
    ``wavetable``)."""
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
    from ..kernels.scan import scan_synth

    return scan_synth(
        params_scaled, n_samples, topology, wavetable_size=wavetable_size,
        sample_rate=sample_rate, osc_mode=osc_mode, wavetable=wavetable, out_dtype=out_dtype,
    )


def synthesize_single(
    params_scaled: torch.Tensor, n_samples: int, topology: str = "fm3_series", **kw
) -> torch.Tensor:
    """Synthesize one candidate; returns ``(n_samples,)``."""
    return synthesize(params_scaled[None, :], n_samples, topology, **kw)[:, 0]
