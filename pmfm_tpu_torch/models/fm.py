"""FM synthesizer model families (port of ``pmfm_tpu/models/fm.py``).

The reference ships three synthesis topologies selected by editing the kernel
name list (Evolutionary_Strategy_OpenCL.hpp:116-117); here they are
first-class model descriptors:

* ``fm2``          — 2-operator FM (kernels/ocl_program.cl:280-330)
* ``fm3_series``   — 3-operator serial chain, the benchmarked variant
                     (kernels/ocl_program.cl:332-386)
* ``fm3_parallel`` — three 2-op pairs averaged (kernels/ocl_program.cl:388-443)
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..ops import synthesis


@dataclasses.dataclass(frozen=True)
class FMTopology:
    name: str
    num_dimensions: int
    param_names: Tuple[str, ...]
    # struct-initialiser defaults (Evolutionary_Strategy.hpp:586-588) cycled
    default_param_maxs: Tuple[float, ...]
    description: str

    def synthesize(self, params_scaled: torch.Tensor, n_samples: int, **kw) -> torch.Tensor:
        """``(n_samples, pop)`` audio of ``(pop, D)`` scaled parameters
        (``ops/synthesis.py::synthesize``)."""
        return synthesis.synthesize(params_scaled, n_samples, self.name, **kw)

    @property
    def default_param_mins(self) -> Tuple[float, ...]:
        return (0.0,) * self.num_dimensions


FM2 = FMTopology(
    name="fm2",
    num_dimensions=4,
    param_names=("modFreq", "modIndex", "carrierFreq", "carrierAmp"),
    default_param_maxs=(3520.0, 8.0, 3520.0, 1.0),
    description="2-operator FM: carrier frequency-modulated by one operator",
)

FM3_SERIES = FMTopology(
    name="fm3_series",
    num_dimensions=6,
    param_names=("freq1", "index1", "freq2", "index2", "freq3", "index3"),
    default_param_maxs=(3520.0, 8.0, 3520.0, 8.0, 3520.0, 8.0),
    description="3-operator serial chain (op1 -> op2 -> op3), the reference's "
    "benchmarked DoubleSeries variant",
)

FM3_PARALLEL = FMTopology(
    name="fm3_parallel",
    num_dimensions=12,
    param_names=tuple(
        f"{p}{i}" for i in range(1, 4) for p in ("modFreq", "modIndex", "carrierFreq", "carrierAmp")
    ),
    default_param_maxs=(3520.0, 8.0, 3520.0, 1.0) * 3,
    description="three independent 2-op FM pairs, outputs averaged",
)

def series_topology(k: int) -> FMTopology:
    """Generic k-operator serial chain ``fm{k}_series`` (k >= 3): op j
    modulates op j+1; the final operator's freq*index is the output
    amplitude. k=3 is the reference DoubleSeries
    (Evolutionary_Strategy.hpp:403-449); larger k extends the same pattern —
    every engine (scan, scanless, oracle, the CUDA kernels incl. the int8
    folded DFT) dispatches on the operator count."""
    if k < 3:
        raise ValueError("series chains start at 3 operators (use fm2 below)")
    return FMTopology(
        name=f"fm{k}_series",
        num_dimensions=2 * k,
        param_names=tuple(f"{p}{i}" for i in range(1, k + 1) for p in ("freq", "index")),
        default_param_maxs=(3520.0, 8.0) * k,
        description=f"{k}-operator serial FM chain (op1 -> ... -> op{k})",
    )


def parallel_topology(k: int) -> FMTopology:
    """Generic bank of k independent 2-op pairs, outputs averaged
    (``fm{k}_parallel``, k >= 2; k=3 is the reference Triple variant,
    Evolutionary_Strategy.hpp:450-495)."""
    if k < 2:
        raise ValueError("parallel banks start at 2 pairs")
    return FMTopology(
        name=f"fm{k}_parallel",
        num_dimensions=4 * k,
        param_names=tuple(
            f"{p}{i}"
            for i in range(1, k + 1)
            for p in ("modFreq", "modIndex", "carrierFreq", "carrierAmp")
        ),
        default_param_maxs=(3520.0, 8.0, 3520.0, 1.0) * k,
        description=f"{k} independent 2-op FM pairs, outputs averaged",
    )


FM4_SERIES = series_topology(4)
FM5_SERIES = series_topology(5)

TOPOLOGIES = {
    t.name: t for t in (FM2, FM3_SERIES, FM3_PARALLEL, FM4_SERIES, FM5_SERIES)
}


def get_topology(name: str) -> FMTopology:
    if name in TOPOLOGIES:
        return TOPOLOGIES[name]
    k = synthesis.series_ops(name)
    if k is not None:
        return series_topology(k)
    k = synthesis.parallel_pairs(name)
    if k is not None:
        return parallel_topology(k)
    raise ValueError(f"unknown topology {name!r}; options {list(TOPOLOGIES)}")
