"""JSON run configuration (port of ``pmfm_tpu/io/config.py``): the
reference's schema plus its ``tpu`` extension section, parsed into the
port's ``ESConfig`` field for field as the reference parses it.

Sections: ``general`` (isDebug, isAudio, outputAudioPath, isBenchmarking,
isLog), ``audio`` (sampleRate, audioLengthLog2, wavetableSize),
``evolutionary`` (numParents, numOffspring, numDimensions, paramMins,
paramMaxs, fitnessThreshold, numGenerations), ``type`` (implementation,
per-backend workgroupSize, input, params, audio) and ``tpu`` (topology,
synthesisEngine, fusedKernel, fusedGeneration, fusedEvolve, gensPerStep,
popBlock, oscMode, spectrumMethod, recombineMode, mutationNoise, minStep,
restartPatience, refineGenerations, refineStepFloor, dftDtype, sineOrder,
numBins, operandCacheDir, meshShape, meshAxisNames, solver, pursuit;
``useFitnessThreshold`` makes fitnessThreshold an early-stop criterion).
The reference module's docstring documents each key.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

from ..es.config import ESConfig
from ..ops.synthesis import TOPOLOGY_DIMS


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Everything a run reads from the JSON file."""

    es: ESConfig
    num_generations: int = 1000
    # general
    is_debug: bool = False
    is_audio: bool = True
    output_audio_path: str = "output_audio/output.wav"
    is_benchmarking: bool = True
    is_log: bool = True
    # type
    implementation: str = "TPU"
    input_mode: str = "params"  # "params" | "audio"
    input_params: tuple[float, ...] = (3078.0, 2.0, 3015.0, 1.5, 3141.0, 1.0)
    input_audio_path: str = "input_audio/input.wav"
    # tpu extensions
    mesh_shape: tuple[int, ...] = ()
    mesh_axis_names: tuple[str, ...] = ("pop",)
    # "evolve" (default) or "pursuit": the reference's staged solver for
    # fm{k}_parallel targets (not ported yet; the field is kept so that one
    # file configures either package)
    solver: str = "evolve"
    pursuit: tuple = ()  # the "tpu"."pursuit" tuning block, sorted items


def _topology_for_dims(d: int) -> str:
    for t, n in TOPOLOGY_DIMS.items():
        if n == d:
            return t
    raise ValueError(
        f"numDimensions={d} matches no topology (need one of {TOPOLOGY_DIMS})"
    )


def load_config(path: str | os.PathLike) -> RunConfig:
    with open(os.fspath(path)) as f:
        return parse_config(json.load(f))


def parse_config(j: dict[str, Any]) -> RunConfig:
    gen = j.get("general", {})
    audio = j.get("audio", {})
    evo = j.get("evolutionary", {})
    typ = j.get("type", {})
    tpu = j.get("tpu", {})

    num_dims = int(evo.get("numDimensions", 6))
    topology = tpu.get("topology") or _topology_for_dims(num_dims)

    mins = evo.get("paramMins", [0.0] * num_dims)
    maxs = evo.get("paramMaxs")
    if maxs is None:
        # the reference's struct-initialiser defaults, cycled to the
        # dimension count
        base = [3520.0, 8.0, 3520.0, 1.0]
        maxs = [base[i % 4] for i in range(num_dims)]

    es = ESConfig(
        num_parents=int(evo.get("numParents", 16)),
        num_offspring=int(evo.get("numOffspring", 16)),
        num_dimensions=num_dims,
        topology=topology,
        param_mins=tuple(float(x) for x in mins),
        param_maxs=tuple(float(x) for x in maxs),
        audio_length_log2=int(audio.get("audioLengthLog2", 10)),
        sample_rate=int(audio.get("sampleRate", 44100)),
        wavetable_size=int(audio.get("wavetableSize", 32768)),
        synthesis_engine=tpu.get("synthesisEngine", "scan"),
        fused_kernel=bool(tpu.get("fusedKernel", False)),
        fused_generation=bool(tpu.get("fusedGeneration", False)),
        fused_evolve=bool(tpu.get("fusedEvolve", False)),
        gens_per_step=int(tpu.get("gensPerStep", 1)),
        pop_block=int(tpu.get("popBlock", 512)),
        osc_mode=tpu.get("oscMode", "floor"),
        spectrum_method=tpu.get("spectrumMethod", "dft"),
        num_bins=tpu.get("numBins"),
        operand_cache_dir=tpu.get("operandCacheDir"),
        recombine_mode=tpu.get("recombineMode", "gather"),
        mutation_noise=tpu.get("mutationNoise", "clt12"),
        min_step=float(tpu.get("minStep", 0.0)),
        sine_order=int(tpu.get("sineOrder", 9)),
        restart_patience=int(tpu.get("restartPatience", 0)),
        refine_generations=int(tpu.get("refineGenerations", 0)),
        refine_step_floor=float(tpu.get("refineStepFloor", 0.01)),
        dft_dtype=tpu.get("dftDtype", "float32"),
        workgroup_size=int(
            (
                typ.get(typ.get("implementation", "OpenCL"), {})
                if isinstance(typ.get(typ.get("implementation", "OpenCL")), dict)
                else {}
            ).get("workgroupSize", 32)
        ),
        fitness_threshold=float(evo.get("fitnessThreshold", 0.0))
        if tpu.get("useFitnessThreshold", False)
        else 0.0,
    )

    params = typ.get("params", [3078.0, 2.0, 3015.0, 1.5, 3141.0, 1.0])
    return RunConfig(
        es=es,
        num_generations=int(evo.get("numGenerations", 1000)),
        is_debug=bool(gen.get("isDebug", False)),
        is_audio=bool(gen.get("isAudio", True)),
        output_audio_path=gen.get("outputAudioPath", "output_audio/output.wav"),
        is_benchmarking=bool(gen.get("isBenchmarking", True)),
        is_log=bool(gen.get("isLog", True)),
        implementation=typ.get("implementation", "TPU"),
        input_mode=typ.get("input", "params"),
        input_params=tuple(float(x) for x in params),
        input_audio_path=typ.get("audio", "input_audio/input.wav"),
        mesh_shape=tuple(int(x) for x in tpu.get("meshShape", [])),
        mesh_axis_names=tuple(tpu.get("meshAxisNames", ["pop"])),
        solver=tpu.get("solver", "evolve"),
        pursuit=tuple(sorted(dict(tpu.get("pursuit", {})).items())),
    )
