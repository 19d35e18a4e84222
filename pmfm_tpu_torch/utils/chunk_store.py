"""Per-chunk persistence for the resume of ``match_audio`` (port of
``pmfm_tpu/utils/chunk_store.py``).

Each finished chunk writes ``chunk_NNNN.npz``: the config's fingerprint,
the chunk's result (best parameters, fitness, generations, trajectory and
the port's ``refine_start_fitness``), its resynthesised audio, and the
seeds. The reference stores the PRNG key the next chunk splits from; the
port seeds chunk i with ``_chunk_seed(seed, i)`` and needs no chain, so it
stores the match's seed (``seed``) and the chunk's (``chunk_seed``). A
rerun with the same config resumes after the last chunk written, with the
stored match's seed, as the reference resumes with the stored key; a chunk
of another config ends the resume there.
"""
from __future__ import annotations

import os

import numpy as np

from ..es.config import ESConfig
from .checkpoint import config_fingerprint


def _chunk_path(directory: str, i: int) -> str:
    return os.path.join(directory, f"chunk_{i:04d}.npz")


def save_chunk(directory, cfg: ESConfig, i: int, result, audio: np.ndarray, seed: int,
               chunk_seed: int) -> None:
    """Write chunk ``i``'s ``result`` (a ``ChunkResult``) and ``audio``
    atomically, with the match's ``seed`` and the chunk's ``chunk_seed``."""
    directory = os.fspath(directory)
    os.makedirs(directory, exist_ok=True)
    path = _chunk_path(directory, i)
    tmp = path + ".tmp.npz"
    empty = np.zeros(0, np.float32)
    np.savez(
        tmp,
        fingerprint=np.bytes_(config_fingerprint(cfg).encode()),
        best_params_scaled=result.best_params_scaled,
        best_params_norm=result.best_params_norm,
        best_fitness=np.float32(result.best_fitness),
        generations_run=np.int64(result.generations_run),
        trajectory=result.trajectory if result.trajectory is not None else empty,
        refine_start_fitness=(empty if result.refine_start_fitness is None
                              else np.float32(result.refine_start_fitness)),
        audio=audio,
        seed=np.int64(seed),
        chunk_seed=np.int64(chunk_seed),
    )
    os.replace(tmp, path)


def resume(directory, cfg: ESConfig, seed: int):
    """``(start_chunk, results, out_audio, seed)`` from the chunks saved in
    ``directory``: the chunks of ``cfg`` from 0 on, and the seed the run
    goes on with (the stored match's, else ``seed``)."""
    from ..es.pipeline import ChunkResult  # local: pipeline imports this module

    directory = os.fspath(directory)
    fp = config_fingerprint(cfg)
    results, out_audio = [], []
    i = 0
    while os.path.exists(_chunk_path(directory, i)):
        with np.load(_chunk_path(directory, i), allow_pickle=False) as z:
            if z["fingerprint"].item().decode() != fp or "chunk_seed" not in z:
                break  # another config (or the reference's chunk): start again from here
            traj, start = z["trajectory"], z["refine_start_fitness"]
            results.append(ChunkResult(
                best_params_scaled=z["best_params_scaled"],
                best_params_norm=z["best_params_norm"],
                best_fitness=float(z["best_fitness"]),
                generations_run=int(z["generations_run"]),
                trajectory=None if traj.size == 0 else traj,
                refine_start_fitness=None if start.size == 0 else float(start),
            ))
            out_audio.append(z["audio"])
            seed = int(z["seed"])
        i += 1
    return i, results, out_audio, seed
