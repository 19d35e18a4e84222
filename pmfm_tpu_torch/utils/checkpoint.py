"""Checkpoint and resume of the ES state (port of
``pmfm_tpu/utils/checkpoint.py``).

Format: one ``.npz`` a tag (``{tag}.npz``, written to ``{tag}.npz.tmp.npz``
and moved into place with ``os.replace``) holding ``chunk_index``, the
config's ``fingerprint``, an optional ``trajectory`` (the best-ever fitness
after each generation so far) and every ``ESState`` field as
``state_{field}``. The port's state differs from the reference's in its
host fields: ``seed`` and ``generation`` are host integers (one a run with
the run axis) and ``generator`` is a ``torch.Generator``, saved as its
``get_state()`` bytes (one row a run), where the reference keeps a PRNG key
and an int32 generation. A checkpoint of the reference's (``state_key``, no
``state_seed``) therefore loads as ``None``, as one of another config does.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np
import torch

from ..device import resolve_device
from ..es.config import ESConfig
from ..es.strategy import ESState

_TENSORS = ("parent_values", "parent_steps", "parent_fitness", "best_values", "best_fitness",
            "stall")


def config_fingerprint(cfg: ESConfig) -> str:
    """16 hex digits of the sha256 of the config's fields, as the reference
    computes them (the two configs have the same fields and defaults, so
    one config has one fingerprint in both packages)."""
    payload = json.dumps(dataclasses.asdict(cfg), sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def save_checkpoint(
    directory: str | os.PathLike,
    state: ESState,
    cfg: ESConfig,
    chunk_index: int,
    tag: str = "latest",
    trajectory: np.ndarray | None = None,
) -> str:
    """Write ``state`` (and ``trajectory``, where given) to
    ``directory/{tag}.npz`` atomically; returns the path."""
    directory = os.fspath(directory)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{tag}.npz")
    tmp = path + ".tmp.npz"  # the .npz suffix keeps np.savez from renaming it
    arrays = {f"state_{k}": getattr(state, k).cpu().numpy() for k in _TENSORS}
    runs = isinstance(state.seed, tuple)
    gens = state.generator if runs else (state.generator,)
    arrays["state_seed"] = np.asarray(state.seed, np.int64)
    arrays["state_generation"] = np.asarray(state.generation, np.int64)
    words = np.stack([g.get_state().numpy() for g in gens])
    arrays["state_generator"] = words if runs else words[0]
    if trajectory is not None:
        arrays["trajectory"] = np.asarray(trajectory, np.float32)
    np.savez(
        tmp,
        chunk_index=np.int64(chunk_index),
        fingerprint=np.bytes_(config_fingerprint(cfg).encode()),
        **arrays,
    )
    os.replace(tmp, path)
    return path


def _generator(words: np.ndarray, dev: torch.device) -> torch.Generator:
    gen = torch.Generator(device=dev)
    state = torch.from_numpy(np.ascontiguousarray(words, np.uint8))
    if state.numel() != gen.get_state().numel():
        raise ValueError(f"checkpoint's generator state ({state.numel()} bytes) is not one of a "
                         f"{dev.type} generator ({gen.get_state().numel()} bytes)")
    gen.set_state(state)
    return gen


def load_checkpoint(
    directory: str | os.PathLike,
    cfg: ESConfig,
    tag: str = "latest",
    *,
    device: str | torch.device = "cuda",
) -> tuple[ESState, int, np.ndarray | None] | None:
    """``(state, chunk_index, trajectory or None)`` with the state's tensors
    and generator on ``device``, or None where the checkpoint is absent,
    was written for another config, or is not one of this package's."""
    path = os.path.join(os.fspath(directory), f"{tag}.npz")
    if not os.path.exists(path):
        return None
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        if z["fingerprint"].item().decode() != config_fingerprint(cfg):
            return None
        if "state_seed" not in z or "state_generator" not in z:
            return None  # the reference's: a PRNG key in place of seed and generator
        tensors = {k: torch.from_numpy(z[f"state_{k}"]).to(dev) for k in _TENSORS}
        seed, generation, words = z["state_seed"], z["state_generation"], z["state_generator"]
        if seed.ndim:  # a state of runs: one seed, generation and generator a run
            host = dict(seed=tuple(int(s) for s in seed),
                        generation=tuple(int(g) for g in generation),
                        generator=tuple(_generator(w, dev) for w in words))
        else:
            host = dict(seed=int(seed), generation=int(generation),
                        generator=_generator(words, dev))
        state = ESState(**tensors, **host)
        traj = np.asarray(z["trajectory"]) if "trajectory" in z else None
        return state, int(z["chunk_index"]), traj
