"""Ahead-of-time artifacts of the STFT matcher (port of
``pmfm_tpu/utils/aot.py``).

The reference serialises its traced matcher with ``jax.export``, so that a
serving process runs it without tracing or compiling it again. The port has
no program to trace: its matcher is Python over PyTorch and ctypes launches
of the kernels, which ``torch.export`` cannot follow. What a serving
process would pay at startup is the one ``nvcc`` build of the kernel
library (``kernels/_build.py``). So the artifact carries that library:

    b"PMFMCUDA" | u32 header_len | header JSON (utf-8) | payload

The header holds the reference's fields (``config``, ``num_generations``,
``target_samples``, ``platforms``, ``mesh_devices``: the ranks the matcher
shards its population over, 1 without a mesh) and the port's:
``source_digest`` (the digest of the kernel sources and arch flags that
names the library), ``arch_flags`` and the payload's ``payload_sha256``.
The payload is the built library's bytes for a ``cuda`` artifact, empty
for a ``cpu`` one (the plain versions need no build). ``load_matcher``
checks the magic, the platform, the digest against the checkout's sources
and the payload's sha256, and places the library where ``_build`` looks
for it, so the first launch loads it and ``nvcc`` never runs. An artifact
of ``mesh_devices`` > 1 runs ``parallel.evolve_sharded`` over a 1-D mesh of
that many ranks of the live world, and refuses a smaller world.
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import struct
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..es.config import ESConfig

_MAGIC = b"PMFMCUDA"
PLATFORMS = ("cuda", "cpu")


def config_to_dict(cfg: ESConfig) -> dict:
    return dataclasses.asdict(cfg)


def config_from_dict(d: dict) -> ESConfig:
    d = dict(d)
    for k in ("param_mins", "param_maxs"):
        if k in d and d[k] is not None:
            d[k] = tuple(d[k])
    return ESConfig(**d)


def export_matcher(
    cfg: ESConfig,
    num_generations: int,
    target_samples: int | None = None,
    *,
    platforms: Sequence[str] | None = None,
    mesh_devices: int | None = None,
) -> bytes:
    """The artifact of the STFT matcher for ``cfg``, ``num_generations`` and
    a target of ``target_samples`` (a multiple of the frame size; one frame
    of ``cfg.num_frames`` by default). ``platforms`` is ``("cuda",)`` (the
    default: the kernel library, built here if it is not yet) or
    ``("cpu",)``. ``mesh_devices`` > 1 records a matcher over that many
    ranks (the reference's ``mesh_devices``); exporting needs no world."""
    from ..kernels import _build

    if mesh_devices is not None and mesh_devices < 1:
        raise ValueError(f"mesh_devices must be >= 1, got {mesh_devices}")
    n = cfg.n_samples
    if target_samples is None:
        target_samples = cfg.num_frames * n
    if target_samples < n or target_samples % n:
        raise ValueError(f"target_samples={target_samples} must be a positive multiple of the "
                         f"frame size {n}")
    platforms = tuple(platforms or ("cuda",))
    if len(platforms) != 1 or platforms[0] not in PLATFORMS:
        raise ValueError(f"platforms must be one of {PLATFORMS}, got {platforms}")
    cfg = cfg.replace(num_frames=target_samples // n)
    payload = b""
    if platforms[0] == "cuda":
        with open(_build.build()["path"], "rb") as f:
            payload = f.read()
    header = {
        "config": config_to_dict(cfg),
        "num_generations": num_generations,
        "target_samples": target_samples,
        "platforms": list(platforms),
        "mesh_devices": int(mesh_devices or 1),
        "source_digest": _build.source_digest(),
        "arch_flags": list(_build.ARCH_FLAGS),
        "payload_sha256": hashlib.sha256(payload).hexdigest(),
    }
    hdr = json.dumps(header, sort_keys=True).encode()
    buf = io.BytesIO()
    buf.write(_MAGIC)
    buf.write(struct.pack("<I", len(hdr)))
    buf.write(hdr)
    buf.write(payload)
    return buf.getvalue()


def save_matcher(path: str | os.PathLike, *args, **kwargs) -> str:
    """``export_matcher`` straight to a file (atomic replace)."""
    path = os.fspath(path)
    blob = export_matcher(*args, **kwargs)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)
    return path


class AOTMatcher:
    """A loaded artifact. ``matcher(seed, target_audio)`` runs
    ``match_audio_stft``'s run with the artifact's config and generations on
    its platform (over a mesh of ``mesh_devices`` ranks of the live world
    when there are several) and returns the reference's keys as numpy
    arrays."""

    def __init__(self, cfg: ESConfig, num_generations: int, target_samples: int,
                 platforms: list[str], mesh_devices: int = 1):
        self.cfg = cfg
        self.num_generations = num_generations
        self.target_samples = target_samples
        self.platforms = platforms
        self.mesh_devices = mesh_devices
        self._mesh = None  # over several ranks: made on the first call, then reused

    def __call__(self, seed: int, target_audio: np.ndarray) -> dict[str, np.ndarray]:
        from ..es.pipeline import stft_run

        target_audio = np.asarray(target_audio, np.float32)
        if target_audio.shape != (self.target_samples,):
            raise ValueError(f"artifact expects target of shape ({self.target_samples},), "
                             f"got {target_audio.shape}")
        mesh = self._matcher_mesh()
        dev = mesh.device if mesh is not None else resolve_device(self.platforms[0])
        _, final, _, _, best_scaled, best_audio = stft_run(
            target_audio, self.cfg, seed, self.num_generations, False, dev, mesh=mesh)
        out = {
            "best_params_scaled": best_scaled,
            "best_params_norm": final.best_values,
            "best_fitness": final.best_fitness,
            "generations_run": torch.tensor(final.generation, dtype=torch.int32),
            "parent_values": final.parent_values,
            "parent_fitness": final.parent_fitness,
            "best_audio": best_audio,
        }
        return {k: v.cpu().numpy() for k, v in out.items()}

    def _matcher_mesh(self):
        """None for one device; else the 1-D mesh of ``mesh_devices`` ranks
        of the live world, made on the first call (``make_mesh`` is
        collective: every rank makes its first call together) and reused.
        Raises when the world is smaller."""
        if self.mesh_devices == 1 or self._mesh is not None:
            return self._mesh
        import torch.distributed as dist

        from ..parallel import make_mesh
        from ..parallel.mesh import local_device

        world = dist.get_world_size() if dist.is_initialized() else 1
        if self.mesh_devices > world:  # the reference's aot.py:211-214
            raise RuntimeError(f"artifact was exported over a {self.mesh_devices}-rank mesh "
                               f"but the world has {world}")
        self._mesh = make_mesh((self.mesh_devices,), device=local_device(self.platforms[0]))
        return self._mesh


def _place_library(payload: bytes) -> None:
    """Write the artifact's library where ``kernels._build`` looks for the
    current sources' library, atomically, unless one is there."""
    from ..kernels import _build

    path = _build.library_path()
    if path.exists():
        return
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.aot.tmp")
    tmp.write_bytes(payload)
    os.replace(tmp, path)


def load_matcher(src: str | os.PathLike | bytes) -> AOTMatcher:
    """Load an artifact of ``export_matcher``/``save_matcher``. Raises
    ``ValueError`` for a bad magic, an unknown platform, kernel sources other
    than the checkout's, or a payload whose sha256 is not the header's."""
    from ..kernels import _build

    if isinstance(src, (bytes, bytearray)):
        blob = bytes(src)
    else:
        with open(os.fspath(src), "rb") as f:
            blob = f.read()
    if blob[: len(_MAGIC)] != _MAGIC:
        raise ValueError("not a PMFM CUDA AOT artifact (bad magic)")
    off = len(_MAGIC)
    (hdr_len,) = struct.unpack_from("<I", blob, off)
    off += 4
    header = json.loads(blob[off : off + hdr_len].decode())
    payload = blob[off + hdr_len :]
    platforms = list(header["platforms"])
    if len(platforms) != 1 or platforms[0] not in PLATFORMS:
        raise ValueError(f"artifact platform {platforms} is not one of {PLATFORMS}")
    if header["source_digest"] != _build.source_digest():
        raise ValueError(f"artifact built from other kernel sources ({header['source_digest']}) "
                         f"than this checkout's ({_build.source_digest()})")
    if hashlib.sha256(payload).hexdigest() != header["payload_sha256"]:
        raise ValueError("artifact payload does not match its sha256 (corrupted)")
    if (platforms[0] == "cuda") != bool(payload):
        raise ValueError(f"a {platforms[0]} artifact with a payload of {len(payload)} bytes")
    if payload:
        _place_library(payload)
    return AOTMatcher(
        cfg=config_from_dict(header["config"]),
        num_generations=int(header["num_generations"]),
        target_samples=int(header["target_samples"]),
        platforms=platforms,
        mesh_devices=int(header.get("mesh_devices", 1)),
    )
