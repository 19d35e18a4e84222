"""Carry state from the reference package into the port.

Functions take plain numpy arrays (what ``np.asarray`` gives for a JAX
array), so this module imports neither package's arrays: a caller reads the
reference's ``ESState`` / ``SpectrumOps`` fields out as numpy and hands them
here. The reference key's first word becomes the port's integer seed, so
``es.pipeline.kernel_seed`` gives the same per-generation seeds bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .es.strategy import ESState
from .ops.spectral import FactoredOps, SpectrumOps, packed_bf16


def seed_from_key(key) -> int:
    """The int32 first word of a raw ``(2,) uint32`` PRNG key."""
    word = int(np.asarray(key, dtype=np.uint32).reshape(-1)[0])
    return word - (1 << 32) if word & 0x80000000 else word


def state_from_numpy(
    parent_values,
    parent_steps,
    parent_fitness,
    best_values,
    best_fitness,
    key,
    generation,
    stall,
    *,
    generator_seed: int = 0,
    device: str | torch.device = "cuda",
) -> ESState:
    """An ``ESState`` from the reference state's fields. Host-side draws of the
    port come from a fresh ``torch.Generator`` seeded with ``generator_seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(generator_seed)

    def f32(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    return ESState(
        parent_values=f32(parent_values),
        parent_steps=f32(parent_steps),
        parent_fitness=f32(parent_fitness),
        best_values=f32(best_values),
        best_fitness=f32(best_fitness).reshape(()),
        seed=seed_from_key(key),
        generation=int(generation),
        stall=torch.tensor(int(stall), dtype=torch.int32, device=dev),
        generator=gen,
    )


def spectrum_ops_from_numpy(
    *,
    n,
    num_bins,
    window,
    norm,
    dft_cos,
    dft_sin,
    dft_packed,
    dft_packed_scale,
    method="dft",
    dft_dtype=None,
    factored=None,
    device: str | torch.device = "cuda",
) -> SpectrumOps:
    """``SpectrumOps`` from the reference operands. bfloat16 arrays (numpy
    dtype ``bfloat16``, 2 bytes) keep their bits. ``dft_dtype`` names the
    engine's dtype (``np.dtype(so.dft_dtype).name``; it defaults to that of
    ``dft_cos``, float32 for the rfft method, which has none); ``factored``
    is the reference's ``FactoredOps`` as a mapping of its fields
    (``so.factored._asdict()``) for the ``"dft_factored"`` method."""
    dev = resolve_device(device)

    def t(a):
        if a is None:
            return None
        a = np.array(a)  # a writable copy
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
        return torch.from_numpy(a).to(dev)

    cos = t(dft_cos)
    if dft_dtype is None:
        dtype = torch.float32 if cos is None else cos.dtype
    else:
        dtype = torch.bfloat16 if str(dft_dtype) in ("bfloat16", "int8") else torch.float32
    fo = None
    if factored is not None:
        f = dict(factored)
        fo = FactoredOps(n1=int(f["n1"]), n2=int(f["n2"]),
                         **{k: t(np.asarray(f[k], np.float32))
                            for k in ("c1", "s1n", "tw_re", "tw_imn", "c2", "s2n")})
    packed = t(dft_packed)
    return SpectrumOps(
        n=int(n),
        num_bins=int(num_bins),
        window=t(np.asarray(window, np.float32)),
        norm=float(norm),
        dft_cos=cos,
        dft_sin=t(dft_sin),
        method=str(method),
        dft_dtype=dtype,
        dft_packed=packed,
        dft_packed_scale=float(dft_packed_scale),
        factored=fo,
        dft_packed_bf16=packed_bf16(packed),
    )


def target_from_numpy(target, *, device: str | torch.device = "cuda") -> torch.Tensor:
    """A float32 target spectrum ``(K,)`` on ``device``."""
    return torch.from_numpy(np.array(target, dtype=np.float32)).to(resolve_device(device))
