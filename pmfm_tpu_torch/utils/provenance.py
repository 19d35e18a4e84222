"""Source fingerprint of the card-measured draw statistics (port of
``pmfm_tpu/utils/provenance.py``).

The kernels' in-kernel draws (Philox4x32-10 in B2 and the B5 runs of it)
are checked for their distribution on the card: ``chip_smoke.py`` phase 4
measures the uniform parent choice, the CLT-12 gaussian's mean, sigma and
kurtosis and the Ek coin's rate over a population of B2's draws. The
result is committed as ``pmfm_tpu_torch/gen_check.json`` together with a
fingerprint of every source that fixes those streams, and a CPU test
(and phase 4 itself) fails when the sources change and the artifact does
not: the artifact then speaks of draws the code no longer makes.
"""
from __future__ import annotations

import hashlib
import inspect
import re
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]
GEN_CHECK_ARTIFACT = PACKAGE / "gen_check.json"
_CSRC = PACKAGE / "csrc"


def _c_function(text: str, name: str) -> str:
    """The definition of the C++ function ``name`` in ``text``, from its
    signature's line to its closing brace."""
    m = re.search(rf"^[^\n]*\b{name}\(", text, re.M)
    if m is None:
        raise ValueError(f"no definition of {name}")
    depth, i = 0, text.index("{", m.end())
    for j in range(i, len(text)):
        depth += {"{": 1, "}": -1}.get(text[j], 0)
        if depth == 0:
            return text[m.start() : j + 1]
    raise ValueError(f"unbalanced braces in {name}")


def seeding_fingerprint() -> str:
    """sha256 over every source that fixes the kernels' draw streams: B2's
    launch interface shared with B5 (``csrc/generation.cuh``), the Philox
    function and the draws of an offspring gene (``csrc/evaluate.cuh``:
    ``philox4x32_10``, ``uniform01``, ``offspring_gene``), their plain
    versions (``kernels/generation.py``: ``philox4x32``, ``philox_draws``,
    ``uniform01``) and the host's seed derivation (``es/pipeline.py``:
    ``kernel_seed``, ``state_seeds``)."""
    from ..es import pipeline
    from ..kernels import generation

    evaluate = (_CSRC / "evaluate.cuh").read_text()
    parts = [(_CSRC / "generation.cuh").read_text()]
    parts += [_c_function(evaluate, f) for f in ("philox4x32_10", "uniform01", "offspring_gene")]
    parts += [inspect.getsource(f) for f in (
        generation.philox4x32, generation.philox_draws, generation.uniform01,
        pipeline.kernel_seed, pipeline.state_seeds)]
    h = hashlib.sha256()
    for part in parts:
        h.update(part.encode())
        h.update(b"\x00")
    return h.hexdigest()
