"""Import hygiene of the port and the behaviour of chip_smoke.py without a card.

pmfm_tpu_torch and chip_smoke.py must import neither jax nor pmfm_tpu (the
port keeps its own copies of what it needs); importing the package needs no
GPU, no nvcc and no built library.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "pmfm_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_reference(path):
    for name in _imported_roots(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "pmfm_tpu"), f"{path.name} imports {name}"


def _run(code_or_args, cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, *code_or_args], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=120,
    )


def test_import_loads_no_jax_and_builds_nothing():
    code = (
        "import sys, pmfm_tpu_torch, pmfm_tpu_torch.es, pmfm_tpu_torch.ops, "
        "pmfm_tpu_torch.kernels, pmfm_tpu_torch.interop, pmfm_tpu_torch.io, "
        "pmfm_tpu_torch.ops.scanless, pmfm_tpu_torch.kernels.synth_fold, "
        "pmfm_tpu_torch.kernels.synth_stream, pmfm_tpu_torch.kernels.evolve, "
        "pmfm_tpu_torch.kernels.scan, pmfm_tpu_torch.bench, pmfm_tpu_torch.cli, "
        "pmfm_tpu_torch.models, pmfm_tpu_torch.ops.oracle, pmfm_tpu_torch.utils, "
        "pmfm_tpu_torch.utils.debug, pmfm_tpu_torch.utils.stage_bench\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'pmfm_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "from pmfm_tpu_torch.kernels import _build\n"
        "assert _build.library.cache_info().currsize == 0\n"
    )
    res = _run(["-c", code], REPO)
    assert res.returncode == 0, res.stderr


def test_one_build_covers_every_kernel_source():
    """One nvcc call compiles every .cu file (the scan synthesis's too), and
    the library's name hashes every source and header, so an edit to the
    shared synthesis or the shared evaluation rebuilds."""
    from pmfm_tpu_torch.kernels import _build

    names = [p.name for p in _build.sources()]
    assert names == ["evolve.cu", "fused_eval.cu", "fused_f32.cu", "large_frame.cu",
                     "scan_synth.cu"]
    assert (_build.CSRC / "synth_common.cuh").exists() and (_build.CSRC / "evaluate.cuh").exists()
    assert _build.library_path().parent == _build.BUILD_DIR


def test_chip_smoke_without_a_card_fails_and_prints_no_result():
    res = _run(["chip_smoke.py"], REPO, {"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run(["chip_smoke.py"], tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
