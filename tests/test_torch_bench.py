"""The port's bench (``python -m pmfm_tpu_torch.bench``) on the CPU: its two
configurations are the reference bench's, and it refuses to run without a
card (the timed runs themselves need one: chip_smoke.py phase 16)."""
import dataclasses
from pathlib import Path

import pytest
import torch

from pmfm_tpu_torch import bench
from pmfm_tpu_torch.es import active_engine, make_spectrum_ops
from pmfm_tpu_torch.io import config as tconfig

REPO = Path(__file__).resolve().parent.parent


def test_bench_config_is_the_reference_bench_engine():
    cfg = bench.bench_config()
    assert (cfg.population_size, cfg.num_parents, cfg.n_samples) == (1 << 15, 256, 1024)
    assert (cfg.topology, cfg.dft_dtype, cfg.sine_order, cfg.mutation_noise) == (
        "fm3_series", "int8", 7, "clt12")
    assert cfg.fused_generation and not cfg.fused_evolve and cfg.refine_generations == 0
    so = make_spectrum_ops(cfg, device="cpu")
    assert active_engine(cfg, so) == "fused_generation"


@pytest.mark.parametrize("field", ["num_parents", "num_offspring", "topology", "audio_length_log2",
                                   "dft_dtype", "fused_generation", "mutation_noise", "min_step",
                                   "restart_patience", "refine_generations", "refine_step_floor",
                                   "param_mins", "param_maxs", "synthesis_engine"])
def test_shipped_config_is_params_match(field):
    """value_shipped runs examples/params_match.json's settings on the bench
    shape (its fitness threshold aside: the bench never stops early)."""
    shipped = bench.shipped_config(bench.bench_config())
    example = tconfig.load_config(REPO / "examples" / "params_match.json").es
    assert getattr(shipped, field) == getattr(example, field)
    assert shipped.sine_order == 9 and shipped.fitness_threshold == 0.0
    assert dataclasses.asdict(shipped.refine_config())["dft_dtype"] == "float32"


def test_bench_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main() == 2
    assert capsys.readouterr().out == ""
