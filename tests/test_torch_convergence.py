"""The ES-quality gate (A1): pmfm_tpu_torch.convergence_check against the
reference's tools/convergence_check.py, and the bench's reading of its file.

The statistics are copies: on the same arrays they give the reference's
numbers bit for bit. A tiny run (P 64, 20 generations, 2 seeds) on the CPU
writes the reference's JSON layout, which ``pmfm_tpu_torch.bench`` reads;
the committed ``pmfm_tpu_torch/quality_gates.json`` is the card's.
"""
import importlib.util
import json
import os

import numpy as np
import pytest

from pmfm_tpu_torch import bench
from pmfm_tpu_torch import convergence_check as cc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location(
        "ref_convergence_check", os.path.join(REPO, "tools", "convergence_check.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _arrays(case):
    rng = np.random.default_rng(case)
    base = rng.lognormal(10.0, 1.0, 64)
    if case == 0:  # ties and equal pairs
        variant = np.round(base * rng.choice([0.5, 1.0, 2.0], 64), -3)
        base = np.round(base, -3)
    elif case == 1:
        variant = base * rng.lognormal(0.1, 0.5, 64)
    else:  # few pairs: the Wilcoxon test's small-n branch
        base, variant = base[:8], base[:8] * rng.lognormal(0.0, 0.3, 8)
    return variant, base


@pytest.mark.parametrize("case", [0, 1, 2])
@pytest.mark.parametrize("fn", ["sign_test_p", "wilcoxon_p", "bootstrap_median_ci",
                                "paired_stats"])
def test_statistics_bit_equal_to_reference(ref, fn, case):
    variant, base = _arrays(case)
    if fn == "paired_stats":
        args = (variant, base)
    elif fn == "bootstrap_median_ci":
        args = (variant / base,)
    else:
        args = (np.log(variant / base),)
    assert getattr(cc, fn)(*args) == getattr(ref, fn)(*args)


@pytest.mark.parametrize("threshold", [15000.0, 40000.0, 150000.0, 1.0])
def test_gens_to_converge_bit_equal_to_reference(ref, threshold):
    rng = np.random.default_rng(int(threshold))
    rescored = np.minimum.accumulate(rng.lognormal(11.0, 1.5, (16, 20)), axis=1)
    boundaries = [10 * (i + 1) for i in range(20)]
    assert cc.gens_to_converge(rescored, boundaries, threshold) == ref.gens_to_converge(
        rescored, boundaries, threshold)


def test_tables_are_the_reference_tables(ref):
    assert cc.TRUE_GENES_BY_TOPOLOGY == ref.TRUE_GENES_BY_TOPOLOGY
    assert cc.TRUE_GENES == ref.TRUE_GENES
    assert cc.VARIANTS == ref.VARIANTS


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny run, twice: a holdout split of the four rungs the bench
    reads, then a train split of two, merged into one file."""
    path = str(tmp_path_factory.mktemp("gate") / "quality_gates.json")
    common = ["--pop-log2", "6", "--mu", "8", "--gens", "20", "--seeds", "2", "--json", path]
    assert cc.main(common + ["--seed-offset", "64", "--split", "holdout", "--variants", "f32",
                             "int8+sin7", "int8+sin7+refine", "shipped"], device="cpu") == 0
    assert cc.main(common + ["--variants", "f32", "int8+sin7"], device="cpu") == 0
    with open(path) as f:
        return path, json.load(f)


def test_tiny_run_writes_the_reference_layout(tiny):
    _, doc = tiny
    assert set(doc) == {"meta", "splits"} and set(doc["splits"]) == {"holdout", "train"}
    assert doc["meta"]["device"] == {"name": "cpu", "power_limit": None}
    hold = doc["splits"]["holdout"]
    assert hold["seed_offset"] == 64 and hold["seeds"] == 2 and hold["meta"]["pop"] == 64
    assert set(hold["results"]) == {"f32", "int8+sin7", "int8+sin7+refine", "shipped"}
    for name, r in hold["results"].items():
        assert len(r["fits"]) == 2 and np.isfinite(r["fits"]).all()
        assert set(r["generations_to_converge"]) == {"150000", "40000", "15000"}
        assert len(r["rescored_trajectory"][0]) == len(r["boundaries_gens"])
        assert ("paired_vs_f32" in r) == (name != "f32")
    assert hold["results"]["int8+sin7"]["boundaries_gens"] == [10, 20]
    # the refine rung: 20 generations, all of them the tail's (as the reference cuts them)
    assert hold["results"]["shipped"]["boundaries_gens"] == [10, 20, 30]
    assert set(doc["splits"]["train"]["results"]) == {"f32", "int8+sin7"}


def test_bench_reads_the_gate(tiny):
    """The bench prefers the held-out split (root bench.py:176-235)."""
    path, doc = tiny
    gtc = bench.generations_to_converge(path)
    assert gtc["split"] == "holdout" and gtc["seeds"] == 2
    assert set(gtc) == {"split", "seeds", "int8+sin7", "int8+sin7+refine"}
    assert set(gtc["int8+sin7"]["40000"]) == {"median_gens", "frac_converged"}
    q = bench.quality_holdout(path)
    st = doc["splits"]["holdout"]["results"]["shipped"]["paired_vs_f32"]
    assert q["shipped"] == {"median_ratio": round(st["median_ratio"], 3),
                            "sign_p": round(st["sign_test_p"], 3)}
    assert bench.quality_holdout(path + ".missing") is None


def test_committed_gate_is_the_cards():
    """``pmfm_tpu_torch/quality_gates.json`` was written on the card at the
    reference's meta (P 2^15, mu 256, 1000 generations), with the card's
    name and power limit; the bench reads both of its metrics from it."""
    with open(bench.QUALITY_GATES) as f:
        doc = json.load(f)
    hold = doc["splits"]["holdout"]
    assert hold["seed_offset"] == 64 and hold["seeds"] == 64
    assert {k: hold["meta"][k] for k in ("pop", "mu", "gens", "segment_gens")} == {
        "pop": 1 << 15, "mu": 256, "gens": 1000, "segment_gens": 10}
    assert "H100" in hold["meta"]["device"]["name"] and hold["meta"]["device"]["power_limit"]
    assert set(hold["results"]) >= {"f32", "int8+sin7", "int8+sin7+refine", "shipped"}
    assert bench.generations_to_converge()["split"] == "holdout"
    assert set(bench.quality_holdout()) == {"int8+sin7+refine", "shipped"}
