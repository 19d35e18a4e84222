"""Card-only tests of the port's CUDA kernels: each kernel against its plain
PyTorch version on the same CUDA tensors, and the ES loop through them.

Run on a machine with a GPU:  python -m pytest tests/test_torch_gpu.py -m gpu
Without a card every test here skips; whether there is one is decided
inside the ``cuda`` fixture, never at import, so every pytest-xdist worker
collects the same tests.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from pmfm_tpu_torch.es import (
    ESConfig,
    active_engine,
    evolve,
    init_state,
    kernel_seed,
    make_spectrum_ops,
)
from pmfm_tpu_torch.kernels import generation as gn
from pmfm_tpu_torch.kernels import synth_fitness as sf
from pmfm_tpu_torch.kernels import synth_fold as sfo
from pmfm_tpu_torch.kernels import synth_stream as sst
from pmfm_tpu_torch.ops import hann_window
from pmfm_tpu_torch.ops import synthesize_single, target_spectrum
from pmfm_tpu_torch.ops.synthesis import topology_dims

pytestmark = pytest.mark.gpu

# kernel vs plain version: the same int8 audio and exact int32 sums; only
# the float32 sum over bins is ordered differently (see chip_smoke.py)
FIT_MAX_REL, FIT_MEDIAN_REL = 1e-3, 1e-5
STEP_MAX_REL = 1e-6
TRUTH = (3078.0, 2.0, 3015.0, 1.5, 3141.0, 1.0, 2500.0, 1.2)
# a population whose last CUDA block is only partly filled: not a multiple
# of the f32 DFT's 128 candidates a block, the int8 mode's 32, or the 32
# lanes of B5's selection
RAGGED_POP = 4001
POPS = [4096, RAGGED_POP]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _setup(dev, topology="fm3_series", n=1024, pop=4096):
    d = topology_dims(topology)
    cfg = ESConfig(num_parents=64, num_offspring=pop - 64, num_dimensions=d, topology=topology,
                   param_mins=(0.0,) * d, param_maxs=(3520.0, 8.0) * (d // 2),
                   audio_length_log2=int(np.log2(n)), dft_dtype="int8", sine_order=7,
                   fused_generation=True, pop_block=pop)
    so = make_spectrum_ops(cfg, device=dev)
    tgt = target_spectrum(synthesize_single(torch.tensor(TRUTH[:d]), n, topology).to(dev), so)
    return cfg, so, tgt


@pytest.mark.parametrize("pop", POPS)
@pytest.mark.parametrize("topology,n", [("fm3_series", 1024), ("fm2", 256), ("fm4_series", 2048)])
def test_b1_kernel_matches_plain(cuda, topology, n, pop):
    cfg, so, tgt = _setup(cuda, topology, n, pop)
    rng = np.random.default_rng(0)
    p = torch.from_numpy((rng.random((cfg.population_size, cfg.num_dimensions)) *
                          np.asarray(cfg.param_maxs)).astype(np.float32)).to(cuda)
    kw = dict(dft_packed=so.dft_packed, dft_scale=so.dft_packed_scale, topology=topology, n=n,
              pop_block=cfg.population_size, sine_order=7)
    before = sf.fused_synth_fitness.launches
    got = sf.fused_synth_fitness(p, tgt, **kw)
    assert sf.fused_synth_fitness.launches == before + 1
    ref = sf.fused_synth_fitness_plain(p, tgt, **kw)
    rel = (got - ref).abs() / ref.abs()
    assert float(rel.max()) <= FIT_MAX_REL and float(rel.median()) <= FIT_MEDIAN_REL


@pytest.mark.parametrize("pop", POPS)
def test_b2_kernel_matches_plain(cuda, pop):
    cfg, so, tgt = _setup(cuda, pop=pop)
    g = torch.Generator(device=cuda).manual_seed(0)
    pv = torch.rand((64, 6), generator=g, device=cuda)
    ps = torch.rand((64, 6), generator=g, device=cuda) * 0.3  # fm3_series
    kw = dict(pop=cfg.population_size, param_mins=cfg.param_mins, param_maxs=cfg.param_maxs,
              dft_packed=so.dft_packed, dft_scale=so.dft_packed_scale, n=1024,
              pop_block=cfg.population_size, sine_order=7, min_step=1e-4)
    seed = kernel_seed(42, 3)
    fk, vk, sk = gn.fused_generation(seed, pv, ps, tgt, **kw)
    fp, vp, sp = gn.fused_generation_plain(seed, pv, ps, tgt, **kw)
    assert torch.equal(vk, vp)
    assert float(((sk - sp).abs() / sp.abs()).max()) <= STEP_MAX_REL
    rel = (fk - fp).abs() / fp.abs()
    assert float(rel.max()) <= FIT_MAX_REL and float(rel.median()) <= FIT_MEDIAN_REL


@pytest.mark.parametrize("pop", [1, 63, 64, 65, RAGGED_POP])
@pytest.mark.parametrize("sine_order", [5, 7, 9])
@pytest.mark.parametrize("topology", ["fm2", "fm3_series", "fm8_series"])
@pytest.mark.parametrize("n,bins", [(256, None), (1024, None), (2048, None), (3584, None),
                                    (1024, 200)])
def test_b1_b2_int8_grid(cuda, n, bins, topology, sine_order, pop):
    """B1/B2 int8 (32-candidate blocks, the DFT on the tensor cores, 32 bins a
    pass) against their plain versions over every frame size class, a bin
    count that leaves a partial pass, population edges and ported chains;
    B2's fitness bit-equal to B1's on B2's own offspring."""
    _grid_case(cuda, "int8", n, bins, topology, sine_order, pop, (FIT_MAX_REL, FIT_MEDIAN_REL))


@pytest.mark.parametrize("pop", [1, 127, 128, 129, RAGGED_POP])
@pytest.mark.parametrize("sine_order", [5, 7, 9])
@pytest.mark.parametrize("topology", ["fm2", "fm3_series", "fm8_series"])
@pytest.mark.parametrize("n,bins", [(256, None), (1024, None), (2048, None), (3584, None),
                                    (1024, 200)])
def test_b1_b2_f32_grid(cuda, n, bins, topology, sine_order, pop):
    """B1/B2 true f32 (synthesis into scratch; the FFT at the power-of-two
    frames, the register-tiled DFT on 128-candidate blocks and one bin group
    each, 64 bins a pass, at n 3584) against their plain versions over every
    frame size class, a bin count that stops the FFT's epilogue early and
    leaves the DFT partial passes, population edges and ported chains; B2's
    fitness bit-equal to B1's on B2's own offspring."""
    _grid_case(cuda, "float32", n, bins, topology, sine_order, pop,
               (F32_FIT_MAX_REL, F32_FIT_MEDIAN_REL))


@pytest.mark.parametrize("pop", [1, 63, 64, 65, RAGGED_POP])
@pytest.mark.parametrize("sine_order", [7, 9])
@pytest.mark.parametrize("topology", ["fm2_parallel", "fm3_parallel", "fm4_parallel"])
@pytest.mark.parametrize("n", [256, 1024, 2048, 3584])
@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_b1_b2_parallel_grid(cuda, dtype, n, topology, sine_order, pop):
    """B1/B2 in the fm{k}_parallel mode (the pair bank's synthesis, the
    rest as for a chain) against their plain versions over the frames, the
    banks, two sine orders and population edges, in the int8 and the f32
    limits; B2's fitness bit-equal to B1's on B2's own offspring (chip_smoke.py
    phase 20's grid)."""
    limits = (FIT_MAX_REL, FIT_MEDIAN_REL) if dtype == "int8" else (F32_FIT_MAX_REL,
                                                                   F32_FIT_MEDIAN_REL)
    _grid_case(cuda, dtype, n, None, topology, sine_order, pop, limits)


@pytest.mark.parametrize("pop", [1, 63, 64, 65, RAGGED_POP])
@pytest.mark.parametrize("sine_order", [5, 7, 9])
@pytest.mark.parametrize("topology", ["fm2", "fm3_series", "fm8_series", "fm3_parallel"])
@pytest.mark.parametrize("n,bins", [(256, None), (1024, None), (2048, None), (3584, None),
                                    (1024, 200)])
def test_b1_b2_bf16_grid(cuda, n, bins, topology, sine_order, pop):
    """B1/B2 bf16 (the int8 kernels' one-warp design on the bf16 tensor
    cores, 64 bytes a candidate-sample pair of shared memory) against their
    plain versions in the int8 limits over every frame size class (3584:
    the block's 229,376 bytes), a partial bin pass, population edges,
    chains and a pair bank; B2's fitness bit-equal to B1's on B2's own
    offspring (chip_smoke.py phase 26's grid)."""
    _grid_case(cuda, "bfloat16", n, bins, topology, sine_order, pop,
               (FIT_MAX_REL, FIT_MEDIAN_REL))


@pytest.mark.parametrize("runs,frames", [(1, 1), (4, 1), (2, 8)])
def test_bf16_run_axis_and_frames_bit_equal_to_lone_launches(cuda, runs, frames):
    """B1/B2 bf16 launched for B runs at F frames: run r bit-equal to a lone
    launch, and B1 within the int8 limits of its plain version."""
    so = make_spectrum_ops(ESConfig(audio_length_log2=11, dft_dtype="bfloat16"), device=cuda)
    rng = np.random.default_rng(runs * 10 + frames)
    dev = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda)  # noqa: E731
    pop, d = 1000, 6
    maxs = (3520.0, 8.0) * 3
    params = dev(rng.random((runs, pop, d)) * np.asarray(maxs))
    pv, ps = dev(rng.random((runs, 64, d))), dev(rng.uniform(0.02, 0.3, (runs, 64, d)))
    tgt = dev(rng.uniform(0.0, 50.0, (runs, frames, so.num_bins)))
    kw = dict(dft_packed=so.dft_packed, dft_scale=0.0, topology="fm3_series", n=2048,
              pop_block=pop, sine_order=9, num_frames=frames)
    kw2 = dict(kw, pop=pop, param_mins=(0.0,) * d, param_maxs=maxs)
    seeds = [kernel_seed(9, r) for r in range(runs)]
    fb = sf.fused_synth_fitness(params, tgt, **kw)
    gb = gn.fused_generation(seeds, pv, ps, tgt, **kw2)
    for r in range(runs):
        assert _bits_equal(fb[r], sf.fused_synth_fitness(params[r], tgt[r], **kw))
        lone = gn.fused_generation(seeds[r], pv[r], ps[r], tgt[r], **kw2)
        assert all(_bits_equal(a[r], b) for a, b in zip(gb, lone))
    ref = sf.fused_synth_fitness_plain(params, tgt, **kw)
    rel = (fb - ref).abs() / ref.abs()
    assert float(rel.max()) <= FIT_MAX_REL and float(rel.median()) <= FIT_MEDIAN_REL


@pytest.mark.parametrize("pop", [4096, RAGGED_POP])
def test_b5_bf16_bit_equal_to_b2_launches(cuda, pop):
    """G generations of B5 in bf16 == G B2 bf16 launches + the stable
    selection, bit for bit; evolve with fused_evolve in bf16 is one launch."""
    from pmfm_tpu_torch.kernels import evolve as ev

    cfg, _, _ = _setup(cuda, pop=pop)
    cfg = cfg.replace(dft_dtype="bfloat16")
    so = make_spectrum_ops(cfg, device=cuda)
    tgt = target_spectrum(synthesize_single(torch.tensor(TRUTH[:6]), 1024, "fm3_series").to(cuda),
                          so)
    g = torch.Generator(device=cuda).manual_seed(3)
    pv = torch.rand((64, 6), generator=g, device=cuda)
    ps = torch.rand((64, 6), generator=g, device=cuda) * 0.3
    kw = dict(pop=pop, param_mins=cfg.param_mins, param_maxs=cfg.param_maxs,
              dft_packed=so.dft_packed, dft_scale=0.0, n=1024, pop_block=pop, sine_order=7)
    seeds = [kernel_seed(6, i) for i in range(8)]
    args = (pv, ps, pv[0].clone(), torch.tensor(float("inf"), device=cuda), tgt)
    before = ev.fused_evolve.launches_by["bf16"]
    out = ev.fused_evolve(seeds, *args, **kw)
    assert ev.fused_evolve.launches_by["bf16"] == before + 1
    loop = ev.fused_evolve_plain(seeds, *args, generation=gn.fused_generation, **kw)
    assert all(_bits_equal(a, b) for a, b in zip(out, loop))
    cfg = cfg.replace(fused_evolve=True)
    final, traj = evolve(init_state(0, cfg, device=cuda), tgt, 20, so, cfg, record_trajectory=True)
    assert ev.fused_evolve.launches_by["bf16"] == before + 2
    assert torch.isfinite(traj).all() and float(traj[-1]) < float(traj[0])


def test_bench_suite_overall_row_on_the_card(cuda, tmp_path, capsys):
    """``python -m pmfm_tpu_torch.bench_suite --suite overall --fused`` on
    the card: the reference's default (bf16) engine through B1's bf16
    kernel, one CSV row."""
    import csv

    from pmfm_tpu_torch import bench_suite

    before = sf.fused_synth_fitness.launches_by["bf16"]
    path = tmp_path / "suite.csv"
    assert bench_suite.main(["--suite", "overall", "--fused", "--gens", "5",
                             "--csv", str(path)]) == 0
    assert sf.fused_synth_fitness.launches_by["bf16"] >= before + 5
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    assert len(rows) == 2 and rows[1][0] == "OverallExecution" and float(rows[1][1]) > 0.0
    assert "OverallExecution" in capsys.readouterr().out


def test_pursuit_cli_runs_on_the_card(cuda, tmp_path, monkeypatch, capsys):
    """python -m pmfm_tpu_torch.cli -j examples/fm3_parallel_match.json on
    the card with each pursuit stage at a tenth of its generations and one
    attempt: exit 0, the WAV and the CSV, and the parallel mode's B1 and B2
    launched in int8 and f32."""
    import dataclasses

    import pmfm_tpu_torch.io
    from pmfm_tpu_torch import cli

    root = Path(__file__).resolve().parent.parent
    load = pmfm_tpu_torch.io.load_config

    def cut(path):
        rc = load(path)
        p = dict(rc.pursuit, maxAttempts=1, peelGenerations=30, tailGenerations=60,
                 aliasGenerations=15, jointGenerations=50, aliasRounds=2)
        return dataclasses.replace(rc, pursuit=tuple(sorted(p.items())))

    monkeypatch.setattr(pmfm_tpu_torch.io, "load_config", cut)
    monkeypatch.chdir(tmp_path)
    for fn in (sf.fused_synth_fitness, gn.fused_generation):
        fn.launches_by.clear()
    assert cli.main(["-j", str(root / "examples" / "fm3_parallel_match.json")]) == 0
    out = capsys.readouterr().out
    assert "pursuit chunk 0" in out and "pursuit chunk 1" in out
    for fn in (sf.fused_synth_fitness, gn.fused_generation):
        assert fn.launches_by["parallel_int8"] > 0 and fn.launches_by["parallel_f32"] > 0
    assert (tmp_path / "output_audio" / "output_fm3_parallel.wav").exists()
    assert (tmp_path / "gpulog(pop=8192gens=1000audioBlockSize=1024).csv").exists()


@pytest.mark.parametrize("pop", [1, RAGGED_POP])
@pytest.mark.parametrize("n", [2048, 3584])
def test_b1_f32_summation_near_float64(cuda, n, pop):
    """At n 2048 the f32 kernels take the FFT (its rounding grows with log2
    N); at n 3584 the DFT, which sums each bin in 128-sample segments added
    pairwise, and the terms over bins in double (csrc fused_f32.cu): at both
    (the f32 grid's fm3_series, sine order 7 inputs), the kernel's relative
    error against a float64 evaluation of
    the same audio is within 1.5x the plain version's (cuBLAS's sums): the
    median at P 4001; at P 1, one value a float32 ulp of the fitness apart,
    within 1.5x the larger of the plain version's and that of U and V rounded
    once to float32 with every later step in float64 (the closest any
    float32 U and V come)."""
    from chip_smoke import fitness_f64, rel_err
    from pmfm_tpu_torch.ops import spectral

    order = 7
    so = spectral.make_spectrum_ops(n, None, dft_dtype="float32", device=cuda)
    rng = np.random.default_rng(n + pop + order)
    tgt = torch.from_numpy(rng.uniform(0.0, 50.0, so.num_bins).astype(np.float32)).to(cuda)
    p = _params(cuda, pop, seed=order)
    kw = dict(dft_packed=so.dft_packed, dft_scale=0.0, topology="fm3_series", n=n,
              pop_block=pop, sine_order=order)
    f64 = fitness_f64(p, tgt, so, "fm3_series", n, order)
    ek = rel_err(sf.fused_synth_fitness(p, tgt, **kw).double(), f64)
    ep = rel_err(sf.fused_synth_fitness_plain(p, tgt, **kw).double(), f64)
    if pop == 1:
        eo = rel_err(fitness_f64(p, tgt, so, "fm3_series", n, order, uv_f32=True), f64)
        assert float(ek[0]) <= 1.5 * max(float(ep[0]), float(eo[0])), (ek, ep, eo)
    else:
        assert float(ek.median()) <= 1.5 * float(ep.median()), (ek.median(), ep.median())
    assert float(ek.max()) <= F32_FIT_MAX_REL


@pytest.mark.parametrize("topology", ["fm2", "fm3_series", "fm8_series"])
def test_b1_b2_f32_shipped_population(cuda, topology):
    """The f32 grid's checks at the shipped tail's population, P 2^15, n 1024."""
    _grid_case(cuda, "float32", 1024, None, topology, 9, 1 << 15,
               (F32_FIT_MAX_REL, F32_FIT_MEDIAN_REL))


def _grid_case(dev, dtype, n, bins, topology, sine_order, pop, limits):
    """B1/B2 in ``dtype`` ("int8" or "float32") against their plain versions
    within ``limits`` (max, median relative), B2's values bit-equal, steps
    within STEP_MAX_REL and B2's fitness bit-equal to B1's on B2's own
    offspring."""
    from pmfm_tpu_torch.ops import spectral

    max_rel, median_rel = limits
    so = spectral.make_spectrum_ops(n, bins, dft_dtype=dtype, device=dev)
    d = topology_dims(topology)
    rng = np.random.default_rng(n + pop + sine_order)
    tgt = torch.from_numpy(rng.uniform(0.0, 50.0, so.num_bins).astype(np.float32)).to(dev)
    parallel = "parallel" in topology
    maxs = (3520.0, 8.0, 3520.0, 1.0) * (d // 4) if parallel else (3520.0, 8.0) * (d // 2)
    p = _params(dev, pop, d, seed=sine_order)
    if parallel:  # amplitudes in [0, 1], as the examples' ranges
        p = p / torch.tensor((3520.0, 8.0) * (d // 2), device=dev) * torch.tensor(maxs, device=dev)
    kw = dict(dft_packed=so.dft_packed, dft_scale=so.dft_packed_scale, topology=topology, n=n,
              pop_block=pop, sine_order=sine_order)
    got = sf.fused_synth_fitness(p, tgt, **kw)
    ref = sf.fused_synth_fitness_plain(p, tgt, **kw)
    rel = (got - ref).abs() / ref.abs()
    assert float(rel.max()) <= max_rel and float(rel.median()) <= median_rel, (
        "B1", float(rel.max()), float(rel.median()))
    mins = (0.0,) * d
    pv = torch.from_numpy(rng.random((64, d)).astype(np.float32)).to(dev)
    ps = torch.from_numpy(rng.uniform(0.02, 0.3, (64, d)).astype(np.float32)).to(dev)
    kw2 = dict(kw, pop=pop, param_mins=mins, param_maxs=maxs)
    seed = kernel_seed(n, pop)
    fk, vk, sk = gn.fused_generation(seed, pv, ps, tgt, **kw2)
    fp, vp, sp = gn.fused_generation_plain(seed, pv, ps, tgt, **kw2)
    assert torch.equal(vk, vp)
    assert float(((sk - sp).abs() / sp.abs()).max()) <= STEP_MAX_REL
    rel = (fk - fp).abs() / fp.abs()
    assert float(rel.max()) <= max_rel and float(rel.median()) <= median_rel, (
        "B2", float(rel.max()), float(rel.median()))
    own = sf.fused_synth_fitness(gn.scale_rows(vk, mins, maxs), tgt, **kw)
    assert torch.equal(fk, own)


@pytest.mark.parametrize("fused_generation", [True, False])
def test_evolve_runs_through_the_kernels(cuda, fused_generation):
    cfg, so, tgt = _setup(cuda)
    cfg = cfg.replace(fused_generation=fused_generation, fused_kernel=True)
    counter = gn.fused_generation if fused_generation else sf.fused_synth_fitness
    before = counter.launches
    final, traj = evolve(init_state(0, cfg, device=cuda), tgt, 20, so, cfg, record_trajectory=True)
    assert counter.launches - before == 20
    assert torch.isfinite(traj).all() and float(traj[-1]) < float(traj[0])
    assert final.parent_values.device.type == "cuda"


def _params(dev, pop, d=6, seed=0):
    rng = np.random.default_rng(seed)
    maxs = np.asarray((3520.0, 8.0) * (d // 2), np.float32)
    return torch.from_numpy((rng.random((pop, d)) * maxs).astype(np.float32)).to(dev)


# B3/B4 against their plain versions: populations around the 32-candidate
# blocks and a ragged one; the plain version runs once a setting at the
# largest (each candidate's output is its own)
LARGE_POPS = (1, 31, 33, 1000)


# every ported chain length class, sine order 5/7/9 (9: match_audio's
# default and its refine tail's) and frame of the route, in both modes
@pytest.mark.parametrize("dft_scale", [1e-5, 0.0])
@pytest.mark.parametrize("n", [4096, 8192, 16384])
@pytest.mark.parametrize("sine_order", [5, 7, 9])
@pytest.mark.parametrize("topology", ["fm2", "fm3_series", "fm8_series"])
def test_b3_kernel_bit_equal_to_plain(cuda, monkeypatch, topology, sine_order, n, dft_scale):
    """B3 in both layouts (time-parallel, a warp a candidate; single pass, a
    thread a candidate; FOLD_TP_BELOW_POP set so that each is taken) bit-equal
    to its plain version at each of LARGE_POPS."""
    d = topology_dims(topology)
    p = _params(cuda, max(LARGE_POPS), d, seed=n + sine_order)
    kw = dict(topology=topology, n=n, sine_order=sine_order, dft_scale=dft_scale)
    want = sfo.fused_synth_fold_plain(p, pop_block=max(LARGE_POPS), **kw)
    for pop in LARGE_POPS:
        for below in (1 << 62, 0):
            monkeypatch.setattr(sfo, "FOLD_TP_BELOW_POP",
                                dict.fromkeys(sfo.FOLD_TP_BELOW_POP, below))
            before = sfo.fused_synth_fold.launches
            got = sfo.fused_synth_fold(p[:pop], **kw)
            assert sfo.fused_synth_fold.launches == before + 1
            assert got[0].dtype == (torch.int8 if dft_scale > 0 else torch.bfloat16)
            assert torch.equal(got[0], want[0][:, :pop]) and torch.equal(got[1], want[1][:, :pop])
            assert torch.equal(got[2], want[2][:pop]) and torch.equal(got[3], want[3][:pop])


# B4: a Latin square of (topology, sine order) over its frames (131072: the
# level totals in device memory), cell (d)'s own setting among them
B4_GRID = [("fm2", 5, 131072), ("fm2", 7, 65536), ("fm2", 9, 32768),
           ("fm3_series", 5, 32768), ("fm3_series", 7, 131072), ("fm3_series", 9, 65536),
           ("fm8_series", 5, 65536), ("fm8_series", 7, 32768), ("fm8_series", 9, 131072)]


@pytest.mark.parametrize("audio_f32", [False, True])
@pytest.mark.parametrize("topology,sine_order,n", B4_GRID)
def test_b4_kernel_bit_equal_to_plain(cuda, topology, sine_order, n, audio_f32):
    p = _params(cuda, max(LARGE_POPS), topology_dims(topology), seed=n + sine_order)
    win = torch.from_numpy(hann_window(n).astype(np.float32)).to(cuda)
    kw = dict(topology=topology, n=n, sine_order=sine_order, audio_f32=audio_f32)
    want = sst.fused_synth_stream_plain(p, win, pop_block=max(LARGE_POPS), **kw)
    for pop in LARGE_POPS:
        before = sst.fused_synth_stream.launches
        got = sst.fused_synth_stream(p[:pop], win, **kw)
        assert sst.fused_synth_stream.launches == before + 1
        assert got.dtype == (torch.float32 if audio_f32 else torch.bfloat16)
        assert torch.equal(got, want[:, :pop])


@pytest.mark.parametrize("log2n,engine,counter", [(13, "synth_fold", sfo.fused_synth_fold),
                                                  (15, "synth_stream", sst.fused_synth_stream)])
def test_evolve_runs_through_the_large_frame_kernels(cuda, log2n, engine, counter):
    n = 1 << log2n
    cfg = ESConfig(num_parents=64, num_offspring=4032, audio_length_log2=log2n,
                   synthesis_engine="scanless", dft_dtype="int8", sine_order=7,
                   fused_generation=True, pop_block=1024)
    so = make_spectrum_ops(cfg, device=cuda)
    assert active_engine(cfg, so) == engine
    audio = synthesize_single(torch.tensor(TRUTH[:6]), n, cfg.topology, engine="scanless")
    tgt = target_spectrum(audio.to(cuda), so)
    launches = (counter.launches, sf.fused_synth_fitness.launches, gn.fused_generation.launches)
    final, traj = evolve(init_state(0, cfg, device=cuda), tgt, 5, so, cfg, record_trajectory=True)
    assert counter.launches - launches[0] == 5
    assert (sf.fused_synth_fitness.launches, gn.fused_generation.launches) == launches[1:]
    assert torch.isfinite(traj).all() and float(traj[-1]) < float(traj[0])


def _f32_setup(dev, n=1024, pop=4096):
    cfg = ESConfig(num_parents=64, num_offspring=pop - 64, audio_length_log2=int(np.log2(n)),
                   dft_dtype="float32", sine_order=9, mutation_noise="clt12_neutral",
                   min_step=1e-4, fused_generation=True, pop_block=pop)
    so = make_spectrum_ops(cfg, device=dev)
    tgt = target_spectrum(synthesize_single(torch.tensor(TRUTH[:6]), n, cfg.topology).to(dev), so)
    return cfg, so, tgt


# B1/B2 true f32 against their plain versions: the same f32 audio, the DFT
# summed in another order (limits as chip_smoke.py's)
F32_FIT_MAX_REL, F32_FIT_MEDIAN_REL = 1e-5, 1e-6


@pytest.mark.parametrize("n,pop", [(1024, 4096), (2048, 4096), (2048, RAGGED_POP)])
def test_b1_b2_f32_kernels_match_plain(cuda, n, pop):
    cfg, so, tgt = _f32_setup(cuda, n, pop)
    assert so.dft_packed.dtype == torch.float32 and so.dft_packed_scale == 0.0
    p = _params(cuda, cfg.population_size)
    p[0] = torch.tensor(TRUTH[:6], device=cuda)
    kw = dict(dft_packed=so.dft_packed, dft_scale=0.0, n=n, pop_block=cfg.population_size,
              sine_order=9)
    before = sf.fused_synth_fitness.launches
    got = sf.fused_synth_fitness(p, tgt, **kw)
    assert sf.fused_synth_fitness.launches == before + 1
    ref = sf.fused_synth_fitness_plain(p, tgt, **kw)
    rel = (got - ref).abs() / ref.abs()
    assert float(rel.max()) <= F32_FIT_MAX_REL and float(rel.median()) <= F32_FIT_MEDIAN_REL
    assert int(got.argmin()) == 0 and int(ref.argmin()) == 0
    g = torch.Generator(device=cuda).manual_seed(1)
    pv = torch.rand((64, 6), generator=g, device=cuda)
    ps = torch.rand((64, 6), generator=g, device=cuda) * 0.3
    kw2 = dict(pop=cfg.population_size, param_mins=cfg.param_mins, param_maxs=cfg.param_maxs,
               root_two_over_pi=cfg.root_two_over_pi, min_step=1e-4, **kw)
    seed = kernel_seed(7, 11)
    fk, vk, sk = gn.fused_generation(seed, pv, ps, tgt, **kw2)
    fp, vp, sp = gn.fused_generation_plain(seed, pv, ps, tgt, **kw2)
    assert torch.equal(vk, vp)
    assert float(((sk - sp).abs() / sp.abs()).max()) <= STEP_MAX_REL
    rel = (fk - fp).abs() / fp.abs()
    assert float(rel.max()) <= F32_FIT_MAX_REL and float(rel.median()) <= F32_FIT_MEDIAN_REL


def _bits_equal(a, b):
    """Equal bit for bit: NaN payloads and the sign of zero included."""
    a, b = a.reshape(-1).contiguous(), b.reshape(-1).contiguous()
    return a.dtype == b.dtype and torch.equal(a.view(torch.int32), b.view(torch.int32))


# B5's cases: the driven settings (ids as before), then the selection's ties
# (identical candidates: every fitness equal; a NaN in the target: every
# fitness NaN) and a population whose keys do not fit its shared memory
B5_CASES = [
    pytest.param("int8", 4096, "run", id="int8-4096"),
    pytest.param("int8", RAGGED_POP, "run", id="int8-4001"),
    pytest.param("float32", 4096, "run", id="float32-4096"),
    pytest.param("float32", RAGGED_POP, "run", id="float32-4001"),
    pytest.param("float32", 1 << 15, "run", id="float32-32768"),
    pytest.param("int8", 4096, "same", id="int8-4096-identical"),
    pytest.param("float32", 4096, "same", id="float32-4096-identical"),
    pytest.param("int8", 4096, "nan", id="int8-4096-nan"),
    pytest.param("int8", 1 << 16, "run", id="int8-65536"),
]


@pytest.mark.parametrize("dtype,pop,case", B5_CASES)
def test_b5_bit_equal_to_b2_launches(cuda, dtype, pop, case):
    """G generations in one B5 call == G B2 launches + the stable selection,
    bit for bit (B5 runs B2's own kernels, so this holds its selection and
    its loop); on ties the survivors are candidates 0..mu-1 in order."""
    from pmfm_tpu_torch.kernels import evolve as ev

    if dtype == "int8":
        cfg, so, tgt = _setup(cuda, pop=pop)
    else:
        cfg, so, tgt = _f32_setup(cuda, pop=pop)
    g = torch.Generator(device=cuda).manual_seed(2)
    pv = torch.rand((64, 6), generator=g, device=cuda)
    ps = torch.rand((64, 6), generator=g, device=cuda) * 0.3
    min_step = cfg.min_step
    if case == "same":
        pv, ps, min_step = pv[:1].expand(64, 6).contiguous(), torch.zeros_like(ps), 0.0
    if case == "nan":
        tgt = tgt.clone()
        tgt[3] = float("nan")
    kw = dict(pop=cfg.population_size, param_mins=cfg.param_mins, param_maxs=cfg.param_maxs,
              dft_packed=so.dft_packed, dft_scale=so.dft_packed_scale, n=cfg.n_samples,
              pop_block=cfg.population_size, sine_order=cfg.sine_order,
              root_two_over_pi=cfg.root_two_over_pi, min_step=min_step)
    seeds = [kernel_seed(5, i) for i in range(8)]
    args = (pv, ps, pv[0].clone(), torch.tensor(float("inf"), device=cuda), tgt)
    before = ev.fused_evolve.launches
    out = ev.fused_evolve(seeds, *args, **kw)
    assert ev.fused_evolve.launches == before + 1
    loop = ev.fused_evolve_plain(seeds, *args, generation=gn.fused_generation, **kw)
    for a, b in zip(out, loop):
        assert _bits_equal(a, b)
    traj = out[5]
    assert (traj[1:] <= traj[:-1]).all() and float(out[4]) == float(traj[-1])
    assert ev.select_geometry(pop, 64)["keys_in_shared"] is (pop < 1 << 16)
    if case == "run":
        return
    fit, val, _ = gn.fused_generation(seeds[0], pv, ps, tgt, **kw)
    assert torch.equal(ev.stable_order(fit)[:64].cpu(), torch.arange(64))
    if case == "same":
        assert (fit == fit[0]).all() and torch.isfinite(fit).all()
        assert torch.equal(out[0], pv) and torch.equal(val[:64], pv)
    else:
        assert torch.isnan(fit).all() and torch.isnan(out[2]).all() and torch.isinf(traj).all()


def test_evolve_fused_evolve_is_one_launch(cuda):
    from pmfm_tpu_torch.kernels import evolve as ev

    cfg, so, tgt = _setup(cuda)
    cfg = cfg.replace(fused_evolve=True)
    launches = (ev.fused_evolve.launches, gn.fused_generation.launches)
    final, traj = evolve(init_state(0, cfg, device=cuda), tgt, 20, so, cfg, record_trajectory=True)
    assert (ev.fused_evolve.launches - launches[0], gn.fused_generation.launches) == (1, launches[1])
    assert final.generation == 20 and traj.shape == (20,)
    assert torch.isfinite(traj).all() and float(traj[-1]) < float(traj[0])
    assert float(final.best_fitness) == float(traj[-1])


# -- the scan kernel, the unfused engines and the CLI ----------------------------

@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("osc_mode", ["floor", "exact", "table"])
@pytest.mark.parametrize("topology", ["fm2", "fm3_series", "fm8_series", "fm3_parallel",
                                      "fm10_series", "fm5_parallel", "fm33_series",
                                      "fm33_parallel"])
def test_scan_kernel_bit_equal_to_plain(cuda, topology, osc_mode, out_dtype):
    """csrc/scan_synth.cu bit for bit against its plain loop over samples,
    at every chain class (compile-time lengths and the runtime-length
    instantiation, its state in the wrapper's scratch, past 32 included),
    oscillator and output type."""
    from pmfm_tpu_torch.kernels import scan as ss

    d = topology_dims(topology)
    maxs = (3520.0, 8.0) * (d // 2) if "series" in topology else (3520.0, 8.0, 3520.0, 1.0) * (d // 4)
    rng = np.random.default_rng(d)
    p = torch.from_numpy((rng.random((300, d)) * np.asarray(maxs)).astype(np.float32)).to(cuda)
    before = ss.scan_synth.launches
    a = ss.scan_synth(p, 512, topology, osc_mode=osc_mode, out_dtype=out_dtype)
    assert ss.scan_synth.launches == before + 1
    b = ss.scan_synth_plain(p, 512, topology, osc_mode=osc_mode, out_dtype=out_dtype)
    assert a.dtype == out_dtype and a.shape == (512, 300)
    assert _bits_equal(a.float(), b.float())


@pytest.mark.parametrize("synth", ["scan", "scanless"])
@pytest.mark.parametrize("method,dtype", [("dft", "float32"), ("dft", "int8"),
                                          ("dft", "bfloat16"), ("rfft", "float32")])
def test_unfused_engines_card_matches_cpu(cuda, method, dtype, synth):
    """Each unfused engine on the card against the same engine on the CPU,
    within the CPU tests' limits against the reference (mild-index ranges,
    tests/test_torch_unfused.py; chip_smoke.py's UNFUSED_TOL)."""
    from chip_smoke import UNFUSED_TOL
    from pmfm_tpu_torch.es import evaluate

    cfg = ESConfig(num_parents=8, num_offspring=248, audio_length_log2=10,
                   param_maxs=(2000.0, 2.0) * 3, spectrum_method=method, dft_dtype=dtype,
                   synthesis_engine=synth)
    rng = np.random.default_rng(7)
    v = torch.from_numpy(rng.random((256, 6)).astype(np.float32))
    t = torch.from_numpy((rng.random(512) * 5.0).astype(np.float32))
    got = evaluate(v.to(cuda), t.to(cuda), make_spectrum_ops(cfg, device=cuda), cfg).cpu()
    want = evaluate(v, t, make_spectrum_ops(cfg, device="cpu"), cfg)
    e = (got.double() - want.double()).abs() / want.double().abs()
    max_rel, median_rel = UNFUSED_TOL[dtype]
    assert float(e.max()) <= max_rel and float(e.median()) <= median_rel


def test_cli_runs_on_the_card(cuda, tmp_path, monkeypatch, capsys):
    """python -m pmfm_tpu_torch.cli -j parameters.json on the card (20
    generations): exit 0, the unfused engine named, one scan launch a
    generation, the WAV and the CSV written."""
    from pmfm_tpu_torch import cli
    from pmfm_tpu_torch.kernels import scan as ss

    root = Path(__file__).resolve().parent.parent
    monkeypatch.chdir(tmp_path)
    before = ss.scan_synth.launches
    assert cli.main(["-j", str(root / "parameters.json"), "--generations", "20"]) == 0
    assert ss.scan_synth.launches - before >= 22
    assert "engine: xla_dft on cuda" in capsys.readouterr().out
    assert (tmp_path / "output_audio" / "output.wav").exists()
    assert (tmp_path / "gpulog(pop=32gens=20audioBlockSize=2048).csv").exists()


# ---- multi-frame fitness and the run axis (A6) ---------------------------------------

F32_MAX_REL, F32_MEDIAN_REL = 1e-5, 1e-6  # chip_smoke.py's B1/B2 f32 limits


@pytest.mark.parametrize("dtype", ["int8", "float32"])
@pytest.mark.parametrize("frames", [2, 8])
@pytest.mark.parametrize("topology,n", [("fm3_series", 2048), ("fm2", 1024),
                                        ("fm3_parallel", 1024), ("fm9_parallel", 1024),
                                        ("fm17_series", 2048)])
def test_b1_b2_frames_kernel_matches_plain(cuda, topology, n, frames, dtype):
    """B1 and B2 at F frames against their plain versions (int8 1e-3 / 1e-5,
    f32 1e-5 / 1e-6), B2's values bit-equal, at a ragged population."""
    d, pop = topology_dims(topology), 129
    so = make_spectrum_ops(ESConfig(num_dimensions=d, topology=topology, param_mins=(0.0,) * d,
                                    param_maxs=(1.0,) * d, audio_length_log2=int(np.log2(n)),
                                    dft_dtype=dtype), device=cuda)
    rng = np.random.default_rng(frames + n)
    maxs = ((3520.0, 8.0, 3520.0, 1.0) * (d // 4) if "parallel" in topology
            else (3520.0, 8.0) * (d // 2))
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda)  # noqa: E731
    p = t(rng.random((pop, d)) * np.asarray(maxs))
    pv, ps = t(rng.random((16, d))), t(rng.uniform(0.02, 0.3, (16, d)))
    tgt = t(rng.uniform(0, 50, (frames, so.num_bins)))
    kw = dict(dft_packed=so.dft_packed, dft_scale=so.dft_packed_scale, topology=topology, n=n,
              pop_block=pop, sine_order=9, num_frames=frames)
    kw2 = dict(kw, pop=pop, param_mins=(0.0,) * d, param_maxs=maxs)
    max_rel, median_rel = (FIT_MAX_REL, FIT_MEDIAN_REL) if dtype == "int8" else (F32_MAX_REL,
                                                                                  F32_MEDIAN_REL)
    for got, ref in ((sf.fused_synth_fitness(p, tgt, **kw),
                      sf.fused_synth_fitness_plain(p, tgt, **kw)),
                     (gn.fused_generation(7, pv, ps, tgt, **kw2),
                      gn.fused_generation_plain(7, pv, ps, tgt, **kw2))):
        if isinstance(got, tuple):
            assert torch.equal(got[1], ref[1])
            got, ref = got[0], ref[0]
        rel = (got - ref).abs() / ref.abs()
        assert float(rel.max()) <= max_rel and float(rel.median()) <= median_rel


@pytest.mark.parametrize("dtype", ["int8", "float32"])
@pytest.mark.parametrize("runs,frames", [(1, 1), (1, 2), (3, 1), (4, 2)])
def test_run_axis_kernels_bit_equal_to_lone_launches(cuda, dtype, runs, frames):
    """One launch of B1, B2 and B5 for B runs is bit-equal, run for run, to
    B lone launches with each run's operands and seeds."""
    from pmfm_tpu_torch.kernels import evolve as ev

    d, pop, mu = 6, RAGGED_POP, 64
    so = make_spectrum_ops(ESConfig(audio_length_log2=10, dft_dtype=dtype), device=cuda)
    rng = np.random.default_rng(runs)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda)  # noqa: E731
    p = t(rng.random((runs, pop, d)) * 3520.0)
    pv, ps = t(rng.random((runs, mu, d))), t(rng.uniform(0.02, 0.3, (runs, mu, d)))
    tgt = t(rng.uniform(0, 50, (runs, frames, so.num_bins)))
    kw = dict(dft_packed=so.dft_packed, dft_scale=so.dft_packed_scale, n=1024, pop_block=pop,
              num_frames=frames)
    kw2 = dict(kw, pop=pop, param_mins=(0.0,) * d, param_maxs=(3520.0, 8.0) * 3)
    seeds = [kernel_seed(5, r) for r in range(runs)]
    fb = sf.fused_synth_fitness(p, tgt, **kw)
    gb = gn.fused_generation(seeds, pv, ps, tgt, **kw2)
    s5 = [[kernel_seed(9, r * 3 + g) for g in range(3)] for r in range(runs)]
    bv, bf = pv[:, 0].clone(), torch.full((runs,), float("inf"), device=cuda)
    eb = ev.fused_evolve(s5, pv, ps, bv, bf, tgt, **kw2)
    for r in range(runs):
        assert torch.equal(fb[r], sf.fused_synth_fitness(p[r], tgt[r], **kw))
        lone = gn.fused_generation(seeds[r], pv[r], ps[r], tgt[r], **kw2)
        assert all(torch.equal(a[r], b) for a, b in zip(gb, lone))
        lone5 = ev.fused_evolve(s5[r], pv[r], ps[r], bv[r], bf[r], tgt[r], **kw2)
        assert all(torch.equal(a[r].nan_to_num(), b.nan_to_num()) for a, b in zip(eb, lone5))


def test_match_many_is_one_b2_launch_a_generation(cuda):
    """``match_many`` over four targets at two frames: one B2 launch a
    generation for all runs (int8, then the f32 tail), one B1 rescore."""
    from pmfm_tpu_torch.es import match_many

    cfg = ESConfig(num_parents=16, num_offspring=1008, audio_length_log2=10, dft_dtype="int8",
                   fused_kernel=True, fused_generation=True, refine_generations=3)
    targets = np.stack([synthesize_single(torch.tensor(TRUTH[:6]) * s, 2048,
                                          "fm3_series").numpy() for s in (1.0, 0.9, 0.8, 0.7)])
    gn.fused_generation.launches_by.clear()
    sf.fused_synth_fitness.launches_by.clear()
    res = match_many(targets, cfg, seed=1, num_generations=10, device=cuda)
    assert len(res) == 4 and all(np.isfinite(r.chunks[0].best_fitness) for r in res)
    assert dict(gn.fused_generation.launches_by) == {"int8_frames_runs": 7, "f32_frames_runs": 3}
    assert dict(sf.fused_synth_fitness.launches_by) == {"f32_frames_runs": 1}


# ---- banks in B3/B4/B5 and 20 to 32 genes in every kernel (Queue B item 3) ----

BANKS = ["fm2_parallel", "fm3_parallel", "fm4_parallel", "fm5_parallel"]
WIDE = ["fm5_parallel", "fm8_parallel", "fm10_series", "fm16_series"]


def _topology_params(dev, pop, topology, seed):
    """Scaled parameters over the examples' ranges: 3520 Hz and index 8 an
    operator, amplitude 1 a pair of a bank."""
    d = topology_dims(topology)
    maxs = ((3520.0, 8.0, 3520.0, 1.0) * (d // 4) if "parallel" in topology
            else (3520.0, 8.0) * (d // 2))
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.random((pop, d)) * np.asarray(maxs)).astype(np.float32)).to(dev)


@pytest.mark.parametrize("dft_scale", [1e-5, 0.0])
@pytest.mark.parametrize("n", [4096, 8192])
@pytest.mark.parametrize("sine_order", [7, 9])
@pytest.mark.parametrize("topology", BANKS + ["fm8_parallel", "fm12_series"])
def test_b3_bank_kernel_bit_equal_to_plain(cuda, monkeypatch, topology, sine_order, n, dft_scale):
    """B3 on a bank (the pairs' modulators level by level, then one
    emitting pass summing the pairs in order; int8 with the bank's gains and
    mag_scale s * dft_scale, bf16 the pair mean) and on a wide chain, in both
    layouts, bit-equal to its plain version at each of LARGE_POPS
    (chip_smoke.py phase 30's settings)."""
    p = _topology_params(cuda, max(LARGE_POPS), topology, seed=n + sine_order)
    kw = dict(topology=topology, n=n, sine_order=sine_order, dft_scale=dft_scale)
    want = sfo.fused_synth_fold_plain(p, pop_block=max(LARGE_POPS), **kw)
    for pop in LARGE_POPS:
        for below in (1 << 62, 0):
            monkeypatch.setattr(sfo, "FOLD_TP_BELOW_POP",
                                dict.fromkeys(sfo.FOLD_TP_BELOW_POP, below))
            assert sfo.fold_geometry(pop, n, dft_scale > 0, topology)["time_parallel"] == bool(below)
            got = sfo.fused_synth_fold(p[:pop], **kw)
            assert all(torch.equal(a, b[..., :pop]) for a, b in zip(got, want))


B4_BANK_GRID = [("fm2_parallel", 7, 65536), ("fm3_parallel", 9, 65536),
                ("fm4_parallel", 7, 32768), ("fm5_parallel", 9, 131072),
                ("fm8_parallel", 9, 32768), ("fm12_series", 7, 32768)]


@pytest.mark.parametrize("audio_f32", [False, True])
@pytest.mark.parametrize("topology,sine_order,n", B4_BANK_GRID)
def test_b4_bank_kernel_bit_equal_to_plain(cuda, topology, sine_order, n, audio_f32):
    """B4 on a bank (its 2k carries: each pair's modulator level by level,
    the pairs' mean times the window) and on a wide chain, bit-equal to its
    plain version (131072: the level totals in device memory)."""
    p = _topology_params(cuda, max(LARGE_POPS), topology, seed=n + sine_order)
    win = torch.from_numpy(hann_window(n).astype(np.float32)).to(cuda)
    kw = dict(topology=topology, n=n, sine_order=sine_order, audio_f32=audio_f32)
    want = sst.fused_synth_stream_plain(p, win, pop_block=max(LARGE_POPS), **kw)
    for pop in LARGE_POPS:
        assert torch.equal(sst.fused_synth_stream(p[:pop], win, **kw), want[:, :pop])


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("frames,runs", [(1, None), (8, None), (1, 4)])
def test_b5_bank_bit_equal_to_b2_launches(cuda, dtype, frames, runs):
    """B5 on fm3_parallel: G generations in one call == G launches of B2's
    bank kernel + the stable selection, bit for bit, in each mode, at 8
    frames and with a run axis of 4 (chip_smoke.py phase 31's settings)."""
    from pmfm_tpu_torch.kernels import evolve as ev

    topology, pop, mu, d = "fm3_parallel", RAGGED_POP, 64, 12
    maxs = (3520.0, 8.0, 3520.0, 1.0) * 3
    so = make_spectrum_ops(ESConfig(num_dimensions=d, topology=topology, param_mins=(0.0,) * d,
                                    param_maxs=maxs, audio_length_log2=10, dft_dtype=dtype),
                           device=cuda)
    rng = np.random.default_rng(frames + (runs or 0))
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda)  # noqa: E731
    lead = () if runs is None else (runs,)
    pv, ps = t(rng.random(lead + (mu, d))), t(rng.uniform(0.02, 0.3, lead + (mu, d)))
    tgt = t(rng.uniform(0, 50, lead + (frames, so.num_bins)))
    kw = dict(pop=pop, param_mins=(0.0,) * d, param_maxs=maxs, dft_packed=so.dft_packed,
              dft_scale=so.dft_packed_scale, topology=topology, n=1024, pop_block=pop,
              sine_order=9, num_frames=frames)
    gens = 6
    if runs is None:
        seeds = [kernel_seed(11, g) for g in range(gens)]
        best = (pv[0].clone(), torch.tensor(float("inf"), device=cuda))
    else:
        seeds = [[kernel_seed(11 + r, g) for g in range(gens)] for r in range(runs)]
        best = (pv[:, 0].clone(), torch.full((runs,), float("inf"), device=cuda))
    args = (pv, ps, *best, tgt)
    before = ev.fused_evolve.launches
    out = ev.fused_evolve(seeds, *args, **kw)
    assert ev.fused_evolve.launches == before + 1
    loop = ev.fused_evolve_plain(seeds, *args, generation=gn.fused_generation, **kw)
    assert all(_bits_equal(a, b) for a, b in zip(out, loop))


@pytest.mark.parametrize("pop", [1, 65, RAGGED_POP])
@pytest.mark.parametrize("topology", WIDE)
@pytest.mark.parametrize("n", [1024, 3584])
@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_b1_b2_wide_grid(cuda, dtype, n, topology, pop):
    """B1/B2 at 20 to 32 genes (fm5_parallel's compile-time bank, the wide
    bank and the wide chain) against their plain versions in the int8 / bf16
    and the f32 limits, B2's values bit-equal and its fitness bit-equal to
    B1's on its own offspring (chip_smoke.py phase 32's settings)."""
    limits = (F32_FIT_MAX_REL, F32_FIT_MEDIAN_REL) if dtype == "float32" else (FIT_MAX_REL,
                                                                              FIT_MEDIAN_REL)
    _grid_case(cuda, dtype, n, None, topology, 9, pop, limits)


# A9 on the card: resume bit-equal under B2 (with restarts, which draw from
# the CUDA generator) and B5, and an artifact run with the build disabled
@pytest.mark.parametrize("engine", ["fused_generation", "restarts", "fused_evolve"])
def test_evolve_checkpointed_resume_bit_equal(cuda, tmp_path, monkeypatch, engine):
    from pmfm_tpu_torch.es import evolve_checkpointed
    from pmfm_tpu_torch.kernels import evolve as ev
    from pmfm_tpu_torch.utils import checkpoint

    cfg, so, tgt = _setup(cuda)
    cfg = {"fused_generation": cfg, "restarts": cfg.replace(restart_patience=2),
           "fused_evolve": cfg.replace(fused_evolve=True)}[engine]
    want, want_traj = evolve(init_state(4, cfg, device=cuda), tgt, 30, so, cfg,
                             record_trajectory=True)
    if engine == "restarts":  # a restart fires inside the run: 2 stalls in a row
        same = (want_traj[1:] == want_traj[:-1]).cpu().numpy()
        assert (same[1:] & same[:-1]).any()
    save, count = checkpoint.save_checkpoint, []

    def stop_after_two(*a, **k):
        save(*a, **k)
        count.append(1)
        if len(count) == 2:
            raise KeyboardInterrupt

    monkeypatch.setattr(checkpoint, "save_checkpoint", stop_after_two)
    with pytest.raises(KeyboardInterrupt):
        evolve_checkpointed(init_state(4, cfg, device=cuda), tgt, 30, so, cfg, tmp_path,
                            every=10, record_trajectory=True)
    monkeypatch.setattr(checkpoint, "save_checkpoint", save)
    before = (gn.fused_generation.launches, ev.fused_evolve.launches)
    got, traj = evolve_checkpointed(init_state(4, cfg, device=cuda), tgt, 30, so, cfg, tmp_path,
                                    every=10, record_trajectory=True)
    after = (gn.fused_generation.launches, ev.fused_evolve.launches)
    assert after[1] - before[1] == (1 if engine == "fused_evolve" else 0)
    assert after[0] - before[0] == (0 if engine == "fused_evolve" else 10)
    for f in ("parent_values", "parent_steps", "parent_fitness", "best_values", "best_fitness",
              "stall"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert torch.equal(got.generator.get_state(), want.generator.get_state())
    np.testing.assert_array_equal(traj, want_traj.cpu().numpy())


def test_aot_runs_with_the_build_disabled(cuda, tmp_path):
    """An artifact exported here runs in a subprocess on a copy of the
    package whose build directory is empty and whose ``_build.build``
    raises, and returns what the live matcher returns."""
    import os
    import shutil
    import subprocess
    import sys

    from pmfm_tpu_torch.es import match_audio_stft
    from pmfm_tpu_torch.utils import aot

    repo = Path(__file__).resolve().parent.parent

    cfg, _, _ = _setup(cuda)
    target = np.random.default_rng(5).standard_normal(2 * 1024).astype(np.float32)
    art = tmp_path / "m.pmfm"
    aot.save_matcher(art, cfg, 20, target_samples=len(target))
    np.save(tmp_path / "target.npy", target)
    shutil.copytree(repo / "pmfm_tpu_torch", tmp_path / "copy" / "pmfm_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    script = (
        "import json, sys, numpy as np\n"
        "from pmfm_tpu_torch.kernels import _build\n"
        "assert not _build.library_path().exists()\n"
        "def refuse(): raise RuntimeError('the build is disabled')\n"
        "_build.build = refuse\n"
        "from pmfm_tpu_torch.utils import aot\n"
        f"m = aot.load_matcher({str(art)!r})\n"
        f"out = m(3, np.load({str(tmp_path / 'target.npy')!r}))\n"
        f"np.savez({str(tmp_path / 'out.npz')!r}, **out)\n"
    )
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path / "copy",
                          env={**os.environ, "PYTHONPATH": str(tmp_path / "copy")},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    live = match_audio_stft(target, cfg, seed=3, num_generations=20, device=cuda)
    with np.load(tmp_path / "out.npz") as out:
        assert out["best_fitness"] == np.float32(live.chunks[0].best_fitness)
        np.testing.assert_array_equal(out["best_params_norm"], live.chunks[0].best_params_norm)
        np.testing.assert_array_equal(out["best_audio"], live.output_audio)


# A10 on the card: a world of one on NCCL bit-equal to evolve, ranks sharing
# the card through gloo; A1's gate at a few seeds
@pytest.mark.parametrize("restart_patience", [0, 2])
def test_mesh_world_of_one_bit_equal_to_evolve(cuda, restart_patience):
    import torch.distributed as dist

    from pmfm_tpu_torch.parallel import evolve_sharded, make_mesh

    cfg, so, tgt = _setup(cuda)
    cfg = cfg.replace(restart_patience=restart_patience)
    mesh = make_mesh((1,), device=cuda)
    try:
        assert mesh.backend == "nccl"
        want, want_traj = evolve(init_state(6, cfg, device=cuda), tgt, 30, so, cfg,
                                 record_trajectory=True)
        before = gn.fused_generation.launches
        got, traj = evolve_sharded(init_state(6, cfg, device=cuda), tgt, 30, so, cfg, mesh,
                                   record_trajectory=True)
        assert gn.fused_generation.launches - before == 30
    finally:
        dist.destroy_process_group()
    for f in ("parent_values", "parent_steps", "parent_fitness", "best_values", "best_fitness",
              "stall"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert torch.equal(traj, want_traj)


@pytest.mark.parametrize("mesh2d", [False, True], ids=["2-pop", "1-pop-x-2-frame"])
def test_mesh_ranks_share_the_card(cuda, mesh2d):
    """Two ranks on cuda:0 through gloo (multiprocess_check): every rank's
    state byte-equal, B2 launched each generation on the 1-D mesh and never
    on the frame axis, as each rank's engine line says, the frame
    all-reduce within the unfused engines' limits of the unsharded
    multi-frame fitness."""
    import re

    from pmfm_tpu_torch import multiprocess_check as mp

    code, lines = mp.run(2, mesh2d, "cuda")
    assert code == 0
    text = "\n".join(lines)
    assert len(set(re.findall(r"digest=(\w+)", text))) == 1
    assert "backend=gloo" in text and "device=cuda:0" in text
    engine, launches = ("xla_stft (frame-sharded)", 0) if mesh2d else ("fused_generation",
                                                                      mp.GENERATIONS)
    assert re.findall(r"^MPENGINE \d+ (.*)$", text, re.M) == [engine] * 2
    assert re.findall(r"fused_generation=(\d+)", text) == [str(launches)] * 2
    if mesh2d:
        for m in re.finditer(r"max_rel=(\S+) median_rel=(\S+)", text):
            assert float(m.group(1)) <= 1e-3 and float(m.group(2)) <= 1e-6


def test_convergence_check_on_the_card(cuda, tmp_path):
    """The quality gate's run at P 2^12, 20 generations, 2 seeds: the
    reference's layout, the card's name, B2 and B1 launched."""
    import json

    from pmfm_tpu_torch import bench
    from pmfm_tpu_torch import convergence_check as cc
    from pmfm_tpu_torch.kernels import synth_fitness

    path = tmp_path / "gate.json"
    b2, b1 = gn.fused_generation.launches, synth_fitness.fused_synth_fitness.launches
    assert cc.main(["--pop-log2", "12", "--mu", "64", "--gens", "20", "--seeds", "2",
                    "--seed-offset", "64", "--split", "holdout", "--variants", "f32",
                    "int8+sin7", "int8+sin7+refine", "shipped", "--json", str(path)]) == 0
    assert gn.fused_generation.launches > b2 and synth_fitness.fused_synth_fitness.launches > b1
    doc = json.loads(path.read_text())
    assert doc["meta"]["device"]["name"] not in ("", "cpu", "?")
    assert bench.generations_to_converge(str(path))["split"] == "holdout"
    assert set(bench.quality_holdout(str(path))) == {"int8+sin7+refine", "shipped"}


# ---- above 32 genes: the long code in every kernel (Queue B item 3) ----
# (chip_smoke.py phase 41's checks)

LONG = ["fm9_parallel", "fm16_parallel", "fm17_series"]


@pytest.mark.parametrize("kernel", ["B1 int8", "B1 bfloat16", "B1 float32", "B2 int8",
                                    "B2 bfloat16", "B2 float32", "B3 int8", "B3 bf16", "B4 f32",
                                    "B4 bf16"])
@pytest.mark.parametrize("topology", WIDE + ["fm3_parallel", "fm4_series"])
def test_long_code_bit_equal_to_fixed_and_wide(cuda, monkeypatch, topology, kernel):
    """With LONG_ABOVE_GENES lowered to 4, the long code takes topologies the
    fixed and wide codes run, and every output is theirs bit for bit."""
    from pmfm_tpu_torch.ops import spectral

    which, mode = kernel.split()
    p = _topology_params(cuda, 1000, topology, seed=5)
    d = p.shape[1]
    if which in ("B1", "B2"):
        so = spectral.make_spectrum_ops(1024, None, dft_dtype=mode, device=cuda)
        tgt = torch.rand(so.num_bins, device=cuda) * 50
        kw = dict(dft_packed=so.dft_packed, dft_scale=so.dft_packed_scale, topology=topology,
                  n=1024, sine_order=9)
        pv = torch.rand((64, d), device=cuda)
        ps = torch.full((64, d), 0.1, device=cuda)
        maxs = ((3520.0, 8.0, 3520.0, 1.0) * (d // 4) if "parallel" in topology
                else (3520.0, 8.0) * (d // 2))

        def run():
            if which == "B1":
                return (sf.fused_synth_fitness(p, tgt, **kw),)
            return gn.fused_generation(3, pv, ps, tgt, pop=1000, param_mins=(0.0,) * d,
                                       param_maxs=maxs, **kw)
    elif which == "B3":
        def run():
            return sfo.fused_synth_fold(p, topology=topology, n=4096, sine_order=7,
                                        dft_scale=1e-5 if mode == "int8" else 0.0)
    else:
        win = torch.from_numpy(hann_window(8192).astype(np.float32)).to(cuda)

        def run():
            return (sst.fused_synth_stream(p, win, topology=topology, n=8192, sine_order=7,
                                           audio_f32=mode == "f32"),)
    want = run()
    monkeypatch.setattr(sf, "LONG_ABOVE_GENES", 4)
    assert sf.uses_long_code(topology)
    got = run()
    assert all(_bits_equal(a.float(), b.float()) for a, b in zip(got, want))


@pytest.mark.parametrize("pop", [1, 65, RAGGED_POP])
@pytest.mark.parametrize("topology", LONG)
@pytest.mark.parametrize("n", [256, 1024, 3584])
@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_b1_b2_long_grid(cuda, dtype, n, topology, pop):
    """B1/B2 above 32 genes (the long code) against their plain versions in
    the int8 / bf16 and the f32 limits, B2's values bit-equal and its fitness
    bit-equal to B1's on its own offspring (fm16_parallel at n 256: its 64
    genes staged fill the int8 block's shared memory)."""
    limits = (F32_FIT_MAX_REL, F32_FIT_MEDIAN_REL) if dtype == "float32" else (FIT_MAX_REL,
                                                                              FIT_MEDIAN_REL)
    _grid_case(cuda, dtype, n, None, topology, 9, pop, limits)


@pytest.mark.parametrize("dft_scale", [1e-5, 0.0])
@pytest.mark.parametrize("n", [4096, 8192])
@pytest.mark.parametrize("topology", LONG)
def test_b3_long_kernel_bit_equal_to_plain(cuda, topology, n, dft_scale):
    """B3 above 32 genes (the long code's single pass at every population)
    bit-equal to its plain version at each of LARGE_POPS."""
    p = _topology_params(cuda, max(LARGE_POPS), topology, seed=n)
    kw = dict(topology=topology, n=n, sine_order=9, dft_scale=dft_scale)
    want = sfo.fused_synth_fold_plain(p, pop_block=max(LARGE_POPS), **kw)
    for pop in LARGE_POPS:
        assert not sfo.fold_geometry(pop, n, dft_scale > 0, topology)["time_parallel"]
        got = sfo.fused_synth_fold(p[:pop], **kw)
        assert all(torch.equal(a, b[..., :pop]) for a, b in zip(got, want))


@pytest.mark.parametrize("audio_f32", [False, True])
@pytest.mark.parametrize("topology,n", [("fm9_parallel", 65536), ("fm17_series", 32768),
                                        ("fm16_parallel", 8192)])
def test_b4_long_kernel_bit_equal_to_plain(cuda, topology, n, audio_f32):
    """B4 above 32 genes (the long code, a thread a candidate over the frame)
    bit-equal to its plain version at each of LARGE_POPS."""
    p = _topology_params(cuda, max(LARGE_POPS), topology, seed=n)
    win = torch.from_numpy(hann_window(n).astype(np.float32)).to(cuda)
    kw = dict(topology=topology, n=n, sine_order=9, audio_f32=audio_f32)
    want = sst.fused_synth_stream_plain(p, win, pop_block=max(LARGE_POPS), **kw)
    for pop in LARGE_POPS:
        assert torch.equal(sst.fused_synth_stream(p[:pop], win, **kw), want[:, :pop])


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("topology", ["fm9_parallel", "fm17_series"])
def test_b5_long_bit_equal_to_b2_launches(cuda, topology, dtype):
    """B5 above 32 genes: G generations in one call == G launches of B2's
    long code + the stable selection, bit for bit, in each mode."""
    from pmfm_tpu_torch.kernels import evolve as ev

    pop, mu, d = RAGGED_POP, 64, topology_dims(topology)
    maxs = ((3520.0, 8.0, 3520.0, 1.0) * (d // 4) if "parallel" in topology
            else (3520.0, 8.0) * (d // 2))
    so = make_spectrum_ops(ESConfig(num_dimensions=d, topology=topology, param_mins=(0.0,) * d,
                                    param_maxs=maxs, audio_length_log2=10, dft_dtype=dtype),
                           device=cuda)
    rng = np.random.default_rng(d)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda)  # noqa: E731
    pv, ps = t(rng.random((mu, d))), t(rng.uniform(0.02, 0.3, (mu, d)))
    tgt = t(rng.uniform(0, 50, so.num_bins))
    kw = dict(pop=pop, param_mins=(0.0,) * d, param_maxs=maxs, dft_packed=so.dft_packed,
              dft_scale=so.dft_packed_scale, topology=topology, n=1024, pop_block=pop,
              sine_order=9)
    seeds = [kernel_seed(13, g) for g in range(6)]
    args = (pv, ps, pv[0].clone(), torch.tensor(float("inf"), device=cuda), tgt)
    out = ev.fused_evolve(seeds, *args, **kw)
    loop = ev.fused_evolve_plain(seeds, *args, generation=gn.fused_generation, **kw)
    assert all(_bits_equal(a, b) for a, b in zip(out, loop))



# ---- B2's time-parallel layout (csrc/fused_tp.cuh) -------------------------------


def _tp_layout(monkeypatch, tp):
    """B2's wrapper in one layout: the time-parallel one wherever its kernel
    takes the shape (``tp_faster`` made to say yes), or the one-warp one."""
    monkeypatch.setattr(gn, "tp_faster", lambda *a, **k: tp)


TP_CHAIN_CASES = ["fm2", "fm3_series", "fm4_series", "fm8_series"]
# (topology, n, frames, sine order, population, runs): the banks at n 1024
# and one frame (the pursuit's polishes), then the chains at frames 1, 2, 8
# and every bank at frames 2 and 8, each at n 1024 and 2048, P 4095 / 4096
TP_CASES = (
    [(t, 1024, 1, o, pop, runs) for t in BANKS for o in (5, 7, 9)
     for pop in (2048, 8191, 8192) for runs in (1, 2)]
    + [(t, n, f, o, pop, runs) for t in TP_CHAIN_CASES for f in (1, 2, 8)
       for n in (1024, 2048) for o in (5, 7, 9) for pop in (4095, 4096) for runs in (1, 2)]
    + [(t, n, f, o, pop, runs) for t in BANKS for f in (2, 8)
       for n in (1024, 2048) for o in (5, 7, 9) for pop in (4095, 4096) for runs in (1, 2)])


def _tp_maxs(topology):
    d = topology_dims(topology)
    if topology.endswith("_parallel"):
        return (3520.0, 8.0, 3520.0, 1.0) * (d // 4)
    return (3520.0, 8.0) * (d // 2)


@pytest.mark.parametrize("topology,n,frames,sine_order,pop,runs", TP_CASES)
def test_b2_time_parallel_layout_bit_equal_to_one_warp(cuda, monkeypatch, topology, n, frames,
                                                       sine_order, pop, runs):
    """B2 int8 on a fixed bank or chain: the time-parallel layout's fitness,
    values and steps bit-equal to the one-warp layout's, one launch of each
    counted under its layout, run r of a batched launch included; at one run
    (the banks at one frame), and at one run, sine order 9 and P 4096 (the
    rest: at n 1024, and at F 8 also at n 2048), B2 within the int8 limits
    of its plain version, its values equal and its steps within
    STEP_MAX_REL."""
    d, mu = topology_dims(topology), 64
    maxs = _tp_maxs(topology)
    so = make_spectrum_ops(ESConfig(num_dimensions=d, topology=topology, param_mins=(0.0,) * d,
                                    param_maxs=maxs, audio_length_log2=n.bit_length() - 1,
                                    dft_dtype="int8"),
                           device=cuda)
    rng = np.random.default_rng(pop + sine_order + 10 * frames + n)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda)  # noqa: E731
    lead = () if runs == 1 else (runs,)
    pv, ps = t(rng.random((*lead, mu, d))), t(rng.uniform(0.02, 0.3, (*lead, mu, d)))
    tgt = t(rng.uniform(0, 50, (*lead, frames, so.num_bins) if frames > 1
                        else (*lead, so.num_bins)))
    seed = 77 if runs == 1 else [77 + r for r in range(runs)]
    kw = dict(pop=pop, param_mins=(0.0,) * d, param_maxs=maxs, dft_packed=so.dft_packed,
              dft_scale=so.dft_packed_scale, topology=topology, n=n, pop_block=pop,
              sine_order=sine_order, num_frames=frames)
    outs = {}
    for tp in (False, True):
        _tp_layout(monkeypatch, tp)
        gn.fused_generation.launches_by_layout.clear()
        outs[tp] = gn.fused_generation(seed, pv, ps, tgt, **kw)
        assert dict(gn.fused_generation.launches_by_layout) == {
            "time_parallel" if tp else "one_warp": 1}
    assert all(_bits_equal(a, b) for a, b in zip(outs[False], outs[True]))
    if runs == 1 and ((frames == 1 and topology in BANKS)
                      or (sine_order == 9 and pop == 4096 and (n == 1024 or frames == 8))):
        fk, vk, sk = outs[True]
        fp, vp, spl = gn.fused_generation_plain(seed, pv, ps, tgt, **kw)
        rel = (fk - fp).abs() / fp.abs()
        assert float(rel.max()) <= FIT_MAX_REL and float(rel.median()) <= FIT_MEDIAN_REL
        assert torch.equal(vk, vp)
        assert float(((sk - spl).abs() / spl.abs()).max()) <= STEP_MAX_REL


@pytest.mark.parametrize("topology", ["fm3_series", "fm3_parallel"])
def test_b5_bit_equal_to_time_parallel_b2_launches_at_8_frames(cuda, monkeypatch, topology):
    """B5 at 8 frames (in the layout B2's wrapper takes there: the
    time-parallel one) equals G launches of B2 in the time-parallel layout +
    the stable selection, at --mode stft's shape (P 4096, n 2048)."""
    from pmfm_tpu_torch.kernels import evolve as ev

    pop, mu, d, frames = 4096, 64, topology_dims(topology), 8
    maxs = _tp_maxs(topology)
    so = make_spectrum_ops(ESConfig(num_dimensions=d, topology=topology, param_mins=(0.0,) * d,
                                    param_maxs=maxs, audio_length_log2=11, dft_dtype="int8"),
                           device=cuda)
    rng = np.random.default_rng(d + frames)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda)  # noqa: E731
    pv, ps = t(rng.random((mu, d))), t(rng.uniform(0.02, 0.3, (mu, d)))
    tgt = t(rng.uniform(0, 50, (frames, so.num_bins)))
    kw = dict(pop=pop, param_mins=(0.0,) * d, param_maxs=maxs, dft_packed=so.dft_packed,
              dft_scale=so.dft_packed_scale, topology=topology, n=2048, pop_block=pop,
              sine_order=9, num_frames=frames)
    seeds = [kernel_seed(23, g) for g in range(5)]
    args = (pv, ps, pv[0].clone(), torch.tensor(float("inf"), device=cuda), tgt)
    out = ev.fused_evolve(seeds, *args, **kw)
    _tp_layout(monkeypatch, True)
    gn.fused_generation.launches_by_layout.clear()
    loop = ev.fused_evolve_plain(seeds, *args, generation=gn.fused_generation, **kw)
    assert dict(gn.fused_generation.launches_by_layout) == {"time_parallel": len(seeds)}
    assert all(_bits_equal(a, b) for a, b in zip(out, loop))


@pytest.mark.parametrize("topology", ["fm3_parallel", "fm5_parallel"])
def test_b5_bit_equal_to_time_parallel_b2_launches(cuda, monkeypatch, topology):
    """B5 in the layout B2's wrapper takes (time-parallel at the polish
    population); G generations in one call equal G launches of B2 in the
    time-parallel layout + the stable selection."""
    from pmfm_tpu_torch.kernels import evolve as ev

    pop, mu, d = 8192, 64, topology_dims(topology)
    maxs = (3520.0, 8.0, 3520.0, 1.0) * (d // 4)
    so = make_spectrum_ops(ESConfig(num_dimensions=d, topology=topology, param_mins=(0.0,) * d,
                                    param_maxs=maxs, audio_length_log2=10, dft_dtype="int8"),
                           device=cuda)
    rng = np.random.default_rng(d)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda)  # noqa: E731
    pv, ps = t(rng.random((mu, d))), t(rng.uniform(0.02, 0.3, (mu, d)))
    tgt = t(rng.uniform(0, 50, so.num_bins))
    kw = dict(pop=pop, param_mins=(0.0,) * d, param_maxs=maxs, dft_packed=so.dft_packed,
              dft_scale=so.dft_packed_scale, topology=topology, n=1024, pop_block=pop,
              sine_order=9)
    seeds = [kernel_seed(19, g) for g in range(5)]
    args = (pv, ps, pv[0].clone(), torch.tensor(float("inf"), device=cuda), tgt)
    out = ev.fused_evolve(seeds, *args, **kw)
    _tp_layout(monkeypatch, True)
    gn.fused_generation.launches_by_layout.clear()
    loop = ev.fused_evolve_plain(seeds, *args, generation=gn.fused_generation, **kw)
    assert dict(gn.fused_generation.launches_by_layout) == {"time_parallel": len(seeds)}
    assert all(_bits_equal(a, b) for a, b in zip(out, loop))


# ---- true f32: the FFT route and the time-parallel synthesis -------------------

F32_USER_SHAPES = [  # (n, frames, runs, pop): cells (m), (n), the bench shape, (h)
    pytest.param(2048, 8, 1, 4096, id="m-F8-P4096"),
    pytest.param(2048, 1, 8, 4096, id="n-8xP4096"),
    pytest.param(1024, 1, 1, 1 << 15, id="g-P32768"),
    pytest.param(2048, 1, 1, 4096, id="h-P4096"),
]


@pytest.mark.parametrize("n,frames,runs,pop", F32_USER_SHAPES)
def test_b1_b2_f32_fft_route_matches_plain(cuda, n, frames, runs, pop):
    """B1/B2 true f32 at the shapes users' paths give them take the FFT
    (``launches_by_f32``) and hold their plain versions within 1e-5 / 1e-6,
    B2's values bit-equal; the DFT route at the same shapes
    (``F32_FFT`` cleared) within the same limits of the FFT's."""
    from chip_smoke import f32_mode

    d, mu = 6, 64
    cfg = ESConfig(num_parents=mu, num_offspring=pop - mu, audio_length_log2=n.bit_length() - 1,
                   dft_dtype="float32", sine_order=9, num_frames=frames)
    so = make_spectrum_ops(cfg, device=cuda)
    rng = np.random.default_rng(n + frames + runs)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda)  # noqa: E731
    lead = () if runs == 1 else (runs,)
    p = t(rng.random((*lead, pop, d)) * np.asarray((3520.0, 8.0) * 3))
    pv, ps = t(rng.random((*lead, mu, d))), t(rng.uniform(0.02, 0.3, (*lead, mu, d)))
    tgt = t(rng.uniform(0, 50, (*lead, frames, so.num_bins)))
    kw = dict(dft_packed=so.dft_packed, dft_scale=0.0, n=n, pop_block=pop, sine_order=9,
              num_frames=frames)
    kw2 = dict(kw, pop=pop, param_mins=cfg.param_mins, param_maxs=cfg.param_maxs, min_step=1e-4)
    seed = 11 if runs == 1 else [11 + r for r in range(runs)]
    sf.fused_synth_fitness.launches_by_f32.clear()
    gn.fused_generation.launches_by_f32.clear()
    f1 = sf.fused_synth_fitness(p, tgt, **kw)
    f2, v2, s2 = gn.fused_generation(seed, pv, ps, tgt, **kw2)
    assert sf.fused_synth_fitness.launches_by_f32["fft"] == 1
    assert gn.fused_generation.launches_by_f32["fft"] == 1
    p1 = sf.fused_synth_fitness_plain(p, tgt, **kw)
    p2, pv2, ps2 = gn.fused_generation_plain(seed, pv, ps, tgt, **kw2)
    assert torch.equal(v2, pv2)
    assert float(((s2 - ps2).abs() / ps2.abs()).max()) <= STEP_MAX_REL
    for got, ref in ((f1, p1), (f2, p2)):
        rel = (got - ref).abs() / ref.abs()
        assert float(rel.max()) <= F32_FIT_MAX_REL and float(rel.median()) <= F32_FIT_MEDIAN_REL
    with f32_mode(sf, False):
        dft = sf.fused_synth_fitness(p, tgt, **kw)
    assert sf.fused_synth_fitness.launches_by_f32["dft"] == 1
    rel = (dft - f1).abs() / f1.abs()
    assert float(rel.max()) <= F32_FIT_MAX_REL and float(rel.median()) <= F32_FIT_MEDIAN_REL


@pytest.mark.parametrize("frames", [1, 2, 8])
@pytest.mark.parametrize("n", [256, 1024, 2048, 3584])
@pytest.mark.parametrize("topology", ["fm2", "fm3_series", "fm4_series", "fm8_series",
                                      "fm2_parallel", "fm3_parallel", "fm5_parallel"])
def test_f32_synthesis_layouts_bit_equal(cuda, topology, n, frames):
    """The true-f32 synthesis' time-parallel layout writes the rows of
    samples of one thread a candidate bit for bit (``chip_smoke.f32_rows``,
    the library's own entry), a run axis of 2 at F 2, and B1's fitness from
    them is bit-equal; at n 3584 (the DFT route) too."""
    from chip_smoke import f32_rows

    d = topology_dims(topology)
    runs = 2 if frames == 2 else 1
    pop = 4095 if frames == 1 else 1000
    rng = np.random.default_rng(n + frames + d)
    p = torch.from_numpy((rng.random((runs, pop, d)) * np.asarray(_tp_maxs(topology)))
                         .astype(np.float32)).to(cuda)
    order = (5, 7, 9)[(n + frames) % 3]
    a, fa = f32_rows(p, topology, n, frames, order, False)
    b, fb = f32_rows(p, topology, n, frames, order, True)
    assert bool(torch.isfinite(a).all())
    assert _bits_equal(a, b) and _bits_equal(fa, fb)


@pytest.mark.parametrize("frames,runs", [(8, 1), (1, 8)])
def test_b2_f32_layouts_and_b5_bit_equal(cuda, frames, runs):
    """B2 true f32 at cells (m) and (n)'s shapes gives the same fitness,
    values and steps in both synthesis layouts; B5 at F 8 equals its B2
    launches + the stable selection."""
    from chip_smoke import f32_mode
    from pmfm_tpu_torch.kernels import evolve as ev

    pop, mu, d = 4096, 64, 6
    cfg = ESConfig(num_parents=mu, num_offspring=pop - mu, audio_length_log2=11,
                   dft_dtype="float32", sine_order=9, num_frames=frames)
    so = make_spectrum_ops(cfg, device=cuda)
    rng = np.random.default_rng(frames * runs)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda)  # noqa: E731
    lead = () if runs == 1 else (runs,)
    pv, ps = t(rng.random((*lead, mu, d))), t(rng.uniform(0.02, 0.3, (*lead, mu, d)))
    tgt = t(rng.uniform(0, 50, (*lead, frames, so.num_bins)))
    kw = dict(pop=pop, param_mins=cfg.param_mins, param_maxs=cfg.param_maxs,
              dft_packed=so.dft_packed, dft_scale=0.0, n=2048, pop_block=pop, sine_order=9,
              num_frames=frames)
    seed = 13 if runs == 1 else [13 + r for r in range(runs)]
    outs = {}
    for tp in (False, True):
        with f32_mode(sf, True, tp):
            gn.fused_generation.launches_by_f32.clear()
            outs[tp] = gn.fused_generation(seed, pv, ps, tgt, **kw)
            assert gn.fused_generation.launches_by_f32[
                "time_parallel" if tp else "one_thread"] == 1
    assert all(_bits_equal(a, b) for a, b in zip(outs[False], outs[True]))
    if runs == 1:
        seeds = [kernel_seed(29, g) for g in range(5)]
        args = (pv, ps, pv[0].clone(), torch.tensor(float("inf"), device=cuda), tgt)
        out = ev.fused_evolve(seeds, *args, **kw)
        loop = ev.fused_evolve_plain(seeds, *args, generation=gn.fused_generation, **kw)
        assert all(_bits_equal(a, b) for a, b in zip(out, loop))


@pytest.mark.parametrize("topology", ["fm3_parallel", "fm5_parallel", "fm16_series"])
def test_b1_f32_exact_matches_hold_the_plain_version(cuda, topology):
    """A known-params truth planted among random candidates against its own
    target spectrum (fitness ~1e-9 at the banks: a difference of
    roundings): the FFT route scores it by the direct sums against the
    folded operand (csrc ``FFT_EXACT_BELOW``), within 1e-5 / 1e-6 of the
    plain version with every random candidate."""
    import chip_smoke as cs

    truth = {"fm3_parallel": cs.PARALLEL_TRUTH[:12], "fm5_parallel": cs.WIDE_TRUTHS["fm5_parallel"],
             "fm16_series": cs.WIDE_TRUTHS["fm16_series"]}[topology]
    n, pop = 1024, 8192
    cfg = ESConfig(num_dimensions=len(truth), topology=topology, audio_length_log2=10,
                   dft_dtype="float32", param_mins=(0.0,) * len(truth),
                   param_maxs=cs.param_maxs(topology))
    so = make_spectrum_ops(cfg, device=cuda)
    tgt = target_spectrum(synthesize_single(torch.tensor(truth), n, topology).to(cuda), so)
    rng = np.random.default_rng(len(truth))
    p = rng.random((pop, len(truth))) * np.asarray(cs.param_maxs(topology))
    p[0] = truth
    p = torch.from_numpy(p.astype(np.float32)).to(cuda)
    kw = dict(dft_packed=so.dft_packed, dft_scale=0.0, topology=topology, n=n, pop_block=pop,
              sine_order=9)
    sf.fused_synth_fitness.launches_by_f32.clear()
    got = sf.fused_synth_fitness(p, tgt, **kw)
    assert sf.fused_synth_fitness.launches_by_f32["fft"] == 1
    ref = sf.fused_synth_fitness_plain(p, tgt, **kw)
    rel = (got - ref).abs() / ref.abs()
    assert float(ref[0]) < 1e-6 * float(ref.median()) or topology == "fm16_series"
    assert float(rel.max()) <= F32_FIT_MAX_REL and float(rel.median()) <= F32_FIT_MEDIAN_REL


# ---- the scan's time-parallel layout (csrc/scan_synth.cu) ----------------------

SCAN_TP_TOPOLOGIES = ["fm2", "fm3_series", "fm8_series", "fm10_series", "fm3_parallel",
                      "fm5_parallel"]


def _scan_layout(monkeypatch, tp):
    """The scan's wrapper in one layout: the time-parallel one wherever its
    kernel takes the chain (``scan_tp_faster`` made to say yes), or one
    thread a candidate (made to say no)."""
    from pmfm_tpu_torch.kernels import scan as ss

    monkeypatch.setattr(ss, "scan_tp_faster", lambda pop: tp)


@pytest.mark.parametrize("pop", [1, 32, 2048])
@pytest.mark.parametrize("n", [1000, 2048])
@pytest.mark.parametrize("topology", SCAN_TP_TOPOLOGIES)
def test_scan_layouts_bit_equal_to_plain_and_each_other(cuda, monkeypatch, topology, n, pop):
    """The scan's two layouts, each bit-equal to the plain loop and to the
    other, every oscillator and both output types, one launch counted under
    each layout; n 1000 ends in a part of a time-parallel chunk, P 2048
    takes several candidates a block (a ragged last one)."""
    from pmfm_tpu_torch.kernels import scan as ss

    d = topology_dims(topology)
    rng = np.random.default_rng(d + n + pop)
    p = torch.from_numpy((rng.random((pop, d)) * np.asarray(_tp_maxs(topology)))
                         .astype(np.float32)).to(cuda)
    for osc_mode in ("floor", "exact", "table"):
        b32 = ss.scan_synth_plain(p, n, topology, osc_mode=osc_mode)
        for out_dtype in (torch.float32, torch.bfloat16):
            outs = {}
            for tp in (False, True):
                _scan_layout(monkeypatch, tp)
                ss.scan_synth.launches_by_layout.clear()
                outs[tp] = ss.scan_synth(p, n, topology, osc_mode=osc_mode, out_dtype=out_dtype)
                assert dict(ss.scan_synth.launches_by_layout) == {
                    "time_parallel" if tp else "one_thread": 1}
                assert _bits_equal(outs[tp].float(), b32.to(out_dtype).float())
            assert _bits_equal(outs[False].float(), outs[True].float())


# ---- B1 int8 in the time-parallel layout (csrc/fused_tp.cuh) --------------------

B1_TP_TOPOLOGIES = ["fm2_parallel", "fm3_parallel", "fm4_parallel", "fm5_parallel",
                    "fm3_series", "fm8_series"]


@pytest.mark.parametrize("topology,frames,runs,pop", (
    [(t, 1, 1, pop) for t in B1_TP_TOPOLOGIES for pop in (1, 32, 8192)]
    + [(t, 8, 1, pop) for t in B1_TP_TOPOLOGIES for pop in (1, 4096)]
    + [(t, 1, 8, pop) for t in B1_TP_TOPOLOGIES for pop in (1, 4096)]))
def test_b1_time_parallel_layout_bit_equal_to_one_warp(cuda, monkeypatch, topology, frames,
                                                       runs, pop):
    """B1 int8: the time-parallel layout's fitness bit-equal to the one-warp
    layout's, one launch of each counted under its layout, at P 1 (the
    pursuit's seed rescores), 32 and 8192, at F 8 and on 8 runs (n 2048
    there, 1024 else); and at P 4096 (F 8, 8 runs) within the int8 limits
    of the plain version."""
    d = topology_dims(topology)
    n = 2048 if frames > 1 or runs > 1 else 1024
    maxs = _tp_maxs(topology)
    so = make_spectrum_ops(ESConfig(num_dimensions=d, topology=topology, param_mins=(0.0,) * d,
                                    param_maxs=maxs, audio_length_log2=n.bit_length() - 1,
                                    dft_dtype="int8"),
                           device=cuda)
    rng = np.random.default_rng(pop + d + 10 * frames + runs)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda)  # noqa: E731
    lead = () if runs == 1 else (runs,)
    params = t(rng.random((*lead, pop, d)) * np.asarray(maxs))
    tgt = t(rng.uniform(0, 50, (*lead, frames, so.num_bins) if frames > 1
                        else (*lead, so.num_bins)))
    kw = dict(dft_packed=so.dft_packed, dft_scale=so.dft_packed_scale, topology=topology, n=n,
              pop_block=pop, sine_order=9, num_frames=frames)
    outs = {}
    for tp in (False, True):
        _tp_layout(monkeypatch, tp)
        sf.fused_synth_fitness.launches_by_layout.clear()
        outs[tp] = sf.fused_synth_fitness(params, tgt, **kw)
        assert dict(sf.fused_synth_fitness.launches_by_layout) == {
            "time_parallel" if tp else "one_warp": 1}
    assert bool(torch.isfinite(outs[True]).all())
    assert _bits_equal(outs[False], outs[True])
    if pop == 4096 and topology in ("fm3_series", "fm3_parallel"):
        fp = sf.fused_synth_fitness_plain(params, tgt, **kw)
        rel = (outs[True] - fp).abs() / fp.abs()
        assert float(rel.max()) <= FIT_MAX_REL and float(rel.median()) <= FIT_MEDIAN_REL


@pytest.mark.parametrize("topology,n,frames", [("fm3_parallel", 1024, 1), ("fm5_parallel", 1024, 1),
                                               ("fm3_series", 2048, 8)])
def test_b2_time_parallel_fitness_is_b1_time_parallel_on_its_offspring(cuda, monkeypatch,
                                                                       topology, n, frames):
    """B2 and B1 both in the time-parallel layout: B2's fitness bit-equal to
    B1's on B2's own offspring (the pursuit's polish shape, --mode stft's)."""
    d, mu, pop = topology_dims(topology), 64, 8192 if frames == 1 else 4096
    maxs = _tp_maxs(topology)
    so = make_spectrum_ops(ESConfig(num_dimensions=d, topology=topology, param_mins=(0.0,) * d,
                                    param_maxs=maxs, audio_length_log2=n.bit_length() - 1,
                                    dft_dtype="int8"),
                           device=cuda)
    rng = np.random.default_rng(d + n + frames)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda)  # noqa: E731
    pv, ps = t(rng.random((mu, d))), t(rng.uniform(0.02, 0.3, (mu, d)))
    tgt = t(rng.uniform(0, 50, (frames, so.num_bins) if frames > 1 else (so.num_bins,)))
    kw = dict(pop=pop, param_mins=(0.0,) * d, param_maxs=maxs, dft_packed=so.dft_packed,
              dft_scale=so.dft_packed_scale, topology=topology, n=n, pop_block=pop,
              sine_order=9, num_frames=frames)
    _tp_layout(monkeypatch, True)
    sf.fused_synth_fitness.launches_by_layout.clear()
    fk, vk, _ = gn.fused_generation(31, pv, ps, tgt, **kw)
    own = sf.fused_synth_fitness(gn.scale_rows(vk, kw["param_mins"], kw["param_maxs"]), tgt,
                                 dft_packed=so.dft_packed, dft_scale=so.dft_packed_scale,
                                 topology=topology, n=n, pop_block=pop, sine_order=9,
                                 num_frames=frames)
    assert dict(sf.fused_synth_fitness.launches_by_layout) == {"time_parallel": 1}
    assert _bits_equal(fk, own)


# ---- B1/B2 bf16's time-parallel layout (csrc/fused_tp_bf16.cuh) -----------------

BF16_TP_TOPOLOGIES = ["fm2", "fm3_series", "fm4_series", "fm5_series", "fm6_series",
                      "fm7_series", "fm8_series"] + BANKS
BF16_TP_N = (512, 1024, 2048)  # the reference suite's fused frames


def _bf16_inputs(cuda, topology, n, frames, runs, pop, seed):
    from pmfm_tpu_torch.ops import spectral

    d, mu = topology_dims(topology), 64
    maxs = _tp_maxs(topology)
    so = spectral.make_spectrum_ops(n, None, dft_dtype="bfloat16", device=cuda)  # any n: 768 too
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda)  # noqa: E731
    lead = () if runs == 1 else (runs,)
    params = t(rng.random((*lead, pop, d)) * np.asarray(maxs))
    pv, ps = t(rng.random((*lead, mu, d))), t(rng.uniform(0.02, 0.3, (*lead, mu, d)))
    tgt = t(rng.uniform(0, 50, (*lead, frames, so.num_bins) if frames > 1
                        else (*lead, so.num_bins)))
    return so, params, pv, ps, tgt, maxs


@pytest.mark.parametrize("topology,n,frames,sine_order,runs", [
    (t, BF16_TP_N[(i + j + f) % 3], frames, o, runs)
    for i, t in enumerate(BF16_TP_TOPOLOGIES) for j, o in enumerate((5, 7, 9))
    for f, frames in enumerate((1, 2, 8)) for runs in (1, 4)] + [
    # n 768: six warps, 96 bins a round (the ring of terms is no two rounds' size)
    (t, 768, frames, (5, 7, 9)[(i + f) % 3], 1 + 3 * ((i + f) % 2))
    for i, t in enumerate(BF16_TP_TOPOLOGIES) for f, frames in enumerate((1, 2, 8))])
def test_bf16_time_parallel_layout_bit_equal_to_one_warp(cuda, monkeypatch, topology, n, frames,
                                                         sine_order, runs):
    """B1 and B2 bf16 on a fixed chain or bank: the time-parallel layout's
    fitness (B2: values and steps) bit-equal to the one-warp layout's, one
    launch of each counted under its layout, run r of a batched launch
    included (every fixed code x sine orders 5/7/9 x F 1/2/8 x runs 1/4,
    the suite's n in turn; and every fixed code at n 768 x F 1/2/8); at one
    run and sine order 9, B1 within the int8 limits of its plain version."""
    d = topology_dims(topology)
    pop = 1000 if runs == 1 else 129
    so, params, pv, ps, tgt, maxs = _bf16_inputs(cuda, topology, n, frames, runs, pop,
                                                 pop + sine_order + 10 * frames + n)
    seed = 77 if runs == 1 else [77 + r for r in range(runs)]
    kw1 = dict(dft_packed=so.dft_packed, dft_scale=so.dft_packed_scale, topology=topology, n=n,
               pop_block=pop, sine_order=sine_order, num_frames=frames)
    kw2 = dict(kw1, pop=pop, param_mins=(0.0,) * d, param_maxs=maxs)
    outs = {}
    for tp in (False, True):
        _tp_layout(monkeypatch, tp)
        sf.fused_synth_fitness.launches_by_layout.clear()
        gn.fused_generation.launches_by_layout.clear()
        outs[tp] = (sf.fused_synth_fitness(params, tgt, **kw1),
                    *gn.fused_generation(seed, pv, ps, tgt, **kw2))
        key = gn.layout_key("bf16", tp)
        assert dict(sf.fused_synth_fitness.launches_by_layout) == {key: 1}
        assert dict(gn.fused_generation.launches_by_layout) == {key: 1}
    assert bool(torch.isfinite(outs[False][0]).all())
    assert all(_bits_equal(a, b) for a, b in zip(outs[False], outs[True]))
    if runs == 1 and sine_order == 9:
        fp = sf.fused_synth_fitness_plain(params, tgt, **kw1)
        rel = (outs[True][0] - fp).abs() / fp.abs()
        assert float(rel.max()) <= FIT_MAX_REL and float(rel.median()) <= FIT_MEDIAN_REL


@pytest.mark.parametrize("topology,n,frames", [("fm3_series", 1024, 1), ("fm4_parallel", 1024, 1),
                                               ("fm3_series", 2048, 8), ("fm8_series", 512, 2)])
def test_bf16_b2_time_parallel_fitness_is_b1_time_parallel_on_its_offspring(
        cuda, monkeypatch, topology, n, frames):
    """B2 and B1 bf16 both in the time-parallel layout: B2's fitness
    bit-equal to B1's on B2's own offspring."""
    d, pop = topology_dims(topology), 4096
    so, _, pv, ps, tgt, maxs = _bf16_inputs(cuda, topology, n, frames, 1, pop, d + n + frames)
    kw1 = dict(dft_packed=so.dft_packed, dft_scale=so.dft_packed_scale, topology=topology, n=n,
               pop_block=pop, sine_order=9, num_frames=frames)
    _tp_layout(monkeypatch, True)
    sf.fused_synth_fitness.launches_by_layout.clear()
    fk, vk, _ = gn.fused_generation(31, pv, ps, tgt, pop=pop, param_mins=(0.0,) * d,
                                    param_maxs=maxs, **kw1)
    own = sf.fused_synth_fitness(gn.scale_rows(vk, (0.0,) * d, maxs), tgt, **kw1)
    assert dict(sf.fused_synth_fitness.launches_by_layout) == {"bf16_time_parallel": 1}
    assert _bits_equal(fk, own)


@pytest.mark.parametrize("topology,frames,runs", [("fm3_series", 1, None), ("fm3_parallel", 1, None),
                                                  ("fm3_series", 8, None), ("fm3_series", 1, 4)])
def test_b5_bf16_bit_equal_to_time_parallel_b2_launches(cuda, monkeypatch, topology, frames, runs):
    """B5 bf16 in the layout B2's wrapper takes; G generations in one call
    equal G launches of B2 bf16 in the time-parallel layout + the stable
    selection (n 1024, P 8192; F 8; a run axis of 4)."""
    from pmfm_tpu_torch.kernels import evolve as ev

    pop, d, nruns = 8192, topology_dims(topology), runs or 1
    so, _, pv, ps, tgt, maxs = _bf16_inputs(cuda, topology, 1024, frames, nruns, pop, d + frames)
    kw = dict(pop=pop, param_mins=(0.0,) * d, param_maxs=maxs, dft_packed=so.dft_packed,
              dft_scale=so.dft_packed_scale, topology=topology, n=1024, pop_block=pop,
              sine_order=9, num_frames=frames)
    g = 5
    seeds = ([kernel_seed(19, i) for i in range(g)] if runs is None
             else [[kernel_seed(19 + r, i) for i in range(g)] for r in range(runs)])
    lead = () if runs is None else (runs,)
    best = torch.full(lead, float("inf"), device=cuda)
    args = (pv, ps, pv[..., 0, :].clone(), best, tgt)
    out = ev.fused_evolve(seeds, *args, **kw)
    _tp_layout(monkeypatch, True)
    gn.fused_generation.launches_by_layout.clear()
    loop = ev.fused_evolve_plain(seeds, *args, generation=gn.fused_generation, **kw)
    assert dict(gn.fused_generation.launches_by_layout) == {"bf16_time_parallel": g * nruns}
    assert all(_bits_equal(a, b) for a, b in zip(out, loop))


# ---- B5 int8 and bf16 on B2's layouts ---------------------------------------------

B5_TP_CODES = ["fm2"] + [f"fm{k}_series" for k in range(3, 9)] + BANKS
# (mode, topology, n, frames, runs, sine order): every fixed chain and bank
# in int8 and bf16 at F 1/2/8, the runs (1/2/8) and sine orders (5/7/9) and
# n (1024/2048) in turn; in bf16 also every code at n 768 (six warps a block)
B5_LAYOUT_CASES = (
    [(m, t, (1024, 2048)[(i + f) % 2], frames, (1, 2, 8)[(i + f) % 3], (5, 7, 9)[(i + 2 * f) % 3])
     for m in ("int8", "bf16") for i, t in enumerate(B5_TP_CODES)
     for f, frames in enumerate((1, 2, 8))]
    + [("bf16", t, 768, frames, (1, 2)[(i + f) % 2], (5, 7, 9)[(i + f) % 3])
       for i, t in enumerate(B5_TP_CODES) for f, frames in enumerate((1, 8))])


def _b5_inputs(cuda, mode, topology, n, frames, runs, pop, seed):
    """B5's operands at the shape: parents, best-ever, targets and G seeds a
    run, with the keyword arguments of its call."""
    from pmfm_tpu_torch.ops import spectral

    d, mu = topology_dims(topology), 64
    maxs = _tp_maxs(topology)
    so = spectral.make_spectrum_ops(n, None, dft_dtype="int8" if mode == "int8" else "bfloat16",
                                    device=cuda)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda)  # noqa: E731
    lead = () if runs == 1 else (runs,)
    pv, ps = t(rng.random((*lead, mu, d))), t(rng.uniform(0.02, 0.3, (*lead, mu, d)))
    tgt = t(rng.uniform(0, 50, (*lead, frames, so.num_bins) if frames > 1
                        else (*lead, so.num_bins)))
    kw = dict(pop=pop, param_mins=(0.0,) * d, param_maxs=maxs, dft_packed=so.dft_packed,
              dft_scale=so.dft_packed_scale, topology=topology, n=n, pop_block=pop,
              num_frames=frames)
    args = (pv, ps, pv[..., 0, :].clone(), torch.full(lead, float("inf"), device=cuda), tgt)
    return args, kw


@pytest.mark.parametrize("mode,topology,n,frames,runs,sine_order", B5_LAYOUT_CASES)
def test_b5_layouts_bit_equal(cuda, monkeypatch, mode, topology, n, frames, runs, sine_order):
    """B5 int8 and bf16 in the layout B2's wrapper takes at its arguments,
    forced time-parallel and forced one-warp: parents, their fitness,
    best-ever and trajectory bit-equal to each other and to G launches of B2
    (in its wrapper's layout) with the stable selection; each B5 call
    counted once in ``launches_by_layout`` under the layout it took, the
    first under ``takes_time_parallel``'s pick."""
    from pmfm_tpu_torch.kernels import evolve as ev

    g, pop = 4, 1000 if runs == 1 else 129
    args, kw = _b5_inputs(cuda, mode, topology, n, frames, runs, pop,
                          pop + sine_order + 10 * frames + n)
    kw["sine_order"] = sine_order
    seeds = ([kernel_seed(41, i) for i in range(g)] if runs == 1
             else [[kernel_seed(41 + r, i) for i in range(g)] for r in range(runs)])
    outs = {}
    for forced in (None, True, False):  # the wrapper's rule first, then each layout forced
        if forced is not None:
            _tp_layout(monkeypatch, forced)
        tp = gn.takes_time_parallel(args[0], **kw)
        assert forced is None or tp is forced
        ev.fused_evolve.launches_by_layout.clear()
        outs[forced] = ev.fused_evolve(seeds, *args, **kw)
        assert dict(ev.fused_evolve.launches_by_layout) == {gn.layout_key(mode, tp): 1}
        if forced is None:
            lone = gn.takes_time_parallel(args[0] if runs == 1 else args[0][0], **kw)
            gn.fused_generation.launches_by_layout.clear()
            loop = ev.fused_evolve_plain(seeds, *args, generation=gn.fused_generation, **kw)
            assert dict(gn.fused_generation.launches_by_layout) == {
                gn.layout_key(mode, lone): g * runs}
    assert bool(torch.isfinite(outs[None][5]).all())
    for out in (outs[True], outs[False], loop):
        assert all(_bits_equal(a, b) for a, b in zip(outs[None], out))


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("topology,n", [("fm3_series", 3584), ("fm10_series", 1024)])
def test_b5_time_parallel_refused_raises(cuda, monkeypatch, mode, topology, n):
    """A time-parallel layout forced on B5 where no time-parallel kernel
    takes the shape (a block past one block's shared memory at n 3584; a
    wide code) raises and counts no launch: nothing falls back to the
    one-warp kernel or the plain version."""
    from pmfm_tpu_torch.kernels import evolve as ev

    args, kw = _b5_inputs(cuda, mode, topology, n, 1, 1, 256, n)
    monkeypatch.setattr(gn, "tp_takes", lambda *a, **k: True)
    _tp_layout(monkeypatch, True)
    before = ev.fused_evolve.launches, dict(ev.fused_evolve.launches_by_layout)
    with pytest.raises(RuntimeError, match="time-parallel layout"):
        ev.fused_evolve([kernel_seed(3, i) for i in range(2)], *args, **kw)
    assert (ev.fused_evolve.launches, dict(ev.fused_evolve.launches_by_layout)) == before
