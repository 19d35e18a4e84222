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
    """B1/B2 true f32 (synthesis into scratch, the register-tiled DFT on
    128-candidate blocks and one bin group each, 64 bins a pass) against
    their plain versions over every frame size class, a bin count that
    leaves partial passes and groups of 3 and 4 tiles, population edges and
    ported chains; B2's fitness bit-equal to B1's on B2's own offspring."""
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
    """Above 512 samples a bin, the f32 DFT sums each bin in 128-sample
    segments added pairwise, and the terms over bins in double (csrc
    fused_f32.cu): at n 2048 and 3584 (the f32 grid's fm3_series, sine order
    7 inputs), the kernel's relative error against a float64 evaluation of
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
                                      "fm10_series", "fm5_parallel"])
def test_scan_kernel_bit_equal_to_plain(cuda, topology, osc_mode, out_dtype):
    """csrc/scan_synth.cu bit for bit against its plain loop over samples,
    at every chain class (compile-time lengths and the runtime-length
    instantiation), oscillator and output type."""
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
                                        ("fm3_parallel", 1024)])
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
