"""The scan synthesis' time-parallel layout and B1 int8's, on the CPU.

The scan's time-parallel kernel (csrc/scan_synth.cu::scan_synth_tp_kernel)
walks each level's position recurrence alone and computes every sample's
sines, outputs and next-level increments apart from it. This file runs that
level-by-level order in torch (the positions of a level in a serial loop,
then every sample's oscillator and increments at once) and holds it bit for
bit against the one-sequence plain loop, ``scan_synth_plain``: exact, so no
tolerance. It also holds the scan's layout rule and launch geometry, and
B1's layout, which is B2's rule, case for case.
"""
import numpy as np
import pytest
import torch

from pmfm_tpu_torch.kernels import generation as tgen
from pmfm_tpu_torch.kernels import scan as tscan
from pmfm_tpu_torch.kernels import synth_fitness as tsf
from pmfm_tpu_torch.ops.synthesis import parallel_pairs, topology_dims
from pmfm_tpu_torch.ops.wavetable import (
    DEFAULT_SAMPLE_RATE,
    DEFAULT_WAVETABLE_SIZE,
    make_osc,
    wrap_pos,
    wrap_pos_both,
)

N = 256
POP = 6


def _params(topology, seed):
    d = topology_dims(topology)
    maxs = np.asarray((3520.0, 8.0, 3520.0, 1.0) * (d // 4) if parallel_pairs(topology)
                      else (3520.0, 8.0) * (d // 2), np.float32)
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.random((POP, d)) * maxs).astype(np.float32))


def _walk(inc, size, both):
    """One level's positions (n, P) from 0, pos[t + 1] = wrap(pos[t] + inc[t])
    in a serial loop, as warp 0's lane walks it (csrc chain_step)."""
    wrap = wrap_pos_both if both else wrap_pos
    out = torch.empty_like(inc)
    pos = torch.zeros_like(inc[0])
    for t in range(inc.shape[0]):
        out[t] = pos
        pos = wrap(pos + inc[t], size)
    return out


def scan_levels(p, n, topology, osc_mode):
    """(n, P) float32 audio in the time-parallel kernel's order: level by
    level, each level's positions walked serially, then every sample's
    oscillator, and from it the next level's increments w2sr cur or, at
    the last level, the output (a bank's pairs added in pair order and
    multiplied by the float32 1/k)."""
    c = tscan.scan_constants(DEFAULT_WAVETABLE_SIZE, DEFAULT_SAMPLE_RATE)
    w2sr, size = c["w2sr"], c["size"]
    osc = make_osc(osc_mode, DEFAULT_WAVETABLE_SIZE, None)
    kind, k = tscan._chain(topology)
    ones = torch.ones((n, p.shape[0]), dtype=torch.float32)
    if kind == "series":
        inc = ones * (w2sr * p[:, 1])
        for j in range(k):
            x = osc(_walk(inc, size, both=j > 0))
            ms = p[:, 2 * j] * p[:, 2 * j + 1]
            if j == k - 1:
                return x * ms
            inc = w2sr * (x * ms + p[:, 2 * j + 3])
    acc = None
    for j in range(k):
        inc = ones * (w2sr * p[:, 4 * j])
        cur = osc(_walk(inc, size, both=False)) * (p[:, 4 * j] * p[:, 4 * j + 1]) + p[:, 4 * j + 2]
        v = osc(_walk(w2sr * cur, size, both=True)) * p[:, 4 * j + 3]
        acc = v if acc is None else acc + v
    return acc * float(np.float32(1.0 / k)) if kind == "parallel" else acc


@pytest.mark.parametrize("osc_mode", ["floor", "exact", "table"])
@pytest.mark.parametrize("topology", ["fm2", "fm3_series", "fm8_series", "fm10_series",
                                      "fm3_parallel", "fm5_parallel"])
def test_scan_level_decomposition_is_exact(topology, osc_mode):
    """The time-parallel order bit-equal to the plain loop over samples (its
    bf16 audio is its float32 audio rounded by ``.to``: one check serves
    both output types)."""
    p = _params(topology, topology_dims(topology) + len(osc_mode))
    want = tscan.scan_synth_plain(p, N, topology, osc_mode=osc_mode)
    got = scan_levels(p, N, topology, osc_mode)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# (pop, n, topology): layout, grid, block, shared bytes, candidates a block, warps
SCAN_LAUNCH_CASES = [
    # parameters.json (cell (i)) and its lone candidates: a block a candidate
    (32, 2048, "fm3_series", "time_parallel", 32, 256, 3096, 1, 8),
    (1, 2048, "fm3_series", "time_parallel", 1, 256, 3096, 1, 8),
    (1, 1024, "fm2", "time_parallel", 1, 256, 3088, 1, 8),
    # several candidates a block past two blocks an SM, at most 32 walks a block
    (2048, 1024, "fm3_series", "time_parallel", 293, 256, 21672, 7, 8),
    (2048, 1024, "fm8_series", "time_parallel", 512, 256, 34048, 4, 8),
    (2048, 1024, "fm3_parallel", "time_parallel", 410, 256, 31984, 5, 8),
    (8192, 2048, "fm3_series", "time_parallel", 820, 256, 31984, 10, 8),
    (4096, 1024, "fm16_parallel", "time_parallel", 4096, 256, 34048, 1, 8),
    # the rule: one-thread blocks on at most half the SMs
    (66 * 128, 1024, "fm2", "time_parallel", 528, 256, 34048, 16, 8),
    (66 * 128 + 1, 1024, "fm2", "one_thread", 67, 128, 0, 1, 4),
    (1 << 15, 1024, "fm3_series", "one_thread", 256, 128, 0, 1, 4),
    # more than 32 levels: one thread a candidate, its state in a scratch
    (4096, 1024, "fm33_series", "one_thread", 32, 128, 0, 1, 4),
    (4096, 1024, "fm17_parallel", "one_thread", 32, 128, 0, 1, 4),
]


@pytest.mark.parametrize("pop,n,topology,layout,grid,block,smem,group,warps", SCAN_LAUNCH_CASES)
def test_scan_launch_geometry(pop, n, topology, layout, grid, block, smem, group, warps):
    la = tscan.scan_launch(pop, n, topology, "floor", torch.float32)
    assert (la["layout"], la["grid"], la["block"], la["smem"], la["group"], la["warps"]) == (
        layout, grid, block, smem, group, warps)
    lanes = group * tscan.scan_levels(topology)
    if layout == "time_parallel":
        assert lanes <= tscan.SCAN_TP_MAX_LANES and smem == tscan.scan_tp_smem(lanes)
        assert la["state_floats"] == 0 and block == 32 * warps
    else:
        kind, k = tscan._chain(topology)
        fixed = k in tscan.SCAN_FIXED[kind]  # a compile-time chain keeps its state in registers
        assert la["state_floats"] == (0 if fixed else (3 if kind == "series" else 6) * k * pop)


@pytest.mark.parametrize("faster", [False, True])
def test_scan_layout_follows_scan_tp_faster(monkeypatch, faster):
    """The layout follows ``scan_tp_faster`` as it stands when the wrapper
    is called, wherever the kernel takes the chain (the card checks patch
    the rule to hold the layouts against each other)."""
    monkeypatch.setattr(tscan, "scan_tp_faster", lambda pop: faster)
    for topology in ("fm2", "fm3_series", "fm32_series", "fm16_parallel"):
        assert tscan.scan_time_parallel(32, topology) is faster
        assert tscan.scan_launch(32, 2048, topology, "floor", torch.float32)["layout"] == (
            "time_parallel" if faster else "one_thread")
    assert not tscan.scan_time_parallel(32, "fm33_series")


def test_scan_wrapper_plain_on_cpu_whatever_the_layout(monkeypatch):
    """On CPU tensors the scan runs its plain loop whichever layout it would
    take on the card, and counts no launch."""
    p = _params("fm3_series", 3)
    before = tscan.scan_synth.launches, dict(tscan.scan_synth.launches_by_layout)
    outs = []
    for faster in (True, False):
        monkeypatch.setattr(tscan, "scan_tp_faster", lambda pop, faster=faster: faster)
        outs.append(tscan.scan_synth(p, 64, "fm3_series"))
    assert (tscan.scan_synth.launches, dict(tscan.scan_synth.launches_by_layout)) == before
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0], tscan.scan_synth_plain(p, 64, "fm3_series"))


# ---- B1 int8's layout: B2's rule (generation.time_parallel) -----------------------

# test_torch_time_parallel.py::test_gen_layout_rule's cases, as B1 takes them
B1_RULE_CASES = [
    (2048, "fm3_series", 4096, 1, True),
    (2048, "fm3_series", 4096, 8, True),
    (1024, "fm3_series", 1 << 15, 1, False),
    (1024, "fm3_series", 8192, 1, True),
    (1024, "fm5_parallel", 8192, 1, True),
    (2048, "fm6_series", 4096, 8, False),
    (1024, "fm4_series", 16384, 1, False),
    (1024, "fm2", 1 << 15, 8, False),
    (256, "fm3_parallel", 16384, 1, False),
    (512, "fm4_series", 4096, 1, True),
    # the pursuit's seed rescores: one candidate
    (1024, "fm3_parallel", 1, 1, True),
    (1024, "fm5_parallel", 1, 1, True),
    (1024, "fm5_series", 1, 1, True),
]


@pytest.mark.parametrize("n,topology,pop,runs,want", B1_RULE_CASES)
def test_b1_layout_is_b2s_rule(n, topology, pop, runs, want):
    d = topology_dims(topology)
    for frames in (1, 8):
        tp = tgen.time_parallel(n, n // 2, d, topology, "int8", frames, pop, runs)
        assert tp is want
        entry, layout = tsf.b1_entry("int8", n, n // 2, d, topology, frames, pop, runs)
        assert (entry, layout) == (("pmfm_fused_synth_fitness_tp", "time_parallel") if tp
                                   else ("pmfm_fused_synth_fitness", "one_warp"))


@pytest.mark.parametrize("mode,entry,layout", [
    # bf16 (one candidate) in its own time-parallel layout, by the same rule
    ("bf16", "pmfm_fused_synth_fitness_bf16_tp", "bf16_time_parallel"),
    ("f32", "pmfm_fused_synth_fitness_f32", None),
])
def test_b1_other_modes_keep_their_kernels(mode, entry, layout):
    assert tsf.b1_entry(mode, 1024, 512, 12, "fm3_parallel", 1, 1) == (entry, layout)


@pytest.mark.parametrize("n,k,topology,frames", [
    (1024, 512, "fm3_parallel", 1), (2048, 1024, "fm3_series", 8), (2048, 1024, "fm5_parallel", 2),
    (3584, 1792, "fm3_parallel", 1), (3072, 1536, "fm3_series", 1),
])
def test_b1_time_parallel_within_a_blocks_shared_memory(monkeypatch, n, k, topology, frames):
    """B1 takes the time-parallel layout, as B2, exactly where its block's
    shared memory (csrc fused_tp.cuh::tp_smem, ``shared_bytes_tp``) fits:
    the rule's speed term made to say yes."""
    monkeypatch.setattr(tgen, "tp_faster", lambda *a, **kw: True)
    d = topology_dims(topology)
    fits = tsf.shared_bytes_tp(n, k, d, frames) <= tsf.MAX_SHARED_BYTES
    entry, layout = tsf.b1_entry("int8", n, k, d, topology, frames, 1)
    assert (layout == "time_parallel") is fits
    assert fits is (n < 3072)


def test_b1_wrapper_plain_on_cpu_whatever_the_layout(monkeypatch):
    """On CPU tensors B1 runs its plain version whichever layout it would
    take on the card (one candidate: the pursuit's seed rescore), and
    counts no launch."""
    from pmfm_tpu_torch.ops.spectral import make_spectrum_ops

    topology, n = "fm3_parallel", 256
    d = topology_dims(topology)
    so = make_spectrum_ops(n, dft_dtype="int8", device="cpu")
    rng = np.random.default_rng(6)
    p = torch.from_numpy((rng.random((1, d)) * np.asarray((3520.0, 8.0, 3520.0, 1.0) * 3))
                         .astype(np.float32))
    target = torch.from_numpy(rng.random(so.num_bins).astype(np.float32))
    kw = dict(dft_packed=so.dft_packed, dft_scale=so.dft_packed_scale, topology=topology, n=n,
              sine_order=9)
    before = tsf.fused_synth_fitness.launches, dict(tsf.fused_synth_fitness.launches_by_layout)
    outs = []
    for switch in (True, False):
        monkeypatch.setattr(tgen, "tp_faster", lambda *a, switch=switch, **k: switch)
        assert (tsf.b1_entry("int8", n, so.num_bins, d, topology, 1, 1)[1]
                == ("time_parallel" if switch else "one_warp"))
        outs.append(tsf.fused_synth_fitness(p, target, **kw))
    after = tsf.fused_synth_fitness.launches, dict(tsf.fused_synth_fitness.launches_by_layout)
    assert after == before
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0], tsf.fused_synth_fitness_plain(p, target, **kw))
