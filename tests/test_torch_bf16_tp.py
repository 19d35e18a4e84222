"""B1/B2 bf16's time-parallel layout (csrc/fused_tp_bf16.cuh) on the CPU:
its shared memory, the rule that picks it (``generation.tp_layout``, the
one rule of B1 and B2), the fold it does in place against the one-warp
kernel's (``synth_fitness.fold``, ``fold_cast``'s two roundings, which the
reference's bf16 ``_evaluate_block`` makes), and the wrappers, which run
their plain versions on CPU tensors whatever layout they would take on the
card. The kernels themselves run only on a card (tests/test_torch_gpu.py
holds them bit-equal to the one-warp kernels); tests/test_torch_bf16.py
holds the plain versions against the reference. Every comparison here is
exact.
"""
import numpy as np
import pytest
import torch

from pmfm_tpu_torch.kernels import generation as tgen
from pmfm_tpu_torch.kernels import synth_fitness as tsf
from pmfm_tpu_torch.ops.synthesis import parallel_pairs, topology_dims

CHAINS = ["fm2"] + [f"fm{k}_series" for k in range(3, 9)]
BANKS = [f"fm{k}_parallel" for k in range(2, 6)]


@pytest.mark.parametrize("frames", [1, 8])
@pytest.mark.parametrize("n", [256, 512, 768, 1024, 2048])
@pytest.mark.parametrize("topology", ["fm2", "fm3_series", "fm8_series", "fm5_parallel"])
def test_bf16_tp_shared_bytes(topology, n, frames):
    """a+/- (64 n bytes), the larger of the ring of the terms (two rounds of
    W x 16 bins, W = min(n / 128, 8) warps, rounded up to a power of two
    rows of 32 floats) and the level totals (levels x n / 128 x 32 floats),
    32 edge samples, and at F > 1 the genes and carries (32 x 3d / 2
    floats), as csrc fused_tp_bf16.cuh::tp_bf16_smem reckons it."""
    d = topology_dims(topology)
    warps = min(n // 128, 8)
    rows = 1 << (2 * warps * 16 - 1).bit_length()
    levels = {"fm2": 1, "fm3_series": 2, "fm8_series": 7, "fm5_parallel": 5}[topology]
    floats = max(rows * 32, levels * (n // 128) * 32) + 32
    floats += 32 * (d + d // 2) if frames > 1 else 0
    assert tsf.shared_bytes_tp_bf16(n, d, topology, frames) == 64 * n + 4 * floats


@pytest.mark.parametrize("n,want", [
    (1024, 98432),   # two blocks an SM
    (2048, 163968),  # one
    (512, 49280),    # four
    (256, 24704),
    (768, 82048),    # six warps: a ring of 256 rows for two rounds of 96 bins
])
def test_bf16_tp_shared_bytes_at_the_suites_shapes(n, want):
    assert tsf.shared_bytes_tp_bf16(n, 6, "fm3_series") == want


@pytest.mark.parametrize("n", range(256, 3585, 256))
def test_bf16_ring_keeps_two_rounds_apart(n):
    """The ring of terms as the kernel indexes it: round r (bins [r R, (r +
    1) R), R = 16 bins a warp) is written at rows k & (rows - 1) while warp 0
    reads round r - 1's, so the two rounds' rows must all differ, at every
    warp count a frame gives (six at n 768, where 2 R is no power of two);
    the rows fit the terms' share of ``shared_bytes_tp_bf16``."""
    warps = min(n // 128, 8)
    per, rows = warps * 16, tsf.tp_bf16_ring(n)
    assert rows & (rows - 1) == 0 and rows >= 2 * per
    k = n // 2
    for r in range(1, -(-k // per)):
        live = [b & (rows - 1) for b in range((r - 1) * per, min((r + 1) * per, k))]
        assert len(set(live)) == len(live)
    assert tsf.shared_bytes_tp_bf16(n, 4, "fm2") >= 64 * n + 4 * rows * 32


@pytest.mark.parametrize("n,topology,frames,takes", [
    (1024, "fm3_series", 1, True),
    (2048, "fm3_series", 8, True),
    (2048, "fm8_series", 8, True),
    (3072, "fm3_series", 1, True),   # 229,504 bytes, within a block's 232,448
    (3072, "fm8_series", 8, False),  # and fm8_series' genes and carries past it
    (3584, "fm3_series", 1, False),  # past the 232,448 bytes a block may have
    (256, "fm5_parallel", 8, True),
    (128, "fm3_series", 1, False),   # one time block: no second half to mirror
    (1024, "fm9_series", 1, False),  # a wide chain: the one-warp layout
    (1024, "fm6_parallel", 1, False),
])
def test_bf16_tp_takes(n, topology, frames, takes):
    d = topology_dims(topology)
    assert tgen.tp_takes(n, n // 2, d, topology, "bf16", frames) is takes


def test_bf16_tp_takes_skips_the_long_code(monkeypatch):
    monkeypatch.setattr(tsf, "LONG_ABOVE_GENES", 16)
    assert not tgen.tp_takes(1024, 512, 20, "fm5_parallel", "bf16")
    assert tgen.tp_takes(1024, 512, 16, "fm4_parallel", "bf16")


@pytest.mark.parametrize("topology", CHAINS + BANKS)
@pytest.mark.parametrize("n", [512, 768, 1024, 2048])
@pytest.mark.parametrize("pop,runs", [(1 << 11, 1), (1 << 13, 1), (1 << 15, 1), (1 << 17, 1),
                                      (1 << 18, 1), (1 << 13, 4), (1 << 11, 32)])
def test_bf16_rule_is_one_function_for_b1_and_b2(topology, n, pop, runs):
    """B1's entry and B2's pick are ``time_parallel``'s, at every shape the
    rule was fitted on (tools/torch_bf16_probe.py's sweep)."""
    d = topology_dims(topology)
    tp = tgen.time_parallel(n, n // 2, d, topology, "bf16", 1, pop, runs)
    assert tp is (tgen.tp_takes(n, n // 2, d, topology, "bf16")
                  and tgen.tp_faster(n, topology, pop, runs, "bf16"))
    assert tsf.b1_entry("bf16", n, n // 2, d, topology, 1, pop, runs) == (
        ("pmfm_fused_synth_fitness_bf16_tp", "bf16_time_parallel") if tp
        else ("pmfm_fused_synth_fitness_bf16", "bf16_one_warp"))


# (n, topology, pop, runs, time-parallel): shapes an H100 timed in both layouts
# (PERF.md §6, tools/torch_bf16_probe.py's sweep, one-warp / time-parallel ms)
BF16_RULE_CASES = [
    # the reference suite: fm3_series at every population and run axis, n 512-2048
    (1024, "fm3_series", 1 << 11, 1, True),    # 0.1652 / 0.0572
    (1024, "fm3_series", 1 << 15, 1, True),    # 0.5149 / 0.3410
    (1024, "fm3_series", 1 << 18, 1, True),    # 3.5650 / 2.5370
    (1024, "fm3_series", 1 << 11, 32, True),   # 0.9998 / 0.6566
    (512, "fm3_series", 1 << 15, 1, True),     # 0.1436 / 0.1351: the one-warp tail
    (2048, "fm3_series", 1 << 15, 1, True),    # 3.7944 / 1.1104
    (1024, "fm5_series", 1 << 18, 1, True),    # 3.9948 / 3.8513
    # long chains on full grids keep the one-warp layout
    (1024, "fm6_series", 1 << 15, 1, False),   # 0.6068 / 0.6379
    (1024, "fm8_series", 1 << 18, 1, False),   # 5.9773 / 6.9287
    (512, "fm3_series", 1 << 17, 1, False),    # 0.4699 / 0.5118
    (512, "fm3_series", 1 << 11, 32, False),   # 0.2306 / 0.2607
    (512, "fm4_parallel", 1 << 18, 1, False),  # 1.7297 / 1.8833
    # and small grids take the time-parallel one
    (512, "fm8_series", 1 << 13, 1, True),     # 0.1366 / 0.1234
    (1024, "fm8_series", 1 << 13, 1, True),    # 0.3037 / 0.2478
    (2048, "fm8_series", 1 << 18, 1, True),    # 44.0006 / 18.6366
    # timed again at 10 medians a layout (--rounds 5): a bank's levels weigh
    # less than a chain's, and the one-warp warps count for more on full grids
    (512, "fm3_parallel", 1 << 18, 1, False),  # 1.4330 / 1.4948
    (512, "fm3_parallel", 1 << 17, 1, False),  # 0.7347 / 0.7453
    (512, "fm3_parallel", 1 << 11, 32, False),  # 0.3619 / 0.3733
    # n 768: six warps a block, two blocks an SM (12 warps, not 16)
    (768, "fm3_series", 1 << 15, 1, False),    # 0.2390 / 0.2521
    (768, "fm3_series", 1 << 13, 4, False),    # 0.2369 / 0.2506
    (768, "fm3_parallel", 1 << 15, 1, True),   # 0.3411 / 0.3193
    (768, "fm4_parallel", 1 << 15, 1, True),   # 0.4963 / 0.3910
    (768, "fm5_parallel", 1 << 18, 1, True),   # 4.1195 / 3.7006
    (768, "fm3_series", 1 << 13, 1, True),     # 0.1172 / 0.0671
    (768, "fm8_series", 1 << 13, 1, True),     # 0.2175 / 0.2151
]


@pytest.mark.parametrize("n,topology,pop,runs,want", BF16_RULE_CASES)
def test_bf16_rule_on_the_cards_times(n, topology, pop, runs, want):
    assert tgen.tp_faster(n, topology, pop, runs, "bf16") is want
    assert tgen.time_parallel(n, n // 2, topology_dims(topology), topology, "bf16", 1, pop,
                              runs) is want


@pytest.mark.parametrize("faster", [False, True])
@pytest.mark.parametrize("n,fits", [(1024, True), (2048, True), (3584, False)])
def test_bf16_layout_follows_tp_faster(monkeypatch, faster, n, fits):
    """The bf16 layout is ``tp_faster`` where the kernel takes the shape, as
    the card checks force it (``chip_smoke.py::gen_layout``); the int8
    layout follows the same function."""
    monkeypatch.setattr(tgen, "tp_faster", lambda *a, **k: faster)
    assert tgen.time_parallel(n, n // 2, 6, "fm3_series", "bf16", 1, 1 << 15) is (faster and fits)
    assert tgen.time_parallel(1024, 512, 6, "fm3_series", "int8", 1, 1 << 15) is faster


def test_f32_never_takes_a_time_parallel_b1_b2_layout():
    assert not tgen.time_parallel(1024, 512, 6, "fm3_series", "f32", 1, 1)
    assert not tgen.tp_takes(1024, 512, 6, "fm3_series", "f32")


@pytest.mark.parametrize("mode,tp,key", [
    ("int8", True, "time_parallel"), ("int8", False, "one_warp"),
    ("bf16", True, "bf16_time_parallel"), ("bf16", False, "bf16_one_warp")])
def test_layout_keys(mode, tp, key):
    assert tgen.layout_key(mode, tp) == key


# ---- the fold in place ----------------------------------------------------------

GROUP = 16


def _mirror_fold(q: np.ndarray, warps: int) -> tuple:
    """The bf16 kernel's fold of one candidate's frame q (N bf16 values as
    float32), step by step: warp w emits the time blocks [w nb / W, (w + 1)
    nb / W) in groups of 16 as MirrorEmit stores them (sample s < N/2 at
    index s of a+, s > N/2 at index N - s of a-, the 16-byte unit below a
    group written whole with a placeholder the next group overwrites,
    except at the warp's last group), into rows that start as NaN, the warps
    in reverse order (a warp's store over its neighbour's samples would
    show); then the fold in place, a+[i] = bf16(q[i] + q[N-i]), a-[i] =
    bf16(q[i] - q[N-i]), index 0 with nothing."""
    n = q.shape[0]
    half, nb = n // 2, n // 128
    ap = np.full(half, np.nan, np.float32)
    am = np.full(half, np.nan, np.float32)
    edge = np.nan
    for w in reversed(range(warps)):
        b0, b1 = w * nb // warps, (w + 1) * nb // warps
        end = b1 * 128
        for m0 in range(b0 * 128, end, GROUP):
            cur = q[m0:m0 + GROUP]
            if m0 < half:
                ap[m0:m0 + GROUP] = cur
                continue
            top = n - m0
            if m0 == half:
                edge = cur[0]
            else:
                am[top] = cur[0]
            am[top - 8:top] = [cur[8 - e] for e in range(8)]
            lo = [np.float32(-7.0)] + [cur[GROUP - e] for e in range(1, 8)]  # -7: the placeholder
            if m0 + GROUP < end or m0 + GROUP == n:
                am[top - 16:top - 8] = lo
            else:
                am[top - 15:top - 8] = lo[1:]
    # the fold in place, a group of 16 samples at a time
    plus, minus = ap.copy(), am.copy()
    for u in range(half // GROUP):
        for j in range(GROUP):
            i = GROUP * u + j
            x = np.float32(0.0) if i == 0 else am[i]
            plus[i] = np.float32(ap[i]) + x
            minus[i] = np.float32(ap[i]) - x
    rnd = lambda v: torch.from_numpy(v).to(torch.bfloat16).to(torch.float32)  # noqa: E731
    return rnd(plus), rnd(minus), float(edge)


@pytest.mark.parametrize("n", [256, 512, 768, 1024, 2048])
@pytest.mark.parametrize("warps", [None, 2])
def test_mirrored_fold_is_fold_cast(n, warps):
    """The in-place mirrored fold gives the one-warp fold bit for bit (index
    0 and the edge sample N/2 included) at the kernel's warp split
    (min(n / 128, 8) warps) and at two warps a frame, on random bf16 frames
    with sums and differences that cancel."""
    rng = np.random.default_rng(n + (warps or 0))
    warps = warps or min(n // 128, 8)
    for _ in range(4):
        q = torch.from_numpy((rng.standard_normal(n) * 300).astype(np.float32)).to(torch.bfloat16)
        q[n // 2 + 1] = -q[n // 2 - 1]  # a sum that cancels
        q[n - 1] = q[1]  # a difference that cancels
        plus, minus, edge = _mirror_fold(q.to(torch.float32).numpy(), warps)
        want = tsf.fold(q[:, None])
        assert not torch.isnan(plus).any() and not torch.isnan(minus).any()
        assert torch.equal(plus, want[0][:, 0]) and torch.equal(minus, want[1][:, 0])
        assert edge == float(want[2][0])


# ---- the wrappers on the CPU ----------------------------------------------------


@pytest.mark.parametrize("topology", ["fm3_series", "fm3_parallel"])
def test_bf16_wrappers_plain_on_cpu_whatever_the_layout(monkeypatch, topology):
    """On CPU tensors B1 and B2 bf16 run their plain versions whichever
    layout the rule would take on the card, count no launch, and give the
    plain versions' results."""
    from pmfm_tpu_torch.ops.spectral import make_spectrum_ops

    n, pop = 256, 40
    d = topology_dims(topology)
    so = make_spectrum_ops(n, dft_dtype="bfloat16", device="cpu")
    rng = np.random.default_rng(7)
    maxs = ((3520.0, 8.0, 3520.0, 1.0) * (d // 4) if parallel_pairs(topology)
            else (3520.0, 8.0) * (d // 2))
    p = torch.from_numpy((rng.random((pop, d)) * np.asarray(maxs)).astype(np.float32))
    pv = torch.from_numpy(rng.random((8, d)).astype(np.float32))
    ps = torch.from_numpy(rng.uniform(0.02, 0.3, (8, d)).astype(np.float32))
    target = torch.from_numpy(rng.random(so.num_bins).astype(np.float32))
    kw = dict(dft_packed=so.dft_packed, dft_scale=so.dft_packed_scale, topology=topology, n=n,
              sine_order=9)
    kw2 = dict(pop=pop, param_mins=(0.0,) * d, param_maxs=maxs, **kw)
    counters = (tsf.fused_synth_fitness, tgen.fused_generation)
    before = [(f.launches, dict(f.launches_by_layout)) for f in counters]
    outs = []
    for faster in (False, True):
        monkeypatch.setattr(tgen, "tp_faster", lambda *a, v=faster, **k: v)
        assert tsf.b1_entry("bf16", n, so.num_bins, d, topology, 1, pop)[1] == (
            "bf16_time_parallel" if faster else "bf16_one_warp")
        outs.append((tsf.fused_synth_fitness(p, target, **kw),
                     *tgen.fused_generation(11, pv, ps, target, **kw2)))
    assert [(f.launches, dict(f.launches_by_layout)) for f in counters] == before
    for out in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(out, outs[0]))
    assert torch.equal(outs[0][0], tsf.fused_synth_fitness_plain(p, target, **kw))
    want = tgen.fused_generation_plain(11, pv, ps, target, **kw2)
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1:], want))
