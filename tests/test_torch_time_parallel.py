"""The time-parallel synthesis of B3 and B4 (csrc/large_frame.cu) and of
B2's time-parallel layout (csrc/fused_tp.cu) on the CPU.

The kernels split each candidate's time blocks across threads and find every
thread's phase offsets level by level: a scalar walk for the first
oscillator's offset, then for each later oscillator a pass in which every
thread totals its own blocks' increments from the offsets it knows, and a
fold of the totals before its first block, sequential in block order. This
file runs that decomposition in torch with the port's own numerics
(``synth_fitness``'s ``_chain_rows``, ``_sin_turns``, ``_frac``) and holds it
bit for bit against the one-sequence plain version, ``synth_blocks_plain``,
which the kernels' plain versions run: exact, so no tolerance. It also holds
the time-parallel B3's fold indexing (rows read back from a frame in groups
of 16) against the plain fold, and the wrappers' launch geometry. A bank
(fm{k}_parallel) takes one level for all its pairs, as B2's time-parallel
layout runs it (synth_common.cuh::bank_scan): the modulators' offsets by
their own walks, every pair's carrier totals over a thread's blocks, one
barrier, a fold in block order, then the emitting pass.
"""
import numpy as np
import pytest
import torch

from pmfm_tpu_torch.kernels import generation as tgen
from pmfm_tpu_torch.kernels import synth_fitness as tsf
from pmfm_tpu_torch.kernels import synth_fold as tfold
from pmfm_tpu_torch.kernels import synth_stream as tstream
from pmfm_tpu_torch.ops.synthesis import parallel_pairs, topology_dims
from pmfm_tpu_torch.ops.wavetable import DEFAULT_SAMPLE_RATE, DEFAULT_WAVETABLE_SIZE

C = tsf.TIME_BLOCK
N = 32768  # B4's shortest frame: 256 time blocks
BANK_N = 1024  # B2's time-parallel layout: eight warps of one time block each
POP = 5


def _params(topology, seed):
    d = topology_dims(topology)
    maxs = np.asarray((3520.0, 8.0, 3520.0, 1.0) * (d // 4) if parallel_pairs(topology)
                      else (3520.0, 8.0) * (d // 2), np.float32)
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.random((POP, d)) * maxs).astype(np.float32))


def _blocks(rows, offs, j_count, blocks, emit_cs=None):
    """Run oscillators 0 .. j_count-1 of the chain over ``blocks`` (a list of
    block indices, the same count for every segment) from the offsets
    ``offs`` (each (S, P), advanced in place), as csrc synth_common.cuh::
    synth_span. Returns each block's total of the last oscillator's
    increments (level mode) or each block's output sine (emit mode,
    ``emit_cs`` the output coefficients; j_count is then the whole chain's
    modulators)."""
    inc1, ims, ics, cs, inc_blk = rows
    t = torch.arange(C, dtype=torch.float32)[:, None, None]
    out = []
    for _ in blocks:
        pos = t * inc1 + offs[0]
        s_last = None
        for j in range(j_count):
            x = tsf._sin_turns(pos, cs) * ims[j] + ics[j]
            pre, tot = tsf._exclusive_prefix(x)
            if emit_cs is not None or j < j_count - 1:
                pos = pre + offs[j + 1]
                offs[j + 1] = tsf._frac(offs[j + 1] + tot)
            s_last = tot
        out.append(tsf._sin_turns(pos, emit_cs) if emit_cs is not None else s_last)
        offs[0] = tsf._frac(offs[0] + inc_blk)
    return out


def time_parallel_synth(p, *, topology, n, sine_order, int8, segments):
    """Each block's output sine (C, P), in time order, computed as the
    kernels do with ``segments`` threads a candidate: thread w owns blocks
    [w nb / S, (w + 1) nb / S) (lengths may differ by one)."""
    inv_sr = tsf.inv_sample_rate(DEFAULT_WAVETABLE_SIZE, DEFAULT_SAMPLE_RATE)
    inc1, ims, ics, _ = tsf._chain_rows(p.T.to(torch.float32), topology, inv_sr)
    cs = tsf.sin_coeffs(sine_order)
    cs_out = tsf.sin_coeffs(sine_order, 63.0) if int8 else cs
    inc_blk = tsf._frac(float(C) * inc1)
    kn, nb, pop = len(ims) + 1, n // C, p.shape[0]
    bounds = [(w * nb // segments, (w + 1) * nb // segments) for w in range(segments)]
    # every thread's offsets at its first block: off[0] by its own scalar walk
    off = [torch.zeros((segments, pop)) for _ in range(kn)]
    for w, (b0, _) in enumerate(bounds):
        for _ in range(b0):
            off[0][w] = tsf._frac(off[0][w] + inc_blk)

    def run(j_count, emit_cs=None):
        """Every thread over its own blocks, from a copy of its offsets:
        the segments are stacked on axis 0 and walk in step; a shorter
        segment's surplus last step is dropped."""
        rows = (inc1, ims, ics, cs, inc_blk)
        o = [x.clone() for x in off]
        steps = max(b1 - b0 for b0, b1 in bounds)
        res = _blocks(rows, o, j_count, range(steps), emit_cs)
        return [[res[i][..., w, :] if emit_cs is not None else res[i][w]
                 for i in range(b1 - b0)] for w, (b0, b1) in enumerate(bounds)]

    for level in range(kn - 1):
        per_thread = run(level + 1)
        totals = [t for seg in per_thread for t in seg]  # block order
        assert len(totals) == nb
        for w, (b0, _) in enumerate(bounds):  # a sequential fold, never a tree
            f = torch.zeros(pop)
            for b in range(b0):
                f = tsf._frac(f + totals[b])
            off[level + 1][w] = f
    return [y for seg in run(kn - 1, cs_out) for y in seg]


def time_parallel_bank(p, *, topology, n, sine_order, int8, segments):
    """Each block's output (C, P) of an fm{k}_parallel bank, in time order,
    computed as B2's time-parallel layout does with ``segments`` warps a
    candidate (csrc synth_common.cuh::bank_scan, then synth_bank_span):
    thread w's modulator offsets at its first block by their own walks, one
    level pass of every pair over the thread's blocks (the modulators alone),
    a sequential fold of the totals in block order for each carrier's offset,
    then the emitting pass, pairs summed in pair order with their gains."""
    inv_sr = tsf.inv_sample_rate(DEFAULT_WAVETABLE_SIZE, DEFAULT_SAMPLE_RATE)
    pairs = tsf._pair_rows(p.T.to(torch.float32), topology, inv_sr)
    gains, _ = tsf.bank_gains([pr[3] for pr in pairs], int8)
    cs = tsf.sin_coeffs(sine_order)
    nb, pop = n // C, p.shape[0]
    bounds = [(w * nb // segments, (w + 1) * nb // segments) for w in range(segments)]
    t = torch.arange(C, dtype=torch.float32)[:, None]
    incs_blk = [tsf._frac(float(C) * pr[0]) for pr in pairs]
    o1_at, o2_at = {}, {}
    for j, (inc1, ims, ics, _) in enumerate(pairs):
        totals = []  # the level pass: block order, every thread over its own blocks
        for w, (b0, b1) in enumerate(bounds):
            o1 = torch.zeros(pop)
            for _ in range(b0):
                o1 = tsf._frac(o1 + incs_blk[j])
            o1_at[j, w] = o1.clone()
            for _ in range(b0, b1):
                x = tsf._sin_turns(t * inc1 + o1, cs) * ims[0] + ics[0]
                totals.append(tsf._exclusive_prefix(x)[1])
                o1 = tsf._frac(o1 + incs_blk[j])
        for w, (b0, _) in enumerate(bounds):  # a sequential fold, never a tree
            f = torch.zeros(pop)
            for b in range(b0):
                f = tsf._frac(f + totals[b])
            o2_at[j, w] = f
    out = []
    for w, (b0, b1) in enumerate(bounds):
        o1 = [o1_at[j, w].clone() for j in range(len(pairs))]
        o2 = [o2_at[j, w].clone() for j in range(len(pairs))]
        for _ in range(b0, b1):
            y = None
            for j, (inc1, ims, ics, _) in enumerate(pairs):
                x = tsf._sin_turns(t * inc1 + o1[j], cs) * ims[0] + ics[0]
                pre, tot = tsf._exclusive_prefix(x)
                o = tsf._sin_turns(pre + o2[j], cs) * gains[j]
                y = o if y is None else y + o
                o2[j] = tsf._frac(o2[j] + tot)
                o1[j] = tsf._frac(o1[j] + incs_blk[j])
            out.append(y if int8 else tsf._div(y, float(len(pairs))))
    return out


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("sine_order", [5, 7, 9])
@pytest.mark.parametrize("topology,segments,int8", [
    ("fm2", 32, True),  # the time-parallel B3's 32 lanes, int8 output oscillator
    ("fm3_series", 16, False),  # B4's 16 warps
    ("fm8_series", 12, False),  # segments of unequal length (21 or 22 blocks)
    # B2's time-parallel layout on banks: eight warps of one block at n 1024
    ("fm2_parallel", 8, True),
    ("fm3_parallel", 8, True),
    ("fm5_parallel", 8, True),
])
def test_time_parallel_decomposition_is_exact(topology, segments, int8, sine_order):
    p = _params(topology, sine_order)
    n = BANK_N if parallel_pairs(topology) else N
    kw = dict(topology=topology, n=n, sine_order=sine_order, int8=int8)
    mirror = time_parallel_bank if parallel_pairs(topology) else time_parallel_synth
    got = mirror(p, segments=segments, **kw)
    inv_sr = tsf.inv_sample_rate(DEFAULT_WAVETABLE_SIZE, DEFAULT_SAMPLE_RATE)
    want = list(tsf.synth_blocks_plain(p, inv_sr=inv_sr, **kw))
    assert len(got) == len(want) == n // C
    for b, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(_bits(g), _bits(w)), f"block {b}"


# ---- B2's time-parallel layout across frames (csrc/fused_tp.cuh) ----------------

FRAMES_N = (256, 2048)
MAGIC = 12582912.0  # csrc INT_MAGIC: y + MAGIC - MAGIC rounds to nearest even (FrameEmit)


def _walk(seg_blocks, x, inc_blk):
    """x advanced by ``seg_blocks`` block increments, frac after each."""
    for _ in range(seg_blocks):
        x = tsf._frac(x + inc_blk)
    return x


def tp_chain_frames(p, *, topology, n, frames, sine_order):
    """Each block's int8 output sine (C, P) over ``frames`` frames of n, in
    time order, as B2's time-parallel layout (csrc fused_tp.cuh) computes
    it: W = min(n / 128, 8) warps a candidate, warp w the blocks [w nb / W,
    (w + 1) nb / W) of every frame. In frame f each warp takes the carries
    at the frame's first block (zero at frame 0, else where the last warp
    ended frame f - 1), walks off[0] to its first block, and runs the levels
    (synth_common.cuh::chain_scan): level L's totals over its blocks, then
    off[L + 1] folded from its frame-start value over the totals of the
    blocks before its first; the emitting pass gives the samples and the
    last warp's carries at the frame's end."""
    inv_sr = tsf.inv_sample_rate(DEFAULT_WAVETABLE_SIZE, DEFAULT_SAMPLE_RATE)
    inc1, ims, ics, _ = tsf._chain_rows(p.T.to(torch.float32), topology, inv_sr)
    cs, cs63 = tsf.sin_coeffs(sine_order), tsf.sin_coeffs(sine_order, 63.0)
    inc_blk = tsf._frac(float(C) * inc1)
    kn, nb, pop = len(ims) + 1, n // C, p.shape[0]
    w_count = min(nb, 8)
    bounds = [(w * nb // w_count, (w + 1) * nb // w_count) for w in range(w_count)]
    steps = nb // w_count
    assert all(b1 - b0 == steps for b0, b1 in bounds)
    rows = (inc1, ims, ics, cs, inc_blk)
    start = [torch.zeros(pop) for _ in range(kn)]
    out = []
    for _ in range(frames):
        off = [s.expand(w_count, pop).clone() for s in start]
        for w, (b0, _) in enumerate(bounds):
            off[0][w] = _walk(b0, start[0], inc_blk)
        for level in range(kn - 1):
            o = [x.clone() for x in off]
            res = _blocks(rows, o, level + 1, range(steps))
            totals = [res[i][w] for w in range(w_count) for i in range(steps)]  # block order
            for w, (b0, _) in enumerate(bounds):
                f = start[level + 1].clone()
                for b in range(b0):
                    f = tsf._frac(f + totals[b])
                off[level + 1][w] = f
        res = _blocks(rows, off, kn - 1, range(steps), cs63)
        out.extend(res[i][..., w, :] for w in range(w_count) for i in range(steps))
        start = [x[w_count - 1].clone() for x in off]  # the last warp's carries
    return out


def tp_bank_frames(p, *, topology, n, frames, sine_order):
    """As ``tp_chain_frames`` for an fm{k}_parallel bank in int8
    (synth_common.cuh::bank_scan across frames): each modulator's o1 walked
    from its frame-start value, one level of every pair's carrier totals,
    each o2 folded from its frame-start value, then the emitting pass, the
    pairs' gained outputs summed in pair order."""
    inv_sr = tsf.inv_sample_rate(DEFAULT_WAVETABLE_SIZE, DEFAULT_SAMPLE_RATE)
    pairs = tsf._pair_rows(p.T.to(torch.float32), topology, inv_sr)
    gains, _ = tsf.bank_gains([pr[3] for pr in pairs], True)
    cs = tsf.sin_coeffs(sine_order)
    nb, pop = n // C, p.shape[0]
    w_count = min(nb, 8)
    bounds = [(w * nb // w_count, (w + 1) * nb // w_count) for w in range(w_count)]
    t = torch.arange(C, dtype=torch.float32)[:, None]
    incs_blk = [tsf._frac(float(C) * pr[0]) for pr in pairs]
    o1s = [torch.zeros(pop) for _ in pairs]
    o2s = [torch.zeros(pop) for _ in pairs]
    out = []
    for _ in range(frames):
        o1_at, o2_at = {}, {}
        for j, (inc1, ims, ics, _) in enumerate(pairs):
            totals = []
            for w, (b0, b1) in enumerate(bounds):
                o1 = _walk(b0, o1s[j], incs_blk[j])
                o1_at[j, w] = o1.clone()
                for _ in range(b0, b1):
                    x = tsf._sin_turns(t * inc1 + o1, cs) * ims[0] + ics[0]
                    totals.append(tsf._exclusive_prefix(x)[1])
                    o1 = tsf._frac(o1 + incs_blk[j])
            for w, (b0, _) in enumerate(bounds):
                f = o2s[j].clone()
                for b in range(b0):
                    f = tsf._frac(f + totals[b])
                o2_at[j, w] = f
        for w, (b0, b1) in enumerate(bounds):
            o1 = [o1_at[j, w].clone() for j in range(len(pairs))]
            o2 = [o2_at[j, w].clone() for j in range(len(pairs))]
            for _ in range(b0, b1):
                y = None
                for j, (inc1, ims, ics, _) in enumerate(pairs):
                    x = tsf._sin_turns(t * inc1 + o1[j], cs) * ims[0] + ics[0]
                    pre, tot = tsf._exclusive_prefix(x)
                    o = tsf._sin_turns(pre + o2[j], cs) * gains[j]
                    y = o if y is None else y + o
                    o2[j] = tsf._frac(o2[j] + tot)
                    o1[j] = tsf._frac(o1[j] + incs_blk[j])
                out.append(y)
        o1s, o2s = o1, o2  # the last warp's carries at the frame's end
    return out


@pytest.mark.parametrize("frames", [1, 2, 8])
@pytest.mark.parametrize("n", FRAMES_N)
@pytest.mark.parametrize("topology", ["fm2", "fm3_series", "fm8_series", "fm3_parallel"])
def test_time_parallel_frames_are_the_continuous_synthesis(topology, n, frames):
    """B2's time-parallel order over F frames (warps of W = min(n / 128, 8),
    carries handed from frame to frame, folds continued from each frame's
    start offsets) gives the port's continuous synthesis of F n samples
    (``synth_blocks_plain`` at n = F n) bit for bit, before and after the
    int8 rounding that FrameEmit applies. Folding from 0 in every frame (a
    mutation of the order) would differ from frame 1 on."""
    p = _params(topology, n + frames)[:3]
    kw = dict(topology=topology, n=n, frames=frames, sine_order=(5, 7, 9)[frames % 3])
    mirror = tp_bank_frames if parallel_pairs(topology) else tp_chain_frames
    got = mirror(p, **kw)
    inv_sr = tsf.inv_sample_rate(DEFAULT_WAVETABLE_SIZE, DEFAULT_SAMPLE_RATE)
    want = list(tsf.synth_blocks_plain(p, topology=topology, n=frames * n, inv_sr=inv_sr,
                                       sine_order=kw["sine_order"], int8=True))
    assert len(got) == len(want) == frames * n // C
    for b, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(_bits(g), _bits(w)), f"block {b}"
        assert torch.equal(_bits((g + MAGIC) - MAGIC), _bits((w + MAGIC) - MAGIC)), f"block {b}"


def kernel_fold(q: torch.Tensor):
    """a+, a- (P, N/2) and the edge sample from a frame q (P, N) as float32,
    with the time-parallel B3's indexing: lane groups u of 16 rows, row
    16u + i paired with element 16 - i of the group at N - 16(u + 1) for
    i > 0 and with sample N - 16u for i = 0 (none for u = 0)."""
    pop, n = q.shape
    half, g = n // 2, 16  # csrc FOLD_G
    ap = torch.empty((pop, half))
    am = torch.empty((pop, half))
    for u in range(half // g):
        old = q[:, u * g : (u + 1) * g]
        lo = q[:, n - (u + 1) * g : n - u * g]
        first = q[:, n - u * g] if u > 0 else torch.zeros(pop)
        x = torch.stack([first] + [lo[:, g - i] for i in range(1, g)], 1)
        ap[:, u * g : (u + 1) * g] = old + x
        am[:, u * g : (u + 1) * g] = old - x
    return ap, am, q[:, half]


@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("n", [4096, 8192])
def test_time_parallel_fold_indexing(n, int8):
    """The frame-fold of the time-parallel B3 gives the plain version's a+,
    a- and edge from the same frame, bit for bit (int8: exact integers;
    bf16: one rounding of each float32 sum)."""
    p = _params("fm3_series", n)
    inv_sr = tsf.inv_sample_rate(DEFAULT_WAVETABLE_SIZE, DEFAULT_SAMPLE_RATE)
    kw = dict(topology="fm3_series", n=n, inv_sr=inv_sr, sine_order=7,
              dft_scale=1e-5 if int8 else 0.0)
    ap, am, edge, _ = tfold._fold_plain_block(p, **kw)
    q = torch.empty((n, POP), dtype=ap.dtype)
    amp = tsf.chain_amp(p, "fm3_series")
    for b, y in enumerate(tsf.synth_blocks_plain(p, topology="fm3_series", n=n, inv_sr=inv_sr,
                                                 sine_order=7, int8=int8)):
        q[b * C : (b + 1) * C] = torch.round(y).to(torch.int8) if int8 else (y * amp).to(q.dtype)
    kp, km, ke = kernel_fold(q.T.to(torch.float32))
    assert torch.equal(kp.to(ap.dtype), ap) and torch.equal(km.to(am.dtype), am)
    assert torch.equal(ke, edge)


T3, T8 = tfold.FOLD_TP_BELOW_POP[3, True], tfold.FOLD_TP_BELOW_POP[8, True]


@pytest.mark.parametrize("pop,n,int8,topology,want", [
    # cell (e), match_audio's int8 engine: a warp a candidate, 8 KB frame + 256 B totals
    (4096, 8192, True, "fm3_series",
     dict(time_parallel=True, blocks=4096, threads=32, shared_bytes=8448)),
    # its bf16 refine tail
    (4096, 8192, False, "fm3_series",
     dict(time_parallel=True, blocks=4096, threads=32, shared_bytes=16640)),
    (1000, 16384, False, "fm3_series",
     dict(time_parallel=True, blocks=1000, threads=32, shared_bytes=33280)),
    # cell (c): the single pass, 32 candidates a block
    (1 << 15, 8192, True, "fm3_series",
     dict(time_parallel=False, blocks=1024, threads=32, shared_bytes=0)),
    (T3 - 1, 4096, True, "fm3_series",
     dict(time_parallel=True, blocks=T3 - 1, threads=32, shared_bytes=4224)),
    (T3, 4096, True, "fm3_series",
     dict(time_parallel=False, blocks=T3 // 32, threads=32, shared_bytes=0)),
    # the longest chain crosses at its own population
    (T8 - 1, 8192, True, "fm8_series",
     dict(time_parallel=True, blocks=T8 - 1, threads=32, shared_bytes=8448)),
    (T8, 8192, True, "fm8_series",
     dict(time_parallel=False, blocks=T8 // 32, threads=32, shared_bytes=0)),
    # a frame whose shared memory would not fit a block takes the single pass
    (1, 1 << 17, False, "fm2", dict(time_parallel=False, blocks=1, threads=32, shared_bytes=0)),
])
def test_fold_geometry(pop, n, int8, topology, want):
    assert tfold.fold_geometry(pop, n, int8, topology) == want


@pytest.mark.parametrize("int8", [True, False])
def test_fold_threshold_covers_every_chain(int8):
    """A threshold for every ported chain (fm2, fm3..fm8_series) and bank
    (fm2..fm5_parallel) in each mode; at P 2048 every one takes the
    time-parallel layout, which was the faster there for all of them. The
    wide shapes (fm9..fm16_series, fm6..fm8_parallel) take the longest
    timed row of their kind."""
    banks = [f"fm{k}_parallel" for k in range(2, 6)]
    for topology in ["fm2"] + [f"fm{k}_series" for k in range(3, 9)] + banks:
        assert tfold.fold_geometry(2048, 8192, int8, topology)["time_parallel"]
    assert len(tfold.FOLD_TP_BELOW_POP) == 22
    assert tfold.fold_shape("fm12_series") == 8 and tfold.fold_shape("fm3_parallel") == banks[1]
    assert tfold.fold_shape("fm8_parallel") == "fm5_parallel"


@pytest.mark.parametrize("below,want", [(0, False), (1 << 62, True)])
def test_fold_geometry_follows_the_threshold(monkeypatch, below, want):
    """The layout follows FOLD_TP_BELOW_POP as it stands when the wrapper is
    called (the card checks set it to hold each layout against the plain
    version); a frame whose shared memory would not fit stays single-pass."""
    monkeypatch.setattr(tfold, "FOLD_TP_BELOW_POP", dict.fromkeys(tfold.FOLD_TP_BELOW_POP, below))
    assert tfold.fold_geometry(1 << 15, 8192, True, "fm3_series")["time_parallel"] == want
    assert tfold.fold_geometry(7, 8192, False, "fm8_series")["time_parallel"] == want
    assert not tfold.fold_geometry(7, 1 << 17, False, "fm2")["time_parallel"]


@pytest.mark.parametrize("pop,n,want", [
    # cell (d): 256 blocks of 512 threads, 32 time blocks a warp, 64 KB of totals
    (1 << 13, 65536, dict(blocks=256, threads=512, blocks_per_warp=32, shared_bytes=65536,
                          scratch_floats=0)),
    (1000, 32768, dict(blocks=32, threads=512, blocks_per_warp=16, shared_bytes=32768,
                       scratch_floats=0)),
    # longer frames keep their totals in device memory
    (33, 131072, dict(blocks=2, threads=512, blocks_per_warp=64, shared_bytes=0,
                      scratch_floats=2 * 32 * 1024)),
])
def test_stream_geometry(pop, n, want):
    assert tstream.stream_geometry(pop, n) == want


def test_b3_wrapper_plain_on_cpu_whatever_the_layout(monkeypatch):
    """On CPU tensors the wrapper runs the plain version whichever layout
    the threshold would pick on the card, and counts no launch."""
    p = _params("fm2", 3)
    before = tfold.fused_synth_fold.launches
    outs = []
    for below in (1 << 62, 0):
        monkeypatch.setattr(tfold, "FOLD_TP_BELOW_POP",
                            dict.fromkeys(tfold.FOLD_TP_BELOW_POP, below))
        outs.append(tfold.fused_synth_fold(p, topology="fm2", n=4096, sine_order=7,
                                           dft_scale=1e-5))
    assert tfold.fused_synth_fold.launches == before
    assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.parametrize("int8", [True, False])
def test_b3_plain_blocks_of_one(int8):
    """The plain version in blocks of one candidate (pop_block 1, as an odd
    population gets) gives each candidate what a larger block gives it:
    with one candidate, a+ and a- must not share memory with the frame."""
    p = _params("fm3_series", 11)
    kw = dict(topology="fm3_series", n=4096, sine_order=7, dft_scale=1e-5 if int8 else 0.0)
    ones = tfold.fused_synth_fold_plain(p, pop_block=1, **kw)
    whole = tfold.fused_synth_fold_plain(p, pop_block=POP, **kw)
    for a, b in zip(ones, whole):
        assert torch.equal(a, b)
    assert not torch.equal(ones[0], ones[1])


# ---- B2's time-parallel layout (csrc/fused_tp.cuh): shared memory and the pick ---

BANKS = [f"fm{k}_parallel" for k in range(2, 6)]


@pytest.mark.parametrize("n,k,d,want", [
    (1024, 512, 20, 32768 + 65536),  # the pursuit's polishes: two blocks an SM
    (1024, 200, 12, 32768 + 32768),  # few bins: the frame is the larger tenant
    (2048, 1024, 12, 65536 + 131072),
    (256, 128, 8, 8192 + 16384),
    (256, 8, 2000, 8192 + 256000),  # the staged genes: past any block
    (3584, 1792, 20, 114688 + 229376),  # past the 232,448 bytes a block may have
])
def test_gen_shared_bytes_tp(n, k, d, want):
    """a+/- of the block's 32 candidates (32 n bytes), then the largest of
    the frame (32 n), the terms (32 K floats) and the staged genes (32 d
    floats), as csrc fused_tp.cu::tp_smem reckons it."""
    assert tsf.shared_bytes_tp(n, k, d) == want


@pytest.mark.parametrize("n,k,topology,frames,want", [
    # --mode stft's shape: the genes and the carries (6 + 3 floats a candidate) beside
    (2048, 1024, "fm3_series", 8, 65536 + 131072 + 32 * 9 * 4),
    (1024, 512, "fm2", 2, 32768 + 65536 + 32 * 6 * 4),
    (1024, 512, "fm8_series", 2, 32768 + 65536 + 32 * 24 * 4),
    (2048, 1024, "fm5_parallel", 8, 65536 + 131072 + 32 * 30 * 4),
    # one frame: no third region, the genes staged in the second
    (2048, 1024, "fm3_series", 1, 65536 + 131072),
    (256, 8, "fm8_series", 1, 8192 + 8192),
])
def test_gen_shared_bytes_tp_chains_and_frames(n, k, topology, frames, want):
    """At F > 1 a third region holds the staged genes (read at every frame)
    and the carries the last warp hands to the next frame: 32 x (d + d / 2)
    floats, as csrc fused_tp.cuh::tp_smem reckons it; at one frame the
    formula is the banks' of one frame."""
    assert tsf.shared_bytes_tp(n, k, topology_dims(topology), frames) == want


@pytest.mark.parametrize("n,k,topology,dtype,frames,want", [
    # the pursuit's polishes: eight warps a block, 96 KB
    (1024, 512, "fm5_parallel", torch.int8, 1, True),
    (1024, 512, "fm2_parallel", torch.int8, 1, True),
    # a frame of two time blocks: two warps
    (256, 128, "fm3_parallel", torch.int8, 1, True),
    (2048, 1024, "fm4_parallel", torch.int8, 1, True),
    # a frame of one time block: the one-warp layout
    (128, 64, "fm3_parallel", torch.int8, 1, False),
    # past a block's shared memory: the one-warp layout
    (3584, 1792, "fm3_parallel", torch.int8, 1, False),
    # F > 1 and the fixed chains take it too (at the default one block of candidates)
    (1024, 512, "fm3_parallel", torch.int8, 2, True),
    (1024, 512, "fm3_series", torch.int8, 1, True),
    # bf16 takes its own time-parallel layout (csrc/fused_tp_bf16.cuh)
    (1024, 512, "fm3_parallel", torch.bfloat16, 1, True),
    # what stays on the one-warp layout: true f32, the wide banks, the long code
    (1024, 512, "fm3_parallel", torch.float32, 1, False),
    (1024, 512, "fm6_parallel", torch.int8, 1, False),
    (1024, 512, "fm9_parallel", torch.int8, 1, False),
])
def test_gen_layout(n, k, topology, dtype, frames, want):
    d = topology_dims(topology)
    scale = 1e-5 if dtype == torch.int8 else 0.0
    mode = tsf.operand_mode(dtype, scale)
    assert tgen.time_parallel(n, k, d, topology, mode, frames) is want


@pytest.mark.parametrize("n,topology,pop,runs,want", [
    # cells (h) / (m) and --batch: 128 and 512 one-warp blocks, one warp an SM or few
    (2048, "fm3_series", 4096, 1, True),
    (2048, "fm3_series", 4096, 4, True),
    # cell (n), the run axis: 1024 blocks, but at n 2048 an SM holds three one-warp blocks
    (2048, "fm3_series", 4096, 8, True),
    # the bench shape: six one-warp blocks an SM at n 1024 hide fm3_series' latency
    (1024, "fm3_series", 1 << 15, 1, False),
    (1024, "fm3_series", 8192, 1, True),
    # the pursuit's polishes and a bank at P 2^15
    (1024, "fm5_parallel", 8192, 1, True),
    (1024, "fm5_parallel", 1 << 15, 1, True),
    # long chains lose once the one-warp grid fills the SMs
    (2048, "fm8_series", 4096, 1, True),
    (2048, "fm6_series", 4096, 8, False),
    (1024, "fm4_series", 16384, 1, False),
    (2048, "fm6_series", 1 << 15, 1, False),
    # a grid of more than eight one-warp waves keeps the one-warp layout
    (1024, "fm2", 1 << 15, 8, False),
    (1024, "fm2", 1 << 15, 1, True),
    # short frames: two or four warps a block
    (256, "fm3_parallel", 16384, 1, False),
    (256, "fm3_parallel", 8192, 1, True),
    (512, "fm4_series", 4096, 1, True),
    (512, "fm6_series", 16384, 1, False),
    (256, "fm6_series", 4096, 1, False),
])
def test_gen_layout_rule(n, topology, pop, runs, want):
    """``tp_faster`` on shapes an H100 timed in both layouts (PERF.md §6,
    tools/torch_b2_layout_probe.py's sweep): the time-parallel layout where it was the faster, the one-warp
    one where it was the faster or the two were within 1%."""
    d = topology_dims(topology)
    assert tgen.tp_faster(n, topology, pop, runs) is want
    assert tgen.time_parallel(n, n // 2, d, topology, "int8", 8, pop, runs) is want


def test_gen_layout_skips_the_long_code(monkeypatch):
    monkeypatch.setattr(tsf, "LONG_ABOVE_GENES", 16)
    assert not tgen.time_parallel(1024, 512, 20, "fm5_parallel", "int8")
    assert tgen.time_parallel(1024, 512, 16, "fm4_parallel", "int8")


@pytest.mark.parametrize("switch", [False, True])
def test_gen_layout_follows_tp_faster(monkeypatch, switch):
    """The layout follows ``tp_faster`` as it stands when the wrapper is
    called (the card checks patch it to hold the layouts against each
    other), for every fixed bank."""
    monkeypatch.setattr(tgen, "tp_faster", lambda *a, **k: switch)
    for b in BANKS:
        assert tgen.time_parallel(1024, 512, topology_dims(b), b, "int8") is switch


def test_b2_wrapper_plain_on_cpu_whatever_the_layout(monkeypatch):
    """On CPU tensors B2 runs its plain version whichever layout it would
    take on the card, and counts no launch."""
    from pmfm_tpu_torch.ops.spectral import make_spectrum_ops

    topology, n, pop = "fm3_parallel", 256, 40
    d = topology_dims(topology)
    so = make_spectrum_ops(n, dft_dtype="int8", device="cpu")
    rng = np.random.default_rng(4)
    pv = torch.from_numpy(rng.random((8, d)).astype(np.float32))
    ps = torch.from_numpy(rng.uniform(0.02, 0.3, (8, d)).astype(np.float32))
    target = torch.from_numpy(rng.random(so.num_bins).astype(np.float32))
    kw = dict(pop=pop, param_mins=(0.0,) * d, param_maxs=(3520.0, 8.0, 3520.0, 1.0) * 3,
              dft_packed=so.dft_packed, dft_scale=so.dft_packed_scale, topology=topology, n=n,
              sine_order=9)
    before = tgen.fused_generation.launches, dict(tgen.fused_generation.launches_by_layout)
    outs = []
    for switch in (True, False):
        monkeypatch.setattr(tgen, "tp_faster", lambda *a, switch=switch, **k: switch)
        assert tgen.time_parallel(n, so.num_bins, d, topology, "int8") is switch
        outs.append(tgen.fused_generation(11, pv, ps, target, **kw))
    after = tgen.fused_generation.launches, dict(tgen.fused_generation.launches_by_layout)
    assert after == before
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    want = tgen.fused_generation_plain(11, pv, ps, target, **kw)
    assert all(torch.equal(a, b) for a, b in zip(outs[0], want))


@pytest.mark.parametrize("topology", ["fm3_series", "fm3_parallel"])
def test_b2_wrapper_plain_on_cpu_whatever_the_layout_at_2_frames(monkeypatch, topology):
    """A chain or a bank at F 2 (the shapes the time-parallel layout took on
    in its second slice): on CPU tensors B2 runs its plain version whichever
    layout it would take on the card, counts no launch, and its fitness
    over the two frames is the plain version's."""
    from pmfm_tpu_torch.ops.spectral import make_spectrum_ops

    n, pop, frames = 256, 40, 2
    d = topology_dims(topology)
    so = make_spectrum_ops(n, dft_dtype="int8", device="cpu")
    rng = np.random.default_rng(5)
    pv = torch.from_numpy(rng.random((8, d)).astype(np.float32))
    ps = torch.from_numpy(rng.uniform(0.02, 0.3, (8, d)).astype(np.float32))
    target = torch.from_numpy(rng.random((frames, so.num_bins)).astype(np.float32))
    maxs = ((3520.0, 8.0, 3520.0, 1.0) * (d // 4) if parallel_pairs(topology)
            else (3520.0, 8.0) * (d // 2))
    kw = dict(pop=pop, param_mins=(0.0,) * d, param_maxs=maxs, dft_packed=so.dft_packed,
              dft_scale=so.dft_packed_scale, topology=topology, n=n, sine_order=7,
              num_frames=frames)
    before = tgen.fused_generation.launches, dict(tgen.fused_generation.launches_by_layout)
    outs = []
    for switch in (True, False):
        monkeypatch.setattr(tgen, "tp_faster", lambda *a, switch=switch, **k: switch)
        assert tgen.time_parallel(n, so.num_bins, d, topology, "int8", frames, pop) is switch
        outs.append(tgen.fused_generation(13, pv, ps, target, **kw))
    after = tgen.fused_generation.launches, dict(tgen.fused_generation.launches_by_layout)
    assert after == before
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    want = tgen.fused_generation_plain(13, pv, ps, target, **kw)
    assert all(torch.equal(a, b) for a, b in zip(outs[0], want))
