// The large-frame synthesis kernels for Hopper (sm_90a): emit-only engines
// whose output goes to a spectrum computed outside the kernel. Their entry
// points are large_frame.cu's; the wide codes' instantiations (chains of 9
// .. 16 oscillators, every bank) are large_frame_wide.cu's, which nvcc
// builds beside it.
//
// The long code (topologies above 32 genes: synth_common.cuh::LongSynth)
// is large_frame_long.cu's: B3's single pass, and B4 as a thread a
// candidate (synth_stream_long_kernel).
//
// Replaces two TPU kernels of pmfm_tpu:
//   synth_fold_kernel(s)  <- kernels/synth_fold.py::fused_synth_fold     (B3)
//   synth_stream_kernel   <- kernels/synth_stream.py::fused_synth_stream (B4)
//
// B3 (the synth_fold route, 4096 <= n <= 16384): synthesis and the window
// fold, a+/-[r] = q[r] +- q[N-r] (a+/-[0] = q[0]), plus the edge sample
// x[N/2] and the magnitude scale |amp| * dft_scale per candidate. int8 mode
// emits q = round(63 sin) (the fold stays exact: |a+/-| <= 126); bf16 mode
// emits the bf16-rounded audio sin * amp and rounds the fold sum once more
// (the reference's fold_cast), with a magnitude scale of 1. a+/- are stored
// candidate-major, as (P, N/2) rows that the wrapper hands out as (N/2, P)
// views: that is the layout in which the folded DFT outside the kernel
// (ops/spectral.py::magnitude_spectrum_prefolded, torch._int_mm) runs about
// 7x faster on an H100 than with time-major a+/- (chip_smoke.py's phase 11
// times both layouts; PERF.md has the numbers).
//
// B4 (the synth_stream route, n >= 32768): synthesis times the Hann window,
// sin * amp * w[m], written as (N, P) time-major bf16, or f32 for the
// true-f32 engine, for ops/spectral.py::magnitude_spectrum_factored
// (prewindowed).
//
// What bounds them on an H100, at the shapes chip_smoke.py drives (fm3_series,
// sine order 7: 44 f32 operations a sample, chip_smoke.py::synth_ops_f32):
//   B3 at n 8192, P 2^15: 11.8 G f32 operations (0.18 ms at 67 TFLOP/s) and
//      268 MB of a+/- written (0.08 ms at 3.35 TB/s): bound by operations.
//   B4 at n 65536, P 2^13: 24 G f32 operations (0.36 ms) and 1.07 GB of bf16
//      audio written (0.32 ms): near the balance point.
// None of these operations contracts into an FMA (the audio is the plain
// version's bit for bit), so the CUDA cores' issue rate, one instruction a
// clock on each of an SM's four schedulers, is the practical limit: twice
// the bound.
//
// The first kernels (one thread walking all n samples of one candidate)
// ran at 35x (B4) and 9.5x (B3) their bounds: at P 2^13 B4 had ~2 warps an
// SM to hide a serial recurrence of 65,536 steps, and B3 at pop 4096 less
// than one; both read the chain length at run time. Here the chain length
// KN is a template argument (evaluate.cuh::dispatch_synth, as B1/B2), and
// time is split across threads with the exact level-by-level scheme below.
//
// Time-parallel synthesis (synth_common.cuh::synth_span). The recurrence
// runs in blocks of 128 samples; inside a block oscillator j+1's phase is
// the exclusive prefix of oscillator j's increments x plus its carried
// offset off[j+1], and from block to block off[j+1] <- frac(off[j+1] +
// tot_j(b)), off[0] <- frac(off[0] + inc_blk), where tot_j(b), block b's
// total of x_j, depends only on off[0..j](b) and the block's own samples.
// A thread that owns the blocks [b0, b1) of a candidate therefore gets the
// exact offsets at b0 level by level:
//   off[0](b0): its own walk of the scalar chain over b < b0;
//   level L = 0 .. KN-2: every thread runs oscillators 0..L over its blocks
//     from the offsets it knows (advancing off[1..L] block by block, as the
//     plain version does) and writes each block's tot_L(b); after a barrier
//     it folds tot_L(0 .. b0-1) from 0 in block order, frac(f + tot), which
//     is off[L+1](b0);
//   a last pass runs the whole chain over its blocks and emits.
// The folds stay sequential in b, in the plain version's fadd/frac order:
// frac-add is not associative, so no tree. The price is recomputation:
// level L runs L+1 oscillators, so fm3_series evaluates 6 sines a sample
// instead of 3 (fm2 3 for 2, fm8_series 36 for 8). The bound in
// chip_smoke.py counts the single pass: it measures the work, not this
// implementation of it.
//
// An fm{k}_parallel bank (the WIDE_BANK code: every bank here takes the
// runtime pair count, so B3/B4 add two instantiations a kernel, mode and
// sine order for all banks and long chains, not one a bank) is k
// independent chains of two: its carrier offsets o2[j](b0) take one level
// each, pair after pair over the same totals (bank_levels), the modulators'
// o1[j](b0) their own walks, and one emitting pass (synth_bank_span) sums
// the pairs in pair order, as B1/B2's bank does. That is three sines a
// pair-sample where the single pass computes two. A chain of 9 .. 16
// oscillators (WIDE_CHAIN) runs its levels in a runtime loop.
//
// B4 layout. A block takes 32 candidates, lane = candidate, and ST_WARPS =
// 16 warps, warp w the w-th of 16 equal runs of time blocks: at P 2^13 that
// is 256 blocks of 512 threads, two an SM (one wave of 264 slots), against
// 256 single warps before. Each sample's store is one warp store of 32
// consecutive candidates into the (N, P) output (64 bytes in bf16, 128 in
// f32). The level totals sit in shared memory, 32 x n/128 floats (64 KB at
// n 65536: two blocks an SM); above ST_SMEM_MAX they go to a scratch of the
// wrapper's in device memory, the same code through a generic pointer, so
// any n that is a multiple of 128 works.
//
// B3 layouts, by population (the wrapper picks, kernels/synth_fold.py::
// fold_geometry, from thresholds by chain length or bank and mode timed on
// the card):
// * Time-parallel, below FOLD_TP_BELOW_POP candidates: a warp a candidate,
//   lane = the lane-th of 32 runs of time blocks (two blocks a lane at
//   n 8192), the levels synchronised by __syncwarp alone. The last pass
//   writes the candidate's whole frame q to shared memory (8 KB of int8 or
//   16 KB of bf16 at n 8192), and the warp then folds it from there: lane l
//   takes rows 16u .. 16u+15 for u = l, l + 32, ..., reads q[16u ..] and the
//   16 samples q[N-16u-15 .. N-16u] (the edge sample N/2 shifts the second
//   half by one, so a row never maps onto whole time blocks) and writes one
//   16-byte vector (two in bf16) of a+ and of a-: a warp's stores are 512
//   contiguous bytes of a row. Pop 4096 (cell (e), match_audio) gets 4096
//   warps instead of 128.
// * Single pass, from FOLD_TP_BELOW_POP up: one thread a candidate, 32 a
//   block, B1/B2's CandidateSynth with the grouped fold emitter FoldEmit (synth_common.cuh:
//   the first half of the frame straight to a+, each group of 16 second-half
//   samples completing 16 rows), as B1/B2 run it. At P 2^15 there are ~8
//   warps an SM already, and the levels' recomputation would cost more than
//   the parallelism gives.
//
// Exactness: every f32 operation uses __fmul_rn / __fadd_rn (synth_common.cuh),
// bf16 rounding is __float2bfloat16_rn (round to nearest even, as PyTorch's
// .to(torch.bfloat16)), so the outputs are bit-equal to the plain versions in
// kernels/synth_fold.py and kernels/synth_stream.py, which walk the time
// axis in one sequence (synth_fitness.py::synth_blocks_plain).

#pragma once

#include "evaluate.cuh"

#define LF_TPB 32        // B3 single pass: candidates (threads) per block
#define LF_G 8           // samples a group of the time-parallel passes' unrolled loop
#define ST_WARPS 16      // B4: runs of time blocks (warps) a block
#define ST_THREADS (32 * ST_WARPS)
#define ST_SMEM_MAX (64 * 1024)  // B4: level totals in shared memory up to this
#define FT_MIN_BLOCKS 16         // B3 time-parallel: blocks (warps) an SM the registers allow
#define SMEM_LIMIT 232448        // shared memory one block of an H100 can use

// The level passes of the time-parallel synthesis (this file's note) for a
// thread whose blocks are [b0, b1): on entry off[0] holds off[0](b0), on
// return off[0 .. KN-1] hold every offset at block b0. tot[b * stride] is
// block b's total at the current level, shared by every thread of the
// candidate; sync orders their writes before the reads and the reads before
// the next level's writes. No fold reads the totals from block b_top up
// (the last thread's first block), so the last thread computes none. A wide
// chain runs its kn - 1 levels in a runtime loop, each level synth_span's
// wide pass over nj = level + 1 oscillators.
template <int NC, int KN, int L = 0, typename Sync>
__device__ __forceinline__ void scan_levels(const Chain<KN>& ch, const SynthParams& sp, int b0,
                                            int b1, int b_top, float (&off)[Chain<KN>::S],
                                            float* tot, int stride, Sync sync) {
  constexpr int S = Chain<KN>::S;
  auto put = [&](int b, float t) { tot[(size_t)b * stride] = t; };
  NoEmit none;
  if constexpr (KN == WIDE_CHAIN) {
    for (int l = 0; l < ch.kn - 1; ++l) {
      float o[S];
#pragma unroll
      for (int j = 0; j < S; ++j) o[j] = off[j];
      synth_span<NC, LF_G, KN, 1, false>(ch, sp, nullptr, b0, min(b1, b_top), o, none, put, l + 1);
      sync();
      float f = 0.f;
      for (int b = 0; b < b0; ++b) f = frac(fadd(f, tot[(size_t)b * stride]));
#pragma unroll
      for (int j = 1; j < S; ++j)
        if (j == l + 1) off[j] = f;
      sync();  // the next level rewrites tot
    }
  } else if constexpr (L < KN - 1) {
    float o[S];
#pragma unroll
    for (int j = 0; j < S; ++j) o[j] = off[j];
    synth_span<NC, LF_G, KN, L + 1, false>(ch, sp, nullptr, b0, min(b1, b_top), o, none, put);
    sync();
    float f = 0.f;
    for (int b = 0; b < b0; ++b) f = frac(fadd(f, tot[(size_t)b * stride]));
    off[L + 1] = f;
    sync();  // the next level rewrites tot
    scan_levels<NC, KN, L + 1>(ch, sp, b0, b1, b_top, off, tot, stride, sync);
  }
}

// off[] at block b0 of the chain ch: off[0] from the scalar walk, the rest
// zero until scan_levels fills them.
template <int KN>
__device__ __forceinline__ void start_offsets(const Chain<KN>& ch, int b0,
                                              float (&off)[Chain<KN>::S]) {
#pragma unroll
  for (int j = 0; j < Chain<KN>::S; ++j) off[j] = 0.f;
  for (int b = 0; b < b0; ++b) off[0] = frac(fadd(off[0], ch.inc_blk));
}

// A bank's carries at block b0, for a thread whose blocks are [b0, b1): its
// pairs are independent chains of two, so each pair's modulator offset
// o1[j] is its own scalar walk and its carrier offset o2[j] one level, run
// pair after pair over the same totals tot (scan_levels' level 0 of pair j's
// chain, pair_chain).
template <int NC, int KN, typename Sync>
__device__ __forceinline__ void bank_levels(const PairBank<KN>& bk, const SynthParams& sp, int b0,
                                            int b1, int b_top, float (&o1)[PairBank<KN>::S],
                                            float (&o2)[PairBank<KN>::S], float* tot, int stride,
                                            Sync sync) {
  constexpr int S = PairBank<KN>::S;
  const int np = bank_pairs(bk);
  auto put = [&](int b, float t) { tot[(size_t)b * stride] = t; };
  NoEmit none;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    o1[j] = o2[j] = 0.f;
    if (j < np) {
      for (int b = 0; b < b0; ++b) o1[j] = frac(fadd(o1[j], bk.inc_blk[j]));
      const Chain<2> ch = pair_chain(bk, j);
      float o[2] = {o1[j], 0.f};
      synth_span<NC, LF_G, 2, 1, false>(ch, sp, nullptr, b0, min(b1, b_top), o, none, put);
      sync();
      float f = 0.f;
      for (int b = 0; b < b0; ++b) f = frac(fadd(f, tot[(size_t)b * stride]));
      o2[j] = f;
      sync();  // the next pair rewrites tot
    }
  }
}

// The emitting pass of the time-parallel kernels over the thread's blocks
// [b0, b1), from the exact carries at b0 (found level by level, then the
// whole chain or bank run once): emit(m, u, y) gets each sample m as
// synth_span and synth_bank_span give it (the output oscillator's y, times
// sin_c63 in int8 for a chain; a bank's gained sum, divided by its pairs in
// the float modes), after amp is set to Chain::amp or PairBank::amp.
template <int NC, int KN, bool INT8, typename Sync, typename Emit>
__device__ __forceinline__ void synth_blocks_tp(const float* p, const SynthParams& sp, int b0,
                                                 int b1, int b_top, float* tot, int stride,
                                                 Sync sync, float& amp, Emit& emit) {
  NoTotal none;
  if constexpr (is_bank(KN)) {
    constexpr int S = PairBank<KN>::S;
    const PairBank<KN> bk = make_bank<KN, INT8>(p, sp);
    amp = bk.amp;
    float o1[S], o2[S];
    bank_levels<NC>(bk, sp, b0, b1, b_top, o1, o2, tot, stride, sync);
    synth_bank_span<NC, LF_G, KN, INT8>(bk, sp, b0, b1, o1, o2, emit);
  } else {
    const Chain<KN> ch = make_chain<KN>(p, sp);
    amp = ch.amp;
    float off[Chain<KN>::S];
    start_offsets(ch, b0, off);
    scan_levels<NC, KN>(ch, sp, b0, b1, b_top, off, tot, stride, sync);
    synth_span<NC, LF_G, KN, emit_nj(KN), true>(ch, sp, INT8 ? sp.sin_c63 : sp.sin_c, b0, b1,
                                                off, emit, none, ch.kn - 1);
  }
}

// ---- B3, single pass ---------------------------------------------------------

template <int NC, int KN, bool INT8>
__global__ void __launch_bounds__(LF_TPB)
synth_fold_kernel(const float* __restrict__ params, int pop, SynthParams sp,
                  fold_t<INT8>* a_plus, fold_t<INT8>* a_minus,  // read back: no __restrict__
                  float* __restrict__ edge, float* __restrict__ mag_scale) {
  const int cand = blockIdx.x * LF_TPB + threadIdx.x;
  if (cand >= pop) return;
  constexpr bool LONG = KN == LONG_CODE;  // reads its parameters from params throughout
  float preg[LONG ? 1 : synth_dims(KN)];
  if constexpr (!LONG) load_params<synth_dims(KN)>(preg, params, cand, sp.d);
  const float* const p = LONG ? params + (size_t)cand * sp.d : preg;
  const int half = sp.n >> 1;
  FoldEmit<INT8> emit;
  emit.ap.p = a_plus + (size_t)cand * half;
  emit.am.p = a_minus + (size_t)cand * half;
  emit.n = sp.n;
  emit.half = half;
  emit.edge_q = 0.f;
  CandidateSynth<NC, KN, INT8> cs;  // B1/B2's synthesis of one frame
  const float amp = cs.init(p, sp, cand);
  emit.amp = amp;
  cs.frame(sp, emit);
  emit.fold_rows(0, false, 0.f);  // rows [0, 16): row 0 keeps q[0] alone
  edge[cand] = emit.edge_q;
  mag_scale[cand] = INT8 ? fmul(fabsf(amp), sp.dft_scale) : 1.f;
}

// ---- B3, time-parallel -----------------------------------------------------------

// Shared memory of a time-parallel B3 block (one warp, one candidate): the
// frame q (n elements) and the level totals (n / TIME_BLOCK floats).
template <bool INT8>
static size_t fold_tp_smem(int n) {
  return (size_t)n * sizeof(fold_t<INT8>) + (size_t)(n / TIME_BLOCK) * sizeof(float);
}

// Block = candidate blockIdx.x, lane l = blocks [l nb / 32, (l + 1) nb / 32).
template <int NC, int KN, bool INT8>
__global__ void __launch_bounds__(32, FT_MIN_BLOCKS)
synth_fold_tp_kernel(const float* __restrict__ params, SynthParams sp,
                     fold_t<INT8>* __restrict__ a_plus, fold_t<INT8>* __restrict__ a_minus,
                     float* __restrict__ edge, float* __restrict__ mag_scale) {
  using T = fold_t<INT8>;
  extern __shared__ __align__(16) unsigned char ft_smem[];
  T* q = reinterpret_cast<T*>(ft_smem);
  float* tot = reinterpret_cast<float*>(ft_smem + (size_t)sp.n * sizeof(T));  // n % 256 == 0
  const int cand = blockIdx.x, lane = threadIdx.x, n = sp.n, half = n >> 1;
  const int nb = n / TIME_BLOCK, b0 = lane * nb / 32, b1 = (lane + 1) * nb / 32;
  float p[synth_dims(KN)];
  load_params<synth_dims(KN)>(p, params, cand, sp.d);
  // the last pass: the quantised samples into the frame, as FoldEmit makes
  // them: int8, round(63 sin) to nearest even, the low byte of y + INT_MAGIC
  // (pack_s8x4's rounding); bf16, the audio rounded
  float amp = 0.f;
  auto put = [&](int m, int, float y) {
    if constexpr (INT8)
      q[m] = (int8_t)(__float_as_uint(fadd(y, INT_MAGIC)) & 0xFFu);
    else
      q[m] = to_bf16(fmul(y, amp));
  };
  synth_blocks_tp<NC, KN, INT8>(p, sp, b0, b1, 31 * nb / 32, tot, 1, WarpSync{}, amp, put);
  __syncwarp();
  // the fold: row r = 16u + i pairs with sample N - r, which is element
  // 16 - i of the group at N - 16(u + 1) for i > 0 and sample N - 16u for
  // i = 0 (none for row 0, which keeps q[0] alone)
  T* ap = a_plus + (size_t)cand * half;
  T* am = a_minus + (size_t)cand * half;
  for (int u = lane; u < half / FOLD_G; u += 32) {
    float old[FOLD_G], lo[FOLD_G], plus[FOLD_G], minus[FOLD_G];
    load_group<INT8>(q + u * FOLD_G, old);
    load_group<INT8>(q + n - (u + 1) * FOLD_G, lo);
    const float first = u > 0 ? to_f32(q[n - u * FOLD_G]) : 0.f;
#pragma unroll
    for (int i = 0; i < FOLD_G; ++i) {
      const float x = i == 0 ? first : lo[FOLD_G - i];
      plus[i] = fadd(old[i], x);
      minus[i] = fsub(old[i], x);
    }
    store_group<INT8>(ap + u * FOLD_G, plus);
    store_group<INT8>(am + u * FOLD_G, minus);
  }
  if (lane == 0) {
    edge[cand] = to_f32(q[half]);
    mag_scale[cand] = INT8 ? fmul(fabsf(amp), sp.dft_scale) : 1.f;
  }
}

// ---- B4 ---------------------------------------------------------------------

// Block = candidates 32 blockIdx.x + lane, warp w = time blocks
// [w nb / ST_WARPS, (w + 1) nb / ST_WARPS). window is 16-byte aligned.
// tot_scratch: null, or 32 x nb floats a block where the totals do not fit
// ST_SMEM_MAX.
template <int NC, int KN, bool F32>
__global__ void __launch_bounds__(ST_THREADS, 2)
synth_stream_kernel(const float* __restrict__ params, int pop, SynthParams sp,
                    const float* __restrict__ window, void* __restrict__ out,
                    float* __restrict__ tot_scratch) {
  extern __shared__ float st_smem[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  // a lane past the population repeats the last candidate: the same
  // samples to the same addresses, so no store needs a branch
  const int cand = min(blockIdx.x * 32 + lane, pop - 1);
  const int nb = sp.n / TIME_BLOCK;
  const int b0 = (int)((long long)w * nb / ST_WARPS), b1 = (int)((long long)(w + 1) * nb / ST_WARPS);
  float* tot = (tot_scratch ? tot_scratch + (size_t)blockIdx.x * nb * 32 : st_smem) + lane;
  float p[synth_dims(KN)];
  load_params<synth_dims(KN)>(p, params, cand, sp.d);
  // sample m of this candidate at col[m * pop]: the group's row pointer and
  // four window values are loaded at its first sample and every fourth (u
  // is a compile-time constant in each copy of put), so a sample costs one
  // address multiply-add and one store
  using OutT = typename std::conditional<F32, float, __nv_bfloat16>::type;
  static_assert(LF_G % 4 == 0, "the window in float4s");
  OutT* const col = reinterpret_cast<OutT*>(out) + cand;
  OutT* row = col;
  float4 w4;
  float amp = 0.f;
  auto put = [&](int m, int u, float y) {
    if (u == 0) row = col + (size_t)m * pop;
    if (u % 4 == 0) w4 = __ldg(reinterpret_cast<const float4*>(window + m));
    const float wm = u % 4 == 0 ? w4.x : u % 4 == 1 ? w4.y : u % 4 == 2 ? w4.z : w4.w;
    const float v = fmul(fmul(y, amp), wm);
    if constexpr (F32)
      row[u * pop] = v;
    else
      row[u * pop] = to_bf16(v);
  };
  // the float modes' synthesis: the unit sine (sin_c), a bank's mean
  synth_blocks_tp<NC, KN, false>(p, sp, b0, b1, (int)((long long)(ST_WARPS - 1) * nb / ST_WARPS),
                                 tot, 32, BlockSync{}, amp, put);
}

// ---- B4 at the long code -------------------------------------------------------

// A thread a candidate (SL_TPB a block) walks its whole frame with the long
// code (synth_common.cuh::LongSynth: the carries in the long scratch, row =
// candidate) and stores sin * amp * w[m] as synth_stream_kernel's put does:
// each sample is one warp store of 32 consecutive candidates. No time
// split, so no levels: a long chain's levels would take kn (kn + 1) / 2
// oscillators a sample.
#define SL_TPB 32
template <int NC, bool F32>
__global__ void __launch_bounds__(SL_TPB)
synth_stream_long_kernel(const float* __restrict__ params, int pop, SynthParams sp,
                         const float* __restrict__ window, void* __restrict__ out) {
  const int cand = blockIdx.x * SL_TPB + threadIdx.x;
  if (cand >= pop) return;
  using OutT = typename std::conditional<F32, float, __nv_bfloat16>::type;
  OutT* const col = reinterpret_cast<OutT*>(out) + cand;
  OutT* row = col;
  float4 w4;
  LongSynth<NC, false> ls;
  const float amp = ls.init(params + (size_t)cand * sp.d, sp, cand);
  auto put = [&](int m, int u, float y) {
    if (u == 0) row = col + (size_t)m * pop;
    if (u % 4 == 0) w4 = __ldg(reinterpret_cast<const float4*>(window + m));
    const float wm = u % 4 == 0 ? w4.x : u % 4 == 1 ? w4.y : u % 4 == 2 ? w4.z : w4.w;
    const float v = fmul(fmul(y, amp), wm);
    if constexpr (F32)
      row[u * pop] = v;
    else
      row[u * pop] = to_bf16(v);
  };
  ls.template span<FOLD_G>(sp, 0, sp.n / TIME_BLOCK, put);
}

#ifdef __CUDACC__
// B3's launch (pmfm_synth_fold's arguments) over the codes SET of
// evaluate.cuh::dispatch_synth, without fixed banks: CODES_FIXED in
// large_frame.cu, CODES_WIDE in large_frame_wide.cu.
template <int SET>
static int synth_fold_launch(const float* params, int pop, const SynthParams& sp, void* a_plus,
                             void* a_minus, float* edge, float* mag_scale, int int8_mode,
                             int time_parallel, cudaStream_t stream) {
  return dispatch_ncoef(sp.ncoef, [&](auto nc) {
    return dispatch_synth<false, SET>(sp, [&](auto kc) {
      constexpr int NC = decltype(nc)::value, KN = decltype(kc)::value;
      auto run = [&](auto int8c) {
        constexpr bool INT8 = decltype(int8c)::value;
        using T = fold_t<INT8>;
        if (!time_parallel) {
          synth_fold_kernel<NC, KN, INT8><<<(pop + LF_TPB - 1) / LF_TPB, LF_TPB, 0, stream>>>(
              params, pop, sp, (T*)a_plus, (T*)a_minus, edge, mag_scale);
          return (int)cudaGetLastError();
        }
        if constexpr (KN == LONG_CODE) {  // the long code takes the single pass alone
          return (int)cudaErrorInvalidValue;
        } else {
          const size_t smem = fold_tp_smem<INT8>(sp.n);
          if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
          const int e = (int)prepare(synth_fold_tp_kernel<NC, KN, INT8>, smem);
          if (e) return e;
          synth_fold_tp_kernel<NC, KN, INT8><<<pop, 32, smem, stream>>>(
              params, sp, (T*)a_plus, (T*)a_minus, edge, mag_scale);
          return (int)cudaGetLastError();
        }
      };
      return int8_mode ? run(std::true_type{}) : run(std::false_type{});
    });
  });
}

// B4's launch over the codes SET: `blocks` blocks of ST_THREADS with `smem`
// bytes of level totals, or the totals in tot_scratch (pmfm_synth_stream).
template <int SET>
static int synth_stream_launch(const float* params, int pop, const SynthParams& sp,
                               const float* window, void* out, int audio_f32, float* tot_scratch,
                               size_t smem, int blocks, cudaStream_t stream) {
  return dispatch_ncoef(sp.ncoef, [&](auto nc) {
    return dispatch_synth<false, SET>(sp, [&](auto kc) {
      constexpr int NC = decltype(nc)::value, KN = decltype(kc)::value;
      auto run = [&](auto f32c) {
        constexpr bool F32 = decltype(f32c)::value;
        const int e = (int)prepare(synth_stream_kernel<NC, KN, F32>, smem);
        if (e) return e;
        synth_stream_kernel<NC, KN, F32><<<blocks, ST_THREADS, smem, stream>>>(
            params, pop, sp, window, out, tot_scratch);
        return (int)cudaGetLastError();
      };
      return audio_f32 ? run(std::true_type{}) : run(std::false_type{});
    });
  });
}

int synth_fold_wide(const float* params, int pop, const SynthParams& sp, void* a_plus,
                    void* a_minus, float* edge, float* mag_scale, int int8_mode,
                    int time_parallel, cudaStream_t stream);
int synth_fold_long(const float* params, int pop, const SynthParams& sp, void* a_plus,
                    void* a_minus, float* edge, float* mag_scale, int int8_mode,
                    int time_parallel, cudaStream_t stream);
int synth_stream_long(const float* params, int pop, const SynthParams& sp, const float* window,
                      void* out, int audio_f32, cudaStream_t stream);
int synth_stream_wide(const float* params, int pop, const SynthParams& sp, const float* window,
                      void* out, int audio_f32, float* tot_scratch, size_t smem, int blocks,
                      cudaStream_t stream);
#endif
