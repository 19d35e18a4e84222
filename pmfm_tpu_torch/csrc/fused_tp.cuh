// B1 and B2 int8 in a second layout for Hopper (sm_90a): W warps a block,
// a time-parallel synthesis, and the folded DFT's bins split over the warps,
// on the fixed chains (fm2, fm3_series .. fm8_series: codes 2 .. FIXED_KN)
// and the fixed banks of 2 .. 5 pairs (BANK_KN + 2 .. + 5), at any frame
// count and on the run axis. fused_eval.cu's one-warp kernels (tc_eval.cuh)
// compute the same functions; the wrappers (kernels/generation.py::
// time_parallel, which B1's synth_fitness.py::b1_entry calls) pick between
// them by shape, and the two give the same fitness (B2: values and steps)
// bit for bit. B1 and B2 differ only in the prologue that stages the
// block's genes (tp_block's GEN flag: B2 draws offspring, B1 copies the
// given rows), as tc_eval.cuh's fitness_block and generation_block do.
// fused_tp.cu instantiates the banks and holds the launchers;
// fused_tp_chain.cu instantiates the chains, so that nvcc builds the two
// halves side by side.
//
// Replaces, with fused_eval.cu's kernels, the TPU kernels
//   B1 <- pmfm_tpu/kernels/synth_fitness.py::fused_synth_fitness
//   B2 <- pmfm_tpu/kernels/generation.py::fused_generation
//
// Why a second layout. The one-warp kernel synthesises a candidate's whole
// frame in one thread and runs the whole DFT in the same warp: at the
// pursuit's polish population (P 8192, n 1024) its grid is 256 one-warp
// blocks on 132 SMs, and at --mode stft's shape (P 4096, n 2048, F 8) 128,
// one warp an SM (its 64 KB of a+/- a block allow three), too few to hide
// the serial chain of dependent f32 adds of the synthesis or the mma.sync
// latency of the DFT. Here a block of 32 candidates has W = min(n / 128, 8)
// warps: eight warps an SM at P 4096, n 2048.
//
// The block, lane t = candidate t, warp w = the time blocks
// [w nb / W, (w + 1) nb / W) of every frame (nb = n / 128: one block a warp
// at n 1024, two at n 2048):
// * Prologue: B2's offspring prologue over the block's 32 x d (candidate,
//   gene) pairs, strided over its W x 32 threads (evaluate.cuh::
//   offspring_gene, unchanged: values and steps are the one-warp kernel's),
//   or B1's copy of the block's rows of the given parameters (zeros past
//   pop), once a launch, the scaled genes staged in shared memory. At P 1
//   (the pursuit's seed rescores) the one-warp kernel is one warp on one
//   SM: here eight warps share the synthesis and the DFT.
// * Frames. Frame f is samples [f n, (f + 1) n) of one continuous synthesis
//   (synth_common.cuh::CandidateSynth): the block walks the frames in order,
//   and each is synthesised, folded and transformed as a single frame is,
//   its fitness (its terms in ascending k, one __fadd_rn at a time) added to
//   the candidate's in frame order (evaluate_tc's order).
// * Synthesis of a frame: each thread forms its candidate's chain
//   (make_chain) or bank (make_bank) from the staged genes and takes the
//   carries at the frame's first block (zero at frame 0; where the last warp
//   ended frame f - 1, which it leaves in shared memory). It finds the
//   carries at its warp's first block level by level (synth_common.cuh::
//   chain_scan, KN - 1 levels, or bank_scan, one level for every pair: the
//   scalar walks from the frame's start, each level's pass over the warp's
//   blocks into shared memory, one __syncthreads a level, a fold in block
//   order from the frame's start value), then runs synth_span or
//   synth_bank_span over its blocks, emitting the int8 frame q (FoldEmit's
//   rounding) into shared memory, 16 samples a 16-byte store, each row's
//   units XOR-swizzled by tc_swizzle. The levels add sum_{l=1}^{KN-1} l
//   sines a sample to a chain's KN (fm3_series 3 on 3), one a pair-sample to
//   a bank's two. The fold over all F n / 128 blocks is the one-thread
//   synthesis' sequence, so the samples are bit for bit its own.
// * Fold: after a barrier, a+/- are formed from q into the swizzled rows
//   that dft_pass reads, as the time-parallel B3 folds from shared memory
//   (large_frame.cuh): row u of 16 reads q[16u ..] and q[N-16u-15 .. N-16u]
//   (the edge sample N/2 shifts the second half by one, so a row never maps
//   onto whole time blocks, and the fold can only start after the barrier),
//   a warp a candidate's row, a lane a unit. The edge sample x[N/2] and the
//   magnitude scale |amp| dft_scale are evaluate_tc's.
// * DFT: warp w runs the n-tiles [w T / W, (w + 1) T / W) of the K / 8 on
//   mma.sync s8 (tc_eval.cuh::dft_pass in its TERMS mode, TP_NT tiles a
//   pass), each bin's term stored to shared memory (term_swizzle).
// * Fitness: after a barrier, thread t of warp 0 adds candidate t's K terms
//   in ascending k, one __fadd_rn at a time, then the frame's sum to the
//   candidate's (a running sum kept in the fitness output, so that no
//   register is carried from frame to frame: the kernel sits at 128): the
//   order in which the one-warp layout's dft_pass and frame loop add them,
//   so the fitness is bit-equal to it.
//
// Shared memory (tp_smem; kernels/synth_fitness.py::shared_bytes_tp is the
// same formula): region A, a+/- of the 32 candidates (32 x n bytes), which
// holds the level totals (levels x nb x 32 floats = levels x n bytes, at
// most 7 n) before the fold; region B, the larger of the frame q (32 x n
// bytes), the terms (32 x K floats) and, at one frame, the staged genes
// (32 x d floats), each dead before the next is written; and, at F > 1,
// region C: the staged genes, read again at every frame, and the carries
// the last warp hands to the next frame (32 x d / 2 floats: a chain's KN
// offsets, a bank's two a pair), 192 d bytes. At n 1024, K 512: 96 KB
// (+ 1,152 bytes for fm3_series at F > 1), two blocks an SM; at n 2048,
// K 1024: 192 KB, one. The wrapper keeps the one-warp layout where a block
// would need more than MAX_BLOCK_SMEM.
//
// The run axis (grid y, run_seeds) as in tc_eval.cuh::generation_block. B5
// (evolve.cu) launches this kernel every generation where B2's wrapper
// would take it (generation.time_parallel at B5's population and runs),
// through fused_tp.cu's prepare/launch pair (generation.cuh); the layouts
// are bit-equal, so B5 stays bit-equal to B2 launches in either.
#pragma once

#include "tc_eval.cuh"

#define TP_MAX_WARPS 8  // warps a block: n / TIME_BLOCK, at most this many
#define TP_NT 2          // n-tiles of 8 bins a DFT pass
#define TP_MIN_BLOCKS 2  // blocks an SM the registers must allow (128 a thread)

// The int8 frame q of one candidate into its swizzled row of shared memory:
// FoldEmit's rounding, 16 samples a store.
struct FrameEmit {
  SwizzledRow<true> row;
  float cur[FOLD_G];
  __device__ __forceinline__ void operator()(int m, int u, float y) {
    cur[u] = fsub(fadd(y, INT_MAGIC), INT_MAGIC);
    if (u == FOLD_G - 1) row.store(m - u, cur);
  }
};

// Byte 0 of the 16-byte unit that holds sample s (a multiple of 16) of row
// r of the frame, as an exact float.
__device__ __forceinline__ float frame_sample(const uint4* s_q, int qunits, int r, int s) {
  const int8_t* unit =
      reinterpret_cast<const int8_t*>(s_q + r * qunits + ((s >> 4) ^ tc_swizzle(r)));
  return (float)unit[0];
}

// One candidate's time-parallel synthesis of a frame: a fixed chain or a
// fixed bank, its carries at the frame's first block (CARRIES floats, d / 2:
// a chain's off[0 .. KN-1]; a bank's o1[], then o2[]) loaded from and stored
// to carry slot j at c[j * stride]. INT8: the int8 engine's output sine
// (63 sin, a bank's int8 gains) for this file's kernel; else the float
// engines' unit sine times the amplitude (the true-f32 B1/B2's time-parallel
// synthesis, fused_f32_tp.cu), as CandidateSynth's INT8 says.
template <int NC, int KN, bool INT8 = true, bool BANK = is_bank(KN)>
struct TpSynth;

template <int NC, int KN, bool INT8>
struct TpSynth<NC, KN, INT8, false> {
  static constexpr int CARRIES = Chain<KN>::S, LEVELS = KN - 1;
  Chain<KN> ch;
  float off[CARRIES];
  __device__ __forceinline__ float init(const float* p, const SynthParams& sp) {
    ch = make_chain<KN>(p, sp);
    return ch.amp;
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < CARRIES; ++j) off[j] = 0.f;
  }
  __device__ __forceinline__ void load(const float* c, int stride) {
#pragma unroll
    for (int j = 0; j < CARRIES; ++j) off[j] = c[j * stride];
  }
  __device__ __forceinline__ void store(float* c, int stride) const {
#pragma unroll
    for (int j = 0; j < CARRIES; ++j) c[j * stride] = off[j];
  }
  template <typename Emit>
  __device__ __forceinline__ void run(const SynthParams& sp, int b0, int b1, int b_top,
                                      float* tot, int nb, Emit& emit) {
    chain_scan<NC, KN>(ch, sp, b0, b1, b_top, off, tot, nb, TC_CPB, BlockSync{});
    NoTotal none;
    synth_span<NC, FOLD_G, KN, KN - 1, true>(ch, sp, INT8 ? sp.sin_c63 : sp.sin_c, b0, b1, off,
                                             emit, none);
  }
};

template <int NC, int KN, bool INT8>
struct TpSynth<NC, KN, INT8, true> {
  static constexpr int S = PairBank<KN>::S, CARRIES = 2 * S, LEVELS = S;
  PairBank<KN> bk;
  float o1[S], o2[S];
  __device__ __forceinline__ float init(const float* p, const SynthParams& sp) {
    bk = make_bank<KN, INT8>(p, sp);
    return bk.amp;
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < S; ++j) o1[j] = o2[j] = 0.f;
  }
  __device__ __forceinline__ void load(const float* c, int stride) {
#pragma unroll
    for (int j = 0; j < S; ++j) {
      o1[j] = c[j * stride];
      o2[j] = c[(S + j) * stride];
    }
  }
  __device__ __forceinline__ void store(float* c, int stride) const {
#pragma unroll
    for (int j = 0; j < S; ++j) {
      c[j * stride] = o1[j];
      c[(S + j) * stride] = o2[j];
    }
  }
  template <typename Emit>
  __device__ __forceinline__ void run(const SynthParams& sp, int b0, int b1, int b_top,
                                      float* tot, int nb, Emit& emit) {
    bank_scan<NC, KN>(bk, sp, b0, b1, b_top, o1, o2, tot, nb, TC_CPB, BlockSync{});
    synth_bank_span<NC, FOLD_G, KN, INT8>(bk, sp, b0, b1, o1, o2, emit);
  }
};

// The prologue of a time-parallel block, B1's and B2's, int8's and bf16's
// (fused_tp_bf16.cuh): the block's 32 x d scaled genes into s_p (zeros past
// pop) with all of its threads, then a barrier. B2's (GEN) draws the
// offspring from the run's parents pv and ps (generation_block's prologue:
// values and steps are the one-warp kernel's); B1's copies the block's rows
// of the run's (pop, d) params in pv (fitness_block's staging).
template <bool GEN>
__device__ __forceinline__ void tp_stage_genes(uint32_t seed,
                                               const uint32_t* __restrict__ run_seeds,
                                               const float* __restrict__ pv,
                                               const float* __restrict__ ps, int pop,
                                               const MutateParams& mp, int d, float* s_p,
                                               float* __restrict__ values,
                                               float* __restrict__ steps) {
  const int tid = threadIdx.x, base = blockIdx.x * TC_CPB, run = blockIdx.y;
  if constexpr (GEN) {
    if (run_seeds) seed = __ldg(run_seeds + run);
    const size_t po = (size_t)run * mp.mu * d, oo = (size_t)run * pop * d;  // the run's rows
    for (int i = tid; i < TC_CPB * d; i += blockDim.x) {  // pair i: (i / d, i % d)
      const int cl = i / d, cand = base + cl;
      s_p[i] = cand < pop ? offspring_gene(seed, cand, i - cl * d, pv + po, ps + po, mp, d,
                                           values + oo, steps + oo)
                          : 0.f;
    }
  } else {
    const int avail = min(pop - base, TC_CPB) * d;
    const float* rows = pv + ((size_t)run * pop + base) * d;
    for (int i = tid; i < TC_CPB * d; i += blockDim.x) s_p[i] = i < avail ? rows[i] : 0.f;
  }
  __syncthreads();
}

// The block, which B1 and B2 share (as tc_eval.cuh's fitness_block and
// generation_block share evaluate_staged): its prologue (tp_stage_genes)
// stages the block's genes, B2's (GEN) offspring or B1's given rows; then
// the synthesis, fold, DFT and fitness of every frame. B1 passes no seeds,
// ps, values or steps.
template <int NC, int KN, bool GEN>
__device__ __forceinline__ void tp_block(uint32_t seed, const uint32_t* __restrict__ run_seeds,
                                         const float* __restrict__ pv,
                                         const float* __restrict__ ps, int pop,
                                         const SynthParams& sp, const MutateParams& mp,
                                         const int8_t* __restrict__ dft,
                                         const float* __restrict__ target,
                                         float* __restrict__ fitness, float* __restrict__ values,
                                         float* __restrict__ steps) {
  using Synth = TpSynth<NC, KN>;
  constexpr int D = synth_dims(KN);
  static_assert(KN != WIDE_CHAIN && KN != WIDE_BANK && KN != LONG_CODE, "the fixed codes only");
  static_assert(2 * Synth::CARRIES == D, "region C's carries are d / 2 floats a candidate");
  static_assert(Synth::LEVELS <= TC_CPB, "the level totals (levels x n bytes) fit region A");
  extern __shared__ __align__(16) uint4 smem_tp[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  const int n = sp.n, half = n >> 1, units = half >> 4, qunits = n >> 4, nb = n / TIME_BLOCK;
  const int d = sp.d, frames = sp.frames, base = blockIdx.x * TC_CPB, run = blockIdx.y;
  uint4* s_ap = smem_tp;               // region A: a+ and a- (32 x n bytes) ...
  uint4* s_am = smem_tp + TC_CPB * units;
  float* tot = reinterpret_cast<float*>(smem_tp) + lane;  // ... the level totals before the fold
  uint4* s_q = smem_tp + 2 * TC_CPB * units;  // region B: q, the terms (one frame: the genes)
  float* terms = reinterpret_cast<float*>(s_q);
  size_t b_bytes = (size_t)TC_CPB * n;
  b_bytes = b_bytes > (size_t)TC_CPB * sp.k * 4 ? b_bytes : (size_t)TC_CPB * sp.k * 4;
  b_bytes = b_bytes > (size_t)TC_CPB * d * 4 ? b_bytes : (size_t)TC_CPB * d * 4;
  // region C (F > 1): the staged genes, then the carries between frames
  float* s_c = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(s_q) + b_bytes);
  float* s_p = frames > 1 ? s_c : reinterpret_cast<float*>(s_q);
  float* carry = s_c + TC_CPB * d + lane;

  tp_stage_genes<GEN>(seed, run_seeds, pv, ps, pop, mp, d, s_p, values, steps);

  const int g = lane >> 2, tiles = sp.k >> 3, cand = base + lane;
  // one frame a pass, not unrolled: what a frame needs is formed in the pass
  // or read from memory, not held in registers across passes (ptxas spilled
  // more where it was: the kernel sits at 128 registers a thread)
#pragma unroll 1
  for (int f = 0; f < frames; ++f) {
    // the synthesis of candidate `lane` over the warp's time blocks of frame f
    const int b0 = warp * nb / nw, b1 = (warp + 1) * nb / nw, b_top = (nw - 1) * nb / nw;
    Synth syn;
    float amp;
    {
      float p[D];
#pragma unroll
      for (int i = 0; i < D; ++i) p[i] = i < d ? s_p[lane * d + i] : 0.f;
      amp = syn.init(p, sp);
    }
    if (f)
      syn.load(carry, TC_CPB);
    else
      syn.zero();
    FrameEmit emit;
    emit.row = SwizzledRow<true>{s_q + lane * qunits, tc_swizzle(lane)};
    // the first level's barrier ends every read of the last frame's terms
    // and, at one frame, of the staged genes in region B
    syn.run(sp, b0, b1, b_top, tot, nb, emit);
    // the last warp's carries at the frame's end start the next frame
    if (warp == nw - 1 && f + 1 < frames) syn.store(carry, TC_CPB);
    __syncthreads();

    // the fold: row 16u + i of candidate r pairs sample 16u + i with N - 16u - i
    for (int i = tid; i < TC_CPB * units; i += blockDim.x) {
      const int r = i / units, u = i - r * units;
      const SwizzledRow<true> q{s_q + r * qunits, tc_swizzle(r)};
      float old[FOLD_G], lo[FOLD_G], plus[FOLD_G], minus[FOLD_G];
      q.load(u * FOLD_G, old);
      q.load(n - (u + 1) * FOLD_G, lo);
      const float first = u > 0 ? frame_sample(s_q, qunits, r, n - u * FOLD_G) : 0.f;
#pragma unroll
      for (int j = 0; j < FOLD_G; ++j) {
        const float x = j == 0 ? first : lo[FOLD_G - j];
        plus[j] = fadd(old[j], x);
        minus[j] = fsub(old[j], x);
      }
      SwizzledRow<true>{s_ap + r * units, tc_swizzle(r)}.store(u * FOLD_G, plus);
      SwizzledRow<true>{s_am + r * units, tc_swizzle(r)}.store(u * FOLD_G, minus);
    }
    // evaluate_tc's edge term 127 (-1)^k x[N/2] and magnitude scale of the
    // thread's rows, read from q before the terms overwrite it
    const float mag_scale = fmul(fabsf(amp), sp.dft_scale);
    float ue[2][2][2], ms[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 16 + h * 8 + g;
        const float eq = frame_sample(s_q, qunits, r, half);
        ue[mt][h][0] = fmul(127.f, eq);
        ue[mt][h][1] = fmul(-127.f, eq);
        ms[mt][h] = __shfl_sync(0xFFFFFFFFu, mag_scale, r);
      }
    __syncthreads();

    // the warp's n-tiles [t0, t1) against run `run`'s target row f, TP_NT a
    // pass, each bin's term to shared memory
    const float* tgt = target + ((size_t)run * frames + f) * sp.k;
    const int t1 = (warp + 1) * tiles / nw;
    float unused[2];
    int t0 = warp * tiles / nw;
    for (; t0 + TP_NT <= t1; t0 += TP_NT)
      dft_pass<TP_NT, true, true>(8 * t0, s_ap, s_am, units, dft, tgt, sp.k, half, ue, ms, unused,
                                  terms);
    for (; t0 < t1; ++t0)
      dft_pass<1, true, true>(8 * t0, s_ap, s_am, units, dft, tgt, sp.k, half, ue, ms, unused,
                              terms);
    __syncthreads();

    // the frame's fitness: candidate `lane`'s terms in ascending k (the
    // one-warp dft_pass's order), then added to the frames before it, the sum
    // kept in the candidate's fitness in device memory
    if (warp == 0 && cand < pop) {
      float ff = 0.f;
      for (int k = 0; k < sp.k; ++k) ff = fadd(ff, terms[k * TC_CPB + (lane ^ term_swizzle(k))]);
      float* out = fitness + (size_t)run * pop + cand;
      *out = fadd(f ? *out : 0.f, ff);
    }
  }
}

// B2: tp_block after the offspring prologue.
template <int NC, int KN>
__global__ void __launch_bounds__(TP_MAX_WARPS * 32, TP_MIN_BLOCKS)
fused_generation_int8_tp_kernel(uint32_t seed, const uint32_t* __restrict__ run_seeds,
                                const float* __restrict__ pv, const float* __restrict__ ps,
                                int pop, SynthParams sp, MutateParams mp,
                                const int8_t* __restrict__ dft, const float* __restrict__ target,
                                float* __restrict__ fitness, float* __restrict__ values,
                                float* __restrict__ steps) {
  tp_block<NC, KN, true>(seed, run_seeds, pv, ps, pop, sp, mp, dft, target, fitness, values,
                         steps);
}

// B1: tp_block on the given (runs, pop, d) params. No values or steps.
template <int NC, int KN>
__global__ void __launch_bounds__(TP_MAX_WARPS * 32, TP_MIN_BLOCKS)
fused_synth_fitness_int8_tp_kernel(const float* __restrict__ params, int pop, SynthParams sp,
                                   const int8_t* __restrict__ dft,
                                   const float* __restrict__ target,
                                   float* __restrict__ fitness) {
  tp_block<NC, KN, false>(0u, nullptr, params, nullptr, pop, sp, MutateParams{}, dft, target,
                          fitness, nullptr, nullptr);
}

// ---- host side ------------------------------------------------------------------

// Dynamic shared memory of a block (this file's note).
static inline size_t tp_smem(const SynthParams& sp) {
  const size_t a = (size_t)TC_CPB * sp.n;
  size_t b = (size_t)TC_CPB * sp.n;
  b = b > (size_t)TC_CPB * sp.k * 4 ? b : (size_t)TC_CPB * sp.k * 4;
  b = b > (size_t)TC_CPB * sp.d * 4 ? b : (size_t)TC_CPB * sp.d * 4;
  const size_t c = sp.frames > 1 ? (size_t)TC_CPB * (sp.d + sp.d / 2) * 4 : 0;
  return a + b + c;
}

static inline int tp_warps(const SynthParams& sp) {
  const int nb = sp.n / TIME_BLOCK;
  return nb < TP_MAX_WARPS ? nb : TP_MAX_WARPS;
}

// The time-parallel kernels of one family, B2 (Gen*Kernel) or B1
// (Fit*Kernel), int8 here and bf16 in fused_tp_bf16.cuh: the kernel at
// (NC, KN), its operand's element and its block's shared memory.
template <typename Kernel>
struct TpFamily;

template <>
struct TpFamily<GenInt8Kernel> {
  using elem = int8_t;
  template <int NC, int KN>
  static GenInt8Kernel at() { return fused_generation_int8_tp_kernel<NC, KN>; }
  static size_t smem(const SynthParams& sp) { return tp_smem(sp); }
};

template <>
struct TpFamily<FitInt8Kernel> {
  using elem = int8_t;
  template <int NC, int KN>
  static FitInt8Kernel at() { return fused_synth_fitness_int8_tp_kernel<NC, KN>; }
  static size_t smem(const SynthParams& sp) { return tp_smem(sp); }
};

// The kernel of Kernel's family (TpFamily) for sp's sine order and fixed
// code (dispatch_synth's CODES_FIXED with the fixed banks): a chain of 2 ..
// FIXED_KN (CHAINS) or a bank of 2 .. FIXED_PAIRS (!CHAINS), each
// translation unit instantiating its own half; its shared memory set and
// the largest carveout asked for. cudaErrorInvalidValue for any other code.
template <bool CHAINS, typename Kernel>
static int prepare_tp(const SynthParams& sp, Kernel* out) {
  Kernel kernel = nullptr;
  int e = dispatch_ncoef(sp.ncoef, [&](auto nc) {
    return dispatch_synth<true, CODES_FIXED>(sp, [&](auto kc) {
      constexpr int KN = decltype(kc)::value, NC = decltype(nc)::value;
      if constexpr (KN != WIDE_CHAIN && KN != WIDE_BANK && KN != LONG_CODE &&
                    is_bank(KN) != CHAINS)
        kernel = TpFamily<Kernel>::template at<NC, KN>();
      return 0;
    });
  });
  if (!e && !kernel) e = (int)cudaErrorInvalidValue;
  if (!e) e = (int)prepare(kernel, TpFamily<Kernel>::smem(sp));
  if (!e)
    e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                  (int)cudaSharedmemCarveoutMaxShared);
  *out = kernel;
  return e;
}

// The chains' kernels (B2, B1), prepared in fused_tp_chain.cu.
int prepare_tp_chain(const SynthParams& sp, GenInt8Kernel* kernel);
int prepare_tp_chain(const SynthParams& sp, FitInt8Kernel* kernel);

// Whether a time-parallel layout whose block takes `smem` bytes takes the
// shape: any frame count, not the long code, n a multiple of 256, 1 ..
// 65535 runs and the block within MAX_BLOCK_SMEM (the code is checked where
// the kernel is prepared).
static inline bool tp_shape(const SynthParams& sp, int pop, int runs, size_t smem) {
  return sp.frames >= 1 && !sp.long_code && sp.n % (2 * TIME_BLOCK) == 0 && pop >= 1 &&
         runs >= 1 && runs <= 65535 && smem <= MAX_BLOCK_SMEM;
}

// B1 in the time-parallel layout of the family of Kernel (FitInt8Kernel,
// FitBf16Kernel): the one-warp B1's arguments and output, for what tp_shape
// takes on a fixed chain or bank (prepare_tp_chain for a chain; the
// overload of Kernel's family); any other shape returns
// cudaErrorInvalidValue. Returns cudaGetLastError().
template <typename Kernel>
static int launch_tp_fitness(const float* params, int pop, int runs, const SynthParams& sp,
                             const void* dft, const float* target, float* fitness,
                             cudaStream_t stream) {
  using F = TpFamily<Kernel>;
  const size_t smem = F::smem(sp);
  if (!tp_shape(sp, pop, runs, smem)) return (int)cudaErrorInvalidValue;
  Kernel kernel = nullptr;
  const int e = sp.npair ? prepare_tp<false>(sp, &kernel) : prepare_tp_chain(sp, &kernel);
  if (e) return e;
  kernel<<<dim3((pop + TC_CPB - 1) / TC_CPB, runs), 32 * tp_warps(sp), smem, stream>>>(
      params, pop, sp, (const typename F::elem*)dft, target, fitness);
  return (int)cudaGetLastError();
}

// B2 in the time-parallel layout of the family of Kernel (GenInt8Kernel,
// GenBf16Kernel), prepared for a run of launches (generation.cuh::
// TpGeneration): for what launch_tp_fitness takes; any other shape returns
// cudaErrorInvalidValue.
template <typename Kernel>
static int prepare_tp_generation(const SynthParams& sp, int pop, int runs,
                                 TpGeneration<Kernel>* gen) {
  gen->kernel = nullptr;
  gen->threads = 32 * tp_warps(sp);
  gen->smem = TpFamily<Kernel>::smem(sp);
  if (!tp_shape(sp, pop, runs, gen->smem)) return (int)cudaErrorInvalidValue;
  return sp.npair ? prepare_tp<false>(sp, &gen->kernel) : prepare_tp_chain(sp, &gen->kernel);
}

// One launch of a prepared B2: the one-warp B2's arguments and outputs (run
// seeds at more than one run, else cudaErrorInvalidValue), pop and runs
// those it was prepared for. Returns cudaGetLastError().
template <typename Kernel>
static int enqueue_tp_generation(const TpGeneration<Kernel>& gen, uint32_t seed,
                                 const uint32_t* run_seeds, const float* pv, const float* ps,
                                 int pop, int runs, const SynthParams& sp, const MutateParams& mp,
                                 const void* dft, const float* target, float* fitness,
                                 float* values, float* steps, cudaStream_t stream) {
  if (runs > 1 && !run_seeds) return (int)cudaErrorInvalidValue;
  gen.kernel<<<dim3((pop + TC_CPB - 1) / TC_CPB, runs), gen.threads, gen.smem, stream>>>(
      seed, run_seeds, pv, ps, pop, sp, mp, (const typename TpFamily<Kernel>::elem*)dft, target,
      fitness, values, steps);
  return (int)cudaGetLastError();
}

// B2 in the time-parallel layout: one prepare and one launch (the extern "C"
// entries of fused_tp.cu and fused_tp_bf16.cu).
template <typename Kernel>
static int launch_tp_generation(uint32_t seed, const uint32_t* run_seeds, const float* pv,
                                const float* ps, int pop, int runs, const SynthParams& sp,
                                const MutateParams& mp, const void* dft, const float* target,
                                float* fitness, float* values, float* steps,
                                cudaStream_t stream) {
  TpGeneration<Kernel> gen;
  const int e = prepare_tp_generation(sp, pop, runs, &gen);
  return e ? e
           : enqueue_tp_generation(gen, seed, run_seeds, pv, ps, pop, runs, sp, mp, dft, target,
                                   fitness, values, steps, stream);
}
