// B2 int8 on an fm{k}_parallel bank of 2 .. 5 pairs (the fixed bank codes
// BANK_KN + 2 .. + 5) in a second layout for Hopper (sm_90a): W warps a
// block, a time-parallel synthesis, and the folded DFT's bins split over the
// warps. fused_eval.cu's one-warp kernel (tc_eval.cuh) computes the same
// function; the wrapper (kernels/generation.py::time_parallel) picks this
// one for int8, one frame and a fixed bank, and the two give the same
// fitness, values and steps bit for bit.
//
// Replaces, with fused_eval.cu's kernel, the TPU kernel
//   B2 <- pmfm_tpu/kernels/generation.py::fused_generation
//
// Why a second layout. The one-warp kernel synthesises a candidate's whole
// frame in one thread and runs the whole DFT in the same warp: at the
// pursuit's polish population (P 8192, n 1024) its grid is 256 one-warp
// blocks on 132 SMs, about two warps an SM, too few to hide the serial
// chain of dependent f32 adds of the synthesis or the mma.sync latency of
// the DFT. Here a block of 32 candidates has W = min(n / 128, 8) warps:
// 2,048 warps at P 8192, two blocks (sixteen warps) an SM.
//
// The block, lane t = candidate t, warp w = the time blocks
// [w nb / W, (w + 1) nb / W) (nb = n / 128: one block a warp at n 1024, two
// at n 2048):
// * Prologue: B2's offspring prologue over the block's 32 x d (candidate,
//   gene) pairs, strided over its W x 32 threads (evaluate.cuh::
//   offspring_gene, unchanged: values and steps are the one-warp kernel's).
// * Synthesis: each thread forms its candidate's bank (make_bank) and finds
//   the carries at its warp's first block (synth_common.cuh::bank_scan: the
//   modulators' scalar walks, one level pass of every pair over the warp's
//   blocks into shared memory, one __syncthreads, a fold of the totals in
//   block order), then runs synth_bank_span over its blocks, emitting the
//   int8 frame q (FoldEmit's rounding) into shared memory, 16 samples a
//   16-byte store, each row's units XOR-swizzled by tc_swizzle (the 8 rows
//   of a quarter-warp's stores hit 8 unit columns). The level pass adds one
//   sine a pair-sample to the pair's two.
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
//   in ascending k, one __fadd_rn at a time: the order in which the one-warp
//   layout's dft_pass adds them, so the fitness is bit-equal to it.
//
// Shared memory (tp_smem; kernels/synth_fitness.py::shared_bytes_tp is the
// same formula): region A, a+/- of the 32 candidates (32 x n bytes), which
// holds the level totals (pairs x nb x 32 floats = pairs x n bytes) before
// the fold; region B, the larger of the frame q (32 x n bytes), the terms
// (32 x K floats) and the staged genes (32 x d floats), each dead before
// the next is written. At n 1024, K 512: 32 KB + 64 KB = 96 KB, two blocks
// an SM; at n 2048, K 1024: 192 KB, one. The wrapper keeps the one-warp
// layout where a block would need more than MAX_BLOCK_SMEM.
//
// One frame only (sp.frames = 1); the run axis (grid y, run_seeds) as in
// tc_eval.cuh::generation_block. B5 (evolve.cu) keeps the one-warp kernel:
// the layouts are bit-equal, so B5 stays bit-equal to B2 launches in either.

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

template <int NC, int KN>
__global__ void __launch_bounds__(TP_MAX_WARPS * 32, TP_MIN_BLOCKS)
fused_generation_int8_tp_kernel(uint32_t seed, const uint32_t* __restrict__ run_seeds,
                                const float* __restrict__ pv, const float* __restrict__ ps,
                                int pop, SynthParams sp, MutateParams mp,
                                const int8_t* __restrict__ dft, const float* __restrict__ target,
                                float* __restrict__ fitness, float* __restrict__ values,
                                float* __restrict__ steps) {
  static_assert(is_bank(KN) && KN != WIDE_BANK, "the fixed banks only");
  constexpr int S = PairBank<KN>::S, D = synth_dims(KN);
  static_assert(S <= TC_CPB, "the level totals fit region A");
  extern __shared__ __align__(16) uint4 smem_tp[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  const int n = sp.n, half = n >> 1, units = half >> 4, qunits = n >> 4, nb = n / TIME_BLOCK;
  const int d = sp.d, base = blockIdx.x * TC_CPB, run = blockIdx.y;
  uint4* s_ap = smem_tp;               // region A: a+ and a- (32 x n bytes) ...
  uint4* s_am = smem_tp + TC_CPB * units;
  float* tot = reinterpret_cast<float*>(smem_tp);  // ... the level totals before the fold
  uint4* s_q = smem_tp + 2 * TC_CPB * units;       // region B: the staged genes, q, the terms
  float* s_p = reinterpret_cast<float*>(s_q);
  float* terms = reinterpret_cast<float*>(s_q);

  // the offspring prologue (generation_block's, over every thread of the block)
  if (run_seeds) seed = __ldg(run_seeds + run);
  const size_t po = (size_t)run * mp.mu * d, oo = (size_t)run * pop * d;  // the run's rows
  for (int i = tid; i < TC_CPB * d; i += blockDim.x) {  // pair i: (i / d, i % d)
    const int cl = i / d, cand = base + cl;
    s_p[i] = cand < pop ? offspring_gene(seed, cand, i - cl * d, pv + po, ps + po, mp, d,
                                         values + oo, steps + oo)
                        : 0.f;
  }
  __syncthreads();

  // the synthesis of candidate `lane` over the warp's time blocks
  float p[D];
#pragma unroll
  for (int i = 0; i < D; ++i) p[i] = i < d ? s_p[lane * d + i] : 0.f;
  const PairBank<KN> bk = make_bank<KN, true>(p, sp);
  const int b0 = warp * nb / nw, b1 = (warp + 1) * nb / nw, b_top = (nw - 1) * nb / nw;
  float o1[S], o2[S];
  // the barrier in bank_scan also ends every read of the staged genes
  bank_scan<NC, KN>(bk, sp, b0, b1, b_top, o1, o2, tot + lane, nb, TC_CPB, BlockSync{});
  FrameEmit emit;
  emit.row = SwizzledRow<true>{s_q + lane * qunits, tc_swizzle(lane)};
  synth_bank_span<NC, FOLD_G, KN, true>(bk, sp, b0, b1, o1, o2, emit);
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
  const int g = lane >> 2;
  const float mag_scale = fmul(fabsf(bk.amp), sp.dft_scale);
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

  // the warp's n-tiles [t0, t1), TP_NT a pass, each bin's term to shared memory
  const int tiles = sp.k >> 3, t1 = (warp + 1) * tiles / nw;
  const float* tgt = target + (size_t)run * sp.k;
  float unused[2];
  int t0 = warp * tiles / nw;
  for (; t0 + TP_NT <= t1; t0 += TP_NT)
    dft_pass<TP_NT, true, true>(8 * t0, s_ap, s_am, units, dft, tgt, sp.k, half, ue, ms, unused,
                                terms);
  for (; t0 < t1; ++t0)
    dft_pass<1, true, true>(8 * t0, s_ap, s_am, units, dft, tgt, sp.k, half, ue, ms, unused,
                            terms);
  __syncthreads();

  // the fitness: candidate `lane`'s terms in ascending k (the one-warp dft_pass's order)
  if (warp == 0) {
    float fit = 0.f;
    for (int k = 0; k < sp.k; ++k) fit = fadd(fit, terms[k * TC_CPB + (lane ^ term_swizzle(k))]);
    const int cand = base + lane;
    if (cand < pop) fitness[(size_t)run * pop + cand] = fadd(0.f, fit);  // evaluate_tc's frame sum
  }
}

// ---- launcher -------------------------------------------------------------------

// Dynamic shared memory of a block (this file's note).
static size_t tp_smem(const SynthParams& sp) {
  const size_t a = (size_t)TC_CPB * sp.n;
  size_t b = (size_t)TC_CPB * sp.n;
  b = b > (size_t)TC_CPB * sp.k * 4 ? b : (size_t)TC_CPB * sp.k * 4;
  b = b > (size_t)TC_CPB * sp.d * 4 ? b : (size_t)TC_CPB * sp.d * 4;
  return a + b;
}

static int tp_warps(const SynthParams& sp) {
  const int nb = sp.n / TIME_BLOCK;
  return nb < TP_MAX_WARPS ? nb : TP_MAX_WARPS;
}

extern "C" {

// B2 int8 in the time-parallel layout: pmfm_fused_generation's arguments
// and outputs (fused_eval.cu), for a fixed bank of 2 .. 5 pairs at one
// frame; any other shape returns cudaErrorInvalidValue. Returns
// cudaGetLastError().
int pmfm_fused_generation_tp(uint32_t seed, const uint32_t* run_seeds, const float* pv,
                             const float* ps, int pop, int runs, SynthParams sp, MutateParams mp,
                             const void* dft, const float* target, float* fitness, float* values,
                             float* steps, cudaStream_t stream) {
  if (sp.frames != 1 || sp.long_code || sp.npair < 2 || sp.npair > FIXED_PAIRS ||
      sp.n % (2 * TIME_BLOCK) || pop < 1 || runs < 1 || runs > 65535 ||
      (runs > 1 && !run_seeds))
    return (int)cudaErrorInvalidValue;
  const size_t smem = tp_smem(sp);
  if (smem > MAX_BLOCK_SMEM) return (int)cudaErrorInvalidValue;
  GenInt8Kernel kernel = nullptr;
  int e = dispatch_ncoef(sp.ncoef, [&](auto nc) {
    return dispatch_synth<true, CODES_FIXED>(sp, [&](auto kc) {
      constexpr int KN = decltype(kc)::value;
      if constexpr (is_bank(KN) && KN != WIDE_BANK)
        kernel = fused_generation_int8_tp_kernel<decltype(nc)::value, KN>;
      return 0;
    });
  });
  if (!e && !kernel) e = (int)cudaErrorInvalidValue;
  if (!e) e = (int)prepare(kernel, smem);
  if (!e)
    e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                  (int)cudaSharedmemCarveoutMaxShared);
  if (e) return e;
  kernel<<<dim3((pop + TC_CPB - 1) / TC_CPB, runs), 32 * tp_warps(sp), smem, stream>>>(
      seed, run_seeds, pv, ps, pop, sp, mp, (const int8_t*)dft, target, fitness, values, steps);
  return (int)cudaGetLastError();
}

}  // extern "C"
