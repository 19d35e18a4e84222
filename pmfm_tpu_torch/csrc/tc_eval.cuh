// The one-warp tensor-core evaluation of B1/B2 in the int8 mode
// (fused_eval.cu) and the bf16 mode (fused_bf16.cu): synthesis and fold of
// a warp's 32 candidates into shared memory, then the folded DFT on the
// tensor cores with the fitness epilogue. fused_eval.cu's note gives the
// design and what bounds it; the two modes differ only where this file
// says so (the element of a+/- and of the operand, the mma instruction, the
// accumulator, the edge term and the magnitude scale), so one template
// serves both and a change to one mode is a change to the other.
//
// The bf16 mode (the reference's default fused engine; _evaluate_block's
// docstring, pmfm_tpu/kernels/synth_fitness.py:390-397): the audio is
// sin * amp (a pair bank's sum over its pairs divided by k) rounded once to
// bf16 (FoldEmit's bf16 branch), each fold sum q[n] +- q[N-n] is formed in
// float32 from two bf16 values and rounded once more to bf16 as it is
// stored (fold_cast), row 0 holds q[0] alone, and the edge sample is the
// bf16 x[N/2]. U and V run on the bf16 tensor cores (mma.sync m16n8k16 bf16
// x bf16 -> f32: the products of bf16 values are exact, the accumulation
// is the tensor cores' own, not IEEE-ordered), and the epilogue adds
// 2 norm (-1)^k x[N/2] (sp.edge_norm) with no magnitude rescale: the
// operand carries window and norm. A row of a+/- is n bytes, twice the
// int8 mode's, so a block takes 32 x n x 2 bytes of shared memory (64 KB at
// n 1024: three blocks an SM; 229,376 bytes at n 3584, the frame limit:
// one block an SM, within the 232,448 a block can use).
#pragma once

#include <type_traits>

#include "generation.cuh"

#define TC_CPB 32  // candidates per CUDA block, one warp
#define TC_NT 4    // n-tiles of 8 bins per pass over a+/-
#define TC_DEPTH 2  // 4-unit steps of the operand in flight (divides the row's units / 4)
#define MAX_BLOCK_SMEM 232448  // shared memory one block of an H100 can use

// The element of a+/- and of the operand: int8 or bf16.
template <bool INT8>
using tc_elem = typename std::conditional<INT8, int8_t, __nv_bfloat16>::type;

// 16-byte unit u of row r of a+/- sits at unit u ^ tc_swizzle(r): the 8 rows
// that a phase of the synthesis stores hit 8 different unit columns, and the
// 2 rows that a phase of the fragment loads reads hit disjoint halves.
__device__ __forceinline__ int tc_swizzle(int r) { return ((r & 1) << 2) | ((r >> 1) & 3); }

// One candidate's row of a+ or a- in shared memory, for FoldEmit: a group of
// 16 samples is one 16-byte unit of int8, or two of bf16 (units 2u and
// 2u + 1 before the swizzle, which keeps them in the row's aligned 8 units).
template <bool INT8>
struct SwizzledRow {
  uint4* row;
  int swz;
  __device__ __forceinline__ void store(int s, const float* v) const {
    if constexpr (INT8) {
      row[(s >> 4) ^ swz] = make_uint4(pack_s8x4(v), pack_s8x4(v + 4), pack_s8x4(v + 8),
                                       pack_s8x4(v + 12));
    } else {
      uint32_t w[FOLD_G / 2];
#pragma unroll
      for (int i = 0; i < FOLD_G / 2; ++i)
        w[i] = (uint32_t)__bfloat16_as_ushort(to_bf16(v[2 * i])) |
               ((uint32_t)__bfloat16_as_ushort(to_bf16(v[2 * i + 1])) << 16);
      row[(s >> 3) ^ swz] = make_uint4(w[0], w[1], w[2], w[3]);
      row[((s >> 3) + 1) ^ swz] = make_uint4(w[4], w[5], w[6], w[7]);
    }
  }
  __device__ __forceinline__ void load(int s, float* v) const {
    if constexpr (INT8) {
      const uint4 w = row[(s >> 4) ^ swz];
      unpack_s8x4(w.x, v);
      unpack_s8x4(w.y, v + 4);
      unpack_s8x4(w.z, v + 8);
      unpack_s8x4(w.w, v + 12);
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 q = row[((s >> 3) + h) ^ swz];
        const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[8 * h + 2 * j] = __bfloat162float(__ushort_as_bfloat16((unsigned short)(w[j] & 0xFFFFu)));
          v[8 * h + 2 * j + 1] = __bfloat162float(__ushort_as_bfloat16((unsigned short)(w[j] >> 16)));
        }
      }
    }
  }
};
static_assert(FOLD_G == 16, "SwizzledRow stores one int8 unit (two bf16 units) per group");

// d += A (16 x 32, rows g and g+8 in a0..a3) x B (32 x 8, column g in b0, b1)
__device__ __forceinline__ void mma_s8(int* d, uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += A (16 x 16 bf16, rows g and g+8 in a0..a3) x B (16 x 8 bf16, column g in b0, b1)
__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One 4-unit step of an m16n8 tile: the thread's 16 bytes of rows g (lo)
// and g + 8 (hi) and of column g (b), consumed by two mma. Thread (g, c)
// holds elements 16c/sizeof .. of the step; A and B take them in the same
// permutation of the contraction index, so the sums are the same (int8:
// 64 samples a step, two k32; bf16: 32 samples, two k16).
__device__ __forceinline__ void mma_step(int* d, const uint4& lo, const uint4& hi, const uint4& b) {
  mma_s8(d, lo.x, hi.x, lo.y, hi.y, b.x, b.y);
  mma_s8(d, lo.z, hi.z, lo.w, hi.w, b.z, b.w);
}
__device__ __forceinline__ void mma_step(float* d, const uint4& lo, const uint4& hi,
                                         const uint4& b) {
  mma_bf16(d, lo.x, hi.x, lo.y, hi.y, b.x, b.y);
  mma_bf16(d, lo.z, hi.z, lo.w, hi.w, b.z, b.w);
}

// Bin k's terms in TERMS mode sit at terms[k * 32 + (row ^ term_swizzle(k))]:
// the 32 rows of a bin are one shared-memory row, and the swizzle sends the
// stores of a tile's 32 threads (rows g + 8 h + 16 mt, bins 2c, 2c + 1) to
// 32 banks.
__device__ __forceinline__ int term_swizzle(int k) { return ((k >> 1) & 3) << 3; }

// Bins [k0, k0 + 8 NT) of the warp's 32 candidates: U and V on the tensor
// cores, then each bin's term (the per-bin squared error), added in
// ascending order to fit[mt], the fitness of row mt * 16 + g + 8 (c & 1)
// (kept by threads c = 0, 1): the one-warp layout. With TERMS (the
// time-parallel layout, fused_tp.cuh: a warp of a larger block, lane =
// threadIdx.x % 32, running a sub-range of the n-tiles) each term is stored
// to terms (term_swizzle) instead and fit is untouched. ue holds the edge
// term's x[N/2] times the edge coefficient (+ for even bins, - for odd) and
// ms the magnitude scale of rows mt * 16 + 8 h + g. `units` is the 16-byte
// units of a row of a+/- (N/2 elements). In TERMS mode bin k's terms go to
// row k & kmask of terms: all bins by default, a ring of two rounds of bins
// in the bf16 time-parallel layout (fused_tp_bf16.cuh).
template <int NT, bool INT8, bool TERMS = false>
__device__ __forceinline__ void dft_pass(int k0, const uint4* s_ap, const uint4* s_am, int units,
                                         const tc_elem<INT8>* __restrict__ dft,
                                         const float* __restrict__ target, int k, int half,
                                         const float (&ue)[2][2][2], const float (&ms)[2][2],
                                         float (&fit)[2], float* terms = nullptr, int kmask = -1) {
  using acc_t = typename std::conditional<INT8, int, float>::type;
  const int lane = TERMS ? threadIdx.x & 31 : threadIdx.x, g = lane >> 2, c = lane & 3,
            sw = tc_swizzle(g);
  acc_t acc[2][NT][2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][t][0][i] = acc[mt][t][1][i] = 0;
  const uint4* pu[NT];
  const uint4* pv[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    pu[t] = reinterpret_cast<const uint4*>(dft + (size_t)(k0 + 8 * t + g) * half) + c;
    pv[t] = reinterpret_cast<const uint4*>(dft + (size_t)(k + k0 + 8 * t + g) * half) + c;
  }
  // the operand of the next TC_DEPTH steps in flight: slot d holds step
  // s + d of the group of TC_DEPTH steps from s (the row's steps are even)
  uint4 bu[TC_DEPTH][NT], bv[TC_DEPTH][NT];
#pragma unroll
  for (int d = 0; d < TC_DEPTH; ++d)
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      bu[d][t] = __ldg(pu[t] + 4 * d);
      bv[d][t] = __ldg(pv[t] + 4 * d);
    }
  for (int s0 = 0; s0 < units; s0 += 4 * TC_DEPTH) {
#pragma unroll
    for (int d = 0; d < TC_DEPTH; ++d) {
      const int u0 = s0 + 4 * d;
      const int ua = (u0 + c) ^ sw;
      uint4 ap[2][2], am[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mt * 16 + h * 8 + g;
          ap[mt][h] = s_ap[r * units + ua];
          am[mt][h] = s_am[r * units + ua];
        }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          mma_step(acc[mt][t][0], ap[mt][0], ap[mt][1], bu[d][t]);
          mma_step(acc[mt][t][1], am[mt][0], am[mt][1], bv[d][t]);
        }
      // refill the slot with the step TC_DEPTH ahead (past the end: its own)
      const int un = u0 + 4 * TC_DEPTH < units ? u0 + 4 * TC_DEPTH : u0;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        bu[d][t] = __ldg(pu[t] + un);
        bv[d][t] = __ldg(pv[t] + un);
      }
    }
  }
  // epilogue: the x[N/2] edge term, magnitude, magnitude scale, L2; register
  // i of a tile is row g + 8 (i >> 1), bin 2c + (i & 1)
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int kb = k0 + 8 * t + 2 * c;
    const float tg[2] = {__ldg(target + kb), __ldg(target + kb + 1)};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float u = fadd((float)acc[mt][t][0][i], ue[mt][i >> 1][i & 1]);  // kb is even
        const float v = (float)acc[mt][t][1][i];
        const float mag = fmul(sqrtf(fadd(fmul(u, u), fmul(v, v))), ms[mt][i >> 1]);
        const float dd = fsub(mag, tg[i & 1]);
        e[i] = fmul(dd, dd);
      }
      if constexpr (TERMS) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int bin = kb + (i & 1), row = mt * 16 + 8 * (i >> 1) + g;
          terms[(bin & kmask) * TC_CPB + (row ^ term_swizzle(bin))] = e[i];
        }
        continue;
      }
      // bins 2j, 2j + 1 of the tile sit in thread (g, j): row g's owner
      // (c = 0) takes registers 0, 1, row g + 8's (c = 1) registers 2, 3
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int src = (lane & ~3) | j;
        const float x0 = __shfl_sync(0xFFFFFFFFu, e[0], src);
        const float x1 = __shfl_sync(0xFFFFFFFFu, e[1], src);
        const float x2 = __shfl_sync(0xFFFFFFFFu, e[2], src);
        const float x3 = __shfl_sync(0xFFFFFFFFu, e[3], src);
        fit[mt] = fadd(fit[mt], (c & 1) ? x2 : x0);
        fit[mt] = fadd(fit[mt], (c & 1) ? x3 : x1);
      }
    }
  }
}

// The fitness of the block's 32 candidates, thread t holding candidate t's
// scaled parameters p; writes fitness[base + t] for base + t < pop. KN is
// the synthesis code of dispatch_synth (a chain, or a bank above BANK_KN).
// sp.frames frames of one continuous synthesis (CandidateSynth's carries
// live on from frame to frame): frame f is synthesised and folded into the
// warp's a+/- (one frame: shared memory does not grow with the frames),
// transformed against target row f (target + f k), and its total added in
// float32 to the candidate's fitness in frame order before the next frame
// overwrites a+/-. The frame count is a runtime loop bound outside the
// per-sample loop.
template <int NC, int KN, bool INT8>
__device__ __forceinline__ void evaluate_tc(const float* p, const SynthParams& sp,
                                            const tc_elem<INT8>* __restrict__ dft,
                                            const float* __restrict__ target, uint4* smem,
                                            float* __restrict__ fitness, int base, int pop,
                                            int row = 0) {
  const int lane = threadIdx.x, g = lane >> 2, c = lane & 3;
  const int half = sp.n >> 1, units = half * (int)sizeof(tc_elem<INT8>) >> 4;
  uint4* s_ap = smem;
  uint4* s_am = smem + TC_CPB * units;

  // synthesis + fold into the thread's rows of a+/a-
  FoldEmit<INT8, SwizzledRow<INT8>> emit;
  emit.ap = SwizzledRow<INT8>{s_ap + lane * units, tc_swizzle(lane)};
  emit.am = SwizzledRow<INT8>{s_am + lane * units, tc_swizzle(lane)};
  emit.n = sp.n;
  emit.half = half;
  emit.edge_q = 0.f;
  CandidateSynth<NC, KN, INT8> cs;
  const float amp = cs.init(p, sp, row);
  emit.amp = amp;
  // int8: 127 (-1)^k and |amp| dft_scale; bf16: 2 norm (-1)^k and no rescale
  const float edge = INT8 ? 127.f : sp.edge_norm;
  float fit[2] = {0.f, 0.f};
  for (int f = 0; f < sp.frames; ++f) {
    if (f) __syncwarp();  // the warp is done reading the last frame's a+/-
    cs.frame(sp, emit);
    emit.fold_rows(0, false, 0.f);  // rows [0, 16): row 0 keeps q[0] alone
    const float mag_scale = INT8 ? fmul(fabsf(amp), sp.dft_scale) : 1.f;
    __syncwarp();

    // the edge term edge (-1)^k x[N/2] of each row, for even and odd k
    float ue[2][2][2], ms[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float eq = __shfl_sync(0xFFFFFFFFu, emit.edge_q, mt * 16 + h * 8 + g);
        ue[mt][h][0] = fmul(edge, eq);
        ue[mt][h][1] = fmul(-edge, eq);
        ms[mt][h] = __shfl_sync(0xFFFFFFFFu, mag_scale, mt * 16 + h * 8 + g);
      }
    // run blockIdx.y's target row f, formed here so that no moved base
    // pointer stays live across the passes (the kernels sit at up to 255
    // registers)
    const float* tgt = target + ((size_t)blockIdx.y * sp.frames + f) * sp.k;
    float ff[2] = {0.f, 0.f};
    const int tiles = sp.k >> 3;
    int t0 = 0;
    for (; t0 + TC_NT <= tiles; t0 += TC_NT)
      dft_pass<TC_NT, INT8>(8 * t0, s_ap, s_am, units, dft, tgt, sp.k, half, ue, ms, ff);
    for (; t0 < tiles; ++t0)
      dft_pass<1, INT8>(8 * t0, s_ap, s_am, units, dft, tgt, sp.k, half, ue, ms, ff);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) fit[mt] = fadd(fit[mt], ff[mt]);
  }
  if (c < 2) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int cand = base + mt * 16 + 8 * c + g;
      if (cand < pop) fitness[(size_t)blockIdx.y * pop + cand] = fit[mt];
    }
  }
}

// Thread t's scaled parameters from the block's (TC_CPB, d) rows in shared
// memory, into the D registers of the synthesis code (synth_dims).
template <int D>
__device__ __forceinline__ void take_params(const float* s_p, int d, float* p) {
#pragma unroll
  for (int i = 0; i < D; ++i) p[i] = i < d ? s_p[threadIdx.x * d + i] : 0.f;
}

// The evaluation of thread t's candidate from the block's (TC_CPB, d) rows
// of scaled parameters in shared memory: in the registers of a fixed or
// wide code; for the long code (which reads them throughout the synthesis,
// while the synthesis overwrites this shared memory with a+/-) copied to
// the thread's row of the long scratch first.
template <int NC, int KN, bool INT8>
__device__ __forceinline__ void evaluate_staged(const float* s_p, const SynthParams& sp,
                                                const tc_elem<INT8>* __restrict__ dft,
                                                const float* __restrict__ target, uint4* smem,
                                                float* __restrict__ fitness, int base, int pop) {
  const int d = sp.d;
  if constexpr (KN == LONG_CODE) {
    const int row = long_row(blockIdx.y, pop, base + threadIdx.x);
    float* lp = sp.lscr + (size_t)row * d;
    for (int i = 0; i < d; ++i) lp[i] = s_p[threadIdx.x * d + i];
    __syncwarp();
    evaluate_tc<NC, KN, INT8>(lp, sp, dft, target, smem, fitness, base, pop, row);
  } else {
    float p[synth_dims(KN)];
    take_params<synth_dims(KN)>(s_p, d, p);
    __syncwarp();
    evaluate_tc<NC, KN, INT8>(p, sp, dft, target, smem, fitness, base, pop);
  }
}

// The run axis: blockIdx.y is run r of a batched launch, whose candidates
// are rows [r pop, (r + 1) pop) of the (runs, pop, d) arrays, whose target
// is rows [r F, (r + 1) F) of the (runs, F, k) targets and whose fitness is
// row r of (runs, pop). A run's blocks compute what a launch of that run
// alone computes (in B2 with the run's own Philox seed, run_seeds[r], and
// its own parents), so a batched launch is bit-equal, run for run, to lone
// launches.

// B1's block: the candidates' scaled parameters, then the evaluation.
template <int NC, int KN, bool INT8>
__device__ __forceinline__ void fitness_block(const float* __restrict__ params, int pop,
                                              const SynthParams& sp,
                                              const tc_elem<INT8>* __restrict__ dft,
                                              const float* __restrict__ target,
                                              float* __restrict__ fitness, uint4* smem) {
  float* s_p = reinterpret_cast<float*>(smem);  // before the synthesis writes a+/-
  const int base = blockIdx.x * TC_CPB, d = sp.d;
  const float* run_params = params + (size_t)blockIdx.y * pop * d;
  const int avail = min(pop - base, TC_CPB) * d;
  for (int i = threadIdx.x; i < TC_CPB * d; i += TC_CPB)
    s_p[i] = i < avail ? run_params[(size_t)base * d + i] : 0.f;
  __syncwarp();
  evaluate_staged<NC, KN, INT8>(s_p, sp, dft, target, smem, fitness, base, pop);
}

// B2's block: the offspring prologue (the block's 32 x d genes over its 32
// threads, evaluate.cuh::offspring_gene), then the evaluation.
template <int NC, int KN, bool INT8>
__device__ __forceinline__ void generation_block(
    uint32_t seed, const uint32_t* __restrict__ run_seeds, const float* __restrict__ pv,
    const float* __restrict__ ps, int pop, const SynthParams& sp, const MutateParams& mp,
    const tc_elem<INT8>* __restrict__ dft, const float* __restrict__ target,
    float* __restrict__ fitness, float* __restrict__ values, float* __restrict__ steps,
    uint4* smem) {
  float* s_p = reinterpret_cast<float*>(smem);  // before the synthesis writes a+/-
  const int base = blockIdx.x * TC_CPB, d = sp.d, run = blockIdx.y;
  if (run_seeds) seed = __ldg(run_seeds + run);
  const size_t po = (size_t)run * mp.mu * d, oo = (size_t)run * pop * d;  // the run's rows
  for (int i = threadIdx.x; i < TC_CPB * d; i += TC_CPB) {  // pair i: (i / d, i % d)
    const int cl = i / d, cand = base + cl;
    s_p[i] = cand < pop ? offspring_gene(seed, cand, i - cl * d, pv + po, ps + po, mp, d,
                                         values + oo, steps + oo)
                        : 0.f;
  }
  __syncwarp();
  evaluate_staged<NC, KN, INT8>(s_p, sp, dft, target, smem, fitness, base, pop);
}

// ---- the kernels (fused_eval.cu: int8, fused_bf16.cu: bf16) --------------------

template <int NC, int KN>
__global__ void __launch_bounds__(TC_CPB)
fused_synth_fitness_int8_kernel(const float* __restrict__ params, int pop, SynthParams sp,
                                const int8_t* __restrict__ dft, const float* __restrict__ target,
                                float* __restrict__ fitness) {
  extern __shared__ __align__(16) uint4 smem_tc[];
  fitness_block<NC, KN, true>(params, pop, sp, dft, target, fitness, smem_tc);
}

template <int NC, int KN>
__global__ void __launch_bounds__(TC_CPB)
fused_generation_int8_kernel(uint32_t seed, const uint32_t* __restrict__ run_seeds,
                             const float* __restrict__ pv, const float* __restrict__ ps, int pop,
                             SynthParams sp, MutateParams mp, const int8_t* __restrict__ dft,
                             const float* __restrict__ target, float* __restrict__ fitness,
                             float* __restrict__ values, float* __restrict__ steps) {
  extern __shared__ __align__(16) uint4 smem_tc[];
  generation_block<NC, KN, true>(seed, run_seeds, pv, ps, pop, sp, mp, dft, target, fitness,
                                 values, steps, smem_tc);
}

template <int NC, int KN>
__global__ void __launch_bounds__(TC_CPB)
fused_synth_fitness_bf16_kernel(const float* __restrict__ params, int pop, SynthParams sp,
                                const __nv_bfloat16* __restrict__ dft,
                                const float* __restrict__ target, float* __restrict__ fitness) {
  extern __shared__ __align__(16) uint4 smem_tc[];
  fitness_block<NC, KN, false>(params, pop, sp, dft, target, fitness, smem_tc);
}

template <int NC, int KN>
__global__ void __launch_bounds__(TC_CPB)
fused_generation_bf16_kernel(uint32_t seed, const uint32_t* __restrict__ run_seeds,
                             const float* __restrict__ pv, const float* __restrict__ ps, int pop,
                             SynthParams sp, MutateParams mp, const __nv_bfloat16* __restrict__ dft,
                             const float* __restrict__ target, float* __restrict__ fitness,
                             float* __restrict__ values, float* __restrict__ steps) {
  extern __shared__ __align__(16) uint4 smem_tc[];
  generation_block<NC, KN, false>(seed, run_seeds, pv, ps, pop, sp, mp, dft, target, fitness,
                                  values, steps, smem_tc);
}

typedef void (*FitInt8Kernel)(const float*, int, SynthParams, const int8_t*, const float*, float*);
typedef void (*FitBf16Kernel)(const float*, int, SynthParams, const __nv_bfloat16*, const float*,
                              float*);

// ---- launchers ------------------------------------------------------------------

#define PICK(kernel) \
  [](auto nc, auto kc) { return kernel<decltype(nc)::value, decltype(kc)::value>; }

// Dynamic shared memory of a block: the a+/- rows of its 32 candidates, or
// the block's 32 rows of d scaled parameters staged there before the
// synthesis overwrites them, whichever is larger (the parameters, above
// d = n sizeof(element) / 4: 64 genes at int8 n 256).
// kernels/synth_fitness.py::shared_bytes is the same formula.
template <bool INT8>
__host__ inline size_t tc_smem(const SynthParams& sp) {
  const size_t rows = (size_t)sp.n * TC_CPB * sizeof(tc_elem<INT8>);
  const size_t params = (size_t)TC_CPB * sp.d * sizeof(float);
  return rows > params ? rows : params;
}

// The kernel `pick` gives for the sine order and the synthesis
// (dispatch_synth: the chain length or the bank's pairs, the fixed banks
// included, of the codes SET: CODES_FIXED in fused_eval.cu and
// fused_bf16.cu, CODES_WIDE in fused_wide.cu), with its shared
// memory set, asking for the largest carveout so that as many one-warp
// blocks as shared memory holds fit an SM (six at n 1024 in int8).
template <bool INT8, int SET, typename Pick, typename K>
static int prepare_tc(Pick&& pick, const SynthParams& sp, K* out) {
  if (sp.frames < 1 || tc_smem<INT8>(sp) > MAX_BLOCK_SMEM) return (int)cudaErrorInvalidValue;
  K kernel = nullptr;
  int e = dispatch_ncoef(sp.ncoef, [&](auto nc) {
    return dispatch_synth<true, SET>(sp, [&](auto kc) {
      kernel = pick(nc, kc);
      return 0;
    });
  });
  if (e) return e;
  e = (int)prepare(kernel, tc_smem<INT8>(sp));
  if (!e)
    e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                  (int)cudaSharedmemCarveoutMaxShared);
  *out = kernel;
  return e;
}

// A prepared kernel on blocks of one warp, `runs` rows of blocks.
template <bool INT8, typename K, typename... Args>
static int launch_tc(K kernel, const SynthParams& sp, int pop, int runs, cudaStream_t stream,
                     Args... args) {
  if (pop < 1 || runs < 1 || runs > 65535) return (int)cudaErrorInvalidValue;
  kernel<<<dim3((pop + TC_CPB - 1) / TC_CPB, runs), TC_CPB, tc_smem<INT8>(sp), stream>>>(args...);
  return (int)cudaGetLastError();
}

// The wide codes (WIDE_CHAIN, WIDE_BANK) and the long code (LONG_CODE) of
// the four kernels, prepared in fused_wide.cu and fused_long.cu, which nvcc
// builds beside fused_eval.cu and fused_bf16.cu; the prepare calls of those
// files hand a wide or long shape (synth_set) to these.
int prepare_wide_fitness_int8(const SynthParams& sp, FitInt8Kernel* kernel);
int prepare_wide_generation_int8(const SynthParams& sp, GenInt8Kernel* kernel);
int prepare_wide_fitness_bf16(const SynthParams& sp, FitBf16Kernel* kernel);
int prepare_wide_generation_bf16(const SynthParams& sp, GenBf16Kernel* kernel);
int prepare_long_fitness_int8(const SynthParams& sp, FitInt8Kernel* kernel);
int prepare_long_generation_int8(const SynthParams& sp, GenInt8Kernel* kernel);
int prepare_long_fitness_bf16(const SynthParams& sp, FitBf16Kernel* kernel);
int prepare_long_generation_bf16(const SynthParams& sp, GenBf16Kernel* kernel);

// Any set's kernel for sp: `fixed` prepares the fixed codes here, `wide`
// and `long_` are two of the eight above.
template <bool INT8, typename Pick, typename K>
static int prepare_tc_any(Pick&& fixed, int (*wide)(const SynthParams&, K*),
                          int (*long_)(const SynthParams&, K*), const SynthParams& sp, K* out) {
  switch (synth_set(sp, true)) {
    case CODES_LONG: return long_(sp, out);
    case CODES_WIDE: return wide(sp, out);
    default: return prepare_tc<INT8, CODES_FIXED>(fixed, sp, out);
  }
}
