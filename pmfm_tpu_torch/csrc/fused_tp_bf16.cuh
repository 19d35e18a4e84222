// B1 and B2 bf16 in a time-parallel layout for Hopper (sm_90a): 32
// candidates a block on W = min(n / 128, 8) warps, a time-parallel
// synthesis, the fold done in place and the folded DFT's bins split over the
// warps in rounds, on the fixed chains (fm2, fm3_series .. fm8_series) and
// the fixed banks of 2 .. 5 pairs, at any frame count and on the run axis.
// tc_eval.cuh's one-warp kernels (fused_bf16.cu) compute the same functions;
// the wrappers (kernels/generation.py::time_parallel, which B1's
// synth_fitness.py::b1_entry calls) pick between them by shape, and the
// layouts give the same fitness (B2: values and steps) bit for bit. B1 and B2
// differ only in the prologue that stages the block's genes (GEN), which
// they share with fused_tp.cuh's int8 block (tp_stage_genes), as they share
// its kernel preparation and launchers (TpFamily, prepare_tp,
// launch_tp_fitness, prepare_tp_generation, enqueue_tp_generation). fused_tp_bf16.cu instantiates
// the banks and holds the entries; fused_tp_bf16_chain.cu instantiates the
// chains, so that nvcc builds the two halves side by side.
//
// Replaces, with fused_bf16.cu's kernels, the bf16 mode (the reference's
// default fused engine) of the TPU kernels
//   B1 <- pmfm_tpu/kernels/synth_fitness.py::fused_synth_fitness
//   B2 <- pmfm_tpu/kernels/generation.py::fused_generation
//
// Why a second layout. A one-warp bf16 block keeps its 32 candidates' a+/-
// in 64 n bytes of shared memory: three warps an SM at n 1024, one at
// n 2048, and at the reference suite's small grids (P 2^11: 64 blocks) most
// SMs hold none. B2 int8's time-parallel block (fused_tp.cuh) shares one
// block's a+/- among eight warps; in bf16 its three tenants (a+/-, the
// frame q, the terms) would each take 64 n bytes, past what a block may have
// at n 2048. This layout keeps only a+/- at full size:
// * The synthesis (fused_tp.cuh's TpSynth in its float mode, the unit sine
//   times the amplitude, a bank's sum divided by k) rounds each sample to
//   bf16 (FoldEmit's bf16 branch) and stores sample s of the first half at
//   index s of the candidate's a+ row and sample s of the second half at
//   index N - s of its a- row (MirrorEmit); the edge sample x[N/2] goes to
//   a slot of its own. n % 256 == 0, so N/2 is a time-block boundary and
//   each warp's blocks lie wholly in one half.
// * The fold in place: after a barrier each (row, group of 16 samples) is
//   read and rewritten by one thread, a+[i] = bf16(q[i] + q[N-i]) and a-[i] =
//   bf16(q[i] - q[N-i]) (fold_cast's two roundings, FoldEmit::fold_rows'
//   fadd / fsub), index 0 keeping q[0] alone in both rows.
// * The terms in rounds: round r covers the n-tiles [r W TP_NT, (r + 1) W
//   TP_NT), TP_NT a warp, through tc_eval.cuh::dft_pass in its TERMS mode,
//   into a ring of two rounds' bins (bin k at row k & (rows - 1),
//   tp_bf16_ring); after the round's barrier warp 0 adds its terms to each
//   candidate's running sum in ascending k, while the next round fills the
//   ring's other rows. Each tile's mma sequence
//   is dft_pass's, whatever NT, so each term is the one-warp kernel's; the
//   adds are in its order (one __fadd_rn at a time in ascending k, then the
//   frame's sum after the frames before it).
// The level totals of the synthesis' scan live in the terms' region, which
// is free until the DFT (in a+/- a warp that has started emitting could
// overwrite totals another warp still reads).
//
// Shared memory (tp_bf16_smem; kernels/synth_fitness.py::shared_bytes_tp_bf16
// is the same formula): a+/- (64 n bytes; at one frame they first hold the
// staged genes, 32 d floats), region T, the larger of the ring of terms
// (tp_bf16_ring: 2 W TP_NT 8 rows of 32 floats, rounded up to a power of
// two) and the level totals (levels x n / 128 x 32 floats), the edge
// samples (32 floats) and, at F > 1, region C: the staged genes and the
// carries the last warp hands to the next frame (32 x (d + d / 2) floats).
// At n 1024: 98,432 bytes, two blocks an SM; at n 2048, 163,968, one.
//
// The run axis (grid y, run_seeds) as in tc_eval.cuh::generation_block. B5
// (evolve.cu) launches this kernel every generation where B2's wrapper
// would take it, through fused_tp_bf16.cu's prepare/launch pair
// (generation.cuh); the layouts are bit-equal, so B5 stays bit-equal to B2
// launches in either.
#pragma once

#include "fused_tp.cuh"

// Eight exact floats (bf16 values) as one 16-byte unit of bf16, each
// rounded to nearest even (SwizzledRow<false>'s store, a unit at a time).
__device__ __forceinline__ uint4 pack_bf16x8(const float* v) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (uint32_t)__bfloat16_as_ushort(to_bf16(v[2 * i])) |
           ((uint32_t)__bfloat16_as_ushort(to_bf16(v[2 * i + 1])) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Rows of the ring of terms of a block of `warps` warps: two rounds of
// warps x TP_NT x 8 bins, rounded up to a power of two, so that bin k's row
// is k & (rows - 1) and two consecutive rounds never share a row (six warps,
// at n 768: 96 bins a round, 256 rows).
__host__ __device__ __forceinline__ int tp_bf16_ring(int warps) {
  int rows = 1;
  while (rows < 2 * warps * TP_NT * 8) rows <<= 1;
  return rows;
}

// The bf16 frame q of one candidate into its swizzled a+/- rows, unfolded:
// sample s < N/2 at index s of a+, sample s > N/2 at index N - s of a-,
// x[N/2] to *edge. A group of 16 second-half samples from m0 covers the
// indices N - m0 - 15 .. N - m0, across three 8-element units: the unit
// below N - m0 - 8 gets index N - m0 - 16 (the next group's first sample)
// as a placeholder that the same thread overwrites with its 2-byte store,
// except at the warp's last group (`end`), whose neighbour is another
// warp's: there the unit's seven samples go out as 2-byte stores.
struct MirrorEmit {
  uint4* ap;
  uint4* am;
  float* edge;
  int swz, n, half, end;
  float amp;
  float cur[FOLD_G];
  __device__ __forceinline__ void put(int i, float v) const {
    reinterpret_cast<__nv_bfloat16*>(am + ((i >> 3) ^ swz))[i & 7] = to_bf16(v);
  }
  __device__ __forceinline__ void operator()(int m, int u, float y) {
    cur[u] = to_f32(to_bf16(fmul(y, amp)));
    if (u != FOLD_G - 1) return;
    const int m0 = m - u;
    if (m0 < half) {
      SwizzledRow<false>{ap, swz}.store(m0, cur);
      return;
    }
    const int top = n - m0;  // sample m0 + j sits at index top - j
    if (m0 == half)
      *edge = cur[0];
    else
      put(top, cur[0]);
    float hi[8], lo[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      hi[e] = cur[8 - e];                  // index top - 8 + e
      lo[e] = e ? cur[FOLD_G - e] : 0.f;  // index top - 16 + e
    }
    am[((top - 8) >> 3) ^ swz] = pack_bf16x8(hi);
    if (m0 + FOLD_G < end || m0 + FOLD_G == n) {
      am[((top - 16) >> 3) ^ swz] = pack_bf16x8(lo);
    } else {
#pragma unroll
      for (int e = 1; e < 8; ++e) put(top - 16 + e, lo[e]);
    }
  }
};

// The block, which B1 and B2 share: the prologue (fused_tp.cuh::
// tp_stage_genes) stages the block's genes, B2's (GEN) offspring or B1's
// given rows; then the synthesis, fold, DFT and fitness of every frame.
template <int NC, int KN, bool GEN>
__device__ __forceinline__ void tp_bf16_block(
    uint32_t seed, const uint32_t* __restrict__ run_seeds, const float* __restrict__ pv,
    const float* __restrict__ ps, int pop, const SynthParams& sp, const MutateParams& mp,
    const __nv_bfloat16* __restrict__ dft, const float* __restrict__ target,
    float* __restrict__ fitness, float* __restrict__ values, float* __restrict__ steps) {
  using Synth = TpSynth<NC, KN, false>;
  constexpr int D = synth_dims(KN);
  static_assert(KN != WIDE_CHAIN && KN != WIDE_BANK && KN != LONG_CODE, "the fixed codes only");
  static_assert(2 * Synth::CARRIES == D, "region C's carries are d / 2 floats a candidate");
  extern __shared__ __align__(16) uint4 smem_tpb[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  // a row of a+ or a-: N/2 bf16, `units` 16-byte units, `groups` of FOLD_G samples
  const int n = sp.n, half = n >> 1, units = half >> 3, groups = half / FOLD_G,
            nb = n / TIME_BLOCK;
  const int d = sp.d, frames = sp.frames, base = blockIdx.x * TC_CPB, run = blockIdx.y;
  const int rb = nw * TP_NT * 8, ring = tp_bf16_ring(nw), kmask = ring - 1;  // bins a round
  const int lt = Synth::LEVELS * nb * TC_CPB;
  uint4* s_ap = smem_tpb;  // a+ and a- (at one frame, first the staged genes)
  uint4* s_am = smem_tpb + TC_CPB * units;
  float* s_t = reinterpret_cast<float*>(smem_tpb + 2 * TC_CPB * units);  // terms, or level totals
  float* s_edge = s_t + (ring * TC_CPB > lt ? ring * TC_CPB : lt);
  float* s_c = s_edge + TC_CPB;  // region C (F > 1): the staged genes, then the carries
  float* s_p = frames > 1 ? s_c : reinterpret_cast<float*>(smem_tpb);
  float* carry = s_c + TC_CPB * d + lane;
  float* tot = s_t + lane;

  tp_stage_genes<GEN>(seed, run_seeds, pv, ps, pop, mp, d, s_p, values, steps);

  const int g = lane >> 2, tiles = sp.k >> 3, per = nw * TP_NT;
  const int rounds = (tiles + per - 1) / per;
  const int b0 = warp * nb / nw, b1 = (warp + 1) * nb / nw, b_top = (nw - 1) * nb / nw;
#pragma unroll 1
  for (int f = 0; f < frames; ++f) {
    // the synthesis of candidate `lane` over the warp's time blocks of frame f,
    // into its a+/- rows unfolded
    {
      Synth syn;
      MirrorEmit emit;
      {
        float p[D];
#pragma unroll
        for (int i = 0; i < D; ++i) p[i] = i < d ? s_p[lane * d + i] : 0.f;
        emit.amp = syn.init(p, sp);
      }
      if (f)
        syn.load(carry, TC_CPB);
      else
        syn.zero();
      emit.ap = s_ap + lane * units;
      emit.am = s_am + lane * units;
      emit.edge = s_edge + lane;
      emit.swz = tc_swizzle(lane);
      emit.n = n;
      emit.half = half;
      emit.end = b1 * TIME_BLOCK;
      // the first level's barrier ends every read of the staged genes in
      // a+/- (one frame)
      syn.run(sp, b0, b1, b_top, tot, nb, emit);
      // the last warp's carries at the frame's end start the next frame
      if (warp == nw - 1 && f + 1 < frames) syn.store(carry, TC_CPB);
    }
    __syncthreads();

    // the fold in place: group u of row r pairs index 16u + j of a+ (q[i])
    // with the same of a- (q[N - i]), and index 0 with nothing
    for (int i = tid; i < TC_CPB * groups; i += blockDim.x) {
      const int r = i / groups, s0 = FOLD_G * (i - r * groups);
      const SwizzledRow<false> ap{s_ap + r * units, tc_swizzle(r)};
      const SwizzledRow<false> am{s_am + r * units, tc_swizzle(r)};
      float q[FOLD_G], qm[FOLD_G], plus[FOLD_G], minus[FOLD_G];
      ap.load(s0, q);
      am.load(s0, qm);
      if (s0 == 0) qm[0] = 0.f;
#pragma unroll
      for (int j = 0; j < FOLD_G; ++j) {
        plus[j] = fadd(q[j], qm[j]);
        minus[j] = fsub(q[j], qm[j]);
      }
      ap.store(s0, plus);
      am.store(s0, minus);
    }
    __syncthreads();

    // evaluate_tc's bf16 edge term 2 norm (-1)^k x[N/2] of the thread's
    // rows, and no magnitude rescale
    float ue[2][2][2], ms[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float eq = s_edge[mt * 16 + h * 8 + g];
        ue[mt][h][0] = fmul(sp.edge_norm, eq);
        ue[mt][h][1] = fmul(-sp.edge_norm, eq);
        ms[mt][h] = 1.f;
      }

    // the rounds: warp w's TP_NT tiles of round r against run `run`'s
    // target row f, into the ring; warp 0 adds round r - 1's terms
    // first (candidate `lane`'s, in ascending k)
    const float* tgt = target + ((size_t)run * frames + f) * sp.k;
    float ff = 0.f, unused[2];
    auto add_round = [&](int r) {
      const int k1 = min((r + 1) * rb, sp.k);
      for (int k = r * rb; k < k1; ++k)
        ff = fadd(ff, s_t[(k & kmask) * TC_CPB + (lane ^ term_swizzle(k))]);
    };
#pragma unroll 1
    for (int r = 0; r < rounds; ++r) {
      if (warp == 0 && r) add_round(r - 1);
      int t0 = r * per + warp * TP_NT;
      const int t1 = min(t0 + TP_NT, tiles);
      if (t0 + TP_NT == t1)
        dft_pass<TP_NT, false, true>(8 * t0, s_ap, s_am, units, dft, tgt, sp.k, half, ue, ms,
                                     unused, s_t, kmask);
      else
        for (; t0 < t1; ++t0)
          dft_pass<1, false, true>(8 * t0, s_ap, s_am, units, dft, tgt, sp.k, half, ue, ms,
                                   unused, s_t, kmask);
      __syncthreads();
    }
    // the frame's fitness, added to the frames before it (kept in the
    // candidate's fitness in device memory)
    if (warp == 0) {
      add_round(rounds - 1);
      const int cand = base + lane;
      if (cand < pop) {
        float* out = fitness + (size_t)run * pop + cand;
        *out = fadd(f ? *out : 0.f, ff);
      }
    }
    // warp 0 is done with the last round's terms before the next frame's
    // level totals overwrite them
    if (f + 1 < frames) __syncthreads();
  }
}

// B2: tp_bf16_block after the offspring prologue.
template <int NC, int KN>
__global__ void __launch_bounds__(TP_MAX_WARPS * 32, TP_MIN_BLOCKS)
fused_generation_bf16_tp_kernel(uint32_t seed, const uint32_t* __restrict__ run_seeds,
                                const float* __restrict__ pv, const float* __restrict__ ps,
                                int pop, SynthParams sp, MutateParams mp,
                                const __nv_bfloat16* __restrict__ dft,
                                const float* __restrict__ target, float* __restrict__ fitness,
                                float* __restrict__ values, float* __restrict__ steps) {
  tp_bf16_block<NC, KN, true>(seed, run_seeds, pv, ps, pop, sp, mp, dft, target, fitness,
                                 values, steps);
}

// B1: tp_bf16_block on the given (runs, pop, d) params. No values or steps.
template <int NC, int KN>
__global__ void __launch_bounds__(TP_MAX_WARPS * 32, TP_MIN_BLOCKS)
fused_synth_fitness_bf16_tp_kernel(const float* __restrict__ params, int pop, SynthParams sp,
                                   const __nv_bfloat16* __restrict__ dft,
                                   const float* __restrict__ target,
                                   float* __restrict__ fitness) {
  tp_bf16_block<NC, KN, false>(0u, nullptr, params, nullptr, pop, sp, MutateParams{}, dft,
                                  target, fitness, nullptr, nullptr);
}

// ---- host side ------------------------------------------------------------------

// Dynamic shared memory of a block (this file's note).
static inline size_t tp_bf16_smem(const SynthParams& sp) {
  const size_t c = TC_CPB, levels = sp.npair ? sp.npair : sp.kn - 1;
  const size_t terms = (size_t)tp_bf16_ring(tp_warps(sp)) * c;
  const size_t totals = levels * (sp.n / TIME_BLOCK) * c;
  const size_t carries = sp.frames > 1 ? c * (sp.d + sp.d / 2) : 0;
  return 2 * c * sp.n + 4 * ((terms > totals ? terms : totals) + c + carries);
}

// The bf16 families of fused_tp.cuh's prepare_tp and launchers.
template <>
struct TpFamily<GenBf16Kernel> {
  using elem = __nv_bfloat16;
  template <int NC, int KN>
  static GenBf16Kernel at() { return fused_generation_bf16_tp_kernel<NC, KN>; }
  static size_t smem(const SynthParams& sp) { return tp_bf16_smem(sp); }
};

template <>
struct TpFamily<FitBf16Kernel> {
  using elem = __nv_bfloat16;
  template <int NC, int KN>
  static FitBf16Kernel at() { return fused_synth_fitness_bf16_tp_kernel<NC, KN>; }
  static size_t smem(const SynthParams& sp) { return tp_bf16_smem(sp); }
};

// The chains' kernels (B2, B1), prepared in fused_tp_bf16_chain.cu.
int prepare_tp_chain(const SynthParams& sp, GenBf16Kernel* kernel);
int prepare_tp_chain(const SynthParams& sp, FitBf16Kernel* kernel);
