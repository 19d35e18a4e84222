// The true-f32 B1/B2's synthesis in a time-parallel layout for Hopper
// (sm_90a): fused_f32.cu's first kernel, f32_synth_kernel, computes the same
// rows of samples with one thread a candidate; this one runs 32 candidates
// a block on W = min(n / 128, 8) warps, warp w the w-th run of time blocks
// of every frame, on the fixed chains (fm2, fm3_series .. fm8_series) and
// the fixed banks of 2 .. 5 pairs, at any frame count and on the run axis.
// The wrapper (kernels/synth_fitness.py::f32_time_parallel) picks the
// layout by shape and passes it as sp.f32_tp; fused_f32.cu's plan launches
// the kernel this file prepares (prepare_f32_tp), and B5 runs the plan.
//
// Replaces, with fused_f32.cu's kernels, the TPU kernels
//   B1 <- pmfm_tpu/kernels/synth_fitness.py::fused_synth_fitness (true f32)
//   B2 <- pmfm_tpu/kernels/generation.py::fused_generation (true f32)
//
// Why a second layout. One thread a candidate runs all F n samples of its
// candidate in order: at P 4096 that is 32 blocks of 128 threads on 132
// SMs, four warps on a quarter of the card, each thread's chain of
// dependent f32 operations the whole kernel's time (16,384 samples a
// thread at --mode stft's F 8, n 2048). Here P 4096 is 128 blocks of eight
// warps.
//
// The block, lane t = candidate base + t, warp w = the time blocks
// [w nb / W, (w + 1) nb / W) of every frame (nb = n / 128), as B2 int8's
// time-parallel synthesis (fused_tp.cuh, whose TpSynth this file runs in
// its float mode):
// * the offspring prologue (B2: evaluate.cuh::offspring_gene over the
//   block's 32 x d (candidate, gene) pairs, strided over its threads) or
//   B1's parameters, staged in shared memory once a launch;
// * frame by frame, each thread takes its candidate's carries at the
//   frame's first block (zero at frame 0, else where the last warp ended
//   the frame before, handed on in shared memory), finds its warp's first
//   block's carries level by level (synth_common.cuh::chain_scan or
//   bank_scan: the scalar walks, each level's totals in shared memory, a
//   fold in block order from the frame's start), and runs synth_span or
//   synth_bank_span over its blocks with XRowEmit on F32Row, the rows
//   f32_synth_kernel writes. The fold over all the frames' blocks is the
//   one-thread synthesis' sequence of operations, so the samples are its
//   own bit for bit. The levels add (KN - 1) / 2 sines a sample to a
//   chain's KN (fm3_series: 1 on 3) and one a pair-sample to a bank's two.
//
// Shared memory (f32_tp_smem; kernels/synth_fitness.py::shared_bytes_f32_tp
// is the same formula): the warps' staging buffers (W x 32 x F32_LDB
// floats), the level totals (levels x nb x 32 floats), the staged genes
// (32 x d floats) and, at F > 1, the carries (32 x d / 2 floats): 37,888
// bytes at most (fm8_series, n 2048, F > 1).

#include "fused_tp.cuh"
#include "generation.cuh"

template <int NC, int KN>
__global__ void __launch_bounds__(TP_MAX_WARPS * 32, TP_MIN_BLOCKS)
f32_synth_tp_kernel(const float* __restrict__ params, uint32_t seed,
                    const uint32_t* __restrict__ run_seeds, const float* __restrict__ pv,
                    const float* __restrict__ ps, MutateParams mp, float* __restrict__ values,
                    float* __restrict__ steps, int pop, SynthParams sp, float* __restrict__ x,
                    int pop_pad) {
  using Synth = TpSynth<NC, KN, false>;
  constexpr int D = synth_dims(KN);
  static_assert(KN != WIDE_CHAIN && KN != WIDE_BANK && KN != LONG_CODE, "the fixed codes only");
  static_assert(2 * Synth::CARRIES == D, "the carries are d / 2 floats a candidate");
  extern __shared__ __align__(16) float smem_f32tp[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  const int n = sp.n, nb = n / TIME_BLOCK, d = sp.d, frames = sp.frames;
  const int base = blockIdx.x * TC_CPB, run = blockIdx.y;
  float* buf = smem_f32tp + warp * 32 * F32_LDB;  // the warp's staging buffer
  float* tot = smem_f32tp + nw * 32 * F32_LDB;    // the level totals
  float* s_p = tot + Synth::LEVELS * nb * TC_CPB;  // the staged genes
  float* carry = s_p + TC_CPB * d + lane;          // the carries between frames
  const bool gen = pv != nullptr;
  if (gen) {
    if (run_seeds) seed = __ldg(run_seeds + run);
    pv += (size_t)run * mp.mu * d;
    ps += (size_t)run * mp.mu * d;
    values += (size_t)run * pop * d;
    steps += (size_t)run * pop * d;
  } else {
    params += (size_t)run * pop * d;
  }
  for (int i = tid; i < TC_CPB * d; i += blockDim.x) {  // pair i: (i / d, i % d)
    const int cl = i / d, cand = base + cl;
    s_p[i] = cand >= pop ? 0.f
             : gen       ? offspring_gene(seed, cand, i - cl * d, pv, ps, mp, d, values, steps)
                         : params[(size_t)base * d + i];
  }
  __syncthreads();
  Synth syn;
  XRowEmit emit;
  {
    float p[D];
#pragma unroll
    for (int i = 0; i < D; ++i) p[i] = i < d ? s_p[lane * d + i] : 0.f;
    emit.amp = syn.init(p, sp);
  }
  const int b0 = warp * nb / nw, b1 = (warp + 1) * nb / nw, b_top = (nw - 1) * nb / nw;
#pragma unroll 1
  for (int f = 0; f < frames; ++f) {
    if (f)
      syn.load(carry, TC_CPB);
    else
      syn.zero();
    const size_t row = (size_t)(run * frames + f) * pop_pad + base + lane;
    emit.row = F32Row{x + row * n, buf, lane, n};
    syn.run(sp, b0, b1, b_top, tot + lane, nb, emit);
    // the last warp's carries at the frame's end start the next frame; the
    // barrier also ends every read of this frame's level totals
    if (warp == nw - 1 && f + 1 < frames) syn.store(carry, TC_CPB);
    __syncthreads();
  }
}

// Dynamic shared memory of a block (this file's note).
static int f32_tp_smem(const SynthParams& sp) {
  const int levels = sp.npair ? sp.npair : sp.kn - 1, nb = sp.n / TIME_BLOCK;
  return 4 * (tp_warps(sp) * 32 * F32_LDB + levels * nb * TC_CPB + TC_CPB * sp.d +
              (sp.frames > 1 ? TC_CPB * (sp.d / 2) : 0));
}

int prepare_f32_tp(const SynthParams& sp, int pop_pad, F32Plan* plan) {
  F32SynthKernel kernel = nullptr;
  int e = sp.long_code || sp.n % (2 * TIME_BLOCK) ? (int)cudaErrorInvalidValue : 0;
  if (!e)
    e = dispatch_ncoef(sp.ncoef, [&](auto nc) {
      return dispatch_synth<true, CODES_FIXED>(sp, [&](auto kc) {
        constexpr int KN = decltype(kc)::value;
        if constexpr (KN != WIDE_CHAIN && KN != WIDE_BANK && KN != LONG_CODE)
          kernel = f32_synth_tp_kernel<decltype(nc)::value, KN>;
        return 0;
      });
    });
  if (!e && !kernel) e = (int)cudaErrorInvalidValue;
  plan->synth = kernel;
  plan->synth_blocks = pop_pad / TC_CPB;
  plan->synth_threads = 32 * tp_warps(sp);
  plan->synth_smem = f32_tp_smem(sp);
  return e ? e : (int)prepare(kernel, plan->synth_smem);
}
