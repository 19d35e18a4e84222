// The evaluation and the offspring prologue shared by the fused kernels B1,
// B2 (fused_eval.cu) and B5 (evolve.cu), as the TPU kernels share
// pmfm_tpu/kernels/synth_fitness.py::_evaluate_block and
// pmfm_tpu/kernels/generation.py::_offspring_block. B1 and B2 run their own
// evaluations, on the int8 tensor cores (fused_eval.cu) and as a synthesis
// kernel plus a register-tiled f32 DFT (fused_f32.cu); both evaluation modes
// below are B5's alone, and B2 and B5 share the offspring genes.
//
// Two modes, chosen by the operand:
//
// int8 (dft_scale > 0; B5's engine). One thread per candidate, TPB
// candidates per CUDA block. Each thread runs its candidate's sample
// recurrence (synth_common.cuh::synth_run) and folds q = round(63 sin) into
// its own column of two (N/2) x TPB byte arrays a+/a- in shared memory
// (64 KB at n = 1024), laid out as 32-bit words [n/4][candidate] so that one
// word holds four consecutive samples of one candidate. The DFT runs on the
// CUDA cores with __dp4a (four int8 products into an exact int32 sum per
// instruction); the operand rows (2K x N/2 int8, 512 KB) are read as 16-byte
// loads that every thread of a warp shares, from L1/L2. No thread reads
// another thread's column, so this mode needs no barrier. Bound at n 1024,
// K 512, P 2^15: 34 G int8 operations (17 us at the int8 tensor-core peak)
// and ~1.7 G f32 operations of synthesis (25 us at 67 TFLOP/s).
//
// true f32 (dft_scale == 0 with the float32 operand; the refine tail,
// _evaluate_block's audio_f32; B5's engine): unquantised audio x = sin * amp folded into
// f32 a+/a- (no rounding but the fold's own add), two f32 contractions
// against the f32 (2K, N/2) operand, the edge term 2 norm (-1)^k x[N/2] and
// no magnitude rescale. A sample now takes 4 bytes, so 64 candidates' fold
// would need 256 KB at n = 1024, above the 227 KB a block can have. The mode
// therefore takes F32_CPB = 16 candidates per block, which fits every
// n <= 3584 (the int8 mode's own limit), rather than putting a+/- in device
// memory as B3 does: the DFT reads each a value K/KT times, and shared memory
// serves that where device memory could not. Sixteen threads a block would
// leave an SM with ~1.5 warps, so each block has F32_GROUPS = 8 threads per
// candidate: the candidate's own thread synthesises and folds, then after a
// barrier all 128 threads run the DFT, thread (c, g) taking candidate c's bin
// tiles g, g + 8, ...; the 8 partial fitness sums are added in group order.
// The products are exact-product __fmaf_rn on the CUDA cores (one rounding a
// term, at least as accurate as a rounded multiply and add; never TF32: the
// reference's dots are Precision.HIGHEST). Bound at n 1024, K 512, P 2^15:
// 2 x 2 K (N/2) P = 34 G f32 operations, 0.51 ms at 67 TFLOP/s.
//
// Exactness. Every synthesis op uses __fmul_rn / __fadd_rn, so nvcc contracts
// nothing into an FMA: the audio (int8 q, or f32 x) is bit for bit what the
// plain PyTorch version (kernels/synth_fitness.py) computes, the int8
// contraction is exact in int32, and only the order of the f32 sums (the
// f32 DFT, the sum over bins) differs from the plain version. B5 runs these
// functions; the B1/B2 evaluations of fused_eval.cu (int8) and fused_f32.cu
// (f32) make the same audio, the same sums and terms and add the terms in
// the same order, so B5's fitness is bit-equal to B2's in both modes.
#pragma once

#include <type_traits>

#include "synth_common.cuh"

#define TPB 64         // int8: candidates (threads) per CUDA block
#define KT 8           // bins per register tile of the DFT
#define F32_CPB 16     // f32: candidates per CUDA block
#define F32_GROUPS 8   // f32: threads per candidate in the DFT
#define F32_TPB (F32_CPB * F32_GROUPS)

template <bool F32>
struct Mode {
  static constexpr int CPB = F32 ? F32_CPB : TPB;       // candidates per block
  static constexpr int THREADS = F32 ? F32_TPB : TPB;   // threads per block
};

// Dynamic shared memory of one evaluation block: the folded audio, and in
// f32 mode the edge samples and partial sums (kernels/synth_fitness.py::
// shared_bytes is the same formula).
__host__ __device__ inline size_t eval_smem_bytes(int n, bool f32) {
  return f32 ? 4 * ((size_t)n * F32_CPB + F32_CPB * (1 + F32_GROUPS)) : (size_t)n * TPB;
}

struct MutateParams {
  int mu;
  int clamp;
  float alpha, inv_alpha;
  float ekb_alpha, ekb_inv_alpha;  // alpha^beta and (1/alpha)^beta, from the host
  float beta_scale;
  float root_two_over_pi;
  float min_step;
  float mins[MAX_D];
  float ranges[MAX_D];  // maxs - mins
};

// ---- int8 mode ---------------------------------------------------------------

__device__ __forceinline__ void put_byte(int* words, int m, int lane, int v) {
  reinterpret_cast<int8_t*>(words)[(((m >> 2) * TPB + lane) << 2) | (m & 3)] = (int8_t)v;
}

__device__ __forceinline__ int get_byte(const int* words, int m, int lane) {
  return reinterpret_cast<const int8_t*>(words)[(((m >> 2) * TPB + lane) << 2) | (m & 3)];
}

// Fitness of one candidate from its scaled parameters p[0..d-1]
// (_evaluate_block + _make_block_synth + _dft_uv + _fit_epilogue).
template <int NC>
__device__ float evaluate_int8(const float* p, const SynthParams& sp,
                               const int8_t* __restrict__ dft,
                               const float* __restrict__ target,
                               int* s_ap, int* s_am, int lane) {
  const Chain ch = make_chain(p, sp);
  const float mag_scale = fmul(fabsf(ch.amp), sp.dft_scale);

  // synthesis + fold: a+[r] = q[r] + q[N-r], a-[r] = q[r] - q[N-r] for
  // 0 < r < N/2, a+/-[0] = q[0]; x[N/2] is kept apart as the edge sample
  const int n = sp.n, half = n >> 1;
  int edge_q = 0;
  auto emit = [&](int m, int, float y) {
    const int q = (int)rintf(y);
    if (m < half) {
      put_byte(s_ap, m, lane, q);
      if (m == 0) put_byte(s_am, 0, lane, q);
    } else if (m == half) {
      edge_q = q;
    } else {
      const int r = n - m;
      const int a = get_byte(s_ap, r, lane);
      put_byte(s_ap, r, lane, a + q);
      put_byte(s_am, r, lane, a - q);
    }
  };
  synth_run<NC>(ch, sp, sp.sin_c63, n, emit);

  // folded DFT: U = cos-half @ a+, V = sin-half @ a-, exact in int32
  const int words = half >> 2;
  const float eq = (float)edge_q;
  float fit = 0.f;
  for (int k0 = 0; k0 < sp.k; k0 += KT) {
    int acc_u[KT], acc_v[KT];
#pragma unroll
    for (int i = 0; i < KT; ++i) acc_u[i] = acc_v[i] = 0;
    for (int w = 0; w < words; w += 4) {
      int ap[4], am[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ap[i] = s_ap[(w + i) * TPB + lane];
        am[i] = s_am[(w + i) * TPB + lane];
      }
#pragma unroll
      for (int i = 0; i < KT; ++i) {
        const int4 oc = __ldg(reinterpret_cast<const int4*>(dft + (size_t)(k0 + i) * half) + (w >> 2));
        const int4 os = __ldg(reinterpret_cast<const int4*>(dft + (size_t)(sp.k + k0 + i) * half) + (w >> 2));
        acc_u[i] = __dp4a(ap[0], oc.x, acc_u[i]);
        acc_u[i] = __dp4a(ap[1], oc.y, acc_u[i]);
        acc_u[i] = __dp4a(ap[2], oc.z, acc_u[i]);
        acc_u[i] = __dp4a(ap[3], oc.w, acc_u[i]);
        acc_v[i] = __dp4a(am[0], os.x, acc_v[i]);
        acc_v[i] = __dp4a(am[1], os.y, acc_v[i]);
        acc_v[i] = __dp4a(am[2], os.z, acc_v[i]);
        acc_v[i] = __dp4a(am[3], os.w, acc_v[i]);
      }
    }
    // epilogue: the x[N/2] edge term 127 (-1)^k, magnitude, |amp| rescale, L2
#pragma unroll
    for (int i = 0; i < KT; ++i) {
      const int kk = k0 + i;
      const float ec = (kk & 1) ? -127.f : 127.f;
      const float u = fadd((float)acc_u[i], fmul(ec, eq));
      const float v = (float)acc_v[i];
      const float mag = fmul(sqrtf(fadd(fmul(u, u), fmul(v, v))), mag_scale);
      const float dd = fsub(mag, __ldg(target + kk));
      fit = fadd(fit, fmul(dd, dd));
    }
  }
  return fit;
}

// ---- true-f32 mode -----------------------------------------------------------

// a+/- of the block's F32_CPB candidates: float4 words [r/4][c], so that a
// DFT thread reads four consecutive samples of its candidate in one load
__device__ __forceinline__ float* f32_slot(float* base, int r, int c) {
  return base + ((((r >> 2) * F32_CPB + c) << 2) | (r & 3));
}

// Synthesis of candidate c into f32 a+/a-; returns the edge sample x[N/2].
template <int NC>
__device__ float synth_fold_f32(const float* p, const SynthParams& sp, float* s_ap, float* s_am,
                                int c) {
  const Chain ch = make_chain(p, sp);
  const int n = sp.n, half = n >> 1;
  float edge = 0.f;
  auto emit = [&](int m, int, float y) {
    const float x = fmul(y, ch.amp);
    if (m < half) {
      *f32_slot(s_ap, m, c) = x;
      if (m == 0) *f32_slot(s_am, 0, c) = x;
    } else if (m == half) {
      edge = x;
    } else {
      const int r = n - m;
      const float a = *f32_slot(s_ap, r, c);
      *f32_slot(s_ap, r, c) = fadd(a, x);
      *f32_slot(s_am, r, c) = fsub(a, x);
    }
  };
  synth_run<NC>(ch, sp, sp.sin_c, n, emit);
  return edge;
}

// Candidate c's share of the L2 fitness: its bin tiles g, g + F32_GROUPS, ...
static __device__ float dft_partial_f32(const float* s_ap, const float* s_am, const SynthParams& sp,
                                        const float* __restrict__ dft,
                                        const float* __restrict__ target,
                                        float edge, int c, int g) {
  const int half = sp.n >> 1, words = half >> 2;
  const float4* ap4 = reinterpret_cast<const float4*>(s_ap);
  const float4* am4 = reinterpret_cast<const float4*>(s_am);
  float fit = 0.f;
  for (int k0 = g * KT; k0 < sp.k; k0 += F32_GROUPS * KT) {
    float acc_u[KT], acc_v[KT];
#pragma unroll
    for (int i = 0; i < KT; ++i) acc_u[i] = acc_v[i] = 0.f;
    for (int w = 0; w < words; ++w) {
      const float4 a = ap4[w * F32_CPB + c];
      const float4 b = am4[w * F32_CPB + c];
#pragma unroll
      for (int i = 0; i < KT; ++i) {
        const float4 oc = __ldg(reinterpret_cast<const float4*>(dft + (size_t)(k0 + i) * half) + w);
        const float4 os = __ldg(reinterpret_cast<const float4*>(dft + (size_t)(sp.k + k0 + i) * half) + w);
        acc_u[i] = __fmaf_rn(oc.x, a.x, acc_u[i]);
        acc_u[i] = __fmaf_rn(oc.y, a.y, acc_u[i]);
        acc_u[i] = __fmaf_rn(oc.z, a.z, acc_u[i]);
        acc_u[i] = __fmaf_rn(oc.w, a.w, acc_u[i]);
        acc_v[i] = __fmaf_rn(os.x, b.x, acc_v[i]);
        acc_v[i] = __fmaf_rn(os.y, b.y, acc_v[i]);
        acc_v[i] = __fmaf_rn(os.z, b.z, acc_v[i]);
        acc_v[i] = __fmaf_rn(os.w, b.w, acc_v[i]);
      }
    }
    // epilogue: the edge term 2 norm (-1)^k x[N/2], magnitude, L2
#pragma unroll
    for (int i = 0; i < KT; ++i) {
      const int kk = k0 + i;
      const float ec = (kk & 1) ? -sp.edge_norm : sp.edge_norm;
      const float u = fadd(acc_u[i], fmul(ec, edge));
      const float v = acc_v[i];
      const float mag = sqrtf(fadd(fmul(u, u), fmul(v, v)));
      const float dd = fsub(mag, __ldg(target + kk));
      fit = fadd(fit, fmul(dd, dd));
    }
  }
  return fit;
}

// ---- one block of candidates, either mode ---------------------------------------

// Fitness of the block's candidates. Thread t serves candidate t % CPB; the
// first CPB threads (the leaders) hold the candidates' parameters `p` and get
// the fitness back. Every thread of the block must call it (f32 mode has
// barriers), and every thread runs it in full: a thread past the end of the
// population (the last block may be ragged) evaluates the zero parameters
// it was given and its result is dropped. Keeping the evaluation free of
// branches on the candidate lets nvcc hold the operand's row addresses in
// uniform registers and keep the DFT's loads in flight together; a branch
// around it made the same loop 2x slower in B5 (PERF.md §6).
template <int NC, bool F32>
__device__ __forceinline__ float evaluate_block(const float* p, const SynthParams& sp,
                                                const void* __restrict__ dft,
                                                const float* __restrict__ target, int* smem) {
  if constexpr (F32) {
    const int c = threadIdx.x % F32_CPB, g = threadIdx.x / F32_CPB;
    const int half = sp.n >> 1;
    float* s_ap = reinterpret_cast<float*>(smem);
    float* s_am = s_ap + half * F32_CPB;
    float* s_edge = s_am + half * F32_CPB;
    float* s_part = s_edge + F32_CPB;
    if (g == 0) s_edge[c] = synth_fold_f32<NC>(p, sp, s_ap, s_am, c);
    __syncthreads();
    s_part[g * F32_CPB + c] = dft_partial_f32(s_ap, s_am, sp, reinterpret_cast<const float*>(dft),
                                              target, s_edge[c], c, g);
    __syncthreads();
    float fit = 0.f;
#pragma unroll
    for (int j = 0; j < F32_GROUPS; ++j) fit = fadd(fit, s_part[j * F32_CPB + c]);
    return fit;
  } else {
    return evaluate_int8<NC>(p, sp, reinterpret_cast<const int8_t*>(dft), target, smem,
                             smem + (sp.n >> 3) * TPB, threadIdx.x);
  }
}

// ---- the offspring prologue (B2 and B5) ----------------------------------------

// Philox4x32-10 (Salmon et al., SC'11): counter (candidate, dimension, call,
// 0), key (seed, 0). kernels/generation.py::philox4x32 is the same function.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

__device__ __forceinline__ float uniform01(uint32_t bits) {
  return fmul((float)(bits >> 8), 1.0f / 16777216.0f);  // exact: 24-bit value
}

// Gene `dim` of candidate `cand`'s offspring (_offspring_block): a uniform
// parent, an exact copy, the Ek coin, a CLT-12 gaussian (sigma 1/6), one
// retry with -0.5 g, log-normal step adaptation, the step floor and the
// optional clamp. Writes the gene's value and step and returns its scaled
// parameter (_scale_rows). It depends on (cand, dim) alone, so the int8
// B1/B2 spread a block's genes over all its threads. The parents are read
// through L2 (__ldcg): B5 rewrites them during its run.
__device__ __forceinline__ float offspring_gene(uint32_t seed, int cand, int dim, const float* pv,
                                                const float* ps, const MutateParams& mp, int d,
                                                float* values, float* steps) {
  const uint4 r0 = philox4x32_10(make_uint4(cand, dim, 0, 0), seed, 0u);
  const uint4 r1 = philox4x32_10(make_uint4(cand, dim, 1, 0), seed, 0u);
  const uint4 r2 = philox4x32_10(make_uint4(cand, dim, 2, 0), seed, 0u);
  const uint4 r3 = philox4x32_10(make_uint4(cand, dim, 3, 0), seed, 0u);
  const int idx = (int)((r0.x & 0x7FFFFFFFu) % (uint32_t)mp.mu);
  const bool coin = (r0.y & 1u) != 0u;
  const uint32_t u[12] = {r0.z, r0.w, r1.x, r1.y, r1.z, r1.w,
                          r2.x, r2.y, r2.z, r2.w, r3.x, r3.y};
  const float x = __ldcg(pv + (size_t)idx * d + dim);
  const float s = __ldcg(ps + (size_t)idx * d + dim);
  const float ek = coin ? mp.inv_alpha : mp.alpha;
  const float ekb = coin ? mp.ekb_inv_alpha : mp.ekb_alpha;
  float g = 0.f;
#pragma unroll
  for (int j = 0; j < 12; ++j) g = fadd(g, fsub(fmul(uniform01(u[j]), 2.f), 1.f));
  g = fmul(g, 1.0f / 12.0f);
  const float eks = fmul(ek, s);
  float nx = fadd(x, fmul(eks, g));
  if (nx < 0.f || nx > 1.f) {
    g = fmul(g, -0.5f);
    nx = fadd(x, fmul(eks, g));
  }
  if (mp.clamp) nx = fminf(fmaxf(nx, 0.f), 1.f);
  const float es = expf(fsub(fabsf(g), mp.root_two_over_pi));
  float ns = fmul(fmul(s, ekb), powf(es, mp.beta_scale));
  if (mp.min_step > 0.f) ns = fmaxf(ns, mp.min_step);
  values[(size_t)cand * d + dim] = nx;
  steps[(size_t)cand * d + dim] = ns;
  return fadd(mp.mins[dim], fmul(nx, mp.ranges[dim]));  // _scale_rows
}

// Candidate `cand`'s offspring, one thread for all its genes (B5):
// its values and steps rows and the scaled parameters p.
__device__ __forceinline__ void offspring(uint32_t seed, int cand, const float* pv, const float* ps,
                                          const MutateParams& mp, int d, float* p,
                                          float* values, float* steps) {
#pragma unroll
  for (int dim = 0; dim < MAX_D; ++dim) {
    p[dim] = 0.f;
    if (dim >= d) continue;
    p[dim] = offspring_gene(seed, cand, dim, pv, ps, mp, d, values, steps);
  }
}

// Runs f.template operator()<NC>() for the sine order's coefficient count.
template <typename F>
__host__ inline int dispatch_ncoef(int ncoef, F&& f) {
  switch (ncoef) {
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// Runs f(std::integral_constant<int, KN>{}) for the chain length kn (2..8).
template <typename F>
__host__ inline int dispatch_chain(int kn, F&& f) {
  switch (kn) {
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
    default: return (int)cudaErrorInvalidValue;
  }
}
