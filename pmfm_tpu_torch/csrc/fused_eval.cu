// Fused FM synthesis + folded int8 DFT + L2 spectral fitness for Hopper
// (sm_90a), with and without an in-kernel offspring prologue.
//
// Replaces two TPU kernels of pmfm_tpu:
//   fused_synth_fitness_kernel <- kernels/synth_fitness.py::fused_synth_fitness (B1)
//   fused_generation_kernel    <- kernels/generation.py::fused_generation       (B2)
// Both call evaluate_candidate, as both TPU kernels call _evaluate_block.
//
// What bounds it on an H100. Per candidate at n = 1024, K = 512 the folded
// DFT is 2 x K x N/2 = 524,288 int8 multiply-adds (34 G int8 operations for
// a population of 2^15), and the synthesis is ~45 f32 operations per sample
// (~1.5 GFLOP for 2^15). Inputs and outputs are ~2 MB, so the work is bound
// by operations, not bytes: ~17 us at the int8 tensor-core peak.
//
// Design (a simple first kernel, not yet a fast one). One thread per
// candidate, TPB candidates per CUDA block. Each thread runs its candidate's
// sample recurrence sequentially (synth_common.cuh::synth_run, the one
// definition B3 and B4 run too), with the TPU kernel's turns-domain phases,
// C = 128-sample blocks and frac'd carries; the exclusive prefix sum inside a
// block is a running f32 sum, where the TPU kernel used a triangular matmul.
// The int8 samples are folded straight into the thread's column of two
// (N/2) x TPB byte arrays a+/a- in shared memory (64 KB at n = 1024), laid out
// as 32-bit words [n/4][candidate] so that one word holds four consecutive
// samples of one candidate. The DFT then runs on the CUDA cores with __dp4a
// (four int8 products into an exact int32 sum per instruction); the operand
// rows (2K x N/2 int8, 512 KB) are read as 16-byte loads that every thread of
// a warp shares, from L1/L2. No thread reads another thread's column, so the
// kernel needs no barrier. Tensor-core (mma / wgmma int8) tiles are later work.
//
// Exactness. Every f32 multiply and add here and in synth_common.cuh uses
// __fmul_rn / __fadd_rn, so nvcc contracts nothing into an FMA: the audio is
// then bit-for-bit what the plain PyTorch version
// (kernels/synth_fitness.py::fused_synth_fitness_plain) computes, and the int8
// contraction is exact in int32. Only the order of the final sum over bins
// differs from the plain version.

#include "synth_common.cuh"

#define TPB 64  // candidates (threads) per CUDA block
#define KT 8    // bins per register tile of the DFT

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

__device__ __forceinline__ void put_byte(int* words, int m, int lane, int v) {
  reinterpret_cast<int8_t*>(words)[(((m >> 2) * TPB + lane) << 2) | (m & 3)] = (int8_t)v;
}

__device__ __forceinline__ int get_byte(const int* words, int m, int lane) {
  return reinterpret_cast<const int8_t*>(words)[(((m >> 2) * TPB + lane) << 2) | (m & 3)];
}

// Fitness of one candidate from its scaled parameters p[0..d-1]
// (_evaluate_block + _make_block_synth + _dft_uv + _fit_epilogue).
template <int NC>
__device__ float evaluate_candidate(const float* p, const SynthParams& sp,
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

template <int NC>
__global__ void __launch_bounds__(TPB)
fused_synth_fitness_kernel(const float* __restrict__ params, int pop, SynthParams sp,
                           const int8_t* __restrict__ dft, const float* __restrict__ target,
                           float* __restrict__ fitness) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x;
  const int cand = blockIdx.x * TPB + lane;
  if (cand >= pop) return;
  int* s_ap = smem;
  int* s_am = smem + (sp.n >> 3) * TPB;
  float p[MAX_D];
  load_params(p, params, cand, sp.d);
  fitness[cand] = evaluate_candidate<NC>(p, sp, dft, target, s_ap, s_am, lane);
}

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

template <int NC>
__global__ void __launch_bounds__(TPB)
fused_generation_kernel(uint32_t seed, const float* __restrict__ pv, const float* __restrict__ ps,
                        int pop, SynthParams sp, MutateParams mp,
                        const int8_t* __restrict__ dft, const float* __restrict__ target,
                        float* __restrict__ fitness, float* __restrict__ values,
                        float* __restrict__ steps) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x;
  const int cand = blockIdx.x * TPB + lane;
  if (cand >= pop) return;
  int* s_ap = smem;
  int* s_am = smem + (sp.n >> 3) * TPB;
  const int d = sp.d;
  float p[MAX_D];
#pragma unroll
  for (int dim = 0; dim < MAX_D; ++dim) {
    p[dim] = 0.f;
    if (dim >= d) continue;
    // offspring prologue (_offspring_block): uniform parent per gene, exact
    // copy, Ek coin, CLT-12 gaussian (sigma 1/6), retry with -0.5 g,
    // log-normal step adaptation, step floor, optional clamp
    const uint4 r0 = philox4x32_10(make_uint4(cand, dim, 0, 0), seed, 0u);
    const uint4 r1 = philox4x32_10(make_uint4(cand, dim, 1, 0), seed, 0u);
    const uint4 r2 = philox4x32_10(make_uint4(cand, dim, 2, 0), seed, 0u);
    const uint4 r3 = philox4x32_10(make_uint4(cand, dim, 3, 0), seed, 0u);
    const int idx = (int)((r0.x & 0x7FFFFFFFu) % (uint32_t)mp.mu);
    const bool coin = (r0.y & 1u) != 0u;
    const uint32_t u[12] = {r0.z, r0.w, r1.x, r1.y, r1.z, r1.w,
                            r2.x, r2.y, r2.z, r2.w, r3.x, r3.y};
    const float x = pv[(size_t)idx * d + dim];
    const float s = ps[(size_t)idx * d + dim];
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
    p[dim] = fadd(mp.mins[dim], fmul(nx, mp.ranges[dim]));  // _scale_rows
  }
  fitness[cand] = evaluate_candidate<NC>(p, sp, dft, target, s_ap, s_am, lane);
}

extern "C" {

const char* pmfm_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// B1: fitness (pop,) of scaled params (pop, d) against the int8 folded
// operand (2k, n/2) and the target (k,). Returns cudaGetLastError().
int pmfm_fused_synth_fitness(const float* params, int pop, SynthParams sp, const int8_t* dft,
                             const float* target, float* fitness, cudaStream_t stream) {
  const size_t smem = (size_t)sp.n * TPB;  // a+ and a-: 2 x (n/2) x TPB bytes
  const dim3 grid((pop + TPB - 1) / TPB);
  cudaError_t e;
  switch (sp.ncoef) {
    case 3:
      if ((e = prepare(fused_synth_fitness_kernel<3>, smem))) return e;
      fused_synth_fitness_kernel<3><<<grid, TPB, smem, stream>>>(params, pop, sp, dft, target, fitness);
      break;
    case 4:
      if ((e = prepare(fused_synth_fitness_kernel<4>, smem))) return e;
      fused_synth_fitness_kernel<4><<<grid, TPB, smem, stream>>>(params, pop, sp, dft, target, fitness);
      break;
    case 5:
      if ((e = prepare(fused_synth_fitness_kernel<5>, smem))) return e;
      fused_synth_fitness_kernel<5><<<grid, TPB, smem, stream>>>(params, pop, sp, dft, target, fitness);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// B2: one generation's offspring (pop, d) values and steps from the parents
// (mu, d), and their fitness (pop,). Returns cudaGetLastError().
int pmfm_fused_generation(uint32_t seed, const float* pv, const float* ps, int pop,
                          SynthParams sp, MutateParams mp, const int8_t* dft, const float* target,
                          float* fitness, float* values, float* steps, cudaStream_t stream) {
  const size_t smem = (size_t)sp.n * TPB;
  const dim3 grid((pop + TPB - 1) / TPB);
  cudaError_t e;
  switch (sp.ncoef) {
    case 3:
      if ((e = prepare(fused_generation_kernel<3>, smem))) return e;
      fused_generation_kernel<3><<<grid, TPB, smem, stream>>>(seed, pv, ps, pop, sp, mp, dft, target, fitness, values, steps);
      break;
    case 4:
      if ((e = prepare(fused_generation_kernel<4>, smem))) return e;
      fused_generation_kernel<4><<<grid, TPB, smem, stream>>>(seed, pv, ps, pop, sp, mp, dft, target, fitness, values, steps);
      break;
    case 5:
      if ((e = prepare(fused_generation_kernel<5>, smem))) return e;
      fused_generation_kernel<5><<<grid, TPB, smem, stream>>>(seed, pv, ps, pop, sp, mp, dft, target, fitness, values, steps);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
