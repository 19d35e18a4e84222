// Fused FM synthesis + folded DFT + L2 spectral fitness for Hopper (sm_90a),
// with and without an in-kernel offspring prologue, in the int8 and the
// true-f32 mode.
//
// Replaces two TPU kernels of pmfm_tpu:
//   fused_synth_fitness_kernel <- kernels/synth_fitness.py::fused_synth_fitness (B1)
//   fused_generation_kernel    <- kernels/generation.py::fused_generation       (B2)
// Both call evaluate.cuh::evaluate_block, as both TPU kernels call
// _evaluate_block; that header's note says what bounds each mode on an H100
// and how the design meets it (int8: one thread per candidate, 64 a block,
// __dp4a; f32: 16 candidates and 128 threads a block, exact-product FMAs).
//
// A simple first kernel, not yet a fast one: tensor-core (mma / wgmma)
// tiles for the DFT are later work.

#include "evaluate.cuh"

template <int NC, bool F32>
__global__ void __launch_bounds__(Mode<F32>::THREADS)
fused_synth_fitness_kernel(const float* __restrict__ params, int pop, SynthParams sp,
                           const void* __restrict__ dft, const float* __restrict__ target,
                           float* __restrict__ fitness) {
  extern __shared__ __align__(16) int smem[];
  constexpr int CPB = Mode<F32>::CPB;
  const int cand = blockIdx.x * CPB + threadIdx.x % CPB;
  const bool active = cand < pop, leader = threadIdx.x < CPB;
  if (!F32 && !active) return;  // int8: no barrier, a thread per candidate
  float p[MAX_D];
  if (leader && active)
    load_params(p, params, cand, sp.d);
  else
    for (int i = 0; i < MAX_D; ++i) p[i] = 0.f;
  const float fit = evaluate_block<NC, F32>(p, sp, dft, target, smem);
  if (leader && active) fitness[cand] = fit;
}

template <int NC, bool F32>
__global__ void __launch_bounds__(Mode<F32>::THREADS)
fused_generation_kernel(uint32_t seed, const float* __restrict__ pv, const float* __restrict__ ps,
                        int pop, SynthParams sp, MutateParams mp,
                        const void* __restrict__ dft, const float* __restrict__ target,
                        float* __restrict__ fitness, float* __restrict__ values,
                        float* __restrict__ steps) {
  extern __shared__ __align__(16) int smem[];
  constexpr int CPB = Mode<F32>::CPB;
  const int cand = blockIdx.x * CPB + threadIdx.x % CPB;
  const bool active = cand < pop, leader = threadIdx.x < CPB;
  if (!F32 && !active) return;  // int8: no barrier, a thread per candidate
  float p[MAX_D];
  if (leader && active)
    offspring(seed, cand, pv, ps, mp, sp.d, p, values, steps);
  else
    for (int i = 0; i < MAX_D; ++i) p[i] = 0.f;
  const float fit = evaluate_block<NC, F32>(p, sp, dft, target, smem);
  if (leader && active) fitness[cand] = fit;
}

template <bool F32>
static int launch_b1(const float* params, int pop, const SynthParams& sp, const void* dft,
                     const float* target, float* fitness, cudaStream_t stream) {
  const size_t smem = eval_smem_bytes(sp.n, F32);
  const dim3 grid((pop + Mode<F32>::CPB - 1) / Mode<F32>::CPB);
  return dispatch_ncoef(sp.ncoef, [&](auto nc) {
    auto kernel = fused_synth_fitness_kernel<decltype(nc)::value, F32>;
    cudaError_t e = prepare(kernel, smem);
    if (e) return (int)e;
    kernel<<<grid, Mode<F32>::THREADS, smem, stream>>>(params, pop, sp, dft, target, fitness);
    return (int)cudaGetLastError();
  });
}

template <bool F32>
static int launch_b2(uint32_t seed, const float* pv, const float* ps, int pop,
                     const SynthParams& sp, const MutateParams& mp, const void* dft,
                     const float* target, float* fitness, float* values, float* steps,
                     cudaStream_t stream) {
  const size_t smem = eval_smem_bytes(sp.n, F32);
  const dim3 grid((pop + Mode<F32>::CPB - 1) / Mode<F32>::CPB);
  return dispatch_ncoef(sp.ncoef, [&](auto nc) {
    auto kernel = fused_generation_kernel<decltype(nc)::value, F32>;
    cudaError_t e = prepare(kernel, smem);
    if (e) return (int)e;
    kernel<<<grid, Mode<F32>::THREADS, smem, stream>>>(seed, pv, ps, pop, sp, mp, dft, target,
                                                        fitness, values, steps);
    return (int)cudaGetLastError();
  });
}

extern "C" {

const char* pmfm_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// B1: fitness (pop,) of scaled params (pop, d) against the folded operand
// (2k, n/2), int8 (f32_mode 0) or float32 (f32_mode 1), and the target (k,).
// Returns cudaGetLastError().
int pmfm_fused_synth_fitness(const float* params, int pop, SynthParams sp, const void* dft,
                             const float* target, float* fitness, int f32_mode,
                             cudaStream_t stream) {
  return f32_mode ? launch_b1<true>(params, pop, sp, dft, target, fitness, stream)
                  : launch_b1<false>(params, pop, sp, dft, target, fitness, stream);
}

// B2: one generation's offspring (pop, d) values and steps from the parents
// (mu, d), and their fitness (pop,). Returns cudaGetLastError().
int pmfm_fused_generation(uint32_t seed, const float* pv, const float* ps, int pop,
                          SynthParams sp, MutateParams mp, const void* dft, const float* target,
                          float* fitness, float* values, float* steps, int f32_mode,
                          cudaStream_t stream) {
  return f32_mode ? launch_b2<true>(seed, pv, ps, pop, sp, mp, dft, target, fitness, values,
                                    steps, stream)
                  : launch_b2<false>(seed, pv, ps, pop, sp, mp, dft, target, fitness, values,
                                     steps, stream);
}

}  // extern "C"
