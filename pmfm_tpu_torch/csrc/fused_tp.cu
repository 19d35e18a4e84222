// B1 and B2 int8's time-parallel layout (fused_tp.cuh: the design, the
// kernels and their shared memory): the fixed banks' instantiations and the
// launchers, which take the chains' from fused_tp_chain.cu (built beside
// this file).
//
// Replaces, with fused_eval.cu's kernels, the TPU kernels
//   B1 <- pmfm_tpu/kernels/synth_fitness.py::fused_synth_fitness
//   B2 <- pmfm_tpu/kernels/generation.py::fused_generation

#include "fused_tp.cuh"

// Whether the layout takes the shape: any frame count, not the long code, n
// a multiple of 256, 1 .. 65535 runs and the block's shared memory within
// MAX_BLOCK_SMEM (the code is checked where the kernel is prepared).
static bool tp_shape(const SynthParams& sp, int pop, int runs) {
  return sp.frames >= 1 && !sp.long_code && sp.n % (2 * TIME_BLOCK) == 0 && pop >= 1 &&
         runs >= 1 && runs <= 65535 && tp_smem(sp) <= MAX_BLOCK_SMEM;
}

extern "C" {

// B1 int8 in the time-parallel layout: pmfm_fused_synth_fitness's arguments
// and output (fused_eval.cu), for what pmfm_fused_generation_tp takes; any
// other shape returns cudaErrorInvalidValue. Returns cudaGetLastError().
int pmfm_fused_synth_fitness_tp(const float* params, int pop, int runs, SynthParams sp,
                                const void* dft, const float* target, float* fitness,
                                cudaStream_t stream) {
  if (!tp_shape(sp, pop, runs)) return (int)cudaErrorInvalidValue;
  FitInt8Kernel kernel = nullptr;
  const int e = sp.npair ? prepare_tp<false>(sp, &kernel) : prepare_tp_chain(sp, &kernel);
  if (e) return e;
  kernel<<<dim3((pop + TC_CPB - 1) / TC_CPB, runs), 32 * tp_warps(sp), tp_smem(sp), stream>>>(
      params, pop, sp, (const int8_t*)dft, target, fitness);
  return (int)cudaGetLastError();
}

// B2 int8 in the time-parallel layout: pmfm_fused_generation's arguments
// and outputs (fused_eval.cu), for a fixed chain (fm2, fm3_series ..
// fm8_series) or a fixed bank of 2 .. 5 pairs at any frame count, n a
// multiple of 256 and the block's shared memory within MAX_BLOCK_SMEM; any
// other shape returns cudaErrorInvalidValue. Returns cudaGetLastError().
int pmfm_fused_generation_tp(uint32_t seed, const uint32_t* run_seeds, const float* pv,
                             const float* ps, int pop, int runs, SynthParams sp, MutateParams mp,
                             const void* dft, const float* target, float* fitness, float* values,
                             float* steps, cudaStream_t stream) {
  if (!tp_shape(sp, pop, runs) || (runs > 1 && !run_seeds)) return (int)cudaErrorInvalidValue;
  GenInt8Kernel kernel = nullptr;
  const int e = sp.npair ? prepare_tp<false>(sp, &kernel) : prepare_tp_chain(sp, &kernel);
  if (e) return e;
  kernel<<<dim3((pop + TC_CPB - 1) / TC_CPB, runs), 32 * tp_warps(sp), tp_smem(sp), stream>>>(
      seed, run_seeds, pv, ps, pop, sp, mp, (const int8_t*)dft, target, fitness, values, steps);
  return (int)cudaGetLastError();
}

}  // extern "C"
