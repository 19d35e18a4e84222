// B1 and B2 bf16's time-parallel layout (fused_tp_bf16.cuh: the design, the
// kernels and their shared memory): the fixed banks' instantiations and the
// entries, which take the chains' from fused_tp_bf16_chain.cu (built beside
// this file) and launch through fused_tp.cuh's launchers, and B2's
// prepare/launch pair that B5 runs (generation.cuh).
//
// Replaces, with fused_bf16.cu's kernels, the bf16 mode of the TPU kernels
//   B1 <- pmfm_tpu/kernels/synth_fitness.py::fused_synth_fitness
//   B2 <- pmfm_tpu/kernels/generation.py::fused_generation

#include "fused_tp_bf16.cuh"

// B2 bf16 in the time-parallel layout as a prepare/launch pair for a run of
// launches (generation.cuh): B5 (evolve.cu) prepares once and launches every
// generation, instantiating no kernel of its own.
int prepare_generation_bf16_tp(const SynthParams& sp, int pop, int runs,
                               TpGeneration<GenBf16Kernel>* gen) {
  return prepare_tp_generation(sp, pop, runs, gen);
}

int launch_generation_bf16_tp(const TpGeneration<GenBf16Kernel>& gen, uint32_t seed,
                              const uint32_t* run_seeds, const float* pv, const float* ps, int pop,
                              int runs, const SynthParams& sp, const MutateParams& mp,
                              const __nv_bfloat16* dft, const float* target, float* fitness,
                              float* values, float* steps, cudaStream_t stream) {
  return enqueue_tp_generation(gen, seed, run_seeds, pv, ps, pop, runs, sp, mp, dft, target,
                               fitness, values, steps, stream);
}

extern "C" {

// B1 bf16 in the time-parallel layout: pmfm_fused_synth_fitness_bf16's
// arguments and output (fused_bf16.cu), for a fixed chain (fm2, fm3_series
// .. fm8_series) or a fixed bank of 2 .. 5 pairs at any frame count, n a
// multiple of 256 and the block's shared memory within MAX_BLOCK_SMEM; any
// other shape returns cudaErrorInvalidValue. Returns cudaGetLastError().
int pmfm_fused_synth_fitness_bf16_tp(const float* params, int pop, int runs, SynthParams sp,
                                     const void* dft, const float* target, float* fitness,
                                     cudaStream_t stream) {
  return launch_tp_fitness<FitBf16Kernel>(params, pop, runs, sp, dft, target, fitness, stream);
}

// B2 bf16 in the time-parallel layout: pmfm_fused_generation_bf16's
// arguments and outputs (fused_bf16.cu), for what
// pmfm_fused_synth_fitness_bf16_tp takes; any other shape returns
// cudaErrorInvalidValue. Returns cudaGetLastError().
int pmfm_fused_generation_bf16_tp(uint32_t seed, const uint32_t* run_seeds, const float* pv,
                                  const float* ps, int pop, int runs, SynthParams sp,
                                  MutateParams mp, const void* dft, const float* target,
                                  float* fitness, float* values, float* steps,
                                  cudaStream_t stream) {
  return launch_tp_generation<GenBf16Kernel>(seed, run_seeds, pv, ps, pop, runs, sp, mp, dft,
                                             target, fitness, values, steps, stream);
}

}  // extern "C"
