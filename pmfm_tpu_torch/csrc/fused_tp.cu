// B2 int8's time-parallel layout (fused_tp.cuh: the design, the kernel and
// its shared memory): the fixed banks' instantiations and the launcher,
// which takes the chains' from fused_tp_chain.cu (built beside this file).
//
// Replaces, with fused_eval.cu's kernel, the TPU kernel
//   B2 <- pmfm_tpu/kernels/generation.py::fused_generation

#include "fused_tp.cuh"

extern "C" {

// B2 int8 in the time-parallel layout: pmfm_fused_generation's arguments
// and outputs (fused_eval.cu), for a fixed chain (fm2, fm3_series ..
// fm8_series) or a fixed bank of 2 .. 5 pairs at any frame count, n a
// multiple of 256 and the block's shared memory within MAX_BLOCK_SMEM; any
// other shape returns cudaErrorInvalidValue. Returns cudaGetLastError().
int pmfm_fused_generation_tp(uint32_t seed, const uint32_t* run_seeds, const float* pv,
                             const float* ps, int pop, int runs, SynthParams sp, MutateParams mp,
                             const void* dft, const float* target, float* fitness, float* values,
                             float* steps, cudaStream_t stream) {
  if (sp.frames < 1 || sp.long_code || sp.n % (2 * TIME_BLOCK) || pop < 1 || runs < 1 ||
      runs > 65535 || (runs > 1 && !run_seeds))
    return (int)cudaErrorInvalidValue;
  const size_t smem = tp_smem(sp);
  if (smem > MAX_BLOCK_SMEM) return (int)cudaErrorInvalidValue;
  GenInt8Kernel kernel = nullptr;
  const int e = sp.npair ? prepare_tp<false>(sp, &kernel) : prepare_tp_chain(sp, &kernel);
  if (e) return e;
  kernel<<<dim3((pop + TC_CPB - 1) / TC_CPB, runs), 32 * tp_warps(sp), smem, stream>>>(
      seed, run_seeds, pv, ps, pop, sp, mp, (const int8_t*)dft, target, fitness, values, steps);
  return (int)cudaGetLastError();
}

}  // extern "C"
