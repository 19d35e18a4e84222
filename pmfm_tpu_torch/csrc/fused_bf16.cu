// B1 and B2 in the bf16 mode for Hopper (sm_90a): fused FM synthesis, the
// fold rounded to bf16, the folded DFT on the bf16 tensor cores and the L2
// spectral fitness, with and without B2's offspring prologue.
//
// Replaces the bf16 mode (a bfloat16 dft_packed with dft_scale 0, the
// reference's default fused engine) of two TPU kernels of pmfm_tpu:
//   B1 <- kernels/synth_fitness.py::fused_synth_fitness (_evaluate_block's
//         bf16 branch: the bf16 scratch, fold_cast, the 2 norm (-1)^k edge)
//   B2 <- kernels/generation.py::fused_generation (the same, after
//         _offspring_block)
// as fused_synth_fitness_bf16_kernel and fused_generation_bf16_kernel. B5
// (evolve.cu) runs the B2 kernel for its bf16 generations, through
// generation.cuh.
//
// The design is the int8 kernels' (fused_eval.cu's note): one warp a block,
// thread t synthesising candidate t into the warp's a+/- in shared memory,
// then U and V on the tensor cores against the operand read from L2, and
// the epilogue summing each row's bins in ascending k. tc_eval.cuh holds the
// one template of both modes and says where they differ: here a+/- are
// bf16 (two rounding points: the audio, then each fold sum), the mma is
// m16n8k16 bf16 -> f32, and the edge term is 2 norm (-1)^k x[N/2] with no
// rescale. Not bit-equal to the plain version
// (kernels/synth_fitness.py::_evaluate_plain's bf16 branch): the audio and
// a+/- are, but the tensor cores' f32 accumulation is not IEEE-ordered.
//
// What bounds it on an H100 at the suite's shape (n 1024, K 512, P 2^15):
// the folded DFT is 2 * 2K * (N/2) * P = 34.4 G bf16 operations (35 us at
// the dense bf16 peak of 989 TFLOP/s) and the synthesis ~1.7 G f32
// operations (25 us at 67 TFLOP/s): 35 us, operations. A block's a+/- are
// twice the int8 mode's bytes (64 KB at n 1024), so three one-warp blocks
// fit an SM where the int8 mode fits six, and at n 3584 (229,376 bytes)
// one: the occupancy, not the tensor cores, is what to work on first.

#include "tc_eval.cuh"

typedef __nv_bfloat16 bf16_t;

// ---- launchers ------------------------------------------------------------------

int prepare_generation_bf16(const SynthParams& sp, GenBf16Kernel* kernel) {
  return prepare_tc_any<false>(PICK(fused_generation_bf16_kernel), prepare_wide_generation_bf16,
                               prepare_long_generation_bf16, sp, kernel);
}

int launch_generation_bf16(GenBf16Kernel kernel, uint32_t seed, const uint32_t* run_seeds,
                           const float* pv, const float* ps, int pop, int runs,
                           const SynthParams& sp, const MutateParams& mp, const bf16_t* dft,
                           const float* target, float* fitness, float* values, float* steps,
                           cudaStream_t stream) {
  if (runs > 1 && !run_seeds) return (int)cudaErrorInvalidValue;
  return launch_tc<false>(kernel, sp, pop, runs, stream, seed, run_seeds, pv, ps, pop, sp, mp, dft,
                          target, fitness, values, steps);
}

extern "C" {

// B1 bf16: fitness (runs, pop) of scaled params (runs, pop, d) against the
// bf16 folded operand (2k, n/2) and the targets (runs, sp.frames, k).
// Returns cudaGetLastError().
int pmfm_fused_synth_fitness_bf16(const float* params, int pop, int runs, SynthParams sp,
                                  const void* dft, const float* target, float* fitness,
                                  cudaStream_t stream) {
  FitBf16Kernel kernel;
  const int e = prepare_tc_any<false>(PICK(fused_synth_fitness_bf16_kernel),
                                      prepare_wide_fitness_bf16, prepare_long_fitness_bf16, sp,
                                      &kernel);
  return e ? e
           : launch_tc<false>(kernel, sp, pop, runs, stream, params, pop, sp, (const bf16_t*)dft,
                              target, fitness);
}

// B2 bf16: pmfm_fused_generation's arguments with the bf16 folded operand.
// Returns cudaGetLastError().
int pmfm_fused_generation_bf16(uint32_t seed, const uint32_t* run_seeds, const float* pv,
                               const float* ps, int pop, int runs, SynthParams sp,
                               MutateParams mp, const void* dft, const float* target,
                               float* fitness, float* values, float* steps, cudaStream_t stream) {
  GenBf16Kernel kernel;
  const int e = prepare_generation_bf16(sp, &kernel);
  return e ? e
           : launch_generation_bf16(kernel, seed, run_seeds, pv, ps, pop, runs, sp, mp,
                                    (const bf16_t*)dft, target, fitness, values, steps, stream);
}

}  // extern "C"
