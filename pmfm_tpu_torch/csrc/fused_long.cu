// B1 and B2, int8 and bf16 (tc_eval.cuh's four kernels), at the long
// synthesis code (LONG_CODE, synth_common.cuh::LongSynth): a chain or a bank
// of any length, the topologies above 32 genes. Each thread copies its
// candidate's scaled parameters from the block's staging rows in shared
// memory to its row of the long scratch (SynthParams::lscr, which the
// wrapper allocates: 2 x d floats a row, the parameters and the carries)
// and synthesises from there, segment after segment, into the same a+/- as
// the other codes; the DFT and the epilogue are theirs. In a source of its
// own, which nvcc builds beside fused_eval.cu, fused_bf16.cu and
// fused_wide.cu; their prepare calls hand a long shape (sp.long_code) to
// these.

#include "tc_eval.cuh"

int prepare_long_fitness_int8(const SynthParams& sp, FitInt8Kernel* kernel) {
  return prepare_tc<true, CODES_LONG>(PICK(fused_synth_fitness_int8_kernel), sp, kernel);
}

int prepare_long_generation_int8(const SynthParams& sp, GenInt8Kernel* kernel) {
  return prepare_tc<true, CODES_LONG>(PICK(fused_generation_int8_kernel), sp, kernel);
}

int prepare_long_fitness_bf16(const SynthParams& sp, FitBf16Kernel* kernel) {
  return prepare_tc<false, CODES_LONG>(PICK(fused_synth_fitness_bf16_kernel), sp, kernel);
}

int prepare_long_generation_bf16(const SynthParams& sp, GenBf16Kernel* kernel) {
  return prepare_tc<false, CODES_LONG>(PICK(fused_generation_bf16_kernel), sp, kernel);
}
