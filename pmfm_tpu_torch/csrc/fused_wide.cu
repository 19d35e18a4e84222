// B1 and B2, int8 and bf16 (tc_eval.cuh's four kernels), at the wide
// synthesis codes: chains of 9 .. 16 oscillators (WIDE_CHAIN) and banks of
// 6 .. 8 pairs (WIDE_BANK), the length read at run time
// (synth_common.cuh). Each instantiation here is as long to build as the
// longest fixed ones, so they sit in a source of their own, which nvcc
// builds beside fused_eval.cu and fused_bf16.cu (kernels/_build.py starts
// one process a source). Those files' prepare calls hand a wide shape to
// these; the launches are theirs.

#include "tc_eval.cuh"

int prepare_wide_fitness_int8(const SynthParams& sp, FitInt8Kernel* kernel) {
  return prepare_tc<true, CODES_WIDE>(PICK(fused_synth_fitness_int8_kernel), sp, kernel);
}

int prepare_wide_generation_int8(const SynthParams& sp, GenInt8Kernel* kernel) {
  return prepare_tc<true, CODES_WIDE>(PICK(fused_generation_int8_kernel), sp, kernel);
}

int prepare_wide_fitness_bf16(const SynthParams& sp, FitBf16Kernel* kernel) {
  return prepare_tc<false, CODES_WIDE>(PICK(fused_synth_fitness_bf16_kernel), sp, kernel);
}

int prepare_wide_generation_bf16(const SynthParams& sp, GenBf16Kernel* kernel) {
  return prepare_tc<false, CODES_WIDE>(PICK(fused_generation_bf16_kernel), sp, kernel);
}
