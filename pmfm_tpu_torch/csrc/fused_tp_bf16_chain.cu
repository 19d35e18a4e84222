// B1 and B2 bf16's time-parallel layout (fused_tp_bf16.cuh) on the fixed
// chains: fm2 and fm3_series .. fm8_series (codes 2 .. FIXED_KN) at sine
// orders 5, 7 and 9. A source of its own,
// which nvcc builds beside fused_tp_bf16.cu (the banks and the entries,
// which hand a chain to prepare_tp_chain), so that neither half is the
// build's longest pole.
//
// Replaces, with fused_bf16.cu's kernels, the bf16 mode of the TPU kernels
//   B1 <- pmfm_tpu/kernels/synth_fitness.py::fused_synth_fitness
//   B2 <- pmfm_tpu/kernels/generation.py::fused_generation

#include "fused_tp_bf16.cuh"

int prepare_tp_chain(const SynthParams& sp, GenBf16Kernel* kernel) {
  return prepare_tp<true>(sp, kernel);
}

int prepare_tp_chain(const SynthParams& sp, FitBf16Kernel* kernel) {
  return prepare_tp<true>(sp, kernel);
}
