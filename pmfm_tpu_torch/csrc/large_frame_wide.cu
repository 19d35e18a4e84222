// B3 and B4 at the wide synthesis codes: chains of 9 .. 16 oscillators
// (WIDE_CHAIN) and every fm{k}_parallel bank (WIDE_BANK, 2 .. 8 pairs), the
// length read at run time (synth_common.cuh; large_frame.cuh has the
// kernels). In a source of their own, which nvcc builds beside
// large_frame.cu (kernels/_build.py starts one process a source); its
// entry points hand a wide shape (evaluate.cuh::wide_synth) to these.

#include "large_frame.cuh"

int synth_fold_wide(const float* params, int pop, const SynthParams& sp, void* a_plus,
                    void* a_minus, float* edge, float* mag_scale, int int8_mode,
                    int time_parallel, cudaStream_t stream) {
  return synth_fold_launch<CODES_WIDE>(params, pop, sp, a_plus, a_minus, edge, mag_scale,
                                       int8_mode, time_parallel, stream);
}

int synth_stream_wide(const float* params, int pop, const SynthParams& sp, const float* window,
                      void* out, int audio_f32, float* tot_scratch, size_t smem, int blocks,
                      cudaStream_t stream) {
  return synth_stream_launch<CODES_WIDE>(params, pop, sp, window, out, audio_f32, tot_scratch,
                                         smem, blocks, stream);
}
