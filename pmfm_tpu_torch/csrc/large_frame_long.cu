// B3 and B4 at the long synthesis code (LONG_CODE, synth_common.cuh::
// LongSynth: a chain or a bank of any length, the topologies above 32
// genes; its carries in the wrapper's long scratch, a row a candidate): B3
// in its single pass (synth_fold_kernel, a thread a candidate, B1/B2's
// synthesis of one frame and fold emitter), B4 as synth_stream_long_kernel
// (large_frame.cuh). In a source of their own, which nvcc builds beside
// large_frame.cu and large_frame_wide.cu; its entry points hand a long shape
// (sp.long_code) to these.

#include "large_frame.cuh"

int synth_fold_long(const float* params, int pop, const SynthParams& sp, void* a_plus,
                    void* a_minus, float* edge, float* mag_scale, int int8_mode,
                    int time_parallel, cudaStream_t stream) {
  return synth_fold_launch<CODES_LONG>(params, pop, sp, a_plus, a_minus, edge, mag_scale,
                                       int8_mode, time_parallel, stream);
}

int synth_stream_long(const float* params, int pop, const SynthParams& sp, const float* window,
                      void* out, int audio_f32, cudaStream_t stream) {
  return dispatch_ncoef(sp.ncoef, [&](auto nc) {
    return dispatch_synth<false, CODES_LONG>(sp, [&](auto) {
      constexpr int NC = decltype(nc)::value;
      const int blocks = (pop + SL_TPB - 1) / SL_TPB;
      if (audio_f32)
        synth_stream_long_kernel<NC, true><<<blocks, SL_TPB, 0, stream>>>(params, pop, sp, window,
                                                                         out);
      else
        synth_stream_long_kernel<NC, false><<<blocks, SL_TPB, 0, stream>>>(params, pop, sp,
                                                                          window, out);
      return (int)cudaGetLastError();
    });
  });
}
