// B3 and B4's entry points for Hopper (sm_90a). large_frame.cuh holds the
// kernels and their note (what bounds them on an H100, the time-parallel
// and single-pass layouts, the exactness); this file instantiates them for
// fm2 and fm3..fm8_series, large_frame_wide.cu for the wide codes (chains
// of 9 .. 16 oscillators and every fm{k}_parallel bank) and
// large_frame_long.cu for the long code (above 32 genes).

#include "large_frame.cuh"

extern "C" {

// B3: folded a+/a- int8 (int8_mode) or bf16, stored candidate-major as
// (pop, n/2) rows, edge (pop,) and mag_scale (pop,) f32 from scaled params
// (pop, d); time_parallel picks the layout (kernels/synth_fold.py::
// fold_geometry). Returns cudaGetLastError(), or cudaErrorInvalidValue for
// a time-parallel frame whose shared memory does not fit a block or a
// time-parallel launch of the long code (sp.long_code: the single pass only).
int pmfm_synth_fold(const float* params, int pop, SynthParams sp, void* a_plus, void* a_minus,
                    float* edge, float* mag_scale, int int8_mode, int time_parallel,
                    cudaStream_t stream) {
  switch (synth_set(sp, false)) {
    case CODES_LONG:
      return synth_fold_long(params, pop, sp, a_plus, a_minus, edge, mag_scale, int8_mode,
                             time_parallel, stream);
    case CODES_WIDE:
      return synth_fold_wide(params, pop, sp, a_plus, a_minus, edge, mag_scale, int8_mode,
                             time_parallel, stream);
    default:
      return synth_fold_launch<CODES_FIXED>(params, pop, sp, a_plus, a_minus, edge, mag_scale,
                                            int8_mode, time_parallel, stream);
  }
}

// B4: windowed audio (n, pop), f32 (audio_f32) or bf16, from scaled params
// (pop, d) and the window (n,). The level totals take 32 x n/128 floats a
// block of 32 candidates: shared memory up to ST_SMEM_MAX, else `scratch`,
// which then holds at least ceil(pop / 32) * 32 * n / 128 floats
// (kernels/synth_stream.py::stream_geometry). The long code (sp.long_code)
// takes a thread a candidate and no totals (synth_stream_long_kernel).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for too little
// scratch.
int pmfm_synth_stream(const float* params, int pop, SynthParams sp, const float* window,
                      void* out, int audio_f32, float* scratch, long long scratch_floats,
                      cudaStream_t stream) {
  if (sp.long_code) return synth_stream_long(params, pop, sp, window, out, audio_f32, stream);
  const int blocks = (pop + 31) / 32;
  const size_t tot_bytes = (size_t)(sp.n / TIME_BLOCK) * 32 * sizeof(float);
  const bool in_smem = tot_bytes <= ST_SMEM_MAX;
  if (!in_smem && (scratch == nullptr ||
                   scratch_floats < (long long)blocks * (long long)(tot_bytes / sizeof(float))))
    return (int)cudaErrorInvalidValue;
  const size_t smem = in_smem ? tot_bytes : 0;
  float* tot_scratch = in_smem ? nullptr : scratch;
  return wide_synth(sp, false)
             ? synth_stream_wide(params, pop, sp, window, out, audio_f32, tot_scratch, smem,
                                 blocks, stream)
             : synth_stream_launch<CODES_FIXED>(params, pop, sp, window, out, audio_f32,
                                                tot_scratch, smem, blocks, stream);
}

}  // extern "C"
