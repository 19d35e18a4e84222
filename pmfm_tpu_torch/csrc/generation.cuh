// B2's launches as host calls that another source can make: B5 (evolve.cu)
// runs every generation's offspring and fitness through them, so a B5
// generation is one B2 launch by construction. fused_eval.cu defines the
// int8 pair and fused_f32.cu the f32 one; their extern "C" B2 entry points
// are each one prepare and one launch of the same pair.
//
// A prepare call does the host work of a launch that does not change from
// one generation to the next (the instantiation for the sine order and the
// chain length or the bank's pairs, the shared-memory attributes, the f32 scratch's checks and
// layout); a run of launches calls it once. Each returns a CUDA error code,
// 0 on success; a launch returns cudaGetLastError() after its kernel(s).
#pragma once

#include "evaluate.cuh"

// ---- int8 (fused_eval.cu) -------------------------------------------------------

typedef void (*GenInt8Kernel)(uint32_t seed, const float* pv, const float* ps, int pop,
                              SynthParams sp, MutateParams mp, const int8_t* dft,
                              const float* target, float* fitness, float* values, float* steps);

int prepare_generation_int8(const SynthParams& sp, GenInt8Kernel* kernel);
int launch_generation_int8(GenInt8Kernel kernel, uint32_t seed, const float* pv, const float* ps,
                           int pop, const SynthParams& sp, const MutateParams& mp,
                           const int8_t* dft, const float* target, float* fitness, float* values,
                           float* steps, cudaStream_t stream);

// ---- true f32 (fused_f32.cu) ------------------------------------------------------

typedef void (*F32SynthKernel)(const float* params, uint32_t seed, const float* pv, const float* ps,
                               MutateParams mp, float* values, float* steps, int pop,
                               SynthParams sp, float* ap, float* am, float* edge);

// The three kernels' instantiation and their views of the scratch.
struct F32Plan {
  F32SynthKernel synth;
  int pop, pop_pad;
  float *ap, *am, *edge;
  double* partial;  // the group sums
  float* run;  // the DFT's running U/V tiles where the sample split applies, else null
};

int prepare_generation_f32(const SynthParams& sp, int pop, float* scratch,
                           long long scratch_floats, F32Plan* plan);
int launch_f32(const F32Plan& plan, const float* params, uint32_t seed, const float* pv,
               const float* ps, const MutateParams& mp, float* values, float* steps,
               const SynthParams& sp, const float* dft, const float* target, float* fitness,
               cudaStream_t stream);
