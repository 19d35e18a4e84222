// B2's launches as host calls that another source can make: B5 (evolve.cu)
// runs every generation's offspring and fitness through them, so a B5
// generation is one B2 launch by construction. fused_eval.cu defines the
// int8 pair, fused_bf16.cu the bf16 one and fused_f32.cu the f32 one (the
// one-warp layouts of int8 and bf16); fused_tp.cu and fused_tp_bf16.cu
// define the time-parallel pairs of int8 and bf16. Their extern "C" B2
// entry points are each one prepare and one launch of the same pair, so B5
// takes either layout of int8 and bf16 as B2's wrapper would.
//
// A prepare call does the host work of a launch that does not change from
// one generation to the next (the instantiation for the sine order and the
// chain length or the bank's pairs, the shared-memory attributes, the
// time-parallel block's geometry, the f32 scratch's checks and layout, the
// f32 route and synthesis layout); a run of launches calls it once. Each
// returns a CUDA error code, 0 on success; a launch returns
// cudaGetLastError() after its kernel(s).
#pragma once

#include "evaluate.cuh"

// ---- int8 (fused_eval.cu) -------------------------------------------------------

typedef void (*GenInt8Kernel)(uint32_t seed, const uint32_t* run_seeds, const float* pv,
                              const float* ps, int pop, SynthParams sp, MutateParams mp,
                              const int8_t* dft, const float* target, float* fitness,
                              float* values, float* steps);

// A launch of `runs` runs (the run axis of fused_eval.cu): parents (runs,
// mu, d), targets (runs, sp.frames, k), fitness (runs, pop) and offspring
// (runs, pop, d); run r draws with run_seeds[r] (device memory), or with
// seed when run_seeds is null (one run only).
int prepare_generation_int8(const SynthParams& sp, GenInt8Kernel* kernel);
int launch_generation_int8(GenInt8Kernel kernel, uint32_t seed, const uint32_t* run_seeds,
                           const float* pv, const float* ps, int pop, int runs,
                           const SynthParams& sp, const MutateParams& mp, const int8_t* dft,
                           const float* target, float* fitness, float* values, float* steps,
                           cudaStream_t stream);

// ---- bf16 (fused_bf16.cu) ---------------------------------------------------------

typedef void (*GenBf16Kernel)(uint32_t seed, const uint32_t* run_seeds, const float* pv,
                              const float* ps, int pop, SynthParams sp, MutateParams mp,
                              const __nv_bfloat16* dft, const float* target, float* fitness,
                              float* values, float* steps);

// The int8 pair's launch with the bf16 folded operand.
int prepare_generation_bf16(const SynthParams& sp, GenBf16Kernel* kernel);
int launch_generation_bf16(GenBf16Kernel kernel, uint32_t seed, const uint32_t* run_seeds,
                           const float* pv, const float* ps, int pop, int runs,
                           const SynthParams& sp, const MutateParams& mp, const __nv_bfloat16* dft,
                           const float* target, float* fitness, float* values, float* steps,
                           cudaStream_t stream);

// ---- int8 and bf16 in the time-parallel layout (fused_tp.cu, fused_tp_bf16.cu) --

// A time-parallel B2 kernel (fused_tp.cuh, fused_tp_bf16.cuh; the one-warp
// kernels' signature) prepared for a run of launches: the kernel for the
// fixed chain or bank, its block's threads (32 x tp_warps) and its dynamic
// shared memory (TpFamily<Kernel>::smem).
template <typename Kernel>
struct TpGeneration {
  Kernel kernel;
  int threads;
  size_t smem;
};

// The prepares return cudaErrorInvalidValue for a shape the layout does not
// take (fused_tp.cuh::tp_shape, or a code other than the fixed chains and
// banks); nothing falls back to the one-warp layout. A launch enqueues
// ceil(pop / 32) x runs blocks, with the one-warp launches' arguments.
int prepare_generation_int8_tp(const SynthParams& sp, int pop, int runs,
                               TpGeneration<GenInt8Kernel>* gen);
int launch_generation_int8_tp(const TpGeneration<GenInt8Kernel>& gen, uint32_t seed,
                              const uint32_t* run_seeds, const float* pv, const float* ps, int pop,
                              int runs, const SynthParams& sp, const MutateParams& mp,
                              const int8_t* dft, const float* target, float* fitness,
                              float* values, float* steps, cudaStream_t stream);
int prepare_generation_bf16_tp(const SynthParams& sp, int pop, int runs,
                               TpGeneration<GenBf16Kernel>* gen);
int launch_generation_bf16_tp(const TpGeneration<GenBf16Kernel>& gen, uint32_t seed,
                              const uint32_t* run_seeds, const float* pv, const float* ps, int pop,
                              int runs, const SynthParams& sp, const MutateParams& mp,
                              const __nv_bfloat16* dft, const float* target, float* fitness,
                              float* values, float* steps, cudaStream_t stream);

// ---- true f32 (fused_f32.cu) ------------------------------------------------------

typedef void (*F32SynthKernel)(const float* params, uint32_t seed, const uint32_t* run_seeds,
                               const float* pv, const float* ps, MutateParams mp, float* values,
                               float* steps, int pop, SynthParams sp, float* x, int pop_pad);

// The kernels' instantiations, their grids and their views of the scratch,
// for `runs` runs of pop candidates at sp.frames frames: frame f of run r
// is row block r * frames + f (rows (r frames + f) pop_pad ..) of the
// samples x, of the DFT's a+/a-, edge samples and group sums (on the FFT
// route, of its exact matches only) and of the FFT's per-row values.
struct F32Plan {
  F32SynthKernel synth;  // the synthesis in the layout sp.f32_tp names
  int synth_blocks, synth_threads;  // its grid's first dimension (the second is runs) and block
  int synth_smem;                   // its dynamic shared memory
  int pop, pop_pad, runs;
  int rows;  // runs x frames x pop_pad
  bool fft;  // the route: the FFT (sp.fft given), else the folded DFT
  float* x;  // the samples, rows x n
  float* frame_fit;  // the FFT route: each row's fitness, rounded once, then its exact flag
  float *ap, *am, *edge;  // the DFT's a+/a- (rows x n/2 each) and edge samples
  double* partial;  // the DFT's group sums
  float* run;  // the DFT's running U/V tiles where the sample split applies, else null
};

int prepare_generation_f32(const SynthParams& sp, int pop, int runs, float* scratch,
                           long long scratch_floats, F32Plan* plan);
int launch_f32(const F32Plan& plan, const float* params, uint32_t seed, const uint32_t* run_seeds,
               const float* pv, const float* ps, const MutateParams& mp, float* values,
               float* steps, const SynthParams& sp, const float* dft, const float* target,
               float* fitness, cudaStream_t stream);
