// Fused FM synthesis + folded DFT + L2 spectral fitness for Hopper (sm_90a),
// with and without an in-kernel offspring prologue, in the int8 mode.
//
// Replaces two TPU kernels of pmfm_tpu:
//   B1 <- kernels/synth_fitness.py::fused_synth_fitness (with _dft_uv, the
//         folded DFT on the MXU)
//   B2 <- kernels/generation.py::fused_generation
// as fused_synth_fitness_int8_kernel and fused_generation_int8_kernel
// (tc_eval.cuh) in the int8 mode; fused_wide.cu instantiates them for the
// wide codes (chains of 9 .. 16, banks of 6 .. 8). The bf16 mode of both is
// fused_bf16.cu's (the same design, one template in tc_eval.cuh), the
// true-f32 mode fused_f32.cu's.
//
// The int8 mode. What bounds it on an H100 at the bench shape (n 1024, K 512,
// P 2^15): the folded DFT is 2 * 2K * (N/2) * P = 34.4 G int8 operations
// (17 us at the int8 tensor-core peak of 1,979 TOP/s) and the synthesis ~1.7 G
// f32 operations (25 us at 67 TFLOP/s): 25 us. The design:
//
// * One warp a block, TC_CPB = 32 candidates, thread t synthesising
//   candidate t: synth_run<NC, FOLD_G, KN> with the chain length KN fixed at
//   compile time (a runtime loop bound there cost the synthesis 4x), or for
//   fm{k}_parallel synth_bank_span with the pair count fixed the same way
//   (synth_common.cuh::CandidateSynth; KN = BANK_KN + k), and the
//   grouped fold emitter (synth_common.cuh::FoldEmit, B3's), which stores
//   whole 16-byte groups of the thread's rows of a+ and a- in shared memory
//   (32 x n bytes a block: 32 KB at n 1024, so six blocks an SM). The sample
//   order and every operation are synth_run's, so the audio is bit-equal to
//   kernels/synth_fitness.py::synth_int8_plain.
// * The folded DFT, U = a+ C^T and V = a- S^T, runs on the int8 tensor cores:
//   mma.sync m16n8k32 s8 x s8 -> s32, exact int32 sums. A is the warp's a+ (a-), two m-tiles of
//   16 candidates; B is the (2K, N/2) operand as it is, each bin's samples
//   contiguous (the .col layout), 32 bins a pass. Per 64-sample step thread
//   (g, c) reads 16 bytes of each of its A rows and of its B column, samples
//   16c .. 16c+15 of the step, and two mma consume them: A and B share that
//   permutation of the contraction index, so the sums are the same. Row r of
//   a+/- keeps its 16-byte units XOR-swizzled by ((r & 1) << 2) | ((r >> 1) & 3),
//   so the synthesis stores (32 rows, one unit) and the fragment loads (rows
//   g and g + 1 of a phase, units 4j .. 4j+3) are free of bank conflicts. B
//   is read straight from L2 (L1), 16 bytes a thread, one step ahead of its
//   use. (Staging B through a cp.async ring shared by 2-3 warps a block cut
//   the L2 traffic 2-3x but was slower at P 2^15: PERF.md §6.)
// * The epilogue: each bin's term (the edge term 127 (-1)^k x[N/2], the
//   magnitude, the |amp| * dft_scale rescale, the squared difference) is
//   computed by the thread that holds the bin's U and V; four rounds of
//   shuffles hand a row's terms to the row's owner, which adds them in
//   ascending k one __fadd_rn at a time. B5 (evolve.cu) runs this kernel for
//   each of its int8 generations, through generation.cuh.
// * B2's prologue: the block's 32 x d (candidate, gene) pairs are spread
//   over its 32 threads (evaluate.cuh::offspring_gene; values and steps are
//   written coalesced) and the scaled parameters reach the synthesising
//   thread through shared memory.
// * Integer-valued floats are rounded and packed to and from int8 with
//   INT_MAGIC (full-rate adds and byte permutes, not quarter-rate
//   conversions).
// * Multi-frame fitness (sp.frames = F > 1, the reference's num_frames; the
//   frame loop of _evaluate_block): a candidate synthesises F n continuous
//   samples, and each frame is folded, transformed against its own target
//   row and summed before the next frame is synthesised into the same
//   shared memory (tc_eval.cuh::evaluate_tc's frame loop): shared memory stays
//   32 x n bytes whatever F. The frames' totals are added in float32 in
//   frame order, as the reference adds them. One instantiation serves every
//   F: the frame count is a runtime bound outside the per-sample loop, and
//   at F = 1 it timed within 3% of a one-frame instantiation (PERF.md §6).
// * The run axis (the port's counterpart of the reference's vmap over the
//   pallas_call, match_many): one launch takes B independent runs as a
//   second grid dimension, run r with its own candidates or parents, target
//   rows and Philox seed, so a batched launch is bit-equal, run for run, to
//   B lone launches.
// * What is left: at P 2^15 the grid is 1024 warps over 792 resident slots
//   (shared memory holds six blocks an SM), and the second round's warps run
//   alone on their SMs.
//
// A thread past the population's end synthesises zero parameters and its
// fitness is dropped; the block needs no barrier but __syncwarp. Exact for
// finite phases: a candidate whose phases overflow to inf/NaN (parameters
// near 1e38) may round its NaN samples to other bytes than rintf would.

#include "tc_eval.cuh"

// ---- launchers ------------------------------------------------------------------

int prepare_generation_int8(const SynthParams& sp, GenInt8Kernel* kernel) {
  return prepare_tc_any<true>(PICK(fused_generation_int8_kernel), prepare_wide_generation_int8,
                              prepare_long_generation_int8, sp, kernel);
}

int launch_generation_int8(GenInt8Kernel kernel, uint32_t seed, const uint32_t* run_seeds,
                           const float* pv, const float* ps, int pop, int runs,
                           const SynthParams& sp, const MutateParams& mp, const int8_t* dft,
                           const float* target, float* fitness, float* values, float* steps,
                           cudaStream_t stream) {
  if (runs > 1 && !run_seeds) return (int)cudaErrorInvalidValue;
  return launch_tc<true>(kernel, sp, pop, runs, stream, seed, run_seeds, pv, ps, pop, sp, mp, dft,
                         target, fitness, values, steps);
}

extern "C" {

const char* pmfm_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// B1 int8: fitness (runs, pop) of scaled params (runs, pop, d) against the
// int8 folded operand (2k, n/2) and the targets (runs, sp.frames, k).
// Returns cudaGetLastError().
int pmfm_fused_synth_fitness(const float* params, int pop, int runs, SynthParams sp,
                             const void* dft, const float* target, float* fitness,
                             cudaStream_t stream) {
  FitInt8Kernel kernel;
  const int e = prepare_tc_any<true>(PICK(fused_synth_fitness_int8_kernel),
                                     prepare_wide_fitness_int8, prepare_long_fitness_int8, sp,
                                     &kernel);
  return e ? e
           : launch_tc<true>(kernel, sp, pop, runs, stream, params, pop, sp, (const int8_t*)dft,
                             target, fitness);
}

// B2 int8: one generation's offspring (runs, pop, d) values and steps from
// the parents (runs, mu, d), and their fitness (runs, pop), against the
// targets (runs, sp.frames, k); run r draws with run_seeds[r] (device
// memory; null for one run, which draws with seed). Returns
// cudaGetLastError().
int pmfm_fused_generation(uint32_t seed, const uint32_t* run_seeds, const float* pv,
                          const float* ps, int pop, int runs, SynthParams sp, MutateParams mp,
                          const void* dft, const float* target, float* fitness, float* values,
                          float* steps, cudaStream_t stream) {
  GenInt8Kernel kernel;
  const int e = prepare_generation_int8(sp, &kernel);
  return e ? e
           : launch_generation_int8(kernel, seed, run_seeds, pv, ps, pop, runs, sp, mp,
                                    (const int8_t*)dft, target, fitness, values, steps, stream);
}

}  // extern "C"
