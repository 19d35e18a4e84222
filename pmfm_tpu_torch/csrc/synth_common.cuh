// The FM synthesis recurrence shared by every kernel of the port (B1, B2,
// B3, B4): one definition of the per-sample phase chain, as the TPU kernels
// share pmfm_tpu/kernels/synth_fitness.py::_make_block_synth.
//
// Numerics (the TPU kernel's, in sample order). Phases are kept in turns
// (phase / wavetable size), so the wrap is frac(x) = x - floor(x). Samples
// run in blocks of TIME_BLOCK = 128; inside a block each modulated
// oscillator's phase is the exclusive prefix sum of the previous
// oscillator's increments plus a carried offset, summed in sample order
// (the TPU kernel used a triangular matmul), and at the end of the block
// the offsets advance by the block total and are frac'd. The oscillator is
// an odd polynomial in turns (sin_turns). Every f32 multiply and add uses
// __fmul_rn / __fadd_rn, so nvcc contracts nothing into an FMA and the
// PyTorch plain versions (kernels/synth_fitness.py::synth_blocks_plain)
// reproduce every sample bit for bit.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define TIME_BLOCK 128  // samples per phase-carry block (the TPU kernel's C)
#define MAX_KN 8        // oscillators in a chain (fm8_series)
#define MAX_D 16        // parameters per candidate

struct SynthParams {
  float sin_c[5];    // odd coefficients of sin(2 pi w), w in [-0.5, 0.5] turns
  float sin_c63[5];  // the same coefficients times 63 (the int8 output oscillator)
  int ncoef;         // 3, 4 or 5 (sine order 5, 7, 9)
  int n;             // frame length
  int k;             // bins (B1/B2: the operand has 2k rows of n/2 bytes)
  int d;             // parameters per candidate
  int kn;            // oscillators in the chain (2 for fm2)
  int fm2;           // 1: fm2 parameter layout, 0: fm{kn}_series
  float inv_sr;      // 1 / sample_rate, as f32
  float dft_scale;   // SpectrumOps.dft_packed_scale (0 outside the int8 engine)
  float edge_norm;   // B1/B2 true-f32 mode: 2 * norm, the x[N/2] edge coefficient's size
};

__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float frac(float x) { return fsub(x, floorf(x)); }

// scale * sin(2 pi x) for any x: round-reduce to [-0.5, 0.5] turns, then the
// odd polynomial, Horner in w^2 from the top coefficient (_sin_turns).
template <int NC>
__device__ __forceinline__ float sin_turns(float x, const float* c) {
  float w = fsub(x, floorf(fadd(x, 0.5f)));
  float w2 = fmul(w, w);
  float acc = c[NC - 1];
#pragma unroll
  for (int j = NC - 2; j >= 0; --j) acc = fadd(c[j], fmul(w2, acc));
  return fmul(w, acc);
}

// One candidate's chain constants: the first oscillator's increment, each
// modulated oscillator's gain and bias in turns per sample, and the output
// amplitude (the last operator's freq * index; fm2's amp parameter).
struct Chain {
  float inc1, inc_blk, amp;
  float ims[MAX_KN - 1], ics[MAX_KN - 1];
  int kn;
};

__device__ __forceinline__ Chain make_chain(const float* p, const SynthParams& sp) {
  Chain ch;
  const float inv_sr = sp.inv_sr;
  ch.kn = sp.kn;
#pragma unroll
  for (int j = 0; j < MAX_KN - 1; ++j) ch.ims[j] = ch.ics[j] = 0.f;
  if (sp.fm2) {
    ch.inc1 = frac(fmul(inv_sr, p[0]));
    ch.ims[0] = fmul(inv_sr, fmul(p[0], p[1]));
    ch.ics[0] = fmul(inv_sr, p[2]);
    ch.amp = p[3];
  } else {
    ch.inc1 = frac(fmul(inv_sr, p[1]));
    ch.amp = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_KN - 1; ++j) {
      if (j < ch.kn - 1) {
        ch.ims[j] = fmul(inv_sr, fmul(p[2 * j], p[2 * j + 1]));
        ch.ics[j] = fmul(inv_sr, p[2 * j + 3]);
      }
    }
#pragma unroll
    for (int j = 0; j < MAX_KN; ++j)
      if (j == ch.kn - 1) ch.amp = fmul(p[2 * j], p[2 * j + 1]);
  }
  ch.inc_blk = frac(fmul((float)TIME_BLOCK, ch.inc1));
  return ch;
}

// Runs the chain over samples 0 .. n-1 (n a multiple of TIME_BLOCK) and calls
// emit(m, u, y) for each sample m in order, with y = sum_j out_c[j] w^(2j+1)
// of the output oscillator's phase: sin_c63 gives the int8 engine's 63 * sin,
// sin_c the unit sine that the float engines multiply by the amplitude.
// Samples come in groups of G (G divides TIME_BLOCK) whose loop is unrolled,
// so u = m % G is a compile-time constant in each copy of emit: an emitter
// can gather a group in registers and store it as one vector.
template <int NC, int G = 1, typename Emit>
__device__ __forceinline__ void synth_run(const Chain& ch, const SynthParams& sp,
                                          const float* out_c, int n, Emit& emit) {
  static_assert(TIME_BLOCK % G == 0, "G must divide TIME_BLOCK");
  float off[MAX_KN];
#pragma unroll
  for (int j = 0; j < MAX_KN; ++j) off[j] = 0.f;
  for (int b = 0; b < n / TIME_BLOCK; ++b) {
    float s[MAX_KN - 1];
#pragma unroll
    for (int j = 0; j < MAX_KN - 1; ++j) s[j] = 0.f;
    for (int t0 = 0; t0 < TIME_BLOCK; t0 += G) {
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const int t = t0 + u;
        float pos = fadd(fmul((float)t, ch.inc1), off[0]);
#pragma unroll
        for (int j = 0; j < MAX_KN - 1; ++j) {
          if (j < ch.kn - 1) {
            const float x = fadd(fmul(sin_turns<NC>(pos, sp.sin_c), ch.ims[j]), ch.ics[j]);
            pos = fadd(s[j], off[j + 1]);  // exclusive prefix + carried offset
            s[j] = fadd(s[j], x);
          }
        }
        emit(b * TIME_BLOCK + t, u, sin_turns<NC>(pos, out_c));
      }
    }
#pragma unroll
    for (int j = 0; j < MAX_KN - 1; ++j)
      if (j < ch.kn - 1) off[j + 1] = frac(fadd(off[j + 1], s[j]));
    off[0] = frac(fadd(off[0], ch.inc_blk));
  }
}

// The scaled parameters of candidate `cand` of a (pop, d) row-major array.
__device__ __forceinline__ void load_params(float* p, const float* __restrict__ params,
                                            int cand, int d) {
#pragma unroll
  for (int i = 0; i < MAX_D; ++i) p[i] = i < d ? params[(size_t)cand * d + i] : 0.f;
}

template <typename K>
static cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}
