// The FM synthesis recurrence shared by every kernel of the port (B1, B2,
// B3, B4): one definition of the per-sample phase chain, as the TPU kernels
// share pmfm_tpu/kernels/synth_fitness.py::_make_block_synth; and the
// grouped fold emitter FoldEmit that B3 and the int8 B1/B2 run on it.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

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
// can gather a group in registers and store it as one vector. KN > 0 fixes
// the chain's length at compile time (it must equal ch.kn): the per-sample
// loop over oscillators then has no branch, and the unrolled samples of a
// group can be interleaved; KN = 0 reads it from ch.kn.
template <int NC, int G = 1, int KN = 0, typename Emit>
__device__ __forceinline__ void synth_run(const Chain& ch, const SynthParams& sp,
                                          const float* out_c, int n, Emit& emit) {
  static_assert(TIME_BLOCK % G == 0, "G must divide TIME_BLOCK");
  const int kn = KN ? KN : ch.kn;
  float off[MAX_KN];
#pragma unroll
  for (int j = 0; j < MAX_KN; ++j) off[j] = 0.f;
  for (int b = 0; b < n / TIME_BLOCK; ++b) {
    float s[MAX_KN - 1];
#pragma unroll
    for (int j = 0; j < MAX_KN - 1; ++j) s[j] = 0.f;
    for (int t0 = 0; t0 < TIME_BLOCK; t0 += G) {
      const float tf0 = (float)t0;  // (float)t as tf0 + u, exact: one conversion a group
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const int t = t0 + u;
        float pos = fadd(fmul(fadd(tf0, (float)u), ch.inc1), off[0]);
#pragma unroll
        for (int j = 0; j < MAX_KN - 1; ++j) {
          if (j < kn - 1) {
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
      if (j < kn - 1) off[j + 1] = frac(fadd(off[j + 1], s[j]));
    off[0] = frac(fadd(off[0], ch.inc_blk));
  }
}

// The scaled parameters of candidate `cand` of a (pop, d) row-major array.
__device__ __forceinline__ void load_params(float* p, const float* __restrict__ params,
                                            int cand, int d) {
#pragma unroll
  for (int i = 0; i < MAX_D; ++i) p[i] = i < d ? params[(size_t)cand * d + i] : 0.f;
}

// ---- the grouped fold emitter (B1, B2 and B3) ---------------------------------

#define FOLD_G 16  // samples per group of the fold emitter: one 16-byte vector of int8
// 1.5 * 2^23 (bits 0x4B400000): for |v| < 2^22, v + INT_MAGIC rounds v to the
// nearest integer (ties to even) in the low mantissa bits, on the full-rate
// add pipe where rintf and int conversions take the quarter-rate one.
#define INT_MAGIC 12582912.f

template <bool INT8>
using fold_t = typename std::conditional<INT8, int8_t, __nv_bfloat16>::type;

__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <bool INT8>
__device__ __forceinline__ fold_t<INT8> from_f32(float v);
template <>
__device__ __forceinline__ int8_t from_f32<true>(float v) { return (int8_t)(int)v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<false>(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ uint32_t lane_bits(int8_t v) { return (uint32_t)(uint8_t)v; }
__device__ __forceinline__ uint32_t lane_bits(__nv_bfloat16 v) {
  return (uint32_t)__bfloat16_as_ushort(v);
}

// 16 consecutive elements of T as exact f32 values <-> one (int8) or two
// (bf16) 16-byte vectors; the stores round each value with from_f32.
template <bool INT8>
__device__ __forceinline__ void store_group(fold_t<INT8>* dst, const float* v) {
  constexpr int PER_WORD = INT8 ? 4 : 2, BITS = 32 / PER_WORD;
  uint32_t w[FOLD_G / PER_WORD];
#pragma unroll
  for (int i = 0; i < FOLD_G / PER_WORD; ++i) {
    w[i] = 0u;
#pragma unroll
    for (int j = 0; j < PER_WORD; ++j)
      w[i] |= lane_bits(from_f32<INT8>(v[i * PER_WORD + j])) << (BITS * j);
  }
  uint4* out = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int i = 0; i < FOLD_G / PER_WORD / 4; ++i)
    out[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
}

template <bool INT8>
__device__ __forceinline__ void load_group(const fold_t<INT8>* src, float* v) {
  constexpr int PER_WORD = INT8 ? 4 : 2, BITS = 32 / PER_WORD;
  const uint4* in = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int i = 0; i < FOLD_G / PER_WORD / 4; ++i) {
    const uint4 q = in[i];
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int j = 0; j < PER_WORD; ++j) {
        const uint32_t b = (w[k] >> (BITS * j)) & ((1u << BITS) - 1u);
        v[(4 * i + k) * PER_WORD + j] =
            INT8 ? (float)(int8_t)(uint8_t)b
                 : __bfloat162float(__ushort_as_bfloat16((unsigned short)b));
      }
    }
  }
}

// A candidate's row of a+ or a- as consecutive elements (B3: device memory).
template <bool INT8>
struct LinearRow {
  fold_t<INT8>* p;
  __device__ __forceinline__ void store(int s, const float* v) const { store_group<INT8>(p + s, v); }
  __device__ __forceinline__ void load(int s, float* v) const { load_group<INT8>(p + s, v); }
};

// The grouped fold emitter (B3, and B1/B2 in both modes): quantises each sample,
// stores the first half, folds the second; one candidate's row of a+ and
// a-, written and read FOLD_G samples at a time through `Row` (s, the first
// sample of a group, is a multiple of FOLD_G). Run it as
// synth_run<NC, FOLD_G>(..., emit), then emit.fold_rows(0, false, 0.f).
//
// Samples come in groups of FOLD_G. The first half of the frame goes
// straight to a+. Each group of FOLD_G second-half samples completes FOLD_G
// rows of the fold: rows [N-m0, N-m0+FOLD_G) pair the group's first sample
// m0 with the previous group's last FOLD_G-1 (the edge sample m = N/2 shifts
// the second half's groups by one, so a group never maps onto whole rows),
// so the thread keeps the previous group in registers, reads the FOLD_G
// first-half samples of those rows back from its own row of a+ (a load
// issued one group ahead, to hide its latency) and writes the sums and
// differences; rows [0, FOLD_G) complete after the last sample. A thread
// reads only what it wrote itself, so no barrier is needed.
// A Row type that keeps the audio in exact float32 (B1/B2 true f32,
// fused_f32.cu) specialises this to true: FoldEmit then stores y * amp
// unrounded. The int8 and bf16 rows keep their own branch.
template <typename Row>
struct exact_f32_row : std::false_type {};

template <bool INT8, typename Row = LinearRow<INT8>>
struct FoldEmit {
  Row ap, am;
  int n, half;
  float amp, edge_q;
  float cur[FOLD_G], prev[FOLD_G], old[FOLD_G];

  // rows [s, s + FOLD_G): row s + i pairs with sample N - s - i, which is
  // prev[FOLD_G - i] for i > 0 and `first` (when there is one) for i = 0
  __device__ __forceinline__ void fold_rows(int s, bool has_first, float first) {
    float plus[FOLD_G], minus[FOLD_G];
#pragma unroll
    for (int i = 0; i < FOLD_G; ++i) {
      const float x = i == 0 ? (has_first ? first : 0.f) : prev[FOLD_G - i];
      plus[i] = fadd(old[i], x);
      minus[i] = fsub(old[i], x);
    }
    ap.store(s, plus);
    am.store(s, minus);
  }

  __device__ __forceinline__ void operator()(int m, int u, float y) {
    // int8: round(63 sin) to nearest even as an exact float, by adding and
    // taking away INT_MAGIC (|y| < 64, so it is rintf(y), with -0 made +0);
    // bf16: the audio rounded to bf16; an exact f32 row: the audio as it is
    cur[u] = INT8                        ? fsub(fadd(y, INT_MAGIC), INT_MAGIC)
             : exact_f32_row<Row>::value ? fmul(y, amp)
                                         : to_f32(from_f32<false>(fmul(y, amp)));
    const int m0 = m - u;
    if (m0 < half) {
      if (u == FOLD_G - 1) ap.store(m0, cur);
      return;
    }
    if (u == 0) {
      if (m0 == half)
        edge_q = cur[0];
      else
        fold_rows(n - m0, true, cur[0]);
      ap.load(n - m0 - FOLD_G, old);  // the next group's rows
    }
    if (u == FOLD_G - 1) {
#pragma unroll
      for (int i = 0; i < FOLD_G; ++i) prev[i] = cur[i];
    }
  }
};

template <typename K>
static cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}
