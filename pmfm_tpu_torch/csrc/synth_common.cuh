// The FM synthesis recurrence shared by every kernel of the port (B1, B2,
// B3, B4): one definition of the per-sample phase chain (synth_span, over
// any run of time blocks from given offsets, whole or one level of the
// time-parallel synthesis of large_frame.cu; synth_run, the whole frame
// from zero offsets), as the TPU kernels share
// pmfm_tpu/kernels/synth_fitness.py::_make_block_synth; the fm{k}_parallel
// bank of B1/B2 (synth_bank_span: k fm2 chains summed in pair order);
// B1/B2's candidate synthesis frame after frame (CandidateSynth); and the
// grouped fold emitter FoldEmit that B3 and B1/B2 run on them.
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
#define MAX_PAIRS 4     // fm2 pairs of an fm{k}_parallel bank (fm4_parallel: MAX_D genes)
// B1/B2's compile-time synthesis code KN (dispatch_synth): a chain of KN
// oscillators (2 .. MAX_KN), or a bank of KN - BANK_KN pairs above BANK_KN.
#define BANK_KN 16

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
  int npair;         // B1/B2: 0 for a chain, else the pairs of an fm{npair}_parallel bank
  int frames;        // B1/B2: frames of n samples a candidate synthesises in one run (>= 1)
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

// The recurrence over time blocks [b0, b1) from the offsets off[] at block
// b0, which advance in place to block b1: the one definition of the chain
// that every kernel runs. Samples come in groups of G (G divides
// TIME_BLOCK) whose loop is unrolled, so u = m % G is a compile-time
// constant in each copy of emit: an emitter can gather a group in registers
// and store it as one vector. KN, the chain's length (it must equal ch.kn),
// is fixed at compile time, so the per-sample loop over oscillators has no
// branch and the unrolled samples of a group can be interleaved (a runtime
// loop bound there cost the synthesis 4x).
//
// EMIT: the whole chain (NJ = KN - 1 modulating oscillators); emit(m, u, y)
// gets each sample m in order with y = sum_j out_c[j] w^(2j+1) of the output
// oscillator's phase (sin_c63 gives the int8 engine's 63 * sin, sin_c the
// unit sine that the float engines multiply by the amplitude).
// !EMIT: one level of the time-parallel synthesis (large_frame.cu): only
// oscillators 0 .. NJ-1 run and nothing is emitted; total(b, t) gets block
// b's total t of oscillator NJ-1's increments, the amount by which block b
// advances off[NJ] (frac(off[NJ] + t)). off[NJ] and later are neither read
// nor written: they are what the level's scan over the blocks makes.
template <int NC, int G, int KN, int NJ, bool EMIT, typename Emit, typename Total>
__device__ __forceinline__ void synth_span(const Chain& ch, const SynthParams& sp,
                                           const float* out_c, int b0, int b1,
                                           float (&off)[MAX_KN], Emit& emit, Total& total) {
  static_assert(TIME_BLOCK % G == 0, "G must divide TIME_BLOCK");
  static_assert(KN >= 2 && KN <= MAX_KN && NJ >= 1 && NJ <= KN - 1, "chain length");
  static_assert(!EMIT || NJ == KN - 1, "emitting runs the whole chain");
  for (int b = b0; b < b1; ++b) {
    float s[MAX_KN - 1];
#pragma unroll
    for (int j = 0; j < MAX_KN - 1; ++j) s[j] = 0.f;
    for (int t0 = 0; t0 < TIME_BLOCK; t0 += G) {
      const float tf0 = (float)t0;  // (float)t as tf0 + u, exact: one conversion a group
#pragma unroll
      for (int u = 0; u < G; ++u) {
        float pos = fadd(fmul(fadd(tf0, (float)u), ch.inc1), off[0]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float x = fadd(fmul(sin_turns<NC>(pos, sp.sin_c), ch.ims[j]), ch.ics[j]);
          if (EMIT || j < NJ - 1) pos = fadd(s[j], off[j + 1]);  // exclusive prefix + carried offset
          s[j] = fadd(s[j], x);
        }
        if constexpr (EMIT) emit(b * TIME_BLOCK + t0 + u, u, sin_turns<NC>(pos, out_c));
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (EMIT || j < NJ - 1) off[j + 1] = frac(fadd(off[j + 1], s[j]));
    if constexpr (!EMIT) total(b, s[NJ - 1]);
    off[0] = frac(fadd(off[0], ch.inc_blk));
  }
}

struct NoTotal {
  __device__ __forceinline__ void operator()(int, float) const {}
};
struct NoEmit {
  __device__ __forceinline__ void operator()(int, int, float) const {}
};

// The whole chain over samples 0 .. n-1 (n a multiple of TIME_BLOCK) from
// zero offsets, emitting every sample (synth_span's EMIT mode).
template <int NC, int G, int KN, typename Emit>
__device__ __forceinline__ void synth_run(const Chain& ch, const SynthParams& sp,
                                          const float* out_c, int n, Emit& emit) {
  float off[MAX_KN];
#pragma unroll
  for (int j = 0; j < MAX_KN; ++j) off[j] = 0.f;
  NoTotal none;
  synth_span<NC, G, KN, KN - 1, true>(ch, sp, out_c, 0, n / TIME_BLOCK, off, emit, none);
}

// ---- the fm{k}_parallel bank (B1, B2) -------------------------------------------

// One candidate's bank of NP fm2 pairs, pair j on genes 4j .. 4j+3 = (fm,
// index, fc, amp): each pair's make_chain constants, and its output gain.
// The int8 mode factors out s = (sum_j |amp_j|) / NP (summed in pair order,
// divided by the float32 NP) and gain_j = amp_j * (63 / (NP s + 1e-30)),
// so the summed pairs stay within +-63 and s rescales the magnitudes; the
// true-f32 mode keeps gain_j = amp_j and divides the sum by NP
// (synth_bank_span). amp is what FoldEmit multiplies a sample by and the
// int8 epilogue rescales by: s (int8), 1 (f32).
struct PairBank {
  float inc1[MAX_PAIRS], inc_blk[MAX_PAIRS], im[MAX_PAIRS], ic[MAX_PAIRS], gain[MAX_PAIRS];
  float amp;
};

template <int NP, bool INT8>
__device__ __forceinline__ PairBank make_bank(const float* p, const SynthParams& sp) {
  static_assert(NP >= 2 && NP <= MAX_PAIRS, "pairs in a bank");
  PairBank bk;
  const float inv_sr = sp.inv_sr;
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    bk.inc1[j] = frac(fmul(inv_sr, p[4 * j]));
    bk.im[j] = fmul(inv_sr, fmul(p[4 * j], p[4 * j + 1]));
    bk.ic[j] = fmul(inv_sr, p[4 * j + 2]);
    bk.inc_blk[j] = frac(fmul((float)TIME_BLOCK, bk.inc1[j]));
    bk.gain[j] = p[4 * j + 3];
  }
  bk.amp = 1.f;
  if constexpr (INT8) {
    float s = fabsf(p[3]);
#pragma unroll
    for (int j = 1; j < NP; ++j) s = fadd(s, fabsf(p[4 * j + 3]));
    s = __fdiv_rn(s, (float)NP);
    const float inv_s = __fdiv_rn(63.f, fadd(fmul((float)NP, s), 1e-30f));
#pragma unroll
    for (int j = 0; j < NP; ++j) bk.gain[j] = fmul(bk.gain[j], inv_s);
    bk.amp = s;
  }
  return bk;
}

// The bank over the time blocks [0, nb) of a frame from the carries o1[],
// o2[], which advance in place (synth_span's contract for a bank): pair j is
// synth_span's chain of two (its own two carries, the same operations)
// whose output is the unit sine times gain_j; emit(m, u, y) gets the sum
// over the pairs in pair order, divided by the float32 NP in the true-f32
// mode (!INT8), with m the sample's index in the frame. NP is fixed at
// compile time, as a chain's KN is.
template <int NC, int G, int NP, bool INT8, typename Emit>
__device__ __forceinline__ void synth_bank_span(const PairBank& bk, const SynthParams& sp, int nb,
                                                float (&o1)[NP], float (&o2)[NP], Emit& emit) {
  static_assert(TIME_BLOCK % G == 0, "G must divide TIME_BLOCK");
  for (int b = 0; b < nb; ++b) {
    float s[NP];
#pragma unroll
    for (int j = 0; j < NP; ++j) s[j] = 0.f;
    for (int t0 = 0; t0 < TIME_BLOCK; t0 += G) {
      const float tf0 = (float)t0;
#pragma unroll
      for (int u = 0; u < G; ++u) {
        float y = 0.f;
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          const float pos1 = fadd(fmul(fadd(tf0, (float)u), bk.inc1[j]), o1[j]);
          const float x = fadd(fmul(sin_turns<NC>(pos1, sp.sin_c), bk.im[j]), bk.ic[j]);
          const float o = fmul(sin_turns<NC>(fadd(s[j], o2[j]), sp.sin_c), bk.gain[j]);
          y = j == 0 ? o : fadd(y, o);
          s[j] = fadd(s[j], x);
        }
        if constexpr (!INT8) y = __fdiv_rn(y, (float)NP);
        emit(b * TIME_BLOCK + t0 + u, u, y);
      }
    }
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      o2[j] = frac(fadd(o2[j], s[j]));
      o1[j] = frac(fadd(o1[j], bk.inc_blk[j]));
    }
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
__device__ __forceinline__ __nv_bfloat16 to_bf16(float v) { return __float2bfloat16_rn(v); }

// Four integer-valued floats (|v| < 2^22) <-> four int8 lanes of a word:
// v + INT_MAGIC holds v's two's complement in its low mantissa bits, so
// full-rate adds and byte permutes do the work of quarter-rate conversions.
__device__ __forceinline__ uint32_t pack_s8x4(const float* v) {
  uint32_t b[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) b[j] = __float_as_uint(fadd(v[j], INT_MAGIC));
  return __byte_perm(__byte_perm(b[0], b[1], 0x0040), __byte_perm(b[2], b[3], 0x0040), 0x5410);
}
__device__ __forceinline__ void unpack_s8x4(uint32_t w, float* v) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = fsub(__int_as_float(0x4B400000 + ((int)(w << (24 - 8 * j)) >> 24)), INT_MAGIC);
}

// 16 consecutive elements of T as exact f32 values <-> one (int8) or two
// (bf16) 16-byte vectors; the bf16 stores round each value to nearest even.
template <bool INT8>
__device__ __forceinline__ void store_group(fold_t<INT8>* dst, const float* v) {
  uint4* out = reinterpret_cast<uint4*>(dst);
  if constexpr (INT8) {
    out[0] = make_uint4(pack_s8x4(v), pack_s8x4(v + 4), pack_s8x4(v + 8), pack_s8x4(v + 12));
  } else {
    uint32_t w[FOLD_G / 2];
#pragma unroll
    for (int i = 0; i < FOLD_G / 2; ++i)
      w[i] = (uint32_t)__bfloat16_as_ushort(to_bf16(v[2 * i])) |
             ((uint32_t)__bfloat16_as_ushort(to_bf16(v[2 * i + 1])) << 16);
    out[0] = make_uint4(w[0], w[1], w[2], w[3]);
    out[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

template <bool INT8>
__device__ __forceinline__ void load_group(const fold_t<INT8>* src, float* v) {
  const uint4* in = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int i = 0; i < (INT8 ? 1 : 2); ++i) {
    const uint4 q = in[i];
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (INT8) {
        unpack_s8x4(w[k], v + 4 * k);
      } else {
        v[8 * i + 2 * k] = __bfloat162float(__ushort_as_bfloat16((unsigned short)(w[k] & 0xFFFFu)));
        v[8 * i + 2 * k + 1] = __bfloat162float(__ushort_as_bfloat16((unsigned short)(w[k] >> 16)));
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
// synth_run<NC, FOLD_G, KN>(..., emit), then emit.fold_rows(0, false, 0.f).
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
                                         : to_f32(to_bf16(fmul(y, amp)));
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

// One candidate's synthesis as B1/B2 run it, frame after frame: a chain of
// KN oscillators, or for KN > BANK_KN a bank of KN - BANK_KN pairs, with
// the phase carries that live on from one frame to the next (frame f is
// samples [f n, (f + 1) n) of one continuous synthesis: its blocks start
// from the offsets where frame f - 1 ended, as a block starts from where
// the block before it ended). init() makes the constants, zeroes the
// carries and returns the amplitude the int8 magnitudes are rescaled by
// (Chain::amp, PairBank::amp); frame() runs the next frame's n samples
// into emit, each with its index in the frame.
template <int NC, int KN, bool INT8, bool BANK = (KN > BANK_KN)>
struct CandidateSynth;

template <int NC, int KN, bool INT8>
struct CandidateSynth<NC, KN, INT8, false> {
  Chain ch;
  float off[MAX_KN];
  __device__ __forceinline__ float init(const float* p, const SynthParams& sp) {
    ch = make_chain(p, sp);
#pragma unroll
    for (int j = 0; j < MAX_KN; ++j) off[j] = 0.f;
    return ch.amp;
  }
  template <typename Emit>
  __device__ __forceinline__ void frame(const SynthParams& sp, Emit& emit) {
    NoTotal none;
    synth_span<NC, FOLD_G, KN, KN - 1, true>(ch, sp, INT8 ? sp.sin_c63 : sp.sin_c, 0,
                                             sp.n / TIME_BLOCK, off, emit, none);
  }
};

template <int NC, int KN, bool INT8>
struct CandidateSynth<NC, KN, INT8, true> {
  static constexpr int NP = KN - BANK_KN;
  PairBank bk;
  float o1[NP], o2[NP];
  __device__ __forceinline__ float init(const float* p, const SynthParams& sp) {
    bk = make_bank<NP, INT8>(p, sp);
#pragma unroll
    for (int j = 0; j < NP; ++j) o1[j] = o2[j] = 0.f;
    return bk.amp;
  }
  template <typename Emit>
  __device__ __forceinline__ void frame(const SynthParams& sp, Emit& emit) {
    synth_bank_span<NC, FOLD_G, NP, INT8>(bk, sp, sp.n / TIME_BLOCK, o1, o2, emit);
  }
};

template <typename K>
static cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}
