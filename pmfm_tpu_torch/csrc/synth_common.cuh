// The FM synthesis recurrence shared by every kernel of the port (B1, B2,
// B3, B4): one definition of the per-sample phase chain (synth_span, over
// any run of time blocks from given offsets, whole or one level of the
// time-parallel synthesis of large_frame.cu; synth_run, the whole frame
// from zero offsets), as the TPU kernels share
// pmfm_tpu/kernels/synth_fitness.py::_make_block_synth; the fm{k}_parallel
// bank (synth_bank_span: k fm2 chains summed in pair order); the candidate
// synthesis frame after frame (CandidateSynth) of B1/B2 and B3's single
// pass; the grouped fold emitter FoldEmit that B3 and B1/B2 int8 and bf16
// run on them, and the true-f32 B1/B2's row emitter XRowEmit.
// Each array is sized by its synthesis code's own slots (chain_slots,
// bank_slots, synth_dims), so raising the caps to 32 genes costs a chain of
// three nothing. Above 32 genes a third code, LONG_CODE (LongSynth), takes
// any length with a bounded tile of state in registers.
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
#define MAX_KN 16       // oscillators in a chain (fm16_series: MAX_D genes)
#define MAX_D 32        // parameters per candidate
#define MAX_PAIRS 8     // fm2 pairs of an fm{k}_parallel bank (fm8_parallel: MAX_D genes)
// The synthesis code KN, every kernel's compile-time template argument: a
// chain of KN oscillators (2 .. MAX_KN), or a bank of KN - BANK_KN pairs
// above BANK_KN. Two codes take the length at run time instead, their
// state in registers of the longest shape and each oscillator or pair past
// the length skipped by a warp-uniform branch: WIDE_CHAIN, a chain of sp.kn
// oscillators, and WIDE_BANK, a bank of sp.npair pairs (dispatch_synth,
// evaluate.cuh, says which shapes take them). One such instantiation serves
// every length where a compile-time one each would multiply nvcc's time.
#define BANK_KN 32
#define WIDE_CHAIN 0
#define WIDE_BANK BANK_KN
// The long code (sp.long_code): a chain or a bank of any length, run in
// segments of LONG_CHAIN_SEG modulating oscillators or LONG_BANK_SEG pairs
// whose state sits in registers, the carries in a scratch of the wrapper's
// (LongSynth). The host sets it above 32 genes (and, to hold it against the
// wide codes, wherever a check asks).
#define LONG_CODE (-1)
#define LONG_CHAIN_SEG 8
#define LONG_BANK_SEG 4
#define LONG_ROW_PAD 128  // B1/B2: a run's rows of the long scratch, the population padded

// A code's slots: oscillators of a chain (chain_slots) or pairs of a bank
// (bank_slots), and the parameters of a candidate (synth_dims).
__host__ __device__ constexpr int chain_slots(int kn) { return kn == WIDE_CHAIN ? MAX_KN : kn; }
__host__ __device__ constexpr int bank_slots(int kn) {
  return kn == WIDE_BANK ? MAX_PAIRS : kn - BANK_KN;
}
__host__ __device__ constexpr bool is_bank(int kn) { return kn >= BANK_KN; }
__host__ __device__ constexpr int synth_dims(int kn) {
  return is_bank(kn) ? 4 * bank_slots(kn) : 2 * chain_slots(kn);
}

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
  int npair;         // 0 for a chain, else the pairs of an fm{npair}_parallel bank
  int frames;        // B1/B2: frames of n samples a candidate synthesises in one run (>= 1)
  int long_code;     // 1: the long code (LONG_CODE) runs the synthesis, whatever its length
  int lrows;         // the long code's scratch rows (a synthesising thread's row each)
  float* lscr;       // the long code's scratch: lrows x d params, then d x lrows carries
  int f32_tp;        // B1/B2 true f32: 1, the time-parallel synthesis (fused_f32_tp.cu)
  const float* fft;  // B1/B2 true f32: the FFT's window and twiddles (fused_f32.cu), null: the DFT
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
// amplitude (the last operator's freq * index; fm2's amp parameter). The
// arrays hold the code's own slots (chain_slots), so a chain of three keeps
// two gains and biases, not MAX_KN - 1.
template <int KN>
struct Chain {
  static constexpr int S = chain_slots(KN);  // oscillators
  float inc1, inc_blk, amp;
  float ims[S - 1], ics[S - 1];
  int kn;  // KN, or a wide chain's sp.kn
};

template <int KN>
__device__ __forceinline__ Chain<KN> make_chain(const float* p, const SynthParams& sp) {
  constexpr int S = Chain<KN>::S;
  Chain<KN> ch;
  const float inv_sr = sp.inv_sr;
  ch.kn = KN == WIDE_CHAIN ? sp.kn : KN;
#pragma unroll
  for (int j = 0; j < S - 1; ++j) ch.ims[j] = ch.ics[j] = 0.f;
  if (sp.fm2) {
    ch.inc1 = frac(fmul(inv_sr, p[0]));
    ch.ims[0] = fmul(inv_sr, fmul(p[0], p[1]));
    ch.ics[0] = fmul(inv_sr, p[2]);
    ch.amp = p[3];
  } else {
    ch.inc1 = frac(fmul(inv_sr, p[1]));
    ch.amp = 0.f;
#pragma unroll
    for (int j = 0; j < S - 1; ++j) {
      if (j < ch.kn - 1) {
        ch.ims[j] = fmul(inv_sr, fmul(p[2 * j], p[2 * j + 1]));
        ch.ics[j] = fmul(inv_sr, p[2 * j + 3]);
      }
    }
#pragma unroll
    for (int j = 0; j < S; ++j)
      if (j == ch.kn - 1) ch.amp = fmul(p[2 * j], p[2 * j + 1]);
  }
  ch.inc_blk = frac(fmul((float)TIME_BLOCK, ch.inc1));
  return ch;
}

// The template argument NJ of synth_span's emitting pass (a wide chain's is
// the runtime nj instead).
__host__ __device__ constexpr int emit_nj(int kn) { return kn == WIDE_CHAIN ? 1 : kn - 1; }

// The recurrence over time blocks [b0, b1) from the offsets off[] at block
// b0, which advance in place to block b1: the one definition of the chain
// that every kernel runs. Samples come in groups of G (G divides
// TIME_BLOCK) whose loop is unrolled, so u = m % G is a compile-time
// constant in each copy of emit: an emitter can gather a group in registers
// and store it as one vector. KN, the chain's length (it must equal ch.kn),
// is fixed at compile time, so the per-sample loop over oscillators has no
// branch and the unrolled samples of a group can be interleaved (a runtime
// loop bound there cost the synthesis 4x). A wide chain (KN = WIDE_CHAIN)
// runs nj_wide oscillators in place of NJ: the loop is unrolled over every
// slot and each slot from nj_wide on is skipped by a branch that all
// threads of a launch take alike, so its state stays in registers.
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
__device__ __forceinline__ void synth_span(const Chain<KN>& ch, const SynthParams& sp,
                                           const float* out_c, int b0, int b1,
                                           float (&off)[Chain<KN>::S], Emit& emit,
                                           Total& total, int nj_wide = 0) {
  constexpr bool WIDE = KN == WIDE_CHAIN;
  constexpr int S = Chain<KN>::S;
  constexpr int JS = WIDE ? S - 1 : NJ;  // the unrolled oscillators
  static_assert(TIME_BLOCK % G == 0, "G must divide TIME_BLOCK");
  static_assert(WIDE || (KN >= 2 && KN <= MAX_KN && NJ >= 1 && NJ <= KN - 1), "chain length");
  static_assert(WIDE || !EMIT || NJ == KN - 1, "emitting runs the whole chain");
  const int nj = WIDE ? nj_wide : NJ;
  for (int b = b0; b < b1; ++b) {
    float s[S - 1];
#pragma unroll
    for (int j = 0; j < S - 1; ++j) s[j] = 0.f;
    for (int t0 = 0; t0 < TIME_BLOCK; t0 += G) {
      const float tf0 = (float)t0;  // (float)t as tf0 + u, exact: one conversion a group
#pragma unroll
      for (int u = 0; u < G; ++u) {
        float pos = fadd(fmul(fadd(tf0, (float)u), ch.inc1), off[0]);
#pragma unroll
        for (int j = 0; j < JS; ++j) {
          if (j < nj) {
            const float x = fadd(fmul(sin_turns<NC>(pos, sp.sin_c), ch.ims[j]), ch.ics[j]);
            // the exclusive prefix plus the carried offset
            if (EMIT || j < nj - 1) pos = fadd(s[j], off[j + 1]);
            s[j] = fadd(s[j], x);
          }
        }
        if constexpr (EMIT) emit(b * TIME_BLOCK + t0 + u, u, sin_turns<NC>(pos, out_c));
      }
    }
#pragma unroll
    for (int j = 0; j < JS; ++j)
      if (j < nj && (EMIT || j < nj - 1)) off[j + 1] = frac(fadd(off[j + 1], s[j]));
    if constexpr (!EMIT) {
      float t = s[JS - 1];
      if constexpr (WIDE) {
#pragma unroll
        for (int j = 0; j < JS; ++j)
          if (j == nj - 1) t = s[j];
      }
      total(b, t);
    }
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
__device__ __forceinline__ void synth_run(const Chain<KN>& ch, const SynthParams& sp,
                                          const float* out_c, int n, Emit& emit) {
  float off[Chain<KN>::S];
#pragma unroll
  for (int j = 0; j < Chain<KN>::S; ++j) off[j] = 0.f;
  NoTotal none;
  synth_span<NC, G, KN, emit_nj(KN), true>(ch, sp, out_c, 0, n / TIME_BLOCK, off, emit, none,
                                           ch.kn - 1);
}

// ---- the fm{k}_parallel bank -------------------------------------------------

// One candidate's bank of np fm2 pairs, pair j on genes 4j .. 4j+3 = (fm,
// index, fc, amp): each pair's make_chain constants, and its output gain.
// The int8 mode factors out s = (sum_j |amp_j|) / np (summed in pair order,
// divided by the float32 np) and gain_j = amp_j * (63 / (np s + 1e-30)),
// so the summed pairs stay within +-63 and s rescales the magnitudes; the
// float modes keep gain_j = amp_j and divide the sum by np
// (synth_bank_span). amp is what FoldEmit multiplies a sample by and the
// int8 epilogue rescales by: s (int8), 1 (bf16, f32). A code's arrays hold
// its own slots (bank_slots); a wide bank (WIDE_BANK) has MAX_PAIRS and
// np = sp.npair.
template <int KN>
struct PairBank {
  static constexpr int S = bank_slots(KN);
  float inc1[S], inc_blk[S], im[S], ic[S], gain[S];
  float amp;
  int np;
};

template <int KN>
__device__ __forceinline__ int bank_pairs(const PairBank<KN>& bk) {
  return KN == WIDE_BANK ? bk.np : PairBank<KN>::S;
}

template <int KN, bool INT8>
__device__ __forceinline__ PairBank<KN> make_bank(const float* p, const SynthParams& sp) {
  constexpr int S = PairBank<KN>::S;
  static_assert(S >= 2 && S <= MAX_PAIRS, "pairs in a bank");
  PairBank<KN> bk;
  const float inv_sr = sp.inv_sr;
  bk.np = KN == WIDE_BANK ? sp.npair : S;
  const int np = bank_pairs(bk);
#pragma unroll
  for (int j = 0; j < S; ++j) {
    bk.inc1[j] = bk.inc_blk[j] = bk.im[j] = bk.ic[j] = bk.gain[j] = 0.f;
    if (j < np) {
      bk.inc1[j] = frac(fmul(inv_sr, p[4 * j]));
      bk.im[j] = fmul(inv_sr, fmul(p[4 * j], p[4 * j + 1]));
      bk.ic[j] = fmul(inv_sr, p[4 * j + 2]);
      bk.inc_blk[j] = frac(fmul((float)TIME_BLOCK, bk.inc1[j]));
      bk.gain[j] = p[4 * j + 3];
    }
  }
  bk.amp = 1.f;
  if constexpr (INT8) {
    float s = fabsf(p[3]);
#pragma unroll
    for (int j = 1; j < S; ++j)
      if (j < np) s = fadd(s, fabsf(p[4 * j + 3]));
    s = __fdiv_rn(s, (float)np);
    const float inv_s = __fdiv_rn(63.f, fadd(fmul((float)np, s), 1e-30f));
#pragma unroll
    for (int j = 0; j < S; ++j) bk.gain[j] = fmul(bk.gain[j], inv_s);
    bk.amp = s;
  }
  return bk;
}

// The bank over the time blocks [b0, b1) of a frame from the carries o1[],
// o2[] at block b0, which advance in place (synth_span's contract for a
// bank): pair j is synth_span's chain of two (its own two carries, the same
// operations) whose output is the unit sine times gain_j; emit(m, u, y)
// gets the sum over the pairs in pair order, divided by the float32 np in
// the float modes (!INT8), with m the sample's index in the frame. The pair
// count is fixed at compile time, as a chain's KN is (a wide bank skips the
// slots from np on, as a wide chain does).
template <int NC, int G, int KN, bool INT8, typename Emit>
__device__ __forceinline__ void synth_bank_span(const PairBank<KN>& bk, const SynthParams& sp,
                                                int b0, int b1, float (&o1)[PairBank<KN>::S],
                                                float (&o2)[PairBank<KN>::S], Emit& emit) {
  constexpr int S = PairBank<KN>::S;
  static_assert(TIME_BLOCK % G == 0, "G must divide TIME_BLOCK");
  const int np = bank_pairs(bk);
  for (int b = b0; b < b1; ++b) {
    float s[S];
#pragma unroll
    for (int j = 0; j < S; ++j) s[j] = 0.f;
    for (int t0 = 0; t0 < TIME_BLOCK; t0 += G) {
      const float tf0 = (float)t0;
#pragma unroll
      for (int u = 0; u < G; ++u) {
        float y = 0.f;
#pragma unroll
        for (int j = 0; j < S; ++j) {
          if (j < np) {
            const float pos1 = fadd(fmul(fadd(tf0, (float)u), bk.inc1[j]), o1[j]);
            const float x = fadd(fmul(sin_turns<NC>(pos1, sp.sin_c), bk.im[j]), bk.ic[j]);
            const float o = fmul(sin_turns<NC>(fadd(s[j], o2[j]), sp.sin_c), bk.gain[j]);
            y = j == 0 ? o : fadd(y, o);
            s[j] = fadd(s[j], x);
          }
        }
        if constexpr (!INT8) y = __fdiv_rn(y, (float)np);
        emit(b * TIME_BLOCK + t0 + u, u, y);
      }
    }
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (j < np) {
        o2[j] = frac(fadd(o2[j], s[j]));
        o1[j] = frac(fadd(o1[j], bk.inc_blk[j]));
      }
    }
  }
}

// Pair j of a bank as synth_span's chain of two, for the time-parallel
// kernels' level pass over its modulator (large_frame.cu).
template <int KN>
__device__ __forceinline__ Chain<2> pair_chain(const PairBank<KN>& bk, int j) {
  Chain<2> ch;
  ch.inc1 = bk.inc1[j];
  ch.inc_blk = bk.inc_blk[j];
  ch.ims[0] = bk.im[j];
  ch.ics[0] = bk.ic[j];
  ch.amp = bk.gain[j];
  ch.kn = 2;
  return ch;
}

// The level pass of a bank over the time blocks [b0, b1), for the
// time-parallel B2 (fused_tp.cuh): from the modulators' offsets o1[] at b0,
// which advance in place to b1, total(j, b, t) gets block b's total t of
// pair j's modulator increments, the amount by which block b advances the
// carrier's offset (o2[j] <- frac(o2[j] + t)). These are synth_bank_span's
// operations on o1 and s[j], in its order, without the carriers' sines, so
// a fold of the totals in block order gives synth_bank_span's o2 bit for bit.
template <int NC, int G, int KN, typename Total>
__device__ __forceinline__ void bank_level_pass(const PairBank<KN>& bk, const SynthParams& sp,
                                                int b0, int b1, float (&o1)[PairBank<KN>::S],
                                                Total& total) {
  constexpr int S = PairBank<KN>::S;
  static_assert(TIME_BLOCK % G == 0, "G must divide TIME_BLOCK");
  const int np = bank_pairs(bk);
  for (int b = b0; b < b1; ++b) {
    float s[S];
#pragma unroll
    for (int j = 0; j < S; ++j) s[j] = 0.f;
    for (int t0 = 0; t0 < TIME_BLOCK; t0 += G) {
      const float tf0 = (float)t0;
#pragma unroll
      for (int u = 0; u < G; ++u) {
#pragma unroll
        for (int j = 0; j < S; ++j) {
          if (j < np) {
            const float pos1 = fadd(fmul(fadd(tf0, (float)u), bk.inc1[j]), o1[j]);
            s[j] = fadd(s[j], fadd(fmul(sin_turns<NC>(pos1, sp.sin_c), bk.im[j]), bk.ic[j]));
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (j < np) {
        total(j, b, s[j]);
        o1[j] = frac(fadd(o1[j], bk.inc_blk[j]));
      }
    }
  }
}

// The barriers of the time-parallel kernels: the candidate's threads are a
// block (BlockSync) or a warp (WarpSync).
struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};
struct WarpSync {
  __device__ __forceinline__ void operator()() const { __syncwarp(); }
};

// A bank's carries at block b0 for a thread of a time-parallel block that
// owns the blocks [b0, b1) of its candidate, as large_frame.cuh's
// scan_levels finds a chain's. On entry o1[], o2[] hold the carries at the
// frame's first block (zero at frame 0, else where the frame before ended:
// frame f is samples [f n, (f + 1) n) of one continuous synthesis). Each
// modulator's o1[j] advances by its own scalar walk over b < b0; then one
// level for every pair at once (a bank's carriers are independent chains of
// two), bank_level_pass over the thread's blocks writing pair j's total of
// block b to tot[(j nb + b) stride], shared by every thread of the
// candidate; sync(); and each carrier's o2[j] continues from its value at
// the frame's first block by a fold of tot(j, 0 .. b0-1) in block order,
// frac(f + t) (never a tree: frac-add is not associative), so the fold over
// all the frames' blocks is the one sequence of the one-thread synthesis.
// No fold reads the totals from block b_top up (the last thread's first
// block), so the last thread computes none.
template <int NC, int KN, typename Sync>
__device__ __forceinline__ void bank_scan(const PairBank<KN>& bk, const SynthParams& sp, int b0,
                                          int b1, int b_top, float (&o1)[PairBank<KN>::S],
                                          float (&o2)[PairBank<KN>::S], float* tot, int nb,
                                          int stride, Sync sync) {
  constexpr int S = PairBank<KN>::S;
  const int np = bank_pairs(bk);
#pragma unroll
  for (int j = 0; j < S; ++j)
    if (j < np)
      for (int b = 0; b < b0; ++b) o1[j] = frac(fadd(o1[j], bk.inc_blk[j]));
  float o[S];
#pragma unroll
  for (int j = 0; j < S; ++j) o[j] = o1[j];
  auto put = [&](int j, int b, float t) { tot[(size_t)(j * nb + b) * stride] = t; };
  bank_level_pass<NC, 8, KN>(bk, sp, b0, b1 < b_top ? b1 : b_top, o, put);
  sync();
#pragma unroll
  for (int j = 0; j < S; ++j) {
    if (j < np) {
      float f = o2[j];
      for (int b = 0; b < b0; ++b) f = frac(fadd(f, tot[(size_t)(j * nb + b) * stride]));
      o2[j] = f;
    }
  }
}

// A fixed chain's offsets at block b0, for a thread of a time-parallel
// block that owns the blocks [b0, b1) of its candidate (B2's time-parallel
// layout, fused_tp.cuh): large_frame.cuh's scan_levels, with each level's
// totals in a region of their own (level L's block b at tot[(L nb + b)
// stride]), so a level takes one sync() where scan_levels' shared region
// takes two, and with offsets that continue from frame to frame as
// bank_scan's carries do. On entry off[] holds the offsets at the frame's
// first block; off[0] advances by its own scalar walk over b < b0; level L
// = 0 .. KN-2 runs oscillators 0 .. L over the thread's blocks below b_top
// from the offsets it knows, writing each block's total; sync(); and
// off[L + 1] continues from its value at the frame's first block by a fold
// of the totals of blocks 0 .. b0-1 in block order.
template <int NC, int KN, int L = 0, typename Sync>
__device__ __forceinline__ void chain_scan(const Chain<KN>& ch, const SynthParams& sp, int b0,
                                           int b1, int b_top, float (&off)[Chain<KN>::S],
                                           float* tot, int nb, int stride, Sync sync) {
  static_assert(KN >= 2 && KN != WIDE_CHAIN && !is_bank(KN), "the fixed chains");
  constexpr int S = Chain<KN>::S;
  if constexpr (L == 0)
    for (int b = 0; b < b0; ++b) off[0] = frac(fadd(off[0], ch.inc_blk));
  if constexpr (L < KN - 1) {
    float o[S];
#pragma unroll
    for (int j = 0; j < S; ++j) o[j] = off[j];
    float* lt = tot + (size_t)L * nb * stride;
    auto put = [&](int b, float t) { lt[(size_t)b * stride] = t; };
    NoEmit none;
    synth_span<NC, 8, KN, L + 1, false>(ch, sp, nullptr, b0, b1 < b_top ? b1 : b_top, o, none,
                                        put);
    sync();
    float f = off[L + 1];
    for (int b = 0; b < b0; ++b) f = frac(fadd(f, lt[(size_t)b * stride]));
    off[L + 1] = f;
    chain_scan<NC, KN, L + 1>(ch, sp, b0, b1, b_top, off, tot, nb, stride, sync);
  }
}

// The scaled parameters of candidate `cand` of a (pop, d) row-major array,
// into the D registers of the synthesis code (synth_dims).
template <int D>
__device__ __forceinline__ void load_params(float* p, const float* __restrict__ params, int cand,
                                            int d) {
#pragma unroll
  for (int i = 0; i < D; ++i) p[i] = i < d ? params[(size_t)cand * d + i] : 0.f;
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
// sample of a group, is a multiple of FOLD_G), int8 or bf16. Run it as
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
    // bf16: the audio rounded to bf16
    cur[u] = INT8 ? fsub(fadd(y, INT_MAGIC), INT_MAGIC) : to_f32(to_bf16(fmul(y, amp)));
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

// One candidate's row of f32 samples in device memory (B1/B2 true f32: a
// frame of n samples a row, rows `stride` floats apart, consecutive
// candidates on consecutive rows). The 32 threads of a warp hold 32
// consecutive rows and store the same group of FOLD_G samples together (the
// synthesis runs them in lockstep, in either layout), so a store goes
// through the warp's staging buffer in shared memory (32 x F32_LDB floats)
// and each 16-byte write then covers part of a row's 64 bytes beside three
// neighbours (8 rows an instruction, not 32 half-sectors: 4x less
// scattered, the one-thread synthesis' main cost when each thread wrote its
// own row).
#define F32_LDB (FOLD_G + 4)  // a staged row, padded: 8 rows of a phase on disjoint banks
struct F32Row {
  float* p;    // the thread's row
  float* buf;  // the warp's staging buffer
  int lane, stride;
  __device__ __forceinline__ void store(int s, const float* v) const {
    __syncwarp();  // the warp is done with the buffer's last group
#pragma unroll
    for (int i = 0; i < FOLD_G / 4; ++i)
      *reinterpret_cast<float4*>(buf + lane * F32_LDB + 4 * i) =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
    __syncwarp();
    float* row0 = p - (size_t)lane * stride + s;  // lane 0's row
#pragma unroll
    for (int it = 0; it < 32 * FOLD_G / 4 / 32; ++it) {
      const int r = it * 8 + (lane >> 2), q = lane & 3;
      *reinterpret_cast<float4*>(row0 + (size_t)r * stride + 4 * q) =
          *reinterpret_cast<const float4*>(buf + r * F32_LDB + 4 * q);
    }
  }
};

// The true-f32 emitter: sample m of the frame is x[m] = y * amp, unrounded
// (the plain version's synth_f32_plain), FOLD_G samples a store of the row.
struct XRowEmit {
  F32Row row;
  float amp;
  float cur[FOLD_G];
  __device__ __forceinline__ void operator()(int m, int u, float y) {
    cur[u] = fmul(y, amp);
    if (u == FOLD_G - 1) row.store(m - u, cur);
  }
};

// One candidate's synthesis as B1/B2 (and B3's single pass) run it, frame
// after frame: a chain of KN oscillators, or for a bank code (is_bank) a
// bank of pairs, with the phase carries that live on from one frame to the
// next (frame f is samples [f n, (f + 1) n) of one continuous synthesis: its
// blocks start from the offsets where frame f - 1 ended, as a block starts
// from where the block before it ended). init() makes the constants, zeroes
// the carries and returns the amplitude the int8 magnitudes are rescaled by
// (Chain::amp, PairBank::amp); frame() runs the next frame's n samples into
// emit, each with its index in the frame. init's `row` is the thread's row
// of the long code's scratch (LongSynth); the other codes ignore it.
template <int NC, int KN, bool INT8, bool BANK = is_bank(KN)>
struct CandidateSynth;

template <int NC, int KN, bool INT8>
struct CandidateSynth<NC, KN, INT8, false> {
  Chain<KN> ch;
  float off[Chain<KN>::S];
  __device__ __forceinline__ float init(const float* p, const SynthParams& sp, int = 0) {
    ch = make_chain<KN>(p, sp);
#pragma unroll
    for (int j = 0; j < Chain<KN>::S; ++j) off[j] = 0.f;
    return ch.amp;
  }
  template <typename Emit>
  __device__ __forceinline__ void frame(const SynthParams& sp, Emit& emit) {
    NoTotal none;
    synth_span<NC, FOLD_G, KN, emit_nj(KN), true>(ch, sp, INT8 ? sp.sin_c63 : sp.sin_c, 0,
                                                  sp.n / TIME_BLOCK, off, emit, none, ch.kn - 1);
  }
};

template <int NC, int KN, bool INT8>
struct CandidateSynth<NC, KN, INT8, true> {
  static constexpr int S = PairBank<KN>::S;
  PairBank<KN> bk;
  float o1[S], o2[S];
  __device__ __forceinline__ float init(const float* p, const SynthParams& sp, int = 0) {
    bk = make_bank<KN, INT8>(p, sp);
#pragma unroll
    for (int j = 0; j < S; ++j) o1[j] = o2[j] = 0.f;
    return bk.amp;
  }
  template <typename Emit>
  __device__ __forceinline__ void frame(const SynthParams& sp, Emit& emit) {
    synth_bank_span<NC, FOLD_G, KN, INT8>(bk, sp, 0, sp.n / TIME_BLOCK, o1, o2, emit);
  }
};

// ---- the long code ------------------------------------------------------------

// One candidate's synthesis at any length (LONG_CODE): a chain of sp.kn
// oscillators (fm{kn}_series) or a bank of sp.npair pairs, frame after
// frame as CandidateSynth runs them, the same operations in the same order
// as synth_span and synth_bank_span, so its samples are theirs bit for bit.
// Its parameters are read from memory (p: the candidate's d scaled
// parameters, a row of the long scratch or of the kernel's input), its
// carries live in the long scratch (carry j at c[j * stride]: a chain's
// off[1 ..], a bank's o1, o2 of each pair), and a time block runs segment
// after segment:
// * a chain: oscillator j+1's phase at sample t is fadd(s[j], off[j+1]),
//   s[j] the running sum of oscillator j's increments before t, so the
//   modulating oscillators run in segments of LONG_CHAIN_SEG over the whole
//   block, each handing the block's 128 phases to the next through ph[]
//   (local memory); the last one emits;
// * a bank: its pairs are independent and their outputs are summed in pair
//   order, so the pairs run in segments of LONG_BANK_SEG, each adding its
//   outputs onto the block's per-sample partial sums in ph[]; the last one
//   divides (the float modes) and emits. The int8 gain needs s = sum_j
//   |amp_j| / k over every pair first (make_bank's), which init forms.
// Only a segment's constants, carries and running sums sit in registers
// (reloaded from p and the scratch each block), so the state does not grow
// with the length: nothing is reordered, and a chain of 9 .. 16 or a bank of
// 2 .. 8 through this code gives the wide and fixed codes' bits.
template <int NC, bool INT8>
struct LongSynth {
  const float* p;
  float* c;
  int stride;
  float off0;   // a chain's off[0]
  float inv_s;  // an int8 bank's 63 / (k s + 1e-30)

  __device__ __forceinline__ float init(const float* p_, const SynthParams& sp, int row) {
    p = p_;
    stride = sp.lrows;
    c = sp.lscr + (size_t)sp.lrows * sp.d + row;
    for (int j = 0; j < sp.d; ++j) c[(size_t)j * stride] = 0.f;
    off0 = 0.f;
    inv_s = 1.f;
    if (!sp.npair) return fmul(p[2 * (sp.kn - 1)], p[2 * (sp.kn - 1) + 1]);
    if (!INT8) return 1.f;
    const int np = sp.npair;
    float s = fabsf(p[3]);
    for (int j = 1; j < np; ++j) s = fadd(s, fabsf(p[4 * j + 3]));
    s = __fdiv_rn(s, (float)np);
    inv_s = __fdiv_rn(63.f, fadd(fmul((float)np, s), 1e-30f));
    return s;
  }

  template <typename Emit>
  __device__ __forceinline__ void frame(const SynthParams& sp, Emit& emit) {
    span<FOLD_G>(sp, 0, sp.n / TIME_BLOCK, emit);
  }

  // Time blocks [b0, b1) from the carries where the last span ended.
  template <int G, typename Emit>
  __device__ __forceinline__ void span(const SynthParams& sp, int b0, int b1, Emit& emit) {
    if (sp.npair)
      bank_span<G>(sp, b0, b1, emit);
    else
      chain_span<G>(sp, b0, b1, emit);
  }

  template <int G, typename Emit>
  __device__ __forceinline__ void chain_span(const SynthParams& sp, int b0, int b1, Emit& emit) {
    constexpr int SEG = LONG_CHAIN_SEG;
    static_assert(TIME_BLOCK % G == 0, "G must divide TIME_BLOCK");
    const int nj = sp.kn - 1;
    const float inv_sr = sp.inv_sr;
    const float* out_c = INT8 ? sp.sin_c63 : sp.sin_c;
    const float inc1 = frac(fmul(inv_sr, p[1]));
    const float inc_blk = frac(fmul((float)TIME_BLOCK, inc1));
    float ph[TIME_BLOCK];
    for (int b = b0; b < b1; ++b) {
      for (int j0 = 0; j0 < nj; j0 += SEG) {
        float im[SEG], ic[SEG], on[SEG], s[SEG];
#pragma unroll
        for (int q = 0; q < SEG; ++q) {
          const int j = j0 + q;
          im[q] = ic[q] = on[q] = s[q] = 0.f;
          if (j < nj) {
            im[q] = fmul(inv_sr, fmul(p[2 * j], p[2 * j + 1]));
            ic[q] = fmul(inv_sr, p[2 * j + 3]);
            on[q] = c[(size_t)(j + 1) * stride];
          }
        }
        const bool first = j0 == 0, last = j0 + SEG >= nj;
        for (int t0 = 0; t0 < TIME_BLOCK; t0 += G) {
          const float tf0 = (float)t0;
#pragma unroll
          for (int u = 0; u < G; ++u) {
            float pos = first ? fadd(fmul(fadd(tf0, (float)u), inc1), off0) : ph[t0 + u];
#pragma unroll
            for (int q = 0; q < SEG; ++q) {
              if (j0 + q < nj) {
                const float x = fadd(fmul(sin_turns<NC>(pos, sp.sin_c), im[q]), ic[q]);
                pos = fadd(s[q], on[q]);
                s[q] = fadd(s[q], x);
              }
            }
            if (last)
              emit(b * TIME_BLOCK + t0 + u, u, sin_turns<NC>(pos, out_c));
            else
              ph[t0 + u] = pos;
          }
        }
#pragma unroll
        for (int q = 0; q < SEG; ++q)
          if (j0 + q < nj) c[(size_t)(j0 + q + 1) * stride] = frac(fadd(on[q], s[q]));
      }
      off0 = frac(fadd(off0, inc_blk));
    }
  }

  template <int G, typename Emit>
  __device__ __forceinline__ void bank_span(const SynthParams& sp, int b0, int b1, Emit& emit) {
    constexpr int SEG = LONG_BANK_SEG;
    static_assert(TIME_BLOCK % G == 0, "G must divide TIME_BLOCK");
    const int np = sp.npair;
    const float inv_sr = sp.inv_sr;
    float ph[TIME_BLOCK];
    for (int b = b0; b < b1; ++b) {
      for (int j0 = 0; j0 < np; j0 += SEG) {
        float inc1[SEG], im[SEG], ic[SEG], gain[SEG], o1[SEG], o2[SEG], s[SEG];
#pragma unroll
        for (int q = 0; q < SEG; ++q) {
          const int j = j0 + q;
          inc1[q] = im[q] = ic[q] = gain[q] = o1[q] = o2[q] = s[q] = 0.f;
          if (j < np) {
            inc1[q] = frac(fmul(inv_sr, p[4 * j]));
            im[q] = fmul(inv_sr, fmul(p[4 * j], p[4 * j + 1]));
            ic[q] = fmul(inv_sr, p[4 * j + 2]);
            gain[q] = INT8 ? fmul(p[4 * j + 3], inv_s) : p[4 * j + 3];
            o1[q] = c[(size_t)(2 * j) * stride];
            o2[q] = c[(size_t)(2 * j + 1) * stride];
          }
        }
        const bool first = j0 == 0, last = j0 + SEG >= np;
        for (int t0 = 0; t0 < TIME_BLOCK; t0 += G) {
          const float tf0 = (float)t0;
#pragma unroll
          for (int u = 0; u < G; ++u) {
            float y = first ? 0.f : ph[t0 + u];
#pragma unroll
            for (int q = 0; q < SEG; ++q) {
              if (j0 + q < np) {
                const float pos1 = fadd(fmul(fadd(tf0, (float)u), inc1[q]), o1[q]);
                const float x = fadd(fmul(sin_turns<NC>(pos1, sp.sin_c), im[q]), ic[q]);
                const float o = fmul(sin_turns<NC>(fadd(s[q], o2[q]), sp.sin_c), gain[q]);
                y = j0 + q == 0 ? o : fadd(y, o);
                s[q] = fadd(s[q], x);
              }
            }
            if (last) {
              if constexpr (!INT8) y = __fdiv_rn(y, (float)np);
              emit(b * TIME_BLOCK + t0 + u, u, y);
            } else {
              ph[t0 + u] = y;
            }
          }
        }
#pragma unroll
        for (int q = 0; q < SEG; ++q) {
          const int j = j0 + q;
          if (j < np) {
            c[(size_t)(2 * j + 1) * stride] = frac(fadd(o2[q], s[q]));
            c[(size_t)(2 * j) * stride] = frac(fadd(o1[q], frac(fmul((float)TIME_BLOCK, inc1[q]))));
          }
        }
      }
    }
  }
};

template <int NC, bool INT8>
struct CandidateSynth<NC, LONG_CODE, INT8, false> : LongSynth<NC, INT8> {};

// The long scratch's row of the B1/B2 thread that synthesises candidate
// cand of run `run` (a run's rows: the population padded to LONG_ROW_PAD).
__device__ __forceinline__ int long_row(int run, int pop, int cand) {
  return run * ((pop + LONG_ROW_PAD - 1) / LONG_ROW_PAD * LONG_ROW_PAD) + cand;
}

template <typename K>
static cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}
