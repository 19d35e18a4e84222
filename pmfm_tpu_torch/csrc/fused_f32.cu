// B1 and B2 in the true-f32 mode for Hopper (sm_90a): FM synthesis into
// rows of f32 samples, the spectrum of each frame by a shared-memory FFT
// (power-of-two frames) or a register-tiled folded DFT (any other frame),
// and the L2 spectral fitness, as kernels behind one launcher.
//
// Replaces, in the true-f32 mode (the refine tail's engine: dft_scale 0, the
// float32 operand, unquantised audio x = sin * amp):
//   B1 <- pmfm_tpu/kernels/synth_fitness.py::fused_synth_fitness, with _dft_uv
//         and _evaluate_block's audio_f32
//   B2 <- pmfm_tpu/kernels/generation.py::fused_generation
// (the int8 mode of both is fused_eval.cu's). B5 (evolve.cu) runs B2's
// kernels for each of its f32 generations, through generation.cuh's plan.
//
// The route, one test on n in the wrapper (kernels/synth_fitness.py::
// f32_route): a power-of-two n (every frame a user's configuration gives,
// 256 .. 2048) takes the FFT, which the wrapper asks for by passing its
// tables (sp.fft); any other n (1280, 3584, ...: only the tests reach them)
// takes the folded DFT. The DFT route is four kernels: the synthesis, the
// fold of the rows into a+/a-, the DFT with the fitness epilogue, and a
// per-candidate sum over frames; the FFT route is the synthesis, the FFT
// with the fitness epilogue, the DFT's three on its exact matches only (a
// list of them a row block), and the sum over frames.
//
// What bounds it on an H100. The reference computes the spectrum as a
// folded matrix product because batched 1-2K-point FFTs do not keep a TPU
// busy (pmfm_tpu/ops/spectral.py). On the card that product is 2 * 2K *
// (N/2) f32 operations a frame (4.2 M at n 2048, K 1024: 137 G at F 8,
// P 4096, 2.1 ms at 67 TFLOP/s), in full f32 on the CUDA cores (never TF32:
// the reference's dots are Precision.HIGHEST). A real FFT of N samples is a
// complex FFT of N/2 points and a split, ~5 (N/2) log2(N/2) + ~10 (N/2)
// operations (~60 k at n 2048, ~70x fewer), so the FFT route is bound by
// bytes: the synthesis writes each frame's N floats once and the FFT reads
// them once (268 MB each way at F 8, P 4096: ~0.08 ms at 3.35 TB/s).
//
// (i) The synthesis writes frame f of candidate c to row (r frames + f)
// pop_pad + c of x (n floats a row), through XRowEmit on F32Row: the plain
// version's samples bit for bit (synth_run's operations, each sample
// fmul(y, amp) unrounded; a pair bank: synth_bank_span's sum divided by k,
// times 1). f32_synth_kernel runs one thread a candidate on blocks of
// SY_TPB (CandidateSynth); fused_f32_tp.cu's kernel runs the same
// synthesis time-parallel, 32 candidates a block on its warps, where the
// one-thread grid leaves the card short of warps (the wrapper's
// f32_time_parallel, sp.f32_tp): the two write the same rows bit for bit.
// Rows past P (up to the padding) are synthesised from zero parameters.
//
// (ii) f32_fft_kernel, a block of FFT_THREADS a tile of FT = FFT_TILE / n
// frames (64 KB of shared memory and 128 registers a thread: two blocks an
// SM; held to three, at 80 registers, it spilled and ran 1.3x slower on the
// card):
// * cp.async stages the tile's rows (FT consecutive rows of x, 64 KB in
//   one piece) in shared memory as they lie: frame f's complex point i is
//   z[i] = x[2i] + i x[2i+1] at float2 f (N/2) + i.
// * Stockham passes of radix 4 (and one of radix 2 where log2(N/2) is odd)
//   over the tile's FT complex FFTs of N/2 points, a thread FFT_TILE / 8 /
//   FFT_THREADS butterflies a pass in registers: load its points, apply the
//   twiddles W^(k r), the butterfly, a barrier, store them to their
//   Stockham places, a barrier. The first pass multiplies each loaded
//   sample by the window (w[n] norm, rounded once), so the tile is never
//   windowed apart. From the first pass's stores on, point c of the tile
//   lives at fft_swizzle(c), an XOR of bits 4-5 into bits 0-1 and 2-3,
//   under which each half-warp's 8-byte accesses fall on 16 distinct bank
//   pairs in every pass (the radix-4 stores of the first two passes are
//   strided 4 and 16 points).
// * The real split: X[k] = E[k] + W_N^k O[k], E and O from Z[k] and
//   conj(Z[N/2 - k]), for the bins 0 .. K-1 (K <= N/2; num_bins is N/2).
// * The epilogue: each bin's magnitude and squared difference with the
//   target row in float32 (the plain version's operations), the terms of
//   a frame summed in double by the frame's FFT_THREADS / FT threads (bins
//   k = t, t + threads, ..., then a fixed tree of shuffles) and rounded
//   once to float32 into frame_fit[row].
// * Exact matches: a frame whose fitness F falls below FFT_EXACT_BELOW x
//   its target row's energy E (sum t_k^2) is a close match: a known-params
//   truth (F / E ~1e-7 on a bank, ~2e-4 on a long chain). There F is a
//   small difference of large terms, and the plain version's f32 sums lie
//   up to 2.2e-4 (relative) from float64 (PERF.md §6): the FFT, closer to
//   float64, lay ~2e-7 sqrt(E / F) from them on the card, past the gate's
//   1e-5 (kernel against plain version) below F / E ~4e-4. The kernel
//   appends such a frame to its row block's list (an atomic count; the
//   order in a list changes no value, each row's sums being its own), and
//   the DFT route's kernels score the listed rows again, packed at the
//   front of the row block: the fold and f32_dft_kernel (their blocks past
//   the count return at once: in most launches all of them), then
//   f32_exact_kernel writing the values back to the rows' places.
// * Operations: every add and multiply is __fadd_rn / __fmul_rn (no FMA),
//   so tests/test_torch_f32.py emulates the kernel's passes in numpy
//   float32. The twiddles W_N^k (k < N) and the window are float64 values
//   rounded once to float32, built on the host beside the operand
//   (ops/spectral.py::fft_tables) and passed in as one device array.
// (iii) f32_frames_kernel adds each candidate's frames' values in float32 in
// frame order.
//
// The DFT route (any other n, and the FFT route's listed exact matches): the fold
// kernel forms a+ = x[i] + x[N-i], a- = x[i] - x[N-i] (a+[0] = x[0] + 0) and
// the edge sample x[N/2], one rounding of each sum and difference (the
// plain version's fold), for f32_dft_kernel and f32_sum_kernel below.
//
// Numerics. The audio is the plain version's bit for bit; only the
// spectrum's order differs from the plain version's float32 products. An
// f32 FFT's rounding grows with log2 N, where a sum over N/2 terms grows
// with their count, so the FFT lies no further from a float64 evaluation
// than the plain version's sums (tests/test_torch_gpu.py::
// test_b1_f32_summation_near_float64; chip_smoke.py phase 12 prints both).
// B1, B2 and B5 share these kernels, so their fitness is bit-equal
// whatever the order; nothing else depends on it.
//
// Frames and runs. With sp.frames = F > 1 (multi-frame fitness) the
// synthesis writes F frames of one continuous synthesis to F row blocks,
// each scored against its own target row (a row block's rows never share a
// tile: pop_pad is a multiple of 128, FT at most 64), and the last kernel
// adds the frames' values in float32 in frame order. A batched launch of B
// runs (fused_eval.cu's run axis) adds B x F row blocks the same way, run r
// with its own parameters or parents, seed and target rows. At F = B = 1
// every kernel computes what it computes for one frame.

#include "generation.cuh"

#define SY_TPB 128        // synthesis: candidates (threads) per block
#define ROW_PAD 128       // the scratch's rows a row block: the population padded
#define FFT_THREADS 256   // FFT: threads a block
#define FFT_TILE 16384    // FFT: floats of a block's tile, FT = FFT_TILE / n frames (64 KB)
#define FFT_MIN_LOGN 8    // FFT: the power-of-two frames it takes, n 256 ..
#define FFT_MAX_LOGN 11   // .. 2048 (MAX_FUSED_N is 3584)
#define FFT_EXACT_BELOW 1e-3  // FFT: a frame below this x its target's energy is an exact match
#define FOLD_TPB 256      // the DFT route's fold
#define DF_BM 128         // DFT: candidates per block (the scratch's row padding)
#define DF_TILES 8        // DFT: bin tiles of 8 per pass
#define DF_BN (8 * DF_TILES)
#define DF_BK 16          // DFT: samples per stage
#define DF_LD (DF_BK + 4) // DFT: a staged row, padded so the fragment loads are conflict-free
#define DF_STAGES 3
#define DF_TM 16          // DFT: candidates of a thread's register tile (and 8 bins)
#define DF_THREADS 128    // DFT: 64 threads for U, 64 for V
#define DF_GROUPS 8       // DFT: bin groups, one a block (the fitness sums them in group order)
#define DF_SEG 128        // DFT: samples a segment where the sample split applies
#define DF_LEVELS 4       // DFT: running tiles of the pairwise segment sum (up to 16 segments)
#define DF_SPLIT_ABOVE 512  // DFT: the split applies where N/2 is above this
#define DF_RUN (DF_TM * 8)  // DFT: floats of a thread's running tile
#define DF_ELD (DF_BN + 1)  // DFT epilogue: a row of U or V terms
#define SUM_TPB 256

static_assert(ROW_PAD % SY_TPB == 0 && ROW_PAD == DF_BM && SY_TPB % 32 == 0,
              "the synthesis grid covers the padded rows in whole warps");
static_assert(ROW_PAD % (FFT_TILE >> FFT_MIN_LOGN) == 0, "a row block is whole FFT tiles");
static_assert(DF_THREADS / 2 == (DF_BM / DF_TM) * DF_TILES,
              "one DF_TM x 8 tile of U or V a thread");
static_assert(DF_THREADS == DF_BM, "a thread a candidate in the epilogue");
static_assert(DF_SEG % DF_BK == 0 && DF_RUN % 4 == 0, "whole stages a segment, float4 slots");
constexpr int DF_MAX_SEGS = 1 << DF_LEVELS;  // segments the levels take: N/2 <= 2048

// The true-f32 time-parallel synthesis (fused_f32_tp.cu) into plan: its
// kernel for sp's sine order and fixed code, its grid over pop_pad rows, its
// block and its dynamic shared memory; cudaErrorInvalidValue for any other
// code.
int prepare_f32_tp(const SynthParams& sp, int pop_pad, F32Plan* plan);

// ---- (i) synthesis ------------------------------------------------------------

// Candidate base + t's scaled parameters into s_p[t * d ..]: B1 reads them,
// B2 makes them (its offspring prologue: the block's SY_TPB x d (candidate,
// gene) pairs spread over its threads, values and steps written coalesced).
// Then thread t synthesises candidate base + t (zero parameters past pop)
// into its rows of x, frame after frame (sp.frames frames of one continuous
// synthesis, CandidateSynth's carries living on from frame to frame): frame
// f of run r goes to row (r * frames + f) * pop_pad + candidate. blockIdx.y
// is the run (fused_eval.cu's run axis: its own parameters or parents and
// seed).
template <int NC, int KN, bool GEN>
__global__ void __launch_bounds__(SY_TPB)
f32_synth_kernel(const float* __restrict__ params, uint32_t seed,
                 const uint32_t* __restrict__ run_seeds, const float* __restrict__ pv,
                 const float* __restrict__ ps, MutateParams mp, float* __restrict__ values,
                 float* __restrict__ steps, int pop, SynthParams sp, float* __restrict__ x,
                 int pop_pad) {
  constexpr bool LONG = KN == LONG_CODE;
  __shared__ float s_p[SY_TPB * (LONG ? 1 : synth_dims(KN))];
  __shared__ __align__(16) float s_buf[SY_TPB * F32_LDB];  // a 32-row staging buffer a warp
  const int base = blockIdx.x * SY_TPB, d = sp.d, run = blockIdx.y;
  // the long code reads its parameters throughout the synthesis, from the
  // block's rows of the long scratch (rows long_row(run, pop, cand))
  float* const lp = LONG ? sp.lscr + (size_t)long_row(run, pop, base) * d : nullptr;
  if constexpr (GEN) {
    if (run_seeds) seed = __ldg(run_seeds + run);
    pv += (size_t)run * mp.mu * d;
    ps += (size_t)run * mp.mu * d;
    values += (size_t)run * pop * d;
    steps += (size_t)run * pop * d;
  } else {
    params += (size_t)run * pop * d;
  }
  for (int i = threadIdx.x; i < SY_TPB * d; i += SY_TPB) {  // pair i: (i / d, i % d)
    const int cl = i / d, cand = base + cl;
    float v;
    if constexpr (GEN)
      v = cand < pop ? offspring_gene(seed, cand, i - cl * d, pv, ps, mp, d, values, steps) : 0.f;
    else
      v = cand < pop ? params[(size_t)base * d + i] : 0.f;
    (LONG ? lp : s_p)[i] = v;
  }
  __syncthreads();
  float preg[LONG ? 1 : synth_dims(KN)];
  if constexpr (!LONG) {
#pragma unroll
    for (int i = 0; i < synth_dims(KN); ++i) preg[i] = i < d ? s_p[threadIdx.x * d + i] : 0.f;
  }
  const float* const p = LONG ? lp + (size_t)threadIdx.x * d : preg;
  const int cand = base + threadIdx.x, lane = threadIdx.x & 31;
  float* buf = s_buf + (threadIdx.x - lane) * F32_LDB;
  CandidateSynth<NC, KN, false> cs;
  XRowEmit emit;
  emit.amp = cs.init(p, sp, long_row(run, pop, cand));
  for (int f = 0; f < sp.frames; ++f) {
    const size_t row = (size_t)(run * sp.frames + f) * pop_pad + cand;
    emit.row = F32Row{x + row * sp.n, buf, lane, sp.n};
    cs.frame(sp, emit);
  }
}

// ---- (ii) the FFT and the fitness epilogue ---------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Where complex point c of the tile lives after the first pass: bits 4-5 of
// c XORed into bits 0-1 and 2-3 (a permutation inside each 16 points).
__device__ __forceinline__ int fft_swizzle(int c) { return c ^ (((c >> 4) & 3) * 5); }

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(fsub(fmul(a.x, w.x), fmul(a.y, w.y)), fadd(fmul(a.x, w.y), fmul(a.y, w.x)));
}

// One Stockham pass of radix R = 2^LR over the tile's FT transforms of M =
// N/2 points, whose sub-transforms of NS = 2^LNS points are done: butterfly
// j of a transform takes points j + r M/R (r < R), multiplies point r by
// W_{NS R}^{(j % NS) r} (the twiddle table's W_N^{(j % NS) r N / (NS R)}),
// and stores output r at (j / NS) NS R + j % NS + r NS. The first pass
// (LNS 0, no twiddles) reads the staged samples as they lie and windows
// them.
template <int LOGN, int LNS, int LR>
__device__ __forceinline__ void fft_pass(float2* s, const float* __restrict__ wn,
                                         const float2* __restrict__ tw) {
  constexpr int N = 1 << LOGN, M = N >> 1, LOGM = LOGN - 1, R = 1 << LR, NS = 1 << LNS;
  constexpr int QB = LOGM - LR;  // log2 of a transform's butterflies
  constexpr int NB = (FFT_TILE / 2 / R) / FFT_THREADS;  // a thread's butterflies
  static_assert(LR == 1 || LR == 2, "radix 2 or 4");
  float2 v[NB][R];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int beta = threadIdx.x + b * FFT_THREADS, f = beta >> QB, j = beta & ((1 << QB) - 1);
    const int kk = j & (NS - 1);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = j + r * (M / R), c = f * M + i;
      if constexpr (LNS == 0) {
        const float2 z = s[c], w = __ldg(reinterpret_cast<const float2*>(wn) + i);
        v[b][r] = make_float2(fmul(z.x, w.x), fmul(z.y, w.y));
      } else {
        v[b][r] = s[fft_swizzle(c)];
        if (r) v[b][r] = cmul(v[b][r], __ldg(tw + ((kk * r) << (LOGN - LNS - LR))));
      }
    }
    if constexpr (LR == 2) {
      const float2 a0 = make_float2(fadd(v[b][0].x, v[b][2].x), fadd(v[b][0].y, v[b][2].y));
      const float2 a1 = make_float2(fsub(v[b][0].x, v[b][2].x), fsub(v[b][0].y, v[b][2].y));
      const float2 a2 = make_float2(fadd(v[b][1].x, v[b][3].x), fadd(v[b][1].y, v[b][3].y));
      // (v1 - v3) (-i)
      const float2 a3 = make_float2(fsub(v[b][1].y, v[b][3].y), -fsub(v[b][1].x, v[b][3].x));
      v[b][0] = make_float2(fadd(a0.x, a2.x), fadd(a0.y, a2.y));
      v[b][1] = make_float2(fadd(a1.x, a3.x), fadd(a1.y, a3.y));
      v[b][2] = make_float2(fsub(a0.x, a2.x), fsub(a0.y, a2.y));
      v[b][3] = make_float2(fsub(a1.x, a3.x), fsub(a1.y, a3.y));
    } else {
      const float2 a0 = v[b][0];
      v[b][0] = make_float2(fadd(a0.x, v[b][1].x), fadd(a0.y, v[b][1].y));
      v[b][1] = make_float2(fsub(a0.x, v[b][1].x), fsub(a0.y, v[b][1].y));
    }
  }
  __syncthreads();  // every point of the pass is read
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int beta = threadIdx.x + b * FFT_THREADS, f = beta >> QB, j = beta & ((1 << QB) - 1);
    const int dst = f * M + ((j >> LNS) << (LNS + LR)) + (j & (NS - 1));
#pragma unroll
    for (int r = 0; r < R; ++r) s[fft_swizzle(dst + r * NS)] = v[b][r];
  }
  __syncthreads();
}

// The passes from sub-transforms of 2^LNS points: radix 4 while two bits
// remain, then radix 2.
template <int LOGN, int LNS>
__device__ __forceinline__ void fft_passes(float2* s, const float* __restrict__ wn,
                                           const float2* __restrict__ tw) {
  if constexpr (LNS < LOGN - 1) {
    constexpr int LR = LOGN - 1 - LNS >= 2 ? 2 : 1;
    fft_pass<LOGN, LNS, LR>(s, wn, tw);
    fft_passes<LOGN, LNS + LR>(s, wn, tw);
  }
}

// Block b: rows [b FT, (b + 1) FT) of x (n = 2^LOGN samples a row), each
// against the target row of its row block (row / pop_pad); writes each
// row's fitness to frame_fit[row]. tab: the window w[n] norm (n floats),
// then W_N^k = (cos, -sin)(2 pi k / N) for k < N (n float2s). A row whose
// fitness is below FFT_EXACT_BELOW x its target row's energy is an exact
// match: it goes to its row block's list (list[rb pop_pad + count[rb]++] =
// its index in the row block), and the DFT's kernels write its value over
// frame_fit[row].
template <int LOGN>
__global__ void __launch_bounds__(FFT_THREADS, 2)
f32_fft_kernel(const float* __restrict__ x, const float* __restrict__ tab,
               const float* __restrict__ target, int k, int pop_pad,
               float* __restrict__ frame_fit, int* __restrict__ count,
               int* __restrict__ list) {
  constexpr int N = 1 << LOGN, M = N >> 1, FT = FFT_TILE / N, TPF = FFT_THREADS / FT;
  static_assert(FT >= 1 && TPF >= 1 && TPF <= 32 && (FFT_THREADS % FT) == 0, "a frame's threads");
  extern __shared__ __align__(16) float2 s_z[];  // FT x M complex points
  const float* wn = tab;
  const float2* tw = reinterpret_cast<const float2*>(tab + N);
  const size_t row0 = (size_t)blockIdx.x * FT;
  const float4* src = reinterpret_cast<const float4*>(x + row0 * N);
  for (int i = threadIdx.x; i < FFT_TILE / 4; i += FFT_THREADS)
    cp_async16(reinterpret_cast<float4*>(s_z) + i, src + i);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  fft_passes<LOGN, 0>(s_z, wn, tw);

  // the real split and the epilogue: frame f's bins k = t, t + TPF, ...
  const int f = threadIdx.x / TPF, t = threadIdx.x % TPF;
  const size_t row = row0 + f;
  const float* tgt = target + (row / pop_pad) * k;
  double sum = 0.0, energy = 0.0;
  for (int kk = t; kk < k; kk += TPF) {
    const float2 a = s_z[fft_swizzle(f * M + kk)];
    const float2 b = s_z[fft_swizzle(f * M + ((M - kk) & (M - 1)))];
    const float er = fmul(0.5f, fadd(a.x, b.x)), ei = fmul(0.5f, fsub(a.y, b.y));
    const float orr = fmul(0.5f, fadd(a.y, b.y)), oi = fmul(-0.5f, fsub(a.x, b.x));
    const float2 w = __ldg(tw + kk);
    const float xr = fadd(er, fsub(fmul(w.x, orr), fmul(w.y, oi)));
    const float xi = fadd(ei, fadd(fmul(w.x, oi), fmul(w.y, orr)));
    const float mag = sqrtf(fadd(fmul(xr, xr), fmul(xi, xi)));
    const float tk = __ldg(tgt + kk), dd = fsub(mag, tk);
    sum = __dadd_rn(sum, (double)fmul(dd, dd));
    energy = __dadd_rn(energy, __dmul_rn((double)tk, (double)tk));
  }
#pragma unroll
  for (int o = TPF / 2; o >= 1; o >>= 1) {
    sum = __dadd_rn(sum, __shfl_xor_sync(0xFFFFFFFFu, sum, o));
    energy = __dadd_rn(energy, __shfl_xor_sync(0xFFFFFFFFu, energy, o));
  }
  if (t == 0) {
    frame_fit[row] = __double2float_rn(sum);
    if (sum < FFT_EXACT_BELOW * energy) {
      const size_t rb = row / pop_pad;
      list[rb * pop_pad + atomicAdd(count + rb, 1)] = (int)(row - rb * pop_pad);
    }
  }
}

typedef void (*F32FftKernel)(const float*, const float*, const float*, int, int, float*, int*,
                             int*);

// fitness[r pop + c] = the frames' values of candidate c of run r
// (blockIdx.y) added in float32 in frame order.
__global__ void __launch_bounds__(SUM_TPB)
f32_frames_kernel(const float* __restrict__ frame_fit, int pop_pad, int pop, int frames,
                  float* __restrict__ fitness) {
  const int c = blockIdx.x * SUM_TPB + threadIdx.x, run = blockIdx.y;
  if (c >= pop) return;
  float fit = 0.f;
  for (int f = 0; f < frames; ++f) {
    const float ff = frame_fit[(size_t)(run * frames + f) * pop_pad + c];
    fit = f ? fadd(fit, ff) : ff;
  }
  fitness[(size_t)run * pop + c] = fit;
}

// ---- (iii) the DFT route: the fold ---------------------------------------------

// Block (b, rb): rows [DF_BM b, + DF_BM) of row block rb of x (n samples a
// row) into the same rows of a+ and a- (n/2 each) and of the edge samples:
// a+/-[0] = x[0] +- 0, a+/-[i] = x[i] +- x[N-i], edge = x[N/2] (FoldEmit's
// operations). Where count is given (the FFT route), row r of the row block
// is slot r of its list: only the slots below count[rb] are folded, each
// from the row the list names (list[rb pop_pad + r]).
__global__ void __launch_bounds__(FOLD_TPB)
f32_fold_kernel(const float* __restrict__ x, int n, int pop_pad, const int* __restrict__ count,
                const int* __restrict__ list, float* __restrict__ ap, float* __restrict__ am,
                float* __restrict__ edge) {
  const int rb = blockIdx.y, c0 = blockIdx.x * DF_BM;
  const int rows = count ? min(DF_BM, count[rb] - c0) : DF_BM;
  const int half = n >> 1;
  for (int i = threadIdx.x; i < rows * half; i += FOLD_TPB) {
    const int c = c0 + i / half, s = i % half;
    const size_t r = (size_t)rb * pop_pad + c;
    const float* xr = x + (count ? (size_t)rb * pop_pad + list[r] : r) * n;
    const float a = xr[s], b = s ? xr[n - s] : 0.f;
    ap[r * half + s] = fadd(a, b);
    am[r * half + s] = fsub(a, b);
    if (!s) edge[r] = xr[half];
  }
}

// For each listed slot r of the FFT route's exact matches (slot s < count[rb]
// of row block rb): its eight group sums added in double in group order
// from 0, rounded once (f32_sum_kernel's value of a frame), to frame_fit of
// the row its list names.
__global__ void __launch_bounds__(SUM_TPB)
f32_exact_kernel(const double* __restrict__ partial, const int* __restrict__ count,
                 const int* __restrict__ list, int rows, int pop_pad,
                 float* __restrict__ frame_fit) {
  const int r = blockIdx.x * SUM_TPB + threadIdx.x;
  if (r >= rows) return;
  const int rb = r / pop_pad;
  if (r - rb * pop_pad >= count[rb]) return;
  double s = 0.0;
#pragma unroll
  for (int g = 0; g < DF_GROUPS; ++g) s = __dadd_rn(s, partial[(size_t)g * rows + r]);
  frame_fit[(size_t)rb * pop_pad + list[r]] = __double2float_rn(s);
}

// ---- (iv) the folded DFT and its fitness epilogue (the DFT route) -------------
//
// f32_dft_kernel is a register-tiled product on the CUDA cores: a block
// takes DF_BM = 128 candidates and one group of bin tiles; cp.async stages
// 16-sample slices of a+/a- and of the operand rows in shared memory
// (DF_STAGES deep), and each thread keeps a 16 x 8 register tile (16
// candidates x 8 bins) of U or of V (warps 0-1 U = a+ C^T, warps 2-3 V = a-
// S^T), so each value loaded from shared memory serves 8 or 16 FMAs, and
// each operand row loaded from L2 serves 128 candidates.
//
// Its numerics. U[c][k] and V[c][k] are sums of exact-product __fmaf_rn
// steps over the samples in ascending order, with no tensor cores, in
// segments. Where N/2 <= DF_SPLIT_ABOVE (512) one accumulator a bin runs
// from 0 over all N/2 samples. Above it the samples split into segments of
// DF_SEG = 128: each segment's chain starts from 0 and the segments are
// added pairwise, by a binary counter over running tiles in scratch
// (DF_LEVELS of them, the thread's own 128 floats each, so no other thread
// touches them): at the end of segment c (from 1) the tiles of the levels
// below c's lowest set bit are added in, earlier samples on the left, and
// the sum goes to that bit's level; after the last segment the levels of
// the set bits of c - 1 are added, lowest first. That is ((s0 + s1) + (s2 +
// s3)) + ... with the same scratch traffic as an in-order sum. One
// ascending chain over all 1792 samples of n 3584 had put the kernel 16x
// further from a float64 evaluation than cuBLAS's blocked sums. Each bin's
// term (the edge term edge_norm (-1)^k x[N/2], the magnitude, the squared
// difference) is the plain version's float32 operations on U and V, and
// the terms are summed in double: a block's pass adds its 64 terms to the
// group's double in scratch (the thread's own), and f32_sum_kernel adds the
// eight group sums in group order and rounds once to float32.
//
// Its geometry. The grid is (P padded to DF_BM) / DF_BM x DF_GROUPS blocks:
// block b takes candidates [DF_BM (b / 8), + DF_BM) and group g = b % 8, so
// the eight blocks that share a slice of a+/a- run side by side and read it
// from L2. A block walks its group's tiles g, g + 8, ... in passes of
// DF_TILES (64 bins), and carries the group's sum across passes.
//
// One stage: DF_BK samples of the block's a+/a- rows and of its pass's
// operand rows (cos for U, sin for V), each row padded to DF_LD floats.
struct DftStage {
  float ap[DF_BM][DF_LD], am[DF_BM][DF_LD];
  float cs[DF_BN][DF_LD], sn[DF_BN][DF_LD];
};
constexpr size_t DF_SMEM = DF_STAGES * sizeof(DftStage) > 2 * DF_BM * DF_ELD * sizeof(float)
                               ? DF_STAGES * sizeof(DftStage)
                               : 2 * DF_BM * DF_ELD * sizeof(float);

// acc = the running tile + acc, element by element: the segments so far,
// then this one.
__device__ __forceinline__ void add_running(float (&acc)[DF_TM][8], const float4* run) {
#pragma unroll
  for (int i = 0; i < DF_RUN / 4; ++i) {
    const float4 t = run[i * DF_THREADS];
    const int r = i >> 1, c = (i & 1) * 4;
    acc[r][c] = fadd(t.x, acc[r][c]);
    acc[r][c + 1] = fadd(t.y, acc[r][c + 1]);
    acc[r][c + 2] = fadd(t.z, acc[r][c + 2]);
    acc[r][c + 3] = fadd(t.w, acc[r][c + 3]);
  }
}

// Block (b, fr): bin group g = b % DF_GROUPS of the DF_BM candidates from
// row c0 = DF_BM ((fr gridDim.x + b) / DF_GROUPS) of the scratch (row block
// fr = r frames + f, frame f of run r, starts at row fr pop_pad), against
// target row fr; writes group g's sum of each candidate's terms to
// partial[g rows + c0 + t]. The row block enters only through c0, the
// run tiles' block index and the target row, so no base pointer is moved
// (a moved kernel argument takes registers the DFT tile needs). Stage row p of a pass holds bin 8 (g + 8 jt) + p % 8
// of the group's tile jt = j0 + p / 8 (a tile past the last loads bin 0 and is
// skipped). Thread (tr, tc) of each half holds candidates tr + 8 i
// (i < DF_TM) and stage rows tc + 8 j (j < 8): each 8-byte fragment load of
// a half-warp reads 2 (a+/-) or 8 (operand) rows whose padded offsets fall on
// disjoint banks. A thread loads 24 floats a sample for 128 FMAs: shared
// memory serves 32 thread-floats a clock and the cores 128 FMAs, so at 5.3
// FMAs a float shared memory is no longer the first limit (an 8 x 8 tile,
// 4 FMAs a float, held the kernel near half the FMA rate).
// Where count is given (the FFT route's exact matches, packed at the front
// of each row block), a block past its row block's count does nothing.
__global__ void __launch_bounds__(DF_THREADS, 2)
f32_dft_kernel(const float* __restrict__ ap, const float* __restrict__ am,
               const float* __restrict__ edge, const float* __restrict__ dft,
               const float* __restrict__ target, SynthParams sp, int rows,
               double* __restrict__ partial, float4* __restrict__ run_tiles,
               const int* __restrict__ count) {
  constexpr int CH = DF_BK / 4;  // 16-byte copies a staged row
  constexpr int A_PER = DF_BM * CH / DF_THREADS, B_PER = DF_BN * CH / DF_THREADS;
  static_assert(DF_BM * CH % DF_THREADS == 0 && DF_BN * CH % DF_THREADS == 0, "copy split");
  extern __shared__ __align__(16) float smem_f[];
  DftStage* st = reinterpret_cast<DftStage*>(smem_f);
  const int lb = blockIdx.y * gridDim.x + blockIdx.x;  // the block's index over all row blocks
  const int g = blockIdx.x % DF_GROUPS, c0 = (lb / DF_GROUPS) * DF_BM;
  if (count && c0 - (int)blockIdx.y * (rows / (int)gridDim.y) >= count[blockIdx.y]) return;
  const int half = sp.n >> 1, k = sp.k, tiles = k >> 3;
  const int mine = g < tiles ? (tiles - g + DF_GROUPS - 1) / DF_GROUPS : 0;  // group g's tiles
  const int tid = threadIdx.x;
  const bool is_v = tid >= DF_THREADS / 2;  // warp-uniform
  const int t2 = tid & (DF_THREADS / 2 - 1), tr = t2 >> 3, tc = t2 & 7;
  const int ksteps = half / DF_BK;
  // stages a segment: all of them unless the sample split applies
  const int seg_steps = half > DF_SPLIT_ABOVE ? DF_SEG / DF_BK : ksteps;
  // the thread's running tile of level l: float4 slot i (elements 4i .. 4i+3
  // of acc) at run[(l * DF_RUN / 4 + i) * DF_THREADS], so a warp's slot
  // accesses are 512 contiguous bytes
  float4* run = run_tiles + (size_t)lb * DF_LEVELS * (DF_RUN / 4) * DF_THREADS + tid;
  const int q = tid % CH;  // this thread's 16-byte part of each row it copies
  const float my_edge = edge[c0 + tid];

  for (int j0 = 0; j0 < mine; j0 += DF_TILES) {
    int bin[B_PER];  // the operand rows this thread copies in this pass
#pragma unroll
    for (int r = 0; r < B_PER; ++r) {
      const int p = (tid + DF_THREADS * r) / CH;
      const int jt = j0 + (p >> 3);
      bin[r] = jt < mine ? 8 * (g + DF_GROUPS * jt) + (p & 7) : 0;
    }
    auto load_stage = [&](int ks) {
      DftStage& s = st[ks % DF_STAGES];
      const int col = ks * DF_BK + 4 * q;
#pragma unroll
      for (int r = 0; r < A_PER; ++r) {
        const int row = (tid + DF_THREADS * r) / CH;
        cp_async16(&s.ap[row][4 * q], ap + (size_t)(c0 + row) * half + col);
        cp_async16(&s.am[row][4 * q], am + (size_t)(c0 + row) * half + col);
      }
#pragma unroll
      for (int r = 0; r < B_PER; ++r) {
        const int p = (tid + DF_THREADS * r) / CH;
        cp_async16(&s.cs[p][4 * q], dft + (size_t)bin[r] * half + col);
        cp_async16(&s.sn[p][4 * q], dft + (size_t)(k + bin[r]) * half + col);
      }
    };

    float acc[DF_TM][8];
#pragma unroll
    for (int i = 0; i < DF_TM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int s = 0; s < DF_STAGES - 1; ++s) {
      if (s < ksteps) load_stage(s);
      cp_async_commit();
    }
    int next_fold = seg_steps, seg = 0;  // seg: segments ended so far
    for (int ks = 0; ks < ksteps; ++ks) {
      cp_async_wait<DF_STAGES - 2>();
      __syncthreads();  // stage ks has landed; every thread is done with stage ks - 1
      if (ks + DF_STAGES - 1 < ksteps) load_stage(ks + DF_STAGES - 1);
      cp_async_commit();
      const DftStage& s = st[ks % DF_STAGES];
      const float(*A)[DF_LD] = is_v ? s.am : s.ap;
      const float(*B)[DF_LD] = is_v ? s.sn : s.cs;
#pragma unroll
      for (int kq = 0; kq < DF_BK; kq += 2) {
        float2 a[DF_TM], b[8];
#pragma unroll
        for (int i = 0; i < DF_TM; ++i) a[i] = *reinterpret_cast<const float2*>(&A[tr + 8 * i][kq]);
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = *reinterpret_cast<const float2*>(&B[tc + 8 * j][kq]);
        // samples kq, kq + 1 in ascending order into every accumulator
#pragma unroll
        for (int i = 0; i < DF_TM; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(b[j].x, a[i].x, acc[i][j]);
#pragma unroll
        for (int i = 0; i < DF_TM; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(b[j].y, a[i].y, acc[i][j]);
      }
      if (ks + 1 == next_fold && ks + 1 < ksteps) {  // a segment ends, not the last
        // the binary counter: add the levels below the lowest set bit of
        // ++seg, then store the sum at that bit's level
        int l = 0;
        for (++seg; !((seg >> l) & 1); ++l) add_running(acc, run + l * (DF_RUN / 4) * DF_THREADS);
        float4* dst = run + l * (DF_RUN / 4) * DF_THREADS;
#pragma unroll
        for (int i = 0; i < DF_RUN / 4; ++i)
          dst[i * DF_THREADS] = make_float4(acc[i >> 1][(i & 1) * 4], acc[i >> 1][(i & 1) * 4 + 1],
                                            acc[i >> 1][(i & 1) * 4 + 2],
                                            acc[i >> 1][(i & 1) * 4 + 3]);
#pragma unroll
        for (int i = 0; i < DF_TM; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
        next_fold += seg_steps;
      }
    }
    // the last segment: add the levels of seg's set bits, lowest first
    for (int l = 0; l < DF_LEVELS; ++l)
      if ((seg >> l) & 1) add_running(acc, run + l * (DF_RUN / 4) * DF_THREADS);
    cp_async_wait<0>();
    __syncthreads();  // the stages are free: U and V go to shared memory
    float(*E)[DF_ELD] = reinterpret_cast<float(*)[DF_ELD]>(smem_f) + (is_v ? DF_BM : 0);
#pragma unroll
    for (int i = 0; i < DF_TM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) E[tr + 8 * i][tc + 8 * j] = acc[i][j];
    __syncthreads();
    // the epilogue: the edge term edge_norm (-1)^k x[N/2], magnitude, L2
    // in float32 (the plain version's operations); terms in ascending k,
    // added in double to the group's sum
    const float(*EU)[DF_ELD] = reinterpret_cast<const float(*)[DF_ELD]>(smem_f);
    const float(*EV)[DF_ELD] = EU + DF_BM;
    const float* tgt = target + (size_t)blockIdx.y * k;  // the row block's target row
    double fit = 0.0;
    for (int p = 0; p < DF_BN; ++p) {
      const int jt = j0 + (p >> 3);
      if (jt >= mine) break;
      const int kk = 8 * (g + DF_GROUPS * jt) + (p & 7);
      const float ec = (kk & 1) ? -sp.edge_norm : sp.edge_norm;
      const float u = fadd(EU[tid][p], fmul(ec, my_edge));
      const float v = EV[tid][p];
      const float mag = sqrtf(fadd(fmul(u, u), fmul(v, v)));
      const float dd = fsub(mag, __ldg(tgt + kk));
      fit = __dadd_rn(fit, (double)fmul(dd, dd));
    }
    double* part = partial + (size_t)g * rows + c0 + tid;  // the thread's own
    *part = j0 ? __dadd_rn(*part, fit) : fit;
    __syncthreads();  // the next pass's copies overwrite U and V
  }
  if (!mine) partial[(size_t)g * rows + c0 + tid] = 0.0;  // a group with no bins
}

// fitness[r pop + c] = for each frame f of run r (blockIdx.y), the eight
// group sums of candidate c (row (r frames + f) pop_pad + c of partial's
// DF_GROUPS blocks of `rows`) added in double in group order, from 0,
// rounded once to float32; the frames' values added in float32 in frame
// order.
__global__ void __launch_bounds__(SUM_TPB)
f32_sum_kernel(const double* __restrict__ partial, int rows, int pop_pad, int pop, int frames,
               float* __restrict__ fitness) {
  const int c = blockIdx.x * SUM_TPB + threadIdx.x, run = blockIdx.y;
  if (c >= pop) return;
  float fit = 0.f;
  for (int f = 0; f < frames; ++f) {
    const double* part = partial + (size_t)(run * frames + f) * pop_pad + c;
    double s = 0.0;
#pragma unroll
    for (int g = 0; g < DF_GROUPS; ++g) s = __dadd_rn(s, part[(size_t)g * rows]);
    const float ff = __double2float_rn(s);
    fit = f ? fadd(fit, ff) : ff;
  }
  fitness[(size_t)run * pop + c] = fit;
}

// ---- launcher -----------------------------------------------------------------

// Whether the FFT takes frames of n samples: a power of two in 2^FFT_MIN_LOGN
// .. 2^FFT_MAX_LOGN.
static bool fft_takes(int n) {
  return n >= (1 << FFT_MIN_LOGN) && n <= (1 << FFT_MAX_LOGN) && !(n & (n - 1));
}

// Floats of scratch for `runs` runs of pop candidates at `frames` frames of
// n samples, on the FFT route (fft) or the DFT's: for each of the runs x
// frames row blocks, the samples (pop_pad x n), the DFT's a+ and a-
// (pop_pad x N/2 each), edge samples (pop_pad), group sums (DF_GROUPS x
// pop_pad doubles) and, where the DFT splits the samples (N/2 above
// DF_SPLIT_ABOVE), DF_LEVELS running tiles of DF_RUN floats for each thread
// of each DFT block (DF_GROUPS x DF_LEVELS x DF_RUN x pop_pad); on the FFT
// route then each row's frame value, its row block's list of exact matches
// and their count (3 x pop_pad).
// kernels/synth_fitness.py::f32_scratch_floats is the same formula.
static long long f32_scratch_floats(int pop, int n, int frames, int runs, bool fft) {
  const long long pop_pad = (long long)(pop + ROW_PAD - 1) / ROW_PAD * ROW_PAD;
  const long long run = n / 2 > DF_SPLIT_ABOVE ? (long long)DF_GROUPS * DF_LEVELS * DF_RUN : 0;
  const long long per_row = 2LL * n + 1 + 2 * DF_GROUPS + run + (fft ? 3 : 0);
  return (long long)runs * frames * pop_pad * per_row;
}

// The FFT route's lists of exact matches (rows ints, a row block's at its
// rows) and their counts (one a row block), after its frame values.
static int* f32_exact_list(const F32Plan& plan) {
  return reinterpret_cast<int*>(plan.frame_fit + plan.rows);
}
static int* f32_exact_count(const F32Plan& plan) { return f32_exact_list(plan) + plan.rows; }

// The FFT kernel for frames of n samples.
static F32FftKernel fft_kernel(int n) {
  switch (n) {
    case 256: return f32_fft_kernel<8>;
    case 512: return f32_fft_kernel<9>;
    case 1024: return f32_fft_kernel<10>;
    default: return f32_fft_kernel<11>;
  }
}

// The plan of the kernels for `runs` runs of pop candidates at sp.frames
// frames (generation.cuh): the route (sp.fft given: the FFT), the
// synthesis in the layout sp.f32_tp names (fused_f32_tp.cu's time-parallel
// kernel, or f32_synth_kernel's instantiation for the sine order and the
// chain or bank), with B2's offspring prologue (GEN) or B1's parameters,
// the scratch's views and the spectrum kernel's shared memory.
// cudaErrorInvalidValue for too little scratch, an FFT asked for at a frame
// it does not take, a frame whose half is not whole DF_BK-sample stages or
// of more segments than the DFT's running tiles' levels take (the FFT
// route's exact matches take the DFT too), more row blocks than a grid's
// second dimension takes, or a time-parallel layout asked for at a code it
// does not take.
template <bool GEN>
static int prepare_f32(const SynthParams& sp, int pop, int runs, float* scratch,
                       long long scratch_floats, F32Plan* plan) {
  const bool fft = sp.fft != nullptr;
  if (pop < 1 || runs < 1 || sp.frames < 1 || (long long)runs * sp.frames > 65535 ||
      (long long)runs * sp.frames * (pop + ROW_PAD) > 0x7FFFFFFFLL ||
      scratch_floats < f32_scratch_floats(pop, sp.n, sp.frames, runs, fft) ||
      (fft && !fft_takes(sp.n)) || (sp.n / 2) % DF_BK || sp.n / 2 > DF_MAX_SEGS * DF_SEG)
    return (int)cudaErrorInvalidValue;
  const int pop_pad = (pop + ROW_PAD - 1) / ROW_PAD * ROW_PAD;
  const size_t half = sp.n / 2, rows = (size_t)runs * sp.frames * pop_pad;
  *plan = F32Plan{};
  plan->pop = pop;
  plan->pop_pad = pop_pad;
  plan->runs = runs;
  plan->rows = (int)rows;
  plan->fft = fft;
  plan->x = scratch;
  plan->ap = plan->x + rows * sp.n;
  plan->am = plan->ap + rows * half;
  plan->edge = plan->am + rows * half;
  plan->partial = reinterpret_cast<double*>(plan->edge + rows);  // pop_pad is even
  float* rest = reinterpret_cast<float*>(plan->partial + (size_t)DF_GROUPS * rows);
  if (sp.n / 2 > DF_SPLIT_ABOVE) {
    plan->run = rest;
    rest += rows * (size_t)(DF_GROUPS * DF_LEVELS * DF_RUN);
  }
  if (fft) plan->frame_fit = rest;  // then the exact matches' lists and counts
  int e;
  if (sp.f32_tp) {
    e = prepare_f32_tp(sp, pop_pad, plan);
  } else {
    e = dispatch_ncoef(sp.ncoef, [&](auto nc) {
      return dispatch_synth<true>(sp, [&](auto kc) {
        plan->synth = f32_synth_kernel<decltype(nc)::value, decltype(kc)::value, GEN>;
        return 0;
      });
    });
    plan->synth_blocks = pop_pad / SY_TPB;
    plan->synth_threads = SY_TPB;
  }
  if (e) return e;
  if (fft) e = (int)prepare(fft_kernel(sp.n), FFT_TILE * sizeof(float));
  return e ? e : (int)prepare(f32_dft_kernel, DF_SMEM);
}

int prepare_generation_f32(const SynthParams& sp, int pop, int runs, float* scratch,
                           long long scratch_floats, F32Plan* plan) {
  return prepare_f32<true>(sp, pop, runs, scratch, scratch_floats, plan);
}

// The kernels of a plan on `stream`; returns cudaGetLastError() after each
// launch (the first error stops it).
int launch_f32(const F32Plan& plan, const float* params, uint32_t seed, const uint32_t* run_seeds,
               const float* pv, const float* ps, const MutateParams& mp, float* values,
               float* steps, const SynthParams& sp, const float* dft, const float* target,
               float* fitness, cudaStream_t stream) {
  if (pv && plan.runs > 1 && !run_seeds) return (int)cudaErrorInvalidValue;
  const F32SynthKernel synth = plan.synth;
  synth<<<dim3(plan.synth_blocks, plan.runs), plan.synth_threads, plan.synth_smem, stream>>>(
      params, seed, run_seeds, pv, ps, mp, values, steps, plan.pop, sp, plan.x, plan.pop_pad);
  int e = (int)cudaGetLastError();
  if (e) return e;
  // the FFT route: every row's fitness and its row block's list of exact
  // matches, then the DFT's kernels on the listed rows only (most launches
  // list none: every block of theirs returns at once)
  int* const count = plan.fft ? f32_exact_count(plan) : nullptr;
  int* const list = plan.fft ? f32_exact_list(plan) : nullptr;
  if (plan.fft) {
    e = (int)cudaMemsetAsync(count, 0, sizeof(int) * plan.runs * sp.frames, stream);
    if (e) return e;
    const F32FftKernel fft = fft_kernel(sp.n);
    fft<<<plan.rows / (FFT_TILE / sp.n), FFT_THREADS, FFT_TILE * sizeof(float), stream>>>(
        plan.x, sp.fft, target, sp.k, plan.pop_pad, plan.frame_fit, count, list);
    e = (int)cudaGetLastError();
    if (e) return e;
  }
  f32_fold_kernel<<<dim3(plan.pop_pad / DF_BM, plan.runs * sp.frames), FOLD_TPB, 0, stream>>>(
      plan.x, sp.n, plan.pop_pad, count, list, plan.ap, plan.am, plan.edge);
  e = (int)cudaGetLastError();
  if (e) return e;
  f32_dft_kernel<<<dim3(plan.pop_pad / DF_BM * DF_GROUPS, plan.runs * sp.frames), DF_THREADS,
                   DF_SMEM, stream>>>(plan.ap, plan.am, plan.edge, dft, target, sp, plan.rows,
                                      plan.partial, reinterpret_cast<float4*>(plan.run), count);
  e = (int)cudaGetLastError();
  if (e) return e;
  const dim3 sum_grid((plan.pop + SUM_TPB - 1) / SUM_TPB, plan.runs);
  if (plan.fft) {
    f32_exact_kernel<<<(plan.rows + SUM_TPB - 1) / SUM_TPB, SUM_TPB, 0, stream>>>(
        plan.partial, count, list, plan.rows, plan.pop_pad, plan.frame_fit);
    e = (int)cudaGetLastError();
    if (e) return e;
    f32_frames_kernel<<<sum_grid, SUM_TPB, 0, stream>>>(plan.frame_fit, plan.pop_pad, plan.pop,
                                                        sp.frames, fitness);
  } else {
    f32_sum_kernel<<<sum_grid, SUM_TPB, 0, stream>>>(plan.partial, plan.rows, plan.pop_pad,
                                                     plan.pop, sp.frames, fitness);
  }
  return (int)cudaGetLastError();
}

extern "C" {

// B1 true f32: fitness (runs, pop) of scaled params (runs, pop, d) against
// the float32 folded operand (2k, n/2: the DFT's, on the FFT route for its
// exact matches) and the targets
// (runs, sp.frames, k); `scratch` holds f32_scratch_floats(pop, n,
// sp.frames, runs, sp.fft != null) floats. Returns cudaGetLastError().
int pmfm_fused_synth_fitness_f32(const float* params, int pop, int runs, SynthParams sp,
                                 const float* dft, const float* target, float* fitness,
                                 float* scratch, long long scratch_floats, cudaStream_t stream) {
  F32Plan plan;
  const int e = prepare_f32<false>(sp, pop, runs, scratch, scratch_floats, &plan);
  return e ? e
           : launch_f32(plan, params, 0u, nullptr, nullptr, nullptr, MutateParams{}, nullptr,
                        nullptr, sp, dft, target, fitness, stream);
}

// B2 true f32: one generation's offspring (runs, pop, d) values and steps
// from the parents (runs, mu, d), and their fitness (runs, pop); run r
// draws with run_seeds[r] (device memory; null for one run, which draws with
// seed). Returns cudaGetLastError().
int pmfm_fused_generation_f32(uint32_t seed, const uint32_t* run_seeds, const float* pv,
                              const float* ps, int pop, int runs, SynthParams sp,
                              MutateParams mp, const float* dft, const float* target,
                              float* fitness, float* values, float* steps, float* scratch,
                              long long scratch_floats, cudaStream_t stream) {
  F32Plan plan;
  const int e = prepare_generation_f32(sp, pop, runs, scratch, scratch_floats, &plan);
  return e ? e
           : launch_f32(plan, nullptr, seed, run_seeds, pv, ps, mp, values, steps, sp, dft,
                        target, fitness, stream);
}

}  // extern "C"
