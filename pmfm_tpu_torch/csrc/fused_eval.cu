// Fused FM synthesis + folded DFT + L2 spectral fitness for Hopper (sm_90a),
// with and without an in-kernel offspring prologue, in the int8 mode.
//
// Replaces two TPU kernels of pmfm_tpu:
//   B1 <- kernels/synth_fitness.py::fused_synth_fitness (with _dft_uv, the
//         folded DFT on the MXU)
//   B2 <- kernels/generation.py::fused_generation
// as fused_synth_fitness_int8_kernel and fused_generation_int8_kernel in the
// int8 mode; the true-f32 mode of both is fused_f32.cu's.
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
//   shared memory (evaluate_int8_mma's frame loop): shared memory stays
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

#include "generation.cuh"

#define TC_CPB 32  // int8: candidates per CUDA block, one warp
#define TC_NT 4    // int8: n-tiles of 8 bins per pass over a+/-
#define TC_DEPTH 2  // int8: 64-sample steps of the operand in flight (divides n / 128)

// ---- int8 mode: the folded DFT on the int8 tensor cores -------------------------

// 16-byte unit u of row r of a+/- sits at unit u ^ tc_swizzle(r): the 8 rows
// that a phase of the synthesis stores hit 8 different unit columns, and the
// 2 rows that a phase of the fragment loads reads hit disjoint halves.
__device__ __forceinline__ int tc_swizzle(int r) { return ((r & 1) << 2) | ((r >> 1) & 3); }

// One candidate's row of int8 a+ or a- in shared memory, for FoldEmit: a
// group of 16 samples is one 16-byte unit.
struct SwizzledRow {
  uint4* row;
  int swz;
  __device__ __forceinline__ void store(int s, const float* v) const {
    row[(s >> 4) ^ swz] = make_uint4(pack_s8x4(v), pack_s8x4(v + 4), pack_s8x4(v + 8),
                                     pack_s8x4(v + 12));
  }
  __device__ __forceinline__ void load(int s, float* v) const {
    const uint4 w = row[(s >> 4) ^ swz];
    unpack_s8x4(w.x, v);
    unpack_s8x4(w.y, v + 4);
    unpack_s8x4(w.z, v + 8);
    unpack_s8x4(w.w, v + 12);
  }
};
static_assert(FOLD_G == 16, "SwizzledRow stores one 16-byte unit per group");

// d += A (16 x 32, rows g and g+8 in a0..a3) x B (32 x 8, column g in b0, b1)
__device__ __forceinline__ void mma_s8(int* d, uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One 64-sample step of an m16n8 tile: the thread's 16 bytes of rows g (lo)
// and g + 8 (hi) and of column g (b), consumed by two mma.
__device__ __forceinline__ void mma_step(int* d, const uint4& lo, const uint4& hi, const uint4& b) {
  mma_s8(d, lo.x, hi.x, lo.y, hi.y, b.x, b.y);
  mma_s8(d, lo.z, hi.z, lo.w, hi.w, b.z, b.w);
}

// Bins [k0, k0 + 8 NT) of the warp's 32 candidates: U and V on the tensor
// cores, then each bin's term, added in ascending order to fit[mt], the
// fitness of row mt * 16 + g + 8 (c & 1) (kept by threads c = 0, 1). ue
// holds 127 x[N/2] (+ for even bins, - for odd) and ms the magnitude scale
// of rows mt * 16 + 8 h + g.
template <int NT>
__device__ __forceinline__ void dft_pass(int k0, const uint4* s_ap, const uint4* s_am, int units,
                                         const int8_t* __restrict__ dft,
                                         const float* __restrict__ target, int k, int half,
                                         const float (&ue)[2][2][2], const float (&ms)[2][2],
                                         float (&fit)[2]) {
  const int lane = threadIdx.x, g = lane >> 2, c = lane & 3, sw = tc_swizzle(g);
  int acc[2][NT][2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][t][0][i] = acc[mt][t][1][i] = 0;
  const uint4* pu[NT];
  const uint4* pv[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    pu[t] = reinterpret_cast<const uint4*>(dft + (size_t)(k0 + 8 * t + g) * half) + c;
    pv[t] = reinterpret_cast<const uint4*>(dft + (size_t)(k + k0 + 8 * t + g) * half) + c;
  }
  // the operand of the next TC_DEPTH steps in flight: slot d holds step
  // s + d of the group of TC_DEPTH steps from s (steps = n / 128 is even)
  uint4 bu[TC_DEPTH][NT], bv[TC_DEPTH][NT];
#pragma unroll
  for (int d = 0; d < TC_DEPTH; ++d)
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      bu[d][t] = __ldg(pu[t] + 4 * d);
      bv[d][t] = __ldg(pv[t] + 4 * d);
    }
  for (int s0 = 0; s0 < units; s0 += 4 * TC_DEPTH) {
#pragma unroll
    for (int d = 0; d < TC_DEPTH; ++d) {
      const int u0 = s0 + 4 * d;
      const int ua = (u0 + c) ^ sw;
      uint4 ap[2][2], am[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mt * 16 + h * 8 + g;
          ap[mt][h] = s_ap[r * units + ua];
          am[mt][h] = s_am[r * units + ua];
        }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          mma_step(acc[mt][t][0], ap[mt][0], ap[mt][1], bu[d][t]);
          mma_step(acc[mt][t][1], am[mt][0], am[mt][1], bv[d][t]);
        }
      // refill the slot with the step TC_DEPTH ahead (past the end: its own)
      const int un = u0 + 4 * TC_DEPTH < units ? u0 + 4 * TC_DEPTH : u0;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        bu[d][t] = __ldg(pu[t] + un);
        bv[d][t] = __ldg(pv[t] + un);
      }
    }
  }
  // epilogue: the x[N/2] edge term, magnitude, |amp| rescale, L2; register
  // i of a tile is row g + 8 (i >> 1), bin 2c + (i & 1)
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int kb = k0 + 8 * t + 2 * c;
    const float tg[2] = {__ldg(target + kb), __ldg(target + kb + 1)};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float u = fadd((float)acc[mt][t][0][i], ue[mt][i >> 1][i & 1]);  // kb is even
        const float v = (float)acc[mt][t][1][i];
        const float mag = fmul(sqrtf(fadd(fmul(u, u), fmul(v, v))), ms[mt][i >> 1]);
        const float dd = fsub(mag, tg[i & 1]);
        e[i] = fmul(dd, dd);
      }
      // bins 2j, 2j + 1 of the tile sit in thread (g, j): row g's owner
      // (c = 0) takes registers 0, 1, row g + 8's (c = 1) registers 2, 3
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int src = (lane & ~3) | j;
        const float x0 = __shfl_sync(0xFFFFFFFFu, e[0], src);
        const float x1 = __shfl_sync(0xFFFFFFFFu, e[1], src);
        const float x2 = __shfl_sync(0xFFFFFFFFu, e[2], src);
        const float x3 = __shfl_sync(0xFFFFFFFFu, e[3], src);
        fit[mt] = fadd(fit[mt], (c & 1) ? x2 : x0);
        fit[mt] = fadd(fit[mt], (c & 1) ? x3 : x1);
      }
    }
  }
}

// The fitness of the block's 32 candidates, thread t holding candidate t's
// scaled parameters p; writes fitness[base + t] for base + t < pop. KN is
// the synthesis code of dispatch_synth (a chain, or a bank above BANK_KN).
// sp.frames frames of one continuous synthesis (CandidateSynth's carries
// live on from frame to frame): frame f is synthesised and folded into the
// warp's a+/- (one frame: shared memory does not grow with the frames),
// transformed against target row f (target + f k), and its total added in
// float32 to the candidate's fitness in frame order before the next frame
// overwrites a+/-. The frame count is a runtime loop bound outside the
// per-sample loop.
template <int NC, int KN>
__device__ __forceinline__ void evaluate_int8_mma(const float* p, const SynthParams& sp,
                                                  const int8_t* __restrict__ dft,
                                                  const float* __restrict__ target, uint4* smem,
                                                  float* __restrict__ fitness, int base, int pop) {
  const int lane = threadIdx.x, g = lane >> 2, c = lane & 3;
  const int half = sp.n >> 1, units = half >> 4;
  uint4* s_ap = smem;
  uint4* s_am = smem + TC_CPB * units;

  // synthesis + fold into the thread's rows of a+/a-
  FoldEmit<true, SwizzledRow> emit;
  emit.ap = SwizzledRow{s_ap + lane * units, tc_swizzle(lane)};
  emit.am = SwizzledRow{s_am + lane * units, tc_swizzle(lane)};
  emit.n = sp.n;
  emit.half = half;
  emit.edge_q = 0.f;
  CandidateSynth<NC, KN, true> cs;
  const float amp = cs.init(p, sp);
  emit.amp = amp;
  float fit[2] = {0.f, 0.f};
  for (int f = 0; f < sp.frames; ++f) {
    if (f) __syncwarp();  // the warp is done reading the last frame's a+/-
    cs.frame(sp, emit);
    emit.fold_rows(0, false, 0.f);  // rows [0, 16): row 0 keeps q[0] alone
    const float mag_scale = fmul(fabsf(amp), sp.dft_scale);
    __syncwarp();

    // the edge term 127 (-1)^k x[N/2] of each row, for even and odd k
    float ue[2][2][2], ms[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float eq = __shfl_sync(0xFFFFFFFFu, emit.edge_q, mt * 16 + h * 8 + g);
        ue[mt][h][0] = fmul(127.f, eq);
        ue[mt][h][1] = fmul(-127.f, eq);
        ms[mt][h] = __shfl_sync(0xFFFFFFFFu, mag_scale, mt * 16 + h * 8 + g);
      }
    // run blockIdx.y's target row f, formed here so that no moved base
    // pointer stays live across the passes (the kernels sit at up to 255
    // registers)
    const float* tgt = target + ((size_t)blockIdx.y * sp.frames + f) * sp.k;
    float ff[2] = {0.f, 0.f};
    const int tiles = sp.k >> 3;
    int t0 = 0;
    for (; t0 + TC_NT <= tiles; t0 += TC_NT)
      dft_pass<TC_NT>(8 * t0, s_ap, s_am, units, dft, tgt, sp.k, half, ue, ms, ff);
    for (; t0 < tiles; ++t0)
      dft_pass<1>(8 * t0, s_ap, s_am, units, dft, tgt, sp.k, half, ue, ms, ff);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) fit[mt] = fadd(fit[mt], ff[mt]);
  }
  if (c < 2) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int cand = base + mt * 16 + 8 * c + g;
      if (cand < pop) fitness[(size_t)blockIdx.y * pop + cand] = fit[mt];
    }
  }
}

// Thread t's scaled parameters from the block's (TC_CPB, d) rows in shared memory.
__device__ __forceinline__ void take_params(const float* s_p, int d, float* p) {
#pragma unroll
  for (int i = 0; i < MAX_D; ++i) p[i] = i < d ? s_p[threadIdx.x * d + i] : 0.f;
}

// The run axis: blockIdx.y is run r of a batched launch, whose candidates
// are rows [r pop, (r + 1) pop) of the (runs, pop, d) arrays, whose target
// is rows [r F, (r + 1) F) of the (runs, F, k) targets and whose fitness is
// row r of (runs, pop). A run's blocks compute what a launch of that run
// alone computes (in B2 with the run's own Philox seed, run_seeds[r], and
// its own parents), so a batched launch is bit-equal, run for run, to lone
// launches.
template <int NC, int KN>
__global__ void __launch_bounds__(TC_CPB)
fused_synth_fitness_int8_kernel(const float* __restrict__ params, int pop, SynthParams sp,
                                const int8_t* __restrict__ dft, const float* __restrict__ target,
                                float* __restrict__ fitness) {
  extern __shared__ __align__(16) uint4 smem_tc[];
  float* s_p = reinterpret_cast<float*>(smem_tc);  // before the synthesis writes a+/-
  const int base = blockIdx.x * TC_CPB, d = sp.d;
  const float* run_params = params + (size_t)blockIdx.y * pop * d;
  const int avail = min(pop - base, TC_CPB) * d;
  for (int i = threadIdx.x; i < TC_CPB * d; i += TC_CPB)
    s_p[i] = i < avail ? run_params[(size_t)base * d + i] : 0.f;
  __syncwarp();
  float p[MAX_D];
  take_params(s_p, d, p);
  __syncwarp();
  evaluate_int8_mma<NC, KN>(p, sp, dft, target, smem_tc, fitness, base, pop);
}

template <int NC, int KN>
__global__ void __launch_bounds__(TC_CPB)
fused_generation_int8_kernel(uint32_t seed, const uint32_t* __restrict__ run_seeds,
                             const float* __restrict__ pv, const float* __restrict__ ps, int pop,
                             SynthParams sp, MutateParams mp, const int8_t* __restrict__ dft,
                             const float* __restrict__ target, float* __restrict__ fitness,
                             float* __restrict__ values, float* __restrict__ steps) {
  extern __shared__ __align__(16) uint4 smem_tc[];
  float* s_p = reinterpret_cast<float*>(smem_tc);  // before the synthesis writes a+/-
  const int base = blockIdx.x * TC_CPB, d = sp.d, run = blockIdx.y;
  if (run_seeds) seed = __ldg(run_seeds + run);
  const size_t po = (size_t)run * mp.mu * d, oo = (size_t)run * pop * d;  // the run's rows
  for (int i = threadIdx.x; i < TC_CPB * d; i += TC_CPB) {  // pair i: (i / d, i % d)
    const int cl = i / d, cand = base + cl;
    s_p[i] = cand < pop ? offspring_gene(seed, cand, i - cl * d, pv + po, ps + po, mp, d,
                                         values + oo, steps + oo)
                        : 0.f;
  }
  __syncwarp();
  float p[MAX_D];
  take_params(s_p, d, p);
  __syncwarp();
  evaluate_int8_mma<NC, KN>(p, sp, dft, target, smem_tc, fitness, base, pop);
}

// ---- launchers ------------------------------------------------------------------

#define PICK(kernel) \
  [](auto nc, auto kc) { return kernel<decltype(nc)::value, decltype(kc)::value>; }

// The int8 kernel `pick` gives for the sine order and the synthesis
// (dispatch_synth: the chain length or the bank's pairs), with its shared
// memory set, asking for the largest carveout so that six blocks of one
// warp fit an SM at n 1024.
template <typename Pick, typename K>
static int prepare_int8(Pick&& pick, const SynthParams& sp, K* out) {
  if (sp.frames < 1) return (int)cudaErrorInvalidValue;
  K kernel = nullptr;
  int e = dispatch_ncoef(sp.ncoef, [&](auto nc) {
    return dispatch_synth(sp, [&](auto kc) {
      kernel = pick(nc, kc);
      return 0;
    });
  });
  if (e) return e;
  e = (int)prepare(kernel, (size_t)sp.n * TC_CPB);
  if (!e)
    e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                  (int)cudaSharedmemCarveoutMaxShared);
  *out = kernel;
  return e;
}

// A prepared int8 kernel on blocks of one warp, `runs` rows of blocks.
template <typename K, typename... Args>
static int launch_int8(K kernel, const SynthParams& sp, int pop, int runs, cudaStream_t stream,
                       Args... args) {
  if (pop < 1 || runs < 1 || runs > 65535) return (int)cudaErrorInvalidValue;
  kernel<<<dim3((pop + TC_CPB - 1) / TC_CPB, runs), TC_CPB, (size_t)sp.n * TC_CPB, stream>>>(
      args...);
  return (int)cudaGetLastError();
}

typedef void (*FitInt8Kernel)(const float*, int, SynthParams, const int8_t*, const float*, float*);

int prepare_generation_int8(const SynthParams& sp, GenInt8Kernel* kernel) {
  return prepare_int8(PICK(fused_generation_int8_kernel), sp, kernel);
}

int launch_generation_int8(GenInt8Kernel kernel, uint32_t seed, const uint32_t* run_seeds,
                           const float* pv, const float* ps, int pop, int runs,
                           const SynthParams& sp, const MutateParams& mp, const int8_t* dft,
                           const float* target, float* fitness, float* values, float* steps,
                           cudaStream_t stream) {
  if (runs > 1 && !run_seeds) return (int)cudaErrorInvalidValue;
  return launch_int8(kernel, sp, pop, runs, stream, seed, run_seeds, pv, ps, pop, sp, mp, dft,
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
  const int e = prepare_int8(PICK(fused_synth_fitness_int8_kernel), sp, &kernel);
  return e ? e
           : launch_int8(kernel, sp, pop, runs, stream, params, pop, sp, (const int8_t*)dft,
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
