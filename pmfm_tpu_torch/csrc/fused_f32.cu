// B1 and B2 in the true-f32 mode for Hopper (sm_90a): FM synthesis + fold,
// a register-tiled f32 folded DFT on the CUDA cores, and the L2 spectral
// fitness, as three kernels behind one launcher.
//
// Replaces, in the true-f32 mode (the refine tail's engine: dft_scale 0, the
// float32 operand, unquantised audio x = sin * amp):
//   B1 <- pmfm_tpu/kernels/synth_fitness.py::fused_synth_fitness, with _dft_uv
//         and _evaluate_block's audio_f32
//   B2 <- pmfm_tpu/kernels/generation.py::fused_generation
// (the int8 mode of both is fused_eval.cu's). B5 (evolve.cu) runs B2's three
// kernels for each of its f32 generations, through generation.cuh's plan.
//
// What bounds it on an H100 at the shipped tail's shape (n 1024, K 512,
// P 2^15): the folded DFT is 2 * 2K * (N/2) * P = 34.4 G f32 operations,
// which must run on the CUDA cores in full f32 (never TF32: the reference's
// dots are Precision.HIGHEST), 0.51 ms at 67 TFLOP/s; the synthesis adds
// ~1.9 G f32 operations: 0.54 ms in all. The scratch a+/a- between the two
// halves is 2 x P x N/2 floats, 128 MB at P 2^15 and n 1024 (written once,
// read once: ~77 us of HBM traffic at 3.35 TB/s, ~15% of the bound), 32 MB
// at P 4096 and n 2048, which L2 holds.
//
// The earlier design (one fused block of 16 candidates x 8 threads, since
// removed) ran at 10x that bound. Its three limits and what this one
// does about each:
// 1. Its DFT loaded more than it computed (one 16-byte operand load per 3.6
//    FMAs; every 16-candidate block read the whole 2 MB operand). Here
//    f32_dft_kernel is a register-tiled product: a block takes DF_BM = 128
//    candidates and one group of bin tiles; cp.async stages 16-sample slices
//    of a+/a- and of the operand rows in shared memory (DF_STAGES deep), and
//    each thread keeps a 16 x 8 register tile (16 candidates x 8 bins) of U
//    or of V (warps 0-1 U = a+ C^T, warps 2-3 V = a- S^T), so each value
//    loaded from shared memory serves 8 or 16 FMAs, and each operand row
//    loaded from L2 serves 128 candidates.
// 2. Its synthesis ran on 16 threads of 128. Here f32_synth_kernel runs one
//    thread a candidate on blocks of SY_TPB threads, and writes a+/a- and the
//    edge sample to scratch, each warp's stores staged through shared memory
//    so that they cover whole 64-byte row segments (F32Row).
// 3. Its synthesis read the chain length at run time (a runtime loop bound
//    cost the int8 synthesis 4x). Here synth_run gets it as the compile-time
//    KN (dispatch_synth; an fm{k}_parallel bank's pair count likewise, to
//    synth_bank_span) with the grouped fold emitter FoldEmit on an exact
//    f32 row (F32Row).
//
// Numerics. The audio is the plain version's bit for bit: synth_run's
// samples and operations, each sample fmul(y, amp) unrounded (a pair bank:
// synth_bank_span's sum over the pairs divided by k, times 1); a+ = old + x,
// a- = old - x (synth_common.cuh's FoldEmit). Only the order of the sums
// differs from the plain version's float32 products:
// * U[c][k] and V[c][k] are sums of exact-product __fmaf_rn steps over the
//   samples in ascending order, with no tensor cores, in segments. Where
//   N/2 <= DF_SPLIT_ABOVE (512: the shipped tail's n 1024 and below) one
//   accumulator a bin runs from 0 over all N/2 samples. Above it the samples
//   split into segments of DF_SEG = 128: each segment's chain starts from 0
//   and the segments are added pairwise, by a binary counter over running
//   tiles in scratch (DF_LEVELS of them, the thread's own 128 floats each,
//   so no other thread touches them): at the end of segment c (from 1) the
//   tiles of the levels below c's lowest set bit are added in, earlier
//   samples on the left, and the sum goes to that bit's level; after the
//   last segment the levels of the set bits of c - 1 are added, lowest first.
//   That is ((s0 + s1) + (s2 + s3)) + ... with the same scratch traffic as
//   an in-order sum (one tile read and one written a segment on average).
//   One ascending chain over all 1792 samples of n 3584 had put the kernel
//   16x further from a float64 evaluation than cuBLAS's blocked sums;
//   256-sample segments added in order still 2.5x at one candidate
//   (chip_smoke.py phase 12 prints both against float64). The running tiles
//   live in scratch because the 16 x 8 tile of a thread already takes 254
//   registers and the stages fill shared memory; their traffic is 64 KB a
//   block a level at each segment end, against 2 x 16 x 128 x 64 FMAs a stage.
// * Each bin's term (the edge term edge_norm (-1)^k x[N/2], the magnitude,
//   the squared difference) is the plain version's float32 operations on U
//   and V, and the terms are summed in double: a block's pass adds its 64
//   terms to the group's double in scratch (the thread's own), and the last
//   kernel adds the eight group sums in group order and rounds once to
//   float32. The 1024 terms of n 2048 summed in float32 in each group's
//   order had put a single candidate 26x further from float64 than the
//   plain version; summed in double, only the rounding of U, V and the terms
//   remains (chip_smoke.py phase 12 prints the kernel beside U and V rounded
//   once to float32 with the rest in float64).
// B1 and B2 share the three kernels and B5 runs B2's, so their fitness is
// bit-equal whatever the order; nothing else depends on it.
//
// Geometry. The grid of f32_dft_kernel is (P padded to DF_BM) / DF_BM x
// DF_GROUPS blocks: block b takes candidates [DF_BM (b / 8), + DF_BM) and
// group g = b % 8, so the eight blocks that share a slice of a+/a- run side
// by side and read it from L2. A block walks its group's tiles g, g + 8, ...
// in passes of DF_TILES (64 bins; at K 512 one pass, at K 1024 two), and
// carries the group's sum across passes. Splitting the bins by group fills
// the card at small populations: P 4096 gives 256 blocks of 4 warps (two
// blocks an SM), P 2^15 2048. A last kernel adds the eight group
// sums of each candidate in group order. The scratch rows past P (up to the
// padding) are synthesised from zero parameters and dropped.
//
// Frames and runs. With sp.frames = F > 1 (multi-frame fitness) the
// synthesis kernel writes F frames of one continuous synthesis to F row
// blocks of the scratch, the DFT kernel takes the row blocks as its grid's
// second dimension (each against its own target row), and the sum kernel
// rounds each frame's double sum once, as for one frame, and adds the
// frames' values in float32 in frame order. A batched launch of B runs
// (fused_eval.cu's run axis) adds B x F row blocks the same way, run r with
// its own parameters or parents, seed and target rows. The scratch grows by
// B x F (f32_scratch_floats); at F = B = 1 every kernel computes what it
// computed before.

#include "generation.cuh"

#define SY_TPB 128        // synthesis: candidates (threads) per block
#define DF_BM 128         // DFT: candidates per block (and the scratch's row padding)
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

static_assert(DF_BM % SY_TPB == 0 && SY_TPB % 32 == 0,
              "the synthesis grid covers the padded rows in whole warps");
static_assert(DF_THREADS / 2 == (DF_BM / DF_TM) * DF_TILES,
              "one DF_TM x 8 tile of U or V a thread");
static_assert(DF_THREADS == DF_BM, "a thread a candidate in the epilogue");
static_assert(DF_SEG % DF_BK == 0 && DF_RUN % 4 == 0, "whole stages a segment, float4 slots");
constexpr int DF_MAX_SEGS = 1 << DF_LEVELS;  // segments the levels take: N/2 <= 2048

// One candidate's row of f32 a+ or a- in device memory, for FoldEmit: a group
// of 16 samples is 64 bytes. The 32 threads of a warp hold 32 consecutive
// rows (stride `half`) and store the same group together (the synthesis
// runs them in lockstep), so a store goes through the warp's staging buffer
// in shared memory and each 16-byte write then covers part of a row's 64
// bytes beside three neighbours (8 rows an instruction, not 32 half-sectors:
// 4x less scattered, the kernel's main cost when each thread wrote its own
// row). load reads back the thread's own row, after a later __syncwarp has
// ordered it behind the other threads' stores.
#define SY_LDB (FOLD_G + 4)  // a staged row, padded: 8 rows of a phase on disjoint banks
struct F32Row {
  float* p;    // the thread's row
  float* buf;  // the warp's staging buffer, 32 x SY_LDB floats
  int lane, half;
  __device__ __forceinline__ void store(int s, const float* v) const {
    __syncwarp();  // the warp is done with the buffer's last group
#pragma unroll
    for (int i = 0; i < FOLD_G / 4; ++i)
      *reinterpret_cast<float4*>(buf + lane * SY_LDB + 4 * i) =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
    __syncwarp();
    float* row0 = p - (size_t)lane * half + s;  // lane 0's row
#pragma unroll
    for (int it = 0; it < 32 * FOLD_G / 4 / 32; ++it) {
      const int r = it * 8 + (lane >> 2), q = lane & 3;
      *reinterpret_cast<float4*>(row0 + (size_t)r * half + 4 * q) =
          *reinterpret_cast<const float4*>(buf + r * SY_LDB + 4 * q);
    }
  }
  __device__ __forceinline__ void load(int s, float* v) const {
    const float4* o = reinterpret_cast<const float4*>(p + s);
#pragma unroll
    for (int i = 0; i < FOLD_G / 4; ++i) {
      const float4 w = o[i];
      v[4 * i] = w.x;
      v[4 * i + 1] = w.y;
      v[4 * i + 2] = w.z;
      v[4 * i + 3] = w.w;
    }
  }
};
template <>
struct exact_f32_row<F32Row> : std::true_type {};

// ---- (i) synthesis + fold ----------------------------------------------------

// Candidate base + t's scaled parameters into s_p[t * d ..]: B1 reads them,
// B2 makes them (its offspring prologue: the block's SY_TPB x d (candidate,
// gene) pairs spread over its threads, values and steps written coalesced).
// Then thread t synthesises candidate base + t (zero parameters past pop)
// into rows of a+/a- (scratch, N/2 floats a row) and its edge sample x[N/2],
// frame after frame (sp.frames frames of one continuous synthesis,
// CandidateSynth's carries living on from frame to frame): frame f of run r
// goes to row (r * frames + f) * pop_pad + candidate. blockIdx.y is the run
// (fused_eval.cu's run axis: its own parameters or parents and seed).
template <int NC, int KN, bool GEN>
__global__ void __launch_bounds__(SY_TPB)
f32_synth_kernel(const float* __restrict__ params, uint32_t seed,
                 const uint32_t* __restrict__ run_seeds, const float* __restrict__ pv,
                 const float* __restrict__ ps, MutateParams mp, float* __restrict__ values,
                 float* __restrict__ steps, int pop, SynthParams sp, float* __restrict__ ap,
                 float* __restrict__ am, float* __restrict__ edge, int pop_pad) {
  __shared__ float s_p[SY_TPB * MAX_D];
  __shared__ __align__(16) float s_buf[SY_TPB * SY_LDB];  // a 32-row staging buffer a warp
  const int base = blockIdx.x * SY_TPB, d = sp.d, run = blockIdx.y;
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
    if constexpr (GEN)
      s_p[i] = cand < pop ? offspring_gene(seed, cand, i - cl * d, pv, ps, mp, d, values, steps)
                          : 0.f;
    else
      s_p[i] = cand < pop ? params[(size_t)base * d + i] : 0.f;
  }
  __syncthreads();
  float p[MAX_D];
#pragma unroll
  for (int i = 0; i < MAX_D; ++i) p[i] = i < d ? s_p[threadIdx.x * d + i] : 0.f;
  const int cand = base + threadIdx.x, half = sp.n >> 1;
  FoldEmit<false, F32Row> emit;
  const int lane = threadIdx.x & 31;
  float* buf = s_buf + (threadIdx.x - lane) * SY_LDB;
  emit.n = sp.n;
  emit.half = half;
  emit.edge_q = 0.f;  // the exact edge sample x[N/2] here
  CandidateSynth<NC, KN, false> cs;
  emit.amp = cs.init(p, sp);
  for (int f = 0; f < sp.frames; ++f) {
    const size_t row = (size_t)(run * sp.frames + f) * pop_pad + cand;
    emit.ap = F32Row{ap + row * half, buf, lane, half};
    emit.am = F32Row{am + row * half, buf, lane, half};
    cs.frame(sp, emit);
    emit.fold_rows(0, false, 0.f);  // rows [0, 16): row 0 keeps x[0] alone
    edge[row] = emit.edge_q;
  }
}

// ---- (ii) the folded DFT and the fitness epilogue -------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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
__global__ void __launch_bounds__(DF_THREADS, 2)
f32_dft_kernel(const float* __restrict__ ap, const float* __restrict__ am,
               const float* __restrict__ edge, const float* __restrict__ dft,
               const float* __restrict__ target, SynthParams sp, int rows,
               double* __restrict__ partial, float4* __restrict__ run_tiles) {
  constexpr int CH = DF_BK / 4;  // 16-byte copies a staged row
  constexpr int A_PER = DF_BM * CH / DF_THREADS, B_PER = DF_BN * CH / DF_THREADS;
  static_assert(DF_BM * CH % DF_THREADS == 0 && DF_BN * CH % DF_THREADS == 0, "copy split");
  extern __shared__ __align__(16) float smem_f[];
  DftStage* st = reinterpret_cast<DftStage*>(smem_f);
  const int lb = blockIdx.y * gridDim.x + blockIdx.x;  // the block's index over all row blocks
  const int g = blockIdx.x % DF_GROUPS, c0 = (lb / DF_GROUPS) * DF_BM;
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

// Floats of scratch for `runs` runs of pop candidates at `frames` frames of
// n samples: for each of the runs x frames row blocks, a+ and a- (pop_pad x
// N/2 each), the edge samples (pop_pad), the group sums (DF_GROUPS x
// pop_pad doubles) and, where the DFT splits the samples (N/2 above
// DF_SPLIT_ABOVE), DF_LEVELS running tiles of DF_RUN floats for each thread
// of each DFT block (DF_GROUPS x DF_LEVELS x DF_RUN x pop_pad).
// kernels/synth_fitness.py::f32_scratch_floats is the same formula.
static long long f32_scratch_floats(int pop, int n, int frames, int runs) {
  const long long pop_pad = (long long)(pop + DF_BM - 1) / DF_BM * DF_BM;
  const long long run = n / 2 > DF_SPLIT_ABOVE ? (long long)DF_GROUPS * DF_LEVELS * DF_RUN : 0;
  return (long long)runs * frames * pop_pad * (n + 1 + 2 * DF_GROUPS + run);
}

// The plan of the three kernels for `runs` runs of pop candidates at
// sp.frames frames (generation.cuh): the synthesis kernel's instantiation
// for the sine order and the chain or bank (dispatch_synth), with B2's
// offspring prologue (GEN) or B1's parameters, the scratch's views and the
// DFT kernel's shared memory. cudaErrorInvalidValue for too little scratch,
// a frame whose half is not whole DF_BK-sample stages, one of more segments
// than the running tiles' levels take, or more row blocks than a grid's
// second dimension takes.
template <bool GEN>
static int prepare_f32(const SynthParams& sp, int pop, int runs, float* scratch,
                       long long scratch_floats, F32Plan* plan) {
  if (pop < 1 || runs < 1 || sp.frames < 1 || (long long)runs * sp.frames > 65535 ||
      (long long)runs * sp.frames * (pop + DF_BM) > 0x7FFFFFFFLL ||
      scratch_floats < f32_scratch_floats(pop, sp.n, sp.frames, runs) || (sp.n / 2) % DF_BK ||
      sp.n / 2 > DF_MAX_SEGS * DF_SEG)
    return (int)cudaErrorInvalidValue;
  const int pop_pad = (pop + DF_BM - 1) / DF_BM * DF_BM;
  const size_t half = sp.n / 2, rows = (size_t)runs * sp.frames * pop_pad;
  plan->pop = pop;
  plan->pop_pad = pop_pad;
  plan->runs = runs;
  plan->rows = (int)rows;
  plan->ap = scratch;
  plan->am = plan->ap + rows * half;
  plan->edge = plan->am + rows * half;
  plan->partial = reinterpret_cast<double*>(plan->edge + rows);  // pop_pad is even
  plan->run = sp.n / 2 > DF_SPLIT_ABOVE
                  ? reinterpret_cast<float*>(plan->partial + (size_t)DF_GROUPS * rows)
                  : nullptr;
  const int e = dispatch_ncoef(sp.ncoef, [&](auto nc) {
    return dispatch_synth(sp, [&](auto kc) {
      plan->synth = f32_synth_kernel<decltype(nc)::value, decltype(kc)::value, GEN>;
      return 0;
    });
  });
  return e ? e : (int)prepare(f32_dft_kernel, DF_SMEM);
}

int prepare_generation_f32(const SynthParams& sp, int pop, int runs, float* scratch,
                           long long scratch_floats, F32Plan* plan) {
  return prepare_f32<true>(sp, pop, runs, scratch, scratch_floats, plan);
}

// The three kernels of a plan on `stream`; returns cudaGetLastError() after
// each launch (the first error stops it).
int launch_f32(const F32Plan& plan, const float* params, uint32_t seed, const uint32_t* run_seeds,
               const float* pv, const float* ps, const MutateParams& mp, float* values,
               float* steps, const SynthParams& sp, const float* dft, const float* target,
               float* fitness, cudaStream_t stream) {
  if (pv && plan.runs > 1 && !run_seeds) return (int)cudaErrorInvalidValue;
  const F32SynthKernel synth = plan.synth;
  synth<<<dim3(plan.pop_pad / SY_TPB, plan.runs), SY_TPB, 0, stream>>>(
      params, seed, run_seeds, pv, ps, mp, values, steps, plan.pop, sp, plan.ap, plan.am,
      plan.edge, plan.pop_pad);
  int e = (int)cudaGetLastError();
  if (e) return e;
  f32_dft_kernel<<<dim3(plan.pop_pad / DF_BM * DF_GROUPS, plan.runs * sp.frames), DF_THREADS,
                   DF_SMEM, stream>>>(plan.ap, plan.am, plan.edge, dft, target, sp, plan.rows,
                                      plan.partial, reinterpret_cast<float4*>(plan.run));
  e = (int)cudaGetLastError();
  if (e) return e;
  f32_sum_kernel<<<dim3((plan.pop + SUM_TPB - 1) / SUM_TPB, plan.runs), SUM_TPB, 0, stream>>>(
      plan.partial, plan.rows, plan.pop_pad, plan.pop, sp.frames, fitness);
  return (int)cudaGetLastError();
}

extern "C" {

// B1 true f32: fitness (runs, pop) of scaled params (runs, pop, d) against
// the float32 folded operand (2k, n/2) and the targets (runs, sp.frames, k);
// `scratch` holds f32_scratch_floats(pop, n, sp.frames, runs) floats.
// Returns cudaGetLastError().
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
