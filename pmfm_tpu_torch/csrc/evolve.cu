// B5, the whole run for Hopper (sm_90a): G generations of B2 with exact comma
// selection, the best-ever candidate and the (G,) best-ever trajectory.
//
// Replaces pmfm_tpu/kernels/evolve.py::fused_evolve (B5: _evolve_kernel,
// _merge_topmu). Generation g is B2's for the seed seeds[g]; then comma
// selection keeps the mu best of the whole offspring population in the exact
// order (fitness, candidate index), -0 equal to +0, +inf after every finite
// value and NaN after +inf; best-ever improves only on a strictly smaller
// fitness. One B5 generation therefore makes bit for bit the parents that one
// B2 launch followed by a stable sort makes (kernels/evolve.py::
// fused_evolve_plain).
//
// Design. pmfm_fused_evolve is a loop on the host that enqueues, generation
// after generation on one stream, B2's own kernels (generation.cuh: in int8
// and bf16 the one-warp kernel of fused_eval.cu / fused_bf16.cu or the
// time-parallel one of fused_tp.cu / fused_tp_bf16.cu, in the layout the
// caller names; the three f32 kernels of fused_f32.cu) and then
// select_kernel, with no synchronisation and no Python between generations.
// So B5 is bit-equal to G B2 launches by construction and follows any change
// of B2. The wrapper (kernels/evolve.py) names the layout B2's wrapper
// would take at the same arguments (generation.time_parallel with B5's
// population and runs); the two layouts are bit-equal, so B5's parents,
// best-ever and trajectory do not depend on it. A time-parallel layout asked
// of a shape its kernel does not take returns cudaErrorInvalidValue: nothing
// falls back to the one-warp kernel. This file instantiates no B2 kernel:
// the time-parallel pairs live beside their kernels, so nvcc builds each
// once. A kernel boundary is the cheapest grid-wide barrier on an H100 (a
// few microseconds), and parents, offspring and fitness stay in the 50 MB L2
// from one launch to the next. The host work that does not change from one
// generation to the next (the instantiations, the shared-memory attributes,
// the time-parallel block's geometry, the f32 scratch's checks) is done once
// before the loop; the loop costs a few microseconds of host time a launch
// against ~0.1-0.8 ms of device time a generation at the users' shapes, so
// the host stays ahead of the card. A persistent cooperative grid would
// instead tie every generation to one block shape and to what is resident,
// which B2's kernels (one-warp blocks, eight-warp time-parallel blocks, two
// 4-warp f32 DFT blocks an SM) do not share.
//
// Frames and runs: B2's kernels take the multi-frame mode (sp.frames) and
// the run axis as they are; a batched call launches B2 once a generation for
// all runs and the selection with one block a run (blockIdx.x = run), each
// run with its own seeds, parents, target rows and best-ever, so a batched
// B5 call is bit-equal, run for run, to lone B5 calls.
//
// What bounds it: B2's evaluation, G times (at the bench shapes 34 G int8
// operations a generation, 25 us), in the layout taken. The selection reads
// P fitness values (128 KB at P 2^15) and writes mu parents; it runs on one
// SM a run, so its time is the latency of its passes, not bandwidth: ~10-20
// us a generation, a share that grows as the time-parallel layout shortens
// B2's part.
//
// The selection is one block of SEL_THREADS threads. Warp w owns a contiguous
// segment of the candidates and its lanes take consecutive ones, so every
// sweep visits the keys of a warp in index order and its shared-memory reads
// are free of bank conflicts. When the population's keys fit shared memory
// (select_keys_in_shared) the first sweep leaves them there; otherwise every
// sweep streams them from L2, the same way.
// 1. A radix select over the order key (order_key: unsigned, ascending with
//    the fitness, -0 == +0, NaN last) finds, 8 bits a pass from the top, the
//    prefix T of the mu-th smallest key and how many of the keys with that
//    prefix are wanted. Each warp counts into its own 256-bin histogram, one
//    atomic for all lanes of a bin (__match_any_sync): a key's top byte is
//    its sign and most of its exponent, so most keys share a few bins. A pass
//    whose bin is wanted whole ends the search.
// 2. A compaction keeps the keys below T and the first `want` keys with
//    prefix T, in index order: a count sweep, the warps' counts scanned, and
//    a write sweep with ballots. It writes mu survivors whatever the ties
//    (all-equal or all-NaN fitness puts every key in one bin).
// 3. A rank sort by (key, index) orders the survivors, whose fitness, values
//    and steps are copied into the parents, best first; thread 0 updates
//    best-ever and writes traj[g].

#include "generation.cuh"

#define SEL_THREADS 1024
#define SEL_WARPS (SEL_THREADS / 32)
#define SEL_BINS 256
#define SEL_BATCH 8      // loads a lane has in flight
#define SEL_RANK 4       // threads that rank one survivor
#define SEL_MAX_SMEM 232448  // shared memory one block of an H100 can use
#define SEL_FIXED_WORDS (SEL_WARPS * SEL_BINS + SEL_BINS + 2 * SEL_WARPS + 4)

// Bytes of the selection's shared memory: the keys of all P candidates when
// they are kept there (padded to 16 bytes), the warps' histograms, the bin
// totals, the warps' counts, a broadcast, and the survivors' (key, index)
// pairs and order. kernels/evolve.py::select_geometry is the same formula.
__host__ __device__ inline size_t select_smem_bytes(int pop, int mu, bool keys_in_shared) {
  const size_t keys = keys_in_shared ? ((size_t)pop + 3) / 4 * 4 : 0;
  return 4 * (keys + SEL_FIXED_WORDS + 3 * (size_t)mu);
}

__host__ inline bool select_keys_in_shared(int pop, int mu) {
  return select_smem_bytes(pop, mu, true) <= SEL_MAX_SMEM;
}

// Unsigned key in the order of (fitness ascending, NaN last): -0 == +0.
__device__ __forceinline__ uint32_t order_key(float f) {
  if (f != f) return 0xFFFFFFFFu;
  const uint32_t b = __float_as_uint(f == 0.f ? 0.f : f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// keys[i] = order_key(fit[i]) for the warp's candidates [lo, hi) (lo a
// multiple of 32), in 16-byte loads, SEL_BATCH of them a lane in flight: one
// round of L2 latency for 1024 keys a warp. A run's row of fitness that
// does not start on 16 bytes (run r > 0 of a batched call whose population
// is not a multiple of 4) is read a float at a time.
__device__ __forceinline__ void load_keys(const float* fit, uint32_t* keys, int lo, int hi) {
  const int lane = threadIdx.x & 31;
  const bool vec = (reinterpret_cast<uintptr_t>(fit) & 15) == 0;
  for (int base = lo; base < hi; base += 128 * SEL_BATCH) {
    float4 v[SEL_BATCH];
#pragma unroll
    for (int j = 0; j < SEL_BATCH; ++j) {
      const int i = base + 4 * (32 * j + lane);
      if (vec && i + 3 < hi) {
        v[j] = __ldcg(reinterpret_cast<const float4*>(fit + i));
      } else {  // the population's ragged end, or a row off 16 bytes
        v[j].x = i < hi ? __ldcg(fit + i) : 0.f;
        v[j].y = i + 1 < hi ? __ldcg(fit + i + 1) : 0.f;
        v[j].z = i + 2 < hi ? __ldcg(fit + i + 2) : 0.f;
        v[j].w = i + 3 < hi ? __ldcg(fit + i + 3) : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < SEL_BATCH; ++j) {
      const int i = base + 4 * (32 * j + lane);
      const uint4 k = make_uint4(order_key(v[j].x), order_key(v[j].y), order_key(v[j].z),
                                 order_key(v[j].w));
      if (i + 3 < hi) {
        *reinterpret_cast<uint4*>(keys + i) = k;
      } else {
        if (i < hi) keys[i] = k.x;
        if (i + 1 < hi) keys[i + 1] = k.y;
        if (i + 2 < hi) keys[i + 2] = k.z;
      }
    }
  }
}

// Calls f(i, key, in) for the warp's candidates [lo, hi), lane l taking
// lo + 32 j + l; every lane of the warp makes every call (in = false past
// hi), so f may use warp-wide intrinsics. Keys come from shared memory, or
// from the fitness in L2; a lane's SEL_BATCH loads are all issued before
// any is used, so they wait out one latency together.
template <bool SHARED, typename F>
__device__ __forceinline__ void sweep(const float* fit, const uint32_t* keys, int lo, int hi,
                                      F&& f) {
  const int lane = threadIdx.x & 31;
  for (int base = lo; base < hi; base += 32 * SEL_BATCH) {
    uint32_t x[SEL_BATCH];  // the key, or the fitness's bits
#pragma unroll
    for (int j = 0; j < SEL_BATCH; ++j) {
      const int i = min(base + 32 * j + lane, hi - 1);
      x[j] = SHARED ? keys[i] : __float_as_uint(__ldcg(fit + i));
    }
#pragma unroll
    for (int j = 0; j < SEL_BATCH; ++j) {
      const int i = base + 32 * j + lane;
      const bool in = i < hi;
      f(i, !in ? 0xFFFFFFFFu : SHARED ? x[j] : order_key(__uint_as_float(x[j])), in);
    }
  }
}

// One generation's comma selection: the mu survivors of fit (pop,), val and
// step (pop, d) into pf (mu,), pv and ps (mu, d), best first; best-ever into
// best_v (d,) and best_f (1,) on a strict improvement; traj_g = best-ever.
// Block r selects run r of a batched run: every array has a leading run
// axis, and run r's trajectory entry sits traj_stride floats after run
// r - 1's.
template <bool SHARED>
__global__ void __launch_bounds__(SEL_THREADS)
select_kernel(int pop, int mu, int d, const float* __restrict__ fit,
              const float* __restrict__ val, const float* __restrict__ step,
              float* __restrict__ pv, float* __restrict__ ps, float* __restrict__ pf,
              float* __restrict__ best_v, float* __restrict__ best_f,
              float* __restrict__ traj_g, int traj_stride) {
  extern __shared__ __align__(16) uint32_t sm[];
  const int run = blockIdx.x;
  fit += (size_t)run * pop;
  val += (size_t)run * pop * d;
  step += (size_t)run * pop * d;
  pv += (size_t)run * mu * d;
  ps += (size_t)run * mu * d;
  pf += (size_t)run * mu;
  best_v += (size_t)run * d;
  best_f += run;
  traj_g += (size_t)run * traj_stride;
  uint32_t* keys = sm;                           // pop (padded), if SHARED
  uint32_t* hist = sm + (SHARED ? (pop + 3) / 4 * 4 : 0);  // SEL_WARPS x SEL_BINS
  uint32_t* tot = hist + SEL_WARPS * SEL_BINS;   // SEL_BINS
  uint32_t* cnt = tot + SEL_BINS;                // 2 x SEL_WARPS
  uint32_t* bc = cnt + 2 * SEL_WARPS;            // 4
  unsigned long long* s_kx = reinterpret_cast<unsigned long long*>(bc + 4);  // mu: key, index
  int* s_ord = reinterpret_cast<int*>(s_kx + mu);  // mu: rank -> survivor
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const unsigned full = 0xFFFFFFFFu;
  const int seg = ((pop + SEL_WARPS - 1) / SEL_WARPS + 31) & ~31;
  const int lo = min(pop, w * seg), hi = min(pop, lo + seg);
  uint32_t* whist = hist + w * SEL_BINS;
  if (SHARED) load_keys(fit, keys, lo, hi);  // the warp reads back only its own keys

  // 1. radix select: keys whose bits under `mask` equal `prefix` are left,
  // `want` of them still to take. The warp keeps its count of keys below
  // the prefix (less) and, after the last pass, of keys with it (eq), which
  // place its survivors in the compaction.
  uint32_t prefix = 0u, mask = 0u, want = (uint32_t)mu, less = 0u, eq = 0u;
  for (int shift = 24; shift >= 0; shift -= 8) {
    __syncwarp();  // the warp has read its histogram of the last pass
    for (int b = lane; b < SEL_BINS; b += 32) whist[b] = 0u;
    __syncwarp();
    sweep<SHARED>(fit, keys, lo, hi, [&](int, uint32_t k, bool in) {
      if (in && (k & mask) == prefix) atomicAdd(&whist[(k >> shift) & 255u], 1u);
    });
    __syncthreads();
    if (t < SEL_BINS) {
      uint32_t c = 0u;
      for (int v = 0; v < SEL_WARPS; ++v) c += hist[v * SEL_BINS + t];
      tot[t] = c;
    }
    __syncthreads();
    if (w == 0) {  // lane l: bins 8l .. 8l + 7; the lane whose bins cross `want` decides
      const uint4 a = reinterpret_cast<const uint4*>(tot)[2 * lane];
      const uint4 b = reinterpret_cast<const uint4*>(tot)[2 * lane + 1];
      const uint32_t v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      uint32_t sum = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += v[j];
      uint32_t incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_up_sync(full, incl, o);
        if (lane >= o) incl += y;
      }
      uint32_t cum = incl - sum;
      if (cum < want && want <= incl) {
        int j = 0;
        while (cum + v[j] < want) cum += v[j++];
        bc[0] = 8 * lane + j;
        bc[1] = want - cum;
        bc[2] = v[j] == want - cum;  // the bin is wanted whole
      }
    }
    __syncthreads();
    const uint32_t bin = bc[0];
    uint32_t below = 0u;
    for (int b = lane; b < SEL_BINS; b += 32) below += b < (int)bin ? whist[b] : 0u;
    less += __reduce_add_sync(full, below);
    eq = whist[bin];
    prefix |= bin << shift;
    want = bc[1];
    mask |= 0xFFu << shift;
    if (bc[2]) break;
  }
  const uint32_t n_less = (uint32_t)mu - want;

  // 2. compaction, in index order: keys below the prefix, then the first
  // `want` keys with it
  if (lane == 0) {
    cnt[w] = less;
    cnt[SEL_WARPS + w] = eq;
  }
  __syncthreads();
  uint32_t ol = 0u, oe = 0u;
  for (int v = 0; v < w; ++v) {
    ol += cnt[v];
    oe += cnt[SEL_WARPS + v];
  }
  const uint32_t lanes_below = (1u << lane) - 1u;
  sweep<SHARED>(fit, keys, lo, hi, [&](int i, uint32_t k, bool in) {
    const bool c = in && (k & mask) <= prefix;
    if (!__any_sync(full, c)) return;  // most keys of most batches are past the prefix
    const bool l = c && (k & mask) < prefix, e = c && !l;
    const uint32_t bl = __ballot_sync(full, l), be = __ballot_sync(full, e);
    if (l) s_kx[ol + __popc(bl & lanes_below)] = (unsigned long long)k << 32 | (uint32_t)i;
    if (e) {
      const uint32_t r = oe + __popc(be & lanes_below);
      if (r < want) s_kx[n_less + r] = (unsigned long long)k << 32 | (uint32_t)i;
    }
    ol += __popc(bl);
    oe += __popc(be);
  });
  __syncthreads();

  // 3. rank sort of the survivors by (key, index), SEL_RANK threads a survivor
  for (int e0 = 0; e0 < mu; e0 += SEL_THREADS / SEL_RANK) {
    const int e = e0 + t / SEL_RANK;
    const bool ok = e < mu;
    int r = 0;
    if (ok) {
      const unsigned long long ke = s_kx[e];
      for (int f = t % SEL_RANK; f < mu; f += SEL_RANK) r += s_kx[f] < ke;
    }
#pragma unroll
    for (int o = 1; o < SEL_RANK; o <<= 1) r += __shfl_xor_sync(full, r, o);
    if (ok && t % SEL_RANK == 0) s_ord[r] = e;
  }
  __syncthreads();
  for (int j = t; j < mu * d; j += SEL_THREADS) {
    const int r = j / d, src = (int)(uint32_t)s_kx[s_ord[r]];
    pv[j] = val[(size_t)src * d + (j - r * d)];
    ps[j] = step[(size_t)src * d + (j - r * d)];
  }
  for (int r = t; r < mu; r += SEL_THREADS) pf[r] = fit[(uint32_t)s_kx[s_ord[r]]];
  if (t == 0) {
    const int src = (int)(uint32_t)s_kx[s_ord[0]];
    const float f0 = fit[src];
    if (f0 < best_f[0]) {
      best_f[0] = f0;
      for (int dim = 0; dim < d; ++dim) best_v[dim] = val[(size_t)src * d + dim];
    }
    *traj_g = best_f[0];
  }
}

extern "C" {

// B5: `gens` generations from the parents pv, ps (mu, d), updated in place
// with pf (mu,) to the last generation's; best_v (d,) and best_f (1,) carry
// the best-ever in and out; traj (gens,) gets best-ever per generation.
// seeds (gens,), in host memory, are the generations' Philox keys. fit_s
// (pop,), val_s and step_s (pop, d) hold each generation's offspring. mode
// is B2's: 0 int8, 1 true f32, 2 bf16 (the operand dft's dtype); in f32
// mode scratch holds fused_f32.cu's f32_scratch_floats(pop, n, frames, runs,
// fft) floats on the route sp.fft names. layout is B2's in int8 and bf16: 0
// the one-warp kernel, 1 the time-parallel one (for what fused_tp.cuh::
// tp_shape takes on a fixed chain or bank; else cudaErrorInvalidValue); 0
// in f32, whose layouts sp names. With a run axis every array has a
// leading one (traj is (runs, gens)) and run_seeds (device memory, (gens,
// runs)) replaces seeds, which may then be null, also at runs = 1 (one of
// the two must be given): each generation is one B2 launch for all runs and
// one selection block a run, so run r computes what a B5 call of that run
// alone computes. Enqueues
// every launch on `stream` and returns the first CUDA error, 0 on success.
int pmfm_fused_evolve(const uint32_t* seeds, const uint32_t* run_seeds, int gens, int pop,
                      int runs, SynthParams sp, MutateParams mp, const void* dft,
                      const float* target, float* pv, float* ps, float* pf, float* best_v,
                      float* best_f, float* traj, float* fit_s, float* val_s, float* step_s,
                      float* scratch, long long scratch_floats, int mode, int layout,
                      cudaStream_t stream) {
  const int mu = mp.mu;
  if (gens < 1 || mu < 1 || pop < mu || runs < 1 || runs > 65535 || (runs > 1 && !run_seeds) ||
      (!seeds && !run_seeds) || mode < 0 || mode > 2 || layout < 0 || layout > 1 ||
      (layout && mode == 1))
    return (int)cudaErrorInvalidValue;
  const bool in_shared = select_keys_in_shared(pop, mu);
  const size_t smem = select_smem_bytes(pop, mu, in_shared);
  if (smem > SEL_MAX_SMEM) return (int)cudaErrorInvalidValue;
  const auto sel = in_shared ? &select_kernel<true> : &select_kernel<false>;
  int e = (int)prepare(sel, smem);
  GenInt8Kernel gen8 = nullptr;
  GenBf16Kernel gen16 = nullptr;
  TpGeneration<GenInt8Kernel> tp8{};
  TpGeneration<GenBf16Kernel> tp16{};
  F32Plan plan{};
  if (!e) {
    if (mode == 1)
      e = prepare_generation_f32(sp, pop, runs, scratch, scratch_floats, &plan);
    else if (mode == 2)
      e = layout ? prepare_generation_bf16_tp(sp, pop, runs, &tp16)
                 : prepare_generation_bf16(sp, &gen16);
    else
      e = layout ? prepare_generation_int8_tp(sp, pop, runs, &tp8)
                 : prepare_generation_int8(sp, &gen8);
  }
  for (int g = 0; g < gens && !e; ++g) {
    const uint32_t* rs = run_seeds ? run_seeds + (size_t)g * runs : nullptr;
    const uint32_t seed = rs ? 0u : seeds[g];
    if (mode == 1)
      e = launch_f32(plan, nullptr, seed, rs, pv, ps, mp, val_s, step_s, sp, (const float*)dft,
                     target, fit_s, stream);
    else if (mode == 2)
      e = layout ? launch_generation_bf16_tp(tp16, seed, rs, pv, ps, pop, runs, sp, mp,
                                             (const __nv_bfloat16*)dft, target, fit_s, val_s,
                                             step_s, stream)
                 : launch_generation_bf16(gen16, seed, rs, pv, ps, pop, runs, sp, mp,
                                          (const __nv_bfloat16*)dft, target, fit_s, val_s,
                                          step_s, stream);
    else
      e = layout ? launch_generation_int8_tp(tp8, seed, rs, pv, ps, pop, runs, sp, mp,
                                             (const int8_t*)dft, target, fit_s, val_s, step_s,
                                             stream)
                 : launch_generation_int8(gen8, seed, rs, pv, ps, pop, runs, sp, mp,
                                          (const int8_t*)dft, target, fit_s, val_s, step_s,
                                          stream);
    if (e) break;
    sel<<<runs, SEL_THREADS, smem, stream>>>(pop, mu, sp.d, fit_s, val_s, step_s, pv, ps, pf,
                                             best_v, best_f, traj + g, gens);
    e = (int)cudaGetLastError();
  }
  return e;
}

}  // extern "C"
