// The whole-run ES kernel for Hopper (sm_90a): G generations in one launch.
//
// Replaces pmfm_tpu/kernels/evolve.py::fused_evolve (B5: _evolve_kernel,
// _merge_topmu). Each generation is B2's: every candidate's offspring from
// the parents (evaluate.cuh::offspring, Philox keyed by the generation's
// seed, counters as B2's) and its fitness (evaluate.cuh::evaluate_block, the
// same function B1 and B2 run, int8 or true f32); then comma selection of
// the mu best of the whole offspring population in the exact order
// (fitness, candidate index), NaN after +inf after every finite value; the
// best-ever candidate and the (G,) best-ever trajectory. One generation of
// B5 therefore makes bit for bit the parents that one B2 launch followed by
// a stable sort makes (kernels/evolve.py::fused_evolve_plain).
//
// What bounds it: the evaluation, as for B2 (evaluate.cuh; 34 G int8
// operations a generation at the bench shapes). Selection reads the P
// fitness values six times from L2 (128 KB at P 2^15) with one block, and
// the two barriers a generation cost a few microseconds; parents, offspring
// and fitness never leave the 50 MB L2 between generations.
//
// Design (simple first). One cooperative launch (cudaLaunchCooperativeKernel)
// of as many blocks as can be resident at once (occupancy x SM count, at most
// one per population block), so a grid-wide barrier is valid. Each block walks
// the population blocks grid-stride and writes every candidate's fitness,
// values and steps to device scratch; barrier; block 0 selects: a 4-pass
// 8-bit radix select finds the mu-th smallest order key T, a compaction in
// candidate order keeps the keys below T and the first ones equal to T, a
// rank sort by (key, index) orders the mu survivors, which are copied into
// the parents; barrier. The TPU kernel's block-wise merge into a running
// top-mu (with its finite 3e38 sentinel and one-hot extraction) was a way to
// keep the pool in VMEM across a sequential grid; here the grid is parallel
// and all P fitness values are in L2 at once, so one exact selection over
// them replaces the merges. The barrier is a counter in device memory that
// only grows (the wrapper zeroes it), so it needs no separate compilation.

#include <algorithm>

#include "evaluate.cuh"

// Grid-wide barrier; `target` = (barriers so far) x gridDim.x. Valid only
// under a cooperative launch, where every block is resident.
__device__ __forceinline__ void grid_barrier(unsigned int* count, unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();  // this block's writes before its arrival
    atomicAdd(count, 1u);
    // poll with relaxed loads and acquire once: blocks that wait share their
    // SM with blocks still evaluating, whose operand reads an acquire load
    // per poll would keep evicting from L1
    unsigned int seen;
    do {
      __nanosleep(128);
      asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(count) : "memory");
    } while (seen < target);
    __threadfence();
  }
  __syncthreads();
}

// Unsigned key in the order of (fitness ascending, NaN last): -0 == +0.
__device__ __forceinline__ uint32_t order_key(float f) {
  if (f != f) return 0xFFFFFFFFu;
  const uint32_t b = __float_as_uint(f == 0.f ? 0.f : f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Calls f(i, key) for i in [lo, hi) in order, reading through L2; lo is a
// multiple of 4, so groups of 4 go as one 16-byte load, and KEY_BATCH of
// those are in flight at once: a pass then waits out one L2 latency per 32
// keys of a thread, not per 4.
#define KEY_BATCH 8
template <typename F>
__device__ __forceinline__ void for_keys(const float* fit, int lo, int hi, F&& f) {
  int i = lo;
  for (; i + 4 * KEY_BATCH <= hi; i += 4 * KEY_BATCH) {
    float4 v[KEY_BATCH];
#pragma unroll
    for (int j = 0; j < KEY_BATCH; ++j) v[j] = __ldcg(reinterpret_cast<const float4*>(fit + i) + j);
#pragma unroll
    for (int j = 0; j < KEY_BATCH; ++j) {
      f(i + 4 * j, order_key(v[j].x));
      f(i + 4 * j + 1, order_key(v[j].y));
      f(i + 4 * j + 2, order_key(v[j].z));
      f(i + 4 * j + 3, order_key(v[j].w));
    }
  }
  for (; i < hi; ++i) f(i, order_key(__ldcg(fit + i)));
}

// Shared memory of block 0's selection (after the evaluation's).
__host__ __device__ inline size_t select_smem_bytes(int mu, int threads) {
  return 4 * (256 + 2 * (size_t)threads + 3 * (size_t)mu + 2);
}

// Block 0: the mu survivors of generation g into pv, ps, pf (best first),
// best-ever into best_v / best, traj[g] = best.
__device__ __noinline__ void select_parents(int pop, int mu, int d, const float* fit, const float* val,
                               const float* step, float* pv, float* ps, float* pf,
                               float* best_v, float& best, float* traj_g, int* smem) {
  const int t = threadIdx.x, nt = blockDim.x;
  uint32_t* hist = reinterpret_cast<uint32_t*>(smem);  // 256 bins
  uint32_t* cnt = hist + 256;                           // 2 x nt
  uint32_t* wkey = cnt + 2 * nt;                        // mu survivors' keys
  int* widx = reinterpret_cast<int*>(wkey + mu);        // ... and indices
  int* word = widx + mu;                                // rank -> survivor
  uint32_t* bc = reinterpret_cast<uint32_t*>(word + mu);  // broadcast
  // contiguous chunk of candidates per thread, in index order
  const int chunk = ((pop + nt - 1) / nt + 3) & ~3;
  const int lo = min(pop, t * chunk), hi = min(pop, lo + chunk);

  // radix select: T = the mu-th smallest key; `want` of the keys equal to T
  uint32_t prefix = 0u, mask = 0u, want = (uint32_t)mu;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = t; i < 256; i += nt) hist[i] = 0u;
    __syncthreads();
    for_keys(fit, lo, hi, [&](int, uint32_t k) {
      if ((k & mask) == prefix) atomicAdd(&hist[(k >> shift) & 255u], 1u);
    });
    __syncthreads();
    if (t == 0) {
      uint32_t cum = 0u;
      int b = 0;
      for (; b < 255; ++b) {
        if (cum + hist[b] >= want) break;
        cum += hist[b];
      }
      bc[0] = prefix | ((uint32_t)b << shift);
      bc[1] = want - cum;
    }
    __syncthreads();
    prefix = bc[0];
    want = bc[1];
    mask |= 0xFFu << shift;
  }
  const uint32_t T = prefix;
  const uint32_t n_less = (uint32_t)mu - want;

  // compaction: keys < T, then the first `want` keys == T, in index order
  uint32_t less = 0u, eq = 0u;
  for_keys(fit, lo, hi, [&](int, uint32_t k) {
    less += k < T;
    eq += k == T;
  });
  cnt[t] = less;
  cnt[nt + t] = eq;
  __syncthreads();
  if (t == 0) {
    uint32_t a = 0u, b = 0u;
    for (int j = 0; j < nt; ++j) {
      const uint32_t x = cnt[j], y = cnt[nt + j];
      cnt[j] = a;
      cnt[nt + j] = b;
      a += x;
      b += y;
    }
  }
  __syncthreads();
  uint32_t ol = cnt[t], oe = cnt[nt + t];
  for_keys(fit, lo, hi, [&](int i, uint32_t k) {
    if (k < T) {
      wkey[ol] = k;
      widx[ol] = i;
      ++ol;
    } else if (k == T) {
      if (oe < want) {
        wkey[n_less + oe] = k;
        widx[n_less + oe] = i;
      }
      ++oe;
    }
  });
  __syncthreads();

  // rank sort of the survivors by (key, index)
  for (int e = t; e < mu; e += nt) {
    const uint32_t ke = wkey[e];
    const int ie = widx[e];
    int r = 0;
    for (int f = 0; f < mu; ++f) {
      const uint32_t kf = wkey[f];
      r += (kf < ke) || (kf == ke && widx[f] < ie);
    }
    word[r] = e;
  }
  __syncthreads();
  for (int r = t; r < mu; r += nt) {
    const int src = widx[word[r]];
    pf[r] = __ldcg(fit + src);
    for (int dim = 0; dim < d; ++dim) {
      pv[(size_t)r * d + dim] = __ldcg(val + (size_t)src * d + dim);
      ps[(size_t)r * d + dim] = __ldcg(step + (size_t)src * d + dim);
    }
  }
  __syncthreads();
  if (t == 0) {  // thread 0 wrote row 0 itself
    if (pf[0] < best) {
      best = pf[0];
      for (int dim = 0; dim < d; ++dim) best_v[dim] = pv[dim];
    }
    *traj_g = best;
  }
}

template <int NC, bool F32>
__global__ void __launch_bounds__(Mode<F32>::THREADS)
fused_evolve_kernel(const uint32_t* __restrict__ seeds, int gens, int pop, SynthParams sp,
                    MutateParams mp, const void* __restrict__ dft,
                    const float* __restrict__ target, float* pv, float* ps, float* pf,
                    float* best_v, float* best_f, float* traj, float* fit_s, float* val_s,
                    float* step_s, unsigned int* barrier) {
  extern __shared__ __align__(16) int smem[];
  constexpr int CPB = Mode<F32>::CPB;
  const bool leader = threadIdx.x < CPB;
  const int nblk = (pop + CPB - 1) / CPB;
  unsigned int arrivals = 0u;
  float best = best_f[0];  // block 0, thread 0 keeps it
#pragma unroll 1
  for (int g = 0; g < gens; ++g) {
    const uint32_t seed = seeds[g];
#pragma unroll 1
    for (int blk = blockIdx.x; blk < nblk; blk += gridDim.x) {
      const int cand = blk * CPB + threadIdx.x % CPB;
      const bool active = cand < pop;
      float p[MAX_D];
      if (leader && active)
        offspring(seed, cand, pv, ps, mp, sp.d, p, val_s, step_s);
      else
        for (int i = 0; i < MAX_D; ++i) p[i] = 0.f;
      const float fit = evaluate_block<NC, F32>(p, sp, dft, target, smem);
      if (leader && active) fit_s[cand] = fit;
    }
    arrivals += gridDim.x;
    grid_barrier(barrier, arrivals);
    if (blockIdx.x == 0)
      select_parents(pop, mp.mu, sp.d, fit_s, val_s, step_s, pv, ps, pf, best_v, best,
                     traj + g, smem);
    arrivals += gridDim.x;
    grid_barrier(barrier, arrivals);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) best_f[0] = best;
}

template <bool F32>
static int launch_b5(const uint32_t* seeds, int gens, int pop, const SynthParams& sp,
                     const MutateParams& mp, const void* dft, const float* target, float* pv,
                     float* ps, float* pf, float* best_v, float* best_f, float* traj,
                     float* fit_s, float* val_s, float* step_s, unsigned int* barrier,
                     int* grid_out, cudaStream_t stream) {
  constexpr int THREADS = Mode<F32>::THREADS, CPB = Mode<F32>::CPB;
  const size_t smem = std::max(eval_smem_bytes(sp.n, F32), select_smem_bytes(mp.mu, THREADS));
  int dev = 0, coop = 0, sms = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev))) return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev))) return e;
  if (!coop) return (int)cudaErrorNotSupported;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) return e;
  return dispatch_ncoef(sp.ncoef, [&](auto nc) {
    auto kernel = fused_evolve_kernel<decltype(nc)::value, F32>;
    cudaError_t err = prepare(kernel, smem);
    if (err) return (int)err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
    if (err) return (int)err;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    const int grid = std::min((pop + CPB - 1) / CPB, per_sm * sms);
    *grid_out = grid;
    int gens_ = gens, pop_ = pop;
    SynthParams sp_ = sp;
    MutateParams mp_ = mp;
    void* args[] = {(void*)&seeds, &gens_,  &pop_, &sp_,   &mp_,   (void*)&dft,
                    (void*)&target, &pv,    &ps,   &pf,    &best_v, &best_f,
                    &traj,          &fit_s, &val_s, &step_s, &barrier};
    err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(THREADS), args, smem,
                                      stream);
    if (err) return (int)err;
    return (int)cudaGetLastError();
  });
}

extern "C" {

// B5: `gens` generations from the parents pv, ps (mu, d), updated in place
// with pf (mu,) to the last generation's; best_v (d,) and best_f (1,) carry
// the best-ever in and out; traj (gens,) gets best-ever per generation.
// seeds (gens,) are the generations' Philox keys. fit_s (pop,), val_s and
// step_s (pop, d) are scratch; barrier is one zeroed counter. grid_out gets
// the number of blocks launched. Returns a CUDA error code, 0 on success.
int pmfm_fused_evolve(const uint32_t* seeds, int gens, int pop, SynthParams sp, MutateParams mp,
                      const void* dft, const float* target, float* pv, float* ps, float* pf,
                      float* best_v, float* best_f, float* traj, float* fit_s, float* val_s,
                      float* step_s, unsigned int* barrier, int f32_mode, int* grid_out,
                      cudaStream_t stream) {
  return f32_mode ? launch_b5<true>(seeds, gens, pop, sp, mp, dft, target, pv, ps, pf, best_v,
                                    best_f, traj, fit_s, val_s, step_s, barrier, grid_out, stream)
                  : launch_b5<false>(seeds, gens, pop, sp, mp, dft, target, pv, ps, pf, best_v,
                                     best_f, traj, fit_s, val_s, step_s, barrier, grid_out,
                                     stream);
}

}  // extern "C"
