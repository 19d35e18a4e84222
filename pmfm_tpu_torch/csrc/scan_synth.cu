// The scan synthesis for Hopper (sm_90a): the sequential per-sample phase
// recurrence of ops/synthesis.py's engine "scan", one thread a candidate,
// into (n, pop) time-major audio in float32 or bf16.
//
// Replaces no TPU kernel: the reference runs this recurrence as one XLA
// lax.scan (pmfm_tpu/ops/synthesis.py::synthesize). Its plain version is
// kernels/scan.py::scan_synth_plain, a PyTorch loop over samples that
// issues ~30 small ops a sample for fm3_series; on the card that is ~60k
// launches a generation at n 2048, which this kernel replaces with one.
//
// Numerics: the plain version's, bit for bit. Every f32 multiply and add is
// __fmul_rn / __fadd_rn (nvcc contracts nothing into an FMA), in the plain
// version's order; the oscillator is sinf, which torch.sin calls on float32
// CUDA tensors (PyTorch is built without fast math), of floorf(pos) * scale
// ("floor"), pos * scale ("exact"), or the wavetable entry at the truncated
// phase ("table"). The bf16 output rounds each float32 sample to nearest
// even, as Tensor.to(torch.bfloat16). fm{k}_parallel adds its k pair
// outputs in pair order and multiplies by the float32 1/k.
//
// Two layouts, which give the same samples bit for bit; the wrapper
// (kernels/scan.py::scan_time_parallel) picks one by shape.
//
// One thread a candidate (scan_synth_kernel): thread c walks candidate c's
// frame; at sample t the warp's 32 stores of row t are one 128-byte
// (float32) or 64-byte (bf16) segment. The chain length is a template
// argument for fm2, fm3..fm8_series and fm2..fm4_parallel, so the phases
// stay in registers; longer chains, of any length, take an instantiation
// that reads it at run time and keeps each candidate's state in a scratch of
// the wrapper's (ScanState<0>: field f of oscillator or pair j at
// state[(f k + j) pop + c], so a warp's accesses are 32 consecutive floats).
// What bounds it: a thread walks all n samples, k sines and the chain a
// sample, so a small population (parameters.json's 32: one warp on one SM of
// 132) takes n x a sample's latency, ~0.36 ms at n 2048.
//
// Time-parallel (scan_synth_tp_kernel): only each level's position
// recurrence, pos[t + 1] = wrap(pos[t] + d[t]), is serial; a level's sines,
// its output and the next level's increments d = w2sr cur are not. A block
// holds `group` candidates; lane (g, l) of warp 0 walks level l of candidate
// g, and the block's other warps compute the sines. Time goes in chunks of
// SCAN_TP_CHUNK samples: at step s, serial lane l walks chunk s - 2 depth(l)
// of its level (depth: l for a chain, 0 or 1 for a pair's two levels),
// reading that chunk's increments and writing its positions to shared
// memory, while the other warps take, for each depth, the chunk one step
// behind it: the sines of its positions, then the next level's increments
// or, at the last depth, the output (a chain's last oscillator; a bank's
// pairs added in pair order and multiplied by 1/k). One __syncthreads a
// step; positions and increments are double-buffered by chunk parity, so a
// level's chain runs two chunks behind the one before it and shared memory
// does not grow with n. Every float operation is the one-thread kernel's, in
// its order. Levels, and candidates a block, are runtime values: one
// instantiation takes any chain of at most SCAN_TP_MAX_LANES levels (a
// chain of k oscillators has k, a bank of k pairs 2 k, fm2 2). Its floor is
// (n + 2 depth SCAN_TP_CHUNK) x the latency of one add-and-wrap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define SCAN_TPB 128  // candidates (threads) per block
#define SCAN_TP_CHUNK 64      // time-parallel: samples a chunk
#define SCAN_TP_UNROLL 8      // time-parallel: increments loaded ahead of the chain
#define SCAN_TP_MAX_LANES 32  // time-parallel: (candidate, level) walks a block, warp 0's lanes
#define SCAN_TP_MAX_WARPS 8

enum ScanTopo { SCAN_FM2 = 0, SCAN_SERIES = 1, SCAN_PARALLEL = 2 };
enum ScanOsc { SCAN_FLOOR = 0, SCAN_EXACT = 1, SCAN_TABLE = 2 };

struct ScanParams {
  int n;          // samples
  int pop;        // candidates
  int k;          // oscillators (fm{k}_series), pairs (fm{k}_parallel) or 1 (fm2)
  float w2sr;     // wavetable_size / sample_rate, as float32
  float size;     // wavetable size
  float scale;    // 2 pi / (size - 1), as float32
  float inv_k;    // fm{k}_parallel: 1/k, as float32
  int table_max;  // size - 1 (the "table" oscillator's clamp)
};

template <int OSC>
__device__ __forceinline__ float osc(float pos, const ScanParams& sp, const float* table) {
  if constexpr (OSC == SCAN_FLOOR) return sinf(__fmul_rn(floorf(pos), sp.scale));
  if constexpr (OSC == SCAN_EXACT) return sinf(__fmul_rn(pos, sp.scale));
  long long i = (long long)pos;  // truncation, as Tensor.to(torch.int64)
  i = i < 0 ? 0 : (i > sp.table_max ? sp.table_max : i);
  return table[i];
}

// wrap_pos / wrap_pos_both of ops/wavetable.py
__device__ __forceinline__ float wrap_up(float p, float size) {
  return p >= size ? __fsub_rn(p, size) : p;
}
__device__ __forceinline__ float wrap_both(float p, float size) {
  p = wrap_up(p, size);
  return p < 0.f ? __fadd_rn(p, size) : p;
}
// One step of a level's position: wrap_both where `both`, else wrap_up.
__device__ __forceinline__ float chain_step(float p, float d, float size, bool both) {
  p = wrap_up(__fadd_rn(p, d), size);
  return both && p < 0.f ? __fadd_rn(p, size) : p;
}

template <typename T>
__device__ __forceinline__ T to_out(float x);
template <>
__device__ __forceinline__ float to_out<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// One field of a candidate's state, one value an oscillator or pair: K > 0
// registers; K 0 (a runtime length) the candidate's strided column of the
// scratch.
template <int K>
struct ScanState {
  float v[K];
  __device__ __forceinline__ float& operator[](int j) { return v[j]; }
};
template <>
struct ScanState<0> {
  float* p;
  int stride;
  __device__ __forceinline__ float& operator[](int j) { return p[(size_t)j * stride]; }
};

// Field f of candidate c's state: registers, or scratch rows [f k, (f + 1) k).
template <int K>
__device__ __forceinline__ ScanState<K> scan_state(float* state, int f, int k, int pop, int c) {
  if constexpr (K) {
    return ScanState<K>{};
  } else {
    return ScanState<0>{state + (size_t)f * k * pop + c, pop};
  }
}

// TOPO SCAN_FM2 (K 1), SCAN_SERIES (K oscillators) or SCAN_PARALLEL (K
// pairs); K 0 takes the chain length from sp.k and its state from `state`
// (6 x k x pop floats for a bank, 3 x k x pop for a chain). Parameters
// (pop, d) row-major.
template <int TOPO, int K, int OSC, typename T>
__global__ void __launch_bounds__(SCAN_TPB)
scan_synth_kernel(const float* __restrict__ params, ScanParams sp,
                  const float* __restrict__ table, float* __restrict__ state,
                  T* __restrict__ out) {
  const int kk = K ? K : sp.k;
  const int c = blockIdx.x * SCAN_TPB + threadIdx.x;
  if (c >= sp.pop) return;
  const float size = sp.size, w2sr = sp.w2sr;
  const int pop = sp.pop;
  if constexpr (TOPO == SCAN_FM2 || TOPO == SCAN_PARALLEL) {
    const float* p = params + (size_t)c * 4 * kk;
    ScanState<K> md = scan_state<K>(state, 0, kk, pop, c);
    ScanState<K> cf = scan_state<K>(state, 1, kk, pop, c);
    ScanState<K> amp = scan_state<K>(state, 2, kk, pop, c);
    ScanState<K> inc = scan_state<K>(state, 3, kk, pop, c);
    ScanState<K> pos1 = scan_state<K>(state, 4, kk, pop, c);
    ScanState<K> pos2 = scan_state<K>(state, 5, kk, pop, c);
#pragma unroll
    for (int j = 0; j < kk; ++j) {
      md[j] = __fmul_rn(p[4 * j], p[4 * j + 1]);
      cf[j] = p[4 * j + 2];
      amp[j] = p[4 * j + 3];
      inc[j] = __fmul_rn(w2sr, p[4 * j]);
      pos1[j] = 0.f;
      pos2[j] = 0.f;
    }
    for (int t = 0; t < sp.n; ++t) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kk; ++j) {
        const float cur = __fadd_rn(__fmul_rn(osc<OSC>(pos1[j], sp, table), md[j]), cf[j]);
        pos1[j] = wrap_up(__fadd_rn(pos1[j], inc[j]), size);
        const float o = __fmul_rn(osc<OSC>(pos2[j], sp, table), amp[j]);
        acc = j ? __fadd_rn(acc, o) : o;
        pos2[j] = wrap_both(__fadd_rn(pos2[j], __fmul_rn(w2sr, cur)), size);
      }
      if constexpr (TOPO == SCAN_PARALLEL) acc = __fmul_rn(acc, sp.inv_k);
      out[(size_t)t * pop + c] = to_out<T>(acc);
    }
  } else {
    const float* p = params + (size_t)c * 2 * kk;
    ScanState<K> ms = scan_state<K>(state, 0, kk, pop, c);
    ScanState<K> cs = scan_state<K>(state, 1, kk, pop, c);
    ScanState<K> pos = scan_state<K>(state, 2, kk, pop, c);
#pragma unroll
    for (int j = 0; j < kk; ++j) {
      ms[j] = __fmul_rn(p[2 * j], p[2 * j + 1]);
      cs[j] = j < kk - 1 ? p[2 * j + 3] : 0.f;
      pos[j] = 0.f;
    }
    const float inc1 = __fmul_rn(w2sr, p[1]);  // the reference's operator-1 increment
    for (int t = 0; t < sp.n; ++t) {
      float cur = __fadd_rn(__fmul_rn(osc<OSC>(pos[0], sp, table), ms[0]), cs[0]);
      pos[0] = wrap_up(__fadd_rn(pos[0], inc1), size);
#pragma unroll
      for (int j = 1; j < kk - 1; ++j) {
        const float nxt = __fadd_rn(__fmul_rn(osc<OSC>(pos[j], sp, table), ms[j]), cs[j]);
        pos[j] = wrap_both(__fadd_rn(pos[j], __fmul_rn(w2sr, cur)), size);
        cur = nxt;
      }
      const float o = __fmul_rn(osc<OSC>(pos[kk - 1], sp, table), ms[kk - 1]);
      pos[kk - 1] = wrap_both(__fadd_rn(pos[kk - 1], __fmul_rn(w2sr, cur)), size);
      out[(size_t)t * pop + c] = to_out<T>(o);
    }
  }
}

// The time-parallel layout (this file's note). TOPO SCAN_FM2 (sp.k 1),
// SCAN_SERIES or SCAN_PARALLEL; `group` candidates a block, group x levels
// <= SCAN_TP_MAX_LANES; blockDim.x 32 x (2 .. SCAN_TP_MAX_WARPS). Shared
// memory (scan_tp_smem): positions and increments, [parity][t][lane] with a
// row of `stride` (the lanes, made odd) floats, then each lane's two
// constants.
template <int TOPO, int OSC, typename T>
__global__ void __launch_bounds__(SCAN_TP_MAX_WARPS * 32)
scan_synth_tp_kernel(const float* __restrict__ params, ScanParams sp,
                     const float* __restrict__ table, int group, T* __restrict__ out) {
  constexpr bool PAIRS = TOPO != SCAN_SERIES;
  constexpr int C = SCAN_TP_CHUNK, U = SCAN_TP_UNROLL;
  extern __shared__ float smem_scan[];
  const int k = sp.k, levels = PAIRS ? 2 * k : k, d = PAIRS ? 4 * k : 2 * k;
  const int lanes = group * levels, stride = lanes | 1, deepest = PAIRS ? 1 : k - 1;
  const int base = blockIdx.x * group, pop = sp.pop, n = sp.n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float size = sp.size, w2sr = sp.w2sr;
  float* s_pos = smem_scan;                // [2][C][stride]
  float* s_inc = s_pos + 2 * C * stride;   // [2][C][stride]
  float* s_mul = s_inc + 2 * C * stride;   // [lanes]: ms_l; a pair's md_j, then amp_j
  float* s_add = s_mul + lanes;            // [lanes]: cs_l; a pair's cf_j
  for (int i = tid; i < lanes; i += blockDim.x) {
    const int g = i / levels, l = i - g * levels;
    float m = 0.f, a = 0.f;
    if (base + g < pop) {
      const float* p = params + (size_t)(base + g) * d;
      if constexpr (PAIRS) {
        const int j = l >> 1;
        if (l & 1) {
          m = p[4 * j + 3];
        } else {
          m = __fmul_rn(p[4 * j], p[4 * j + 1]);
          a = p[4 * j + 2];
        }
      } else {
        m = __fmul_rn(p[2 * l], p[2 * l + 1]);
        a = l < k - 1 ? p[2 * l + 3] : 0.f;
      }
    }
    s_mul[i] = m;
    s_add[i] = a;
  }
  // warp 0's lane (g, l): level l of candidate g; a level of depth 0 adds a
  // constant (a chain's w2sr p[1], a pair's w2sr p[4j]) and wraps up only
  const bool serial = warp == 0 && lane < lanes;
  int depth = 0;
  float inc = 0.f, pos = 0.f;
  if (serial) {
    const int g = lane / levels, l = lane - g * levels;
    depth = PAIRS ? (l & 1) : l;
    if (depth == 0 && base + g < pop)
      inc = __fmul_rn(w2sr, params[(size_t)(base + g) * d + (PAIRS ? 4 * (l >> 1) : 1)]);
  }
  const bool cst = depth == 0;
  __syncthreads();
  const int chunks = (n + C - 1) / C, steps = chunks + 2 * deepest + 1;
  for (int s = 0; s < steps; ++s) {
    if (warp == 0) {
      const int c = s - 2 * depth;
      if (serial && c >= 0 && c < chunks) {
        // the whole chunk, also past n in the last one: those positions are
        // never read, and the carry is not needed after it
        float* pb = s_pos + (c & 1) * C * stride + lane;
        const float* ib = s_inc + (c & 1) * C * stride + lane;
#pragma unroll
        for (int t0 = 0; t0 < C; t0 += U) {
          float dd[U];
#pragma unroll
          for (int u = 0; u < U; ++u) dd[u] = cst ? inc : ib[(t0 + u) * stride];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            pb[(t0 + u) * stride] = pos;
            pos = chain_step(pos, dd[u], size, !cst);
          }
        }
      }
    } else {
      for (int dp = 0; dp <= deepest; ++dp) {
        const int c = s - 1 - 2 * dp;
        if (c < 0 || c >= chunks) continue;
        const int t_base = c * C, len = min(C, n - t_base);
        const float* pb = s_pos + (c & 1) * C * stride;
        float* ib = s_inc + (c & 1) * C * stride;
        for (int i = tid - 32; i < group * len; i += blockDim.x - 32) {
          const int t = i / group, g = i - t * group, l0 = g * levels;
          const float* row = pb + t * stride + l0;
          float* next = ib + t * stride + l0;
          T* o = out + (size_t)(t_base + t) * pop + base + g;
          if constexpr (PAIRS) {
            if (dp == 0) {
              for (int j = 0; j < k; ++j) {
                const float cur = __fadd_rn(
                    __fmul_rn(osc<OSC>(row[2 * j], sp, table), s_mul[l0 + 2 * j]),
                    s_add[l0 + 2 * j]);
                next[2 * j + 1] = __fmul_rn(w2sr, cur);
              }
            } else {
              float acc = 0.f;
              for (int j = 0; j < k; ++j) {
                const float v = __fmul_rn(osc<OSC>(row[2 * j + 1], sp, table),
                                          s_mul[l0 + 2 * j + 1]);
                acc = j ? __fadd_rn(acc, v) : v;
              }
              if constexpr (TOPO == SCAN_PARALLEL) acc = __fmul_rn(acc, sp.inv_k);
              if (base + g < pop) *o = to_out<T>(acc);
            }
          } else {
            const float x = osc<OSC>(row[dp], sp, table);
            if (dp < k - 1)
              next[dp + 1] = __fmul_rn(w2sr, __fadd_rn(__fmul_rn(x, s_mul[l0 + dp]),
                                                       s_add[l0 + dp]));
            else if (base + g < pop)
              *o = to_out<T>(__fmul_rn(x, s_mul[l0 + dp]));
          }
        }
      }
    }
    __syncthreads();
  }
}

// The bare chain of one level, one thread, `steps` add-and-wraps (a
// multiple of 8) over the 8 increments d: the serial floor's latency a step.
__global__ void scan_chain_probe_kernel(const float* __restrict__ d, int steps, float size,
                                        float* __restrict__ out) {
  float dd[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) dd[u] = d[u];
  float p = 0.f;
  for (int s = 0; s < steps; s += 8)
#pragma unroll
    for (int u = 0; u < 8; ++u) p = chain_step(p, dd[u], size, true);
  *out = p;
}

// Dynamic shared memory of a time-parallel block (kernels/scan.py::
// scan_tp_smem is the same formula).
static size_t scan_tp_smem(int lanes) {
  return (size_t)(4 * SCAN_TP_CHUNK * (lanes | 1) + 2 * lanes) * sizeof(float);
}

template <int TOPO, typename T>
static int launch_scan_tp(int osc_mode, const float* params, const ScanParams& sp,
                          const float* table, int group, int warps, void* out,
                          cudaStream_t stream) {
  const int lanes = group * (TOPO == SCAN_SERIES ? sp.k : 2 * sp.k);
  const dim3 grid((sp.pop + group - 1) / group), block(32 * warps);
  const size_t smem = scan_tp_smem(lanes);
  T* o = static_cast<T*>(out);
  switch (osc_mode) {
    case SCAN_FLOOR:
      scan_synth_tp_kernel<TOPO, SCAN_FLOOR, T><<<grid, block, smem, stream>>>(params, sp, table,
                                                                              group, o);
      break;
    case SCAN_EXACT:
      scan_synth_tp_kernel<TOPO, SCAN_EXACT, T><<<grid, block, smem, stream>>>(params, sp, table,
                                                                              group, o);
      break;
    case SCAN_TABLE:
      scan_synth_tp_kernel<TOPO, SCAN_TABLE, T><<<grid, block, smem, stream>>>(params, sp, table,
                                                                              group, o);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_tp(int topo, int osc_mode, const float* params, const ScanParams& sp,
                       const float* table, int group, int warps, void* out, cudaStream_t stream) {
  switch (topo) {
    case SCAN_FM2:
      return launch_scan_tp<SCAN_FM2, T>(osc_mode, params, sp, table, group, warps, out, stream);
    case SCAN_SERIES:
      return launch_scan_tp<SCAN_SERIES, T>(osc_mode, params, sp, table, group, warps, out,
                                            stream);
    case SCAN_PARALLEL:
      return launch_scan_tp<SCAN_PARALLEL, T>(osc_mode, params, sp, table, group, warps, out,
                                              stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <int TOPO, int K, int OSC, typename T>
static int launch_scan(const float* params, const ScanParams& sp, const float* table,
                       float* state, void* out, cudaStream_t stream) {
  scan_synth_kernel<TOPO, K, OSC, T><<<(sp.pop + SCAN_TPB - 1) / SCAN_TPB, SCAN_TPB, 0, stream>>>(
      params, sp, table, state, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

template <int TOPO, int K, typename T>
static int dispatch_osc(int osc_mode, const float* params, const ScanParams& sp,
                        const float* table, float* state, void* out, cudaStream_t stream) {
  switch (osc_mode) {
    case SCAN_FLOOR:
      return launch_scan<TOPO, K, SCAN_FLOOR, T>(params, sp, table, state, out, stream);
    case SCAN_EXACT:
      return launch_scan<TOPO, K, SCAN_EXACT, T>(params, sp, table, state, out, stream);
    case SCAN_TABLE:
      return launch_scan<TOPO, K, SCAN_TABLE, T>(params, sp, table, state, out, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// Floats of the runtime-length instantiation's state for a topology kind
// and length k (0 for a compile-time length): kernels/scan.py::
// scan_state_floats is the same formula.
static long long scan_state_floats(int topo, int k, int pop) {
  return (long long)(topo == SCAN_SERIES ? 3 : 6) * k * pop;
}

// Compile-time chain lengths for fm2, fm3..fm8_series and fm2..fm4_parallel
// (every example config); longer chains take the K 0 instantiation, its
// state in `state` (state_floats of them).
template <typename T>
static int dispatch_topo(int topo, int osc_mode, const float* params, const ScanParams& sp,
                         const float* table, float* state, long long state_floats, void* out,
                         cudaStream_t stream) {
  const int k = sp.k;
#define SCAN_CASE(TP, KK)                                                                      \
  if (topo == TP && k == KK)                                                                   \
    return dispatch_osc<TP, KK, T>(osc_mode, params, sp, table, nullptr, out, stream);
  SCAN_CASE(SCAN_FM2, 1)
  SCAN_CASE(SCAN_SERIES, 3) SCAN_CASE(SCAN_SERIES, 4) SCAN_CASE(SCAN_SERIES, 5)
  SCAN_CASE(SCAN_SERIES, 6) SCAN_CASE(SCAN_SERIES, 7) SCAN_CASE(SCAN_SERIES, 8)
  SCAN_CASE(SCAN_PARALLEL, 2) SCAN_CASE(SCAN_PARALLEL, 3) SCAN_CASE(SCAN_PARALLEL, 4)
#undef SCAN_CASE
  if (!state || state_floats < scan_state_floats(topo, k, sp.pop))
    return (int)cudaErrorInvalidValue;
  if (topo == SCAN_SERIES && k >= 3)
    return dispatch_osc<SCAN_SERIES, 0, T>(osc_mode, params, sp, table, state, out, stream);
  if (topo == SCAN_PARALLEL && k >= 2)
    return dispatch_osc<SCAN_PARALLEL, 0, T>(osc_mode, params, sp, table, state, out, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" {

// Audio (n, pop) of scaled params (pop, d): topo 0 fm2 (sp.k 1), 1
// fm{k}_series (k >= 3), 2 fm{k}_parallel (k >= 2); osc_mode 0 floor, 1
// exact, 2 table (`table` holds table_max + 1 floats); bf16 != 0 writes
// bfloat16, else float32; `state` holds state_floats floats, at least
// scan_state_floats(topo, k, pop) for a length without a compile-time
// instantiation (may be null otherwise). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a topology, mode or state the kernel does not
// take.
int pmfm_scan_synth(const float* params, int topo, int osc_mode, int bf16, ScanParams sp,
                    const float* table, float* state, long long state_floats, void* out,
                    cudaStream_t stream) {
  if (sp.pop < 1 || sp.n < 1) return (int)cudaErrorInvalidValue;
  return bf16 ? dispatch_topo<__nv_bfloat16>(topo, osc_mode, params, sp, table, state,
                                             state_floats, out, stream)
              : dispatch_topo<float>(topo, osc_mode, params, sp, table, state, state_floats, out,
                                     stream);
}

// The same audio in the time-parallel layout: `group` candidates a block of
// `warps` warps (topo and sp as pmfm_scan_synth's, sp.k 1 for fm2, at least
// 3 for a chain and 2 for a bank). cudaErrorInvalidValue where group x the
// levels (a chain's k, a bank's 2 k, fm2's 2) exceeds SCAN_TP_MAX_LANES or
// warps is outside 2 .. SCAN_TP_MAX_WARPS.
int pmfm_scan_synth_tp(const float* params, int topo, int osc_mode, int bf16, ScanParams sp,
                       const float* table, int group, int warps, void* out, cudaStream_t stream) {
  const int levels = topo == SCAN_SERIES ? sp.k : 2 * sp.k;
  if (sp.pop < 1 || sp.n < 1 || group < 1 || warps < 2 || warps > SCAN_TP_MAX_WARPS ||
      (topo == SCAN_FM2 && sp.k != 1) || (topo == SCAN_SERIES && sp.k < 3) ||
      (topo == SCAN_PARALLEL && sp.k < 2) || levels * group > SCAN_TP_MAX_LANES)
    return (int)cudaErrorInvalidValue;
  return bf16 ? dispatch_tp<__nv_bfloat16>(topo, osc_mode, params, sp, table, group, warps, out,
                                           stream)
              : dispatch_tp<float>(topo, osc_mode, params, sp, table, group, warps, out, stream);
}

// One thread's bare chain of `steps` add-and-wraps (a multiple of 8, the
// wrap of a level past the first) over the 8 floats of d, its end position
// to out: timed by the caller, the scan's serial floor a sample.
int pmfm_scan_chain_probe(const float* d, int steps, float size, float* out,
                          cudaStream_t stream) {
  if (steps < 8 || steps % 8) return (int)cudaErrorInvalidValue;
  scan_chain_probe_kernel<<<1, 1, 0, stream>>>(d, steps, size, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
