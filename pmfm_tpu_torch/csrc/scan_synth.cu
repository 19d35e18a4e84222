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
// Layout: thread c walks candidate c's frame; at sample t the warp's 32
// stores of row t are one 128-byte (float32) or 64-byte (bf16) segment.
// The chain length is a template argument for fm2, fm3..fm8_series and
// fm2..fm4_parallel, so the phases stay in registers; longer chains take an
// instantiation that reads it at run time (SCAN_MAX_K).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define SCAN_TPB 128   // candidates (threads) per block
#define SCAN_MAX_K 32  // oscillators or pairs of the runtime-length instantiation

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

template <typename T>
__device__ __forceinline__ T to_out(float x);
template <>
__device__ __forceinline__ float to_out<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// TOPO SCAN_FM2 (K 1), SCAN_SERIES (K oscillators) or SCAN_PARALLEL (K
// pairs); K 0 takes the chain length from sp.k (up to SCAN_MAX_K, its
// state in local memory). Parameters (pop, d) row-major.
template <int TOPO, int K, int OSC, typename T>
__global__ void __launch_bounds__(SCAN_TPB)
scan_synth_kernel(const float* __restrict__ params, ScanParams sp,
                  const float* __restrict__ table, T* __restrict__ out) {
  constexpr int CAP = K ? K : SCAN_MAX_K;
  const int kk = K ? K : sp.k;
  const int c = blockIdx.x * SCAN_TPB + threadIdx.x;
  if (c >= sp.pop) return;
  const float size = sp.size, w2sr = sp.w2sr;
  const int pop = sp.pop;
  if constexpr (TOPO == SCAN_FM2 || TOPO == SCAN_PARALLEL) {
    const float* p = params + (size_t)c * 4 * kk;
    float md[CAP], cf[CAP], amp[CAP], inc[CAP], pos1[CAP], pos2[CAP];
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
    float ms[CAP], cs[CAP], pos[CAP];
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

template <int TOPO, int K, int OSC, typename T>
static int launch_scan(const float* params, const ScanParams& sp, const float* table, void* out,
                       cudaStream_t stream) {
  scan_synth_kernel<TOPO, K, OSC, T><<<(sp.pop + SCAN_TPB - 1) / SCAN_TPB, SCAN_TPB, 0, stream>>>(
      params, sp, table, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

template <int TOPO, int K, typename T>
static int dispatch_osc(int osc_mode, const float* params, const ScanParams& sp,
                        const float* table, void* out, cudaStream_t stream) {
  switch (osc_mode) {
    case SCAN_FLOOR: return launch_scan<TOPO, K, SCAN_FLOOR, T>(params, sp, table, out, stream);
    case SCAN_EXACT: return launch_scan<TOPO, K, SCAN_EXACT, T>(params, sp, table, out, stream);
    case SCAN_TABLE: return launch_scan<TOPO, K, SCAN_TABLE, T>(params, sp, table, out, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// Compile-time chain lengths for fm2, fm3..fm8_series and fm2..fm4_parallel
// (every example config); longer chains take the K 0 instantiation.
template <typename T>
static int dispatch_topo(int topo, int osc_mode, const float* params, const ScanParams& sp,
                         const float* table, void* out, cudaStream_t stream) {
  const int k = sp.k;
#define SCAN_CASE(TP, KK) \
  if (topo == TP && k == KK) return dispatch_osc<TP, KK, T>(osc_mode, params, sp, table, out, stream);
  SCAN_CASE(SCAN_FM2, 1)
  SCAN_CASE(SCAN_SERIES, 3) SCAN_CASE(SCAN_SERIES, 4) SCAN_CASE(SCAN_SERIES, 5)
  SCAN_CASE(SCAN_SERIES, 6) SCAN_CASE(SCAN_SERIES, 7) SCAN_CASE(SCAN_SERIES, 8)
  SCAN_CASE(SCAN_PARALLEL, 2) SCAN_CASE(SCAN_PARALLEL, 3) SCAN_CASE(SCAN_PARALLEL, 4)
#undef SCAN_CASE
  if (k < 1 || k > SCAN_MAX_K) return (int)cudaErrorInvalidValue;
  if (topo == SCAN_SERIES && k >= 3)
    return dispatch_osc<SCAN_SERIES, 0, T>(osc_mode, params, sp, table, out, stream);
  if (topo == SCAN_PARALLEL && k >= 2)
    return dispatch_osc<SCAN_PARALLEL, 0, T>(osc_mode, params, sp, table, out, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" {

// Audio (n, pop) of scaled params (pop, d): topo 0 fm2 (sp.k 1), 1
// fm{k}_series (k 3..SCAN_MAX_K), 2 fm{k}_parallel (k 2..SCAN_MAX_K);
// osc_mode 0 floor, 1 exact, 2 table (`table` holds table_max + 1 floats);
// bf16 != 0 writes bfloat16, else float32. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a topology or mode the kernel does not take.
int pmfm_scan_synth(const float* params, int topo, int osc_mode, int bf16, ScanParams sp,
                    const float* table, void* out, cudaStream_t stream) {
  if (sp.pop < 1 || sp.n < 1) return (int)cudaErrorInvalidValue;
  return bf16 ? dispatch_topo<__nv_bfloat16>(topo, osc_mode, params, sp, table, out, stream)
              : dispatch_topo<float>(topo, osc_mode, params, sp, table, out, stream);
}

}  // extern "C"
