// The large-frame synthesis kernels for Hopper (sm_90a): emit-only engines
// whose output goes to a spectrum computed outside the kernel.
//
// Replaces two TPU kernels of pmfm_tpu:
//   synth_fold_kernel   <- kernels/synth_fold.py::fused_synth_fold     (B3)
//   synth_stream_kernel <- kernels/synth_stream.py::fused_synth_stream (B4)
//
// B3 (the synth_fold route, 4096 <= n <= 16384): synthesis and the window
// fold, a+/-[r] = q[r] +- q[N-r] (a+/-[0] = q[0]), plus the edge sample
// x[N/2] and the magnitude scale |amp| * dft_scale per candidate. int8 mode
// emits q = round(63 sin) (the fold stays exact: |a+/-| <= 126); bf16 mode
// emits the bf16-rounded audio sin * amp and rounds the fold sum once more
// (the reference's fold_cast), with a magnitude scale of 1. a+/- are stored
// candidate-major, as (P, N/2) rows that the wrapper hands out as (N/2, P)
// views: that is the layout in which the folded DFT outside the kernel
// (ops/spectral.py::magnitude_spectrum_prefolded, torch._int_mm) runs about
// 7x faster on an H100 than with time-major a+/- (chip_smoke.py's phase 11
// times both layouts; PERF.md has the numbers).
//
// B4 (the synth_stream route, n >= 32768): synthesis times the Hann window,
// sin * amp * w[m], written as (N, P) time-major bf16, or f32 for the
// true-f32 engine, for ops/spectral.py::magnitude_spectrum_factored
// (prewindowed). The TPU kernel's sequential time-chunk grid axis, whose
// phase carries lived in scratch, is the thread's own loop over samples:
// the carries stay in registers.
//
// What bounds them on an H100, at the shapes chip_smoke.py drives (fm3_series,
// sine order 7: 44 f32 operations a sample, chip_smoke.py::synth_ops_f32):
//   B3 at n 8192, P 2^15: 11.8 G f32 operations (0.18 ms at 67 TFLOP/s) and
//      268 MB of a+/- written (0.08 ms at 3.35 TB/s): bound by operations.
//   B4 at n 65536, P 2^13: 24 G f32 operations (0.36 ms) and 1.07 GB of bf16
//      audio written (0.32 ms): near the balance point.
//
// Design (simple first kernels). One thread per candidate, 32 candidates per
// block; each thread runs synth_common.cuh::synth_run, the recurrence B1 and
// B2 run. B4 writes sample m of all 32 candidates with one warp store (64
// bytes of bf16, 128 of f32). B3 takes the samples in unrolled groups of 16
// and writes each group of its own row as one 16-byte vector (two in bf16)
// through synth_common.cuh::FoldEmit, the grouped fold emitter B1 and B2
// share: the first half of the frame goes straight to a+ (a half frame is
// 4 KB a candidate at n = 8192, so 64 candidates' halves would not fit shared
// memory), and each group of 16 second-half samples completes 16 rows of the
// fold (FoldEmit's note says how). The per-thread time loop is the weak
// point: at P = 2^13 there are only ~2 warps per SM to hide the
// recurrence's latency. Splitting time across threads (the scanless prefix
// sum) is later work.
//
// Exactness: every f32 operation uses __fmul_rn / __fadd_rn (synth_common.cuh),
// bf16 rounding is __float2bfloat16_rn (round to nearest even, as PyTorch's
// .to(torch.bfloat16)), so the outputs are bit-equal to the plain versions in
// kernels/synth_fold.py and kernels/synth_stream.py.

#include "synth_common.cuh"

#define LF_TPB 32  // candidates (threads) per CUDA block

template <int NC, bool INT8>
__global__ void __launch_bounds__(LF_TPB)
synth_fold_kernel(const float* __restrict__ params, int pop, SynthParams sp,
                  fold_t<INT8>* a_plus, fold_t<INT8>* a_minus,  // read back: no __restrict__
                  float* __restrict__ edge, float* __restrict__ mag_scale) {
  const int cand = blockIdx.x * LF_TPB + threadIdx.x;
  if (cand >= pop) return;
  float p[MAX_D];
  load_params(p, params, cand, sp.d);
  const Chain ch = make_chain(p, sp);
  const int half = sp.n >> 1;
  FoldEmit<INT8> emit;
  emit.ap.p = a_plus + (size_t)cand * half;
  emit.am.p = a_minus + (size_t)cand * half;
  emit.n = sp.n;
  emit.half = half;
  emit.amp = ch.amp;
  emit.edge_q = 0.f;
  synth_run<NC, FOLD_G>(ch, sp, INT8 ? sp.sin_c63 : sp.sin_c, sp.n, emit);
  emit.fold_rows(0, false, 0.f);  // rows [0, 16): row 0 keeps q[0] alone
  edge[cand] = emit.edge_q;
  mag_scale[cand] = INT8 ? fmul(fabsf(ch.amp), sp.dft_scale) : 1.f;
}

template <int NC, bool F32>
__global__ void __launch_bounds__(LF_TPB)
synth_stream_kernel(const float* __restrict__ params, int pop, SynthParams sp,
                    const float* __restrict__ window, void* __restrict__ out) {
  const int cand = blockIdx.x * LF_TPB + threadIdx.x;
  if (cand >= pop) return;
  float p[MAX_D];
  load_params(p, params, cand, sp.d);
  const Chain ch = make_chain(p, sp);
  const size_t P = (size_t)pop;
  auto emit = [&](int m, int, float y) {
    const float v = fmul(fmul(y, ch.amp), __ldg(window + m));
    if (F32)
      reinterpret_cast<float*>(out)[(size_t)m * P + cand] = v;
    else
      reinterpret_cast<__nv_bfloat16*>(out)[(size_t)m * P + cand] = __float2bfloat16_rn(v);
  };
  synth_run<NC>(ch, sp, sp.sin_c, sp.n, emit);
}

template <int NC>
static void launch_fold(dim3 grid, cudaStream_t s, const float* params, int pop,
                        const SynthParams& sp, void* ap, void* am, float* edge, float* ms,
                        int int8_mode) {
  if (int8_mode)
    synth_fold_kernel<NC, true><<<grid, LF_TPB, 0, s>>>(
        params, pop, sp, (int8_t*)ap, (int8_t*)am, edge, ms);
  else
    synth_fold_kernel<NC, false><<<grid, LF_TPB, 0, s>>>(
        params, pop, sp, (__nv_bfloat16*)ap, (__nv_bfloat16*)am, edge, ms);
}

template <int NC>
static void launch_stream(dim3 grid, cudaStream_t s, const float* params, int pop,
                          const SynthParams& sp, const float* window, void* out, int audio_f32) {
  if (audio_f32)
    synth_stream_kernel<NC, true><<<grid, LF_TPB, 0, s>>>(params, pop, sp, window, out);
  else
    synth_stream_kernel<NC, false><<<grid, LF_TPB, 0, s>>>(params, pop, sp, window, out);
}

extern "C" {

// B3: folded a+/a- int8 (int8_mode) or bf16, stored candidate-major as
// (pop, n/2) rows, edge (pop,) and mag_scale (pop,) f32 from scaled params
// (pop, d). Returns cudaGetLastError().
int pmfm_synth_fold(const float* params, int pop, SynthParams sp, void* a_plus, void* a_minus,
                    float* edge, float* mag_scale, int int8_mode, cudaStream_t stream) {
  const dim3 grid((pop + LF_TPB - 1) / LF_TPB);
  switch (sp.ncoef) {
    case 3: launch_fold<3>(grid, stream, params, pop, sp, a_plus, a_minus, edge, mag_scale, int8_mode); break;
    case 4: launch_fold<4>(grid, stream, params, pop, sp, a_plus, a_minus, edge, mag_scale, int8_mode); break;
    case 5: launch_fold<5>(grid, stream, params, pop, sp, a_plus, a_minus, edge, mag_scale, int8_mode); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// B4: windowed audio (n, pop), f32 (audio_f32) or bf16, from scaled params
// (pop, d) and the window (n,). Returns cudaGetLastError().
int pmfm_synth_stream(const float* params, int pop, SynthParams sp, const float* window,
                      void* out, int audio_f32, cudaStream_t stream) {
  const dim3 grid((pop + LF_TPB - 1) / LF_TPB);
  switch (sp.ncoef) {
    case 3: launch_stream<3>(grid, stream, params, pop, sp, window, out, audio_f32); break;
    case 4: launch_stream<4>(grid, stream, params, pop, sp, window, out, audio_f32); break;
    case 5: launch_stream<5>(grid, stream, params, pop, sp, window, out, audio_f32); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
