// The offspring prologue shared by the fused B2 kernels (fused_eval.cu: int8;
// fused_f32.cu: true f32), as the TPU kernel keeps it in
// pmfm_tpu/kernels/generation.py::_offspring_block, and the host dispatch of
// the kernels' instantiations. B5 (evolve.cu) runs B2's own kernels for its
// evaluation (generation.cuh), so nothing here is B5's alone.
#pragma once

#include <type_traits>

#include "synth_common.cuh"

struct MutateParams {
  int mu;
  int clamp;
  float alpha, inv_alpha;
  float ekb_alpha, ekb_inv_alpha;  // alpha^beta and (1/alpha)^beta, from the host
  float beta_scale;
  float root_two_over_pi;
  float min_step;
  const float* mins;    // (d,) device memory, any d
  const float* ranges;  // (d,) maxs - mins, device memory
};

// ---- the offspring prologue ---------------------------------------------------

// Philox4x32-10 (Salmon et al., SC'11): counter (candidate, dimension, call,
// 0), key (seed, 0). kernels/generation.py::philox4x32 is the same function.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

__device__ __forceinline__ float uniform01(uint32_t bits) {
  return fmul((float)(bits >> 8), 1.0f / 16777216.0f);  // exact: 24-bit value
}

// Gene `dim` of candidate `cand`'s offspring (_offspring_block): a uniform
// parent, an exact copy, the Ek coin, a CLT-12 gaussian (sigma 1/6), one
// retry with -0.5 g, log-normal step adaptation, the step floor and the
// optional clamp. Writes the gene's value and step and returns its scaled
// parameter (_scale_rows). It depends on (cand, dim) alone, so B2 spreads a
// block's genes over all its threads. The parents are read through L2
// (__ldcg): B5's selection rewrites them between generations.
__device__ __forceinline__ float offspring_gene(uint32_t seed, int cand, int dim, const float* pv,
                                                const float* ps, const MutateParams& mp, int d,
                                                float* values, float* steps) {
  const uint4 r0 = philox4x32_10(make_uint4(cand, dim, 0, 0), seed, 0u);
  const uint4 r1 = philox4x32_10(make_uint4(cand, dim, 1, 0), seed, 0u);
  const uint4 r2 = philox4x32_10(make_uint4(cand, dim, 2, 0), seed, 0u);
  const uint4 r3 = philox4x32_10(make_uint4(cand, dim, 3, 0), seed, 0u);
  const int idx = (int)((r0.x & 0x7FFFFFFFu) % (uint32_t)mp.mu);
  const bool coin = (r0.y & 1u) != 0u;
  const uint32_t u[12] = {r0.z, r0.w, r1.x, r1.y, r1.z, r1.w,
                          r2.x, r2.y, r2.z, r2.w, r3.x, r3.y};
  const float x = __ldcg(pv + (size_t)idx * d + dim);
  const float s = __ldcg(ps + (size_t)idx * d + dim);
  const float ek = coin ? mp.inv_alpha : mp.alpha;
  const float ekb = coin ? mp.ekb_inv_alpha : mp.ekb_alpha;
  float g = 0.f;
#pragma unroll
  for (int j = 0; j < 12; ++j) g = fadd(g, fsub(fmul(uniform01(u[j]), 2.f), 1.f));
  g = fmul(g, 1.0f / 12.0f);
  const float eks = fmul(ek, s);
  float nx = fadd(x, fmul(eks, g));
  if (nx < 0.f || nx > 1.f) {
    g = fmul(g, -0.5f);
    nx = fadd(x, fmul(eks, g));
  }
  if (mp.clamp) nx = fminf(fmaxf(nx, 0.f), 1.f);
  const float es = expf(fsub(fabsf(g), mp.root_two_over_pi));
  float ns = fmul(fmul(s, ekb), powf(es, mp.beta_scale));
  if (mp.min_step > 0.f) ns = fmaxf(ns, mp.min_step);
  values[(size_t)cand * d + dim] = nx;
  steps[(size_t)cand * d + dim] = ns;
  return fadd(__ldg(mp.mins + dim), fmul(nx, __ldg(mp.ranges + dim)));  // _scale_rows
}

// Runs f.template operator()<NC>() for the sine order's coefficient count.
template <typename F>
__host__ inline int dispatch_ncoef(int ncoef, F&& f) {
  switch (ncoef) {
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// The longest chain and the largest bank with a compile-time code of their
// own; longer chains and larger banks (all banks in B3/B4) take the wide
// codes (synth_common.cuh: WIDE_CHAIN, WIDE_BANK).
#define FIXED_KN 8      // fm8_series
#define FIXED_PAIRS 5   // fm5_parallel (20 genes, the reference's pursuit family)

// Runs f(std::integral_constant<int, KN>{}) for sp's synthesis code: a chain
// of sp.kn oscillators (2 .. FIXED_KN each its own code, then up to MAX_KN
// WIDE_CHAIN), or a bank of sp.npair pairs (with FIXED_BANKS, 2 ..
// FIXED_PAIRS each its own code BANK_KN + npair, then up to MAX_PAIRS
// WIDE_BANK; without, every bank WIDE_BANK). B1/B2 take the fixed banks;
// B3/B4 do not (one bank instantiation a kernel, mode and sine order, where
// four more each would add half again to large_frame.cu's build).
//
// With sp.long_code set, any chain but fm2 and any bank takes LONG_CODE
// instead (synth_common.cuh::LongSynth; the host sets it above 32 genes).
//
// SET picks which codes a translation unit instantiates: CODES_ALL, or
// CODES_FIXED, CODES_WIDE and CODES_LONG, whose sources nvcc builds side by
// side (fused_eval.cu and fused_bf16.cu beside fused_wide.cu and
// fused_long.cu, large_frame.cu beside large_frame_wide.cu and
// large_frame_long.cu); a code outside the set returns
// cudaErrorInvalidValue, and synth_set says which set a shape is in.
enum SynthSet { CODES_ALL, CODES_FIXED, CODES_WIDE, CODES_LONG };

__host__ inline bool wide_synth(const SynthParams& sp, bool fixed_banks) {
  return sp.npair ? !fixed_banks || sp.npair > FIXED_PAIRS : sp.kn > FIXED_KN;
}

__host__ inline int synth_set(const SynthParams& sp, bool fixed_banks) {
  return sp.long_code ? CODES_LONG : wide_synth(sp, fixed_banks) ? CODES_WIDE : CODES_FIXED;
}

template <bool FIXED_BANKS, int SET = CODES_ALL, typename F>
__host__ inline int dispatch_synth(const SynthParams& sp, F&& f) {
  using std::integral_constant;
  if (SET != CODES_ALL && synth_set(sp, FIXED_BANKS) != SET) return (int)cudaErrorInvalidValue;
  if (sp.long_code) {
    if constexpr (SET == CODES_ALL || SET == CODES_LONG) {
      if (!sp.fm2 && sp.lscr && (sp.npair >= 2 || (sp.npair == 0 && sp.kn >= 3)))
        return f(integral_constant<int, LONG_CODE>{});
    }
    return (int)cudaErrorInvalidValue;
  }
  if constexpr (SET == CODES_LONG) return (int)cudaErrorInvalidValue;
  if constexpr (SET != CODES_WIDE && SET != CODES_LONG) {
    if (sp.npair == 0) {
      switch (sp.kn) {
        case 2: return f(integral_constant<int, 2>{});
        case 3: return f(integral_constant<int, 3>{});
        case 4: return f(integral_constant<int, 4>{});
        case 5: return f(integral_constant<int, 5>{});
        case 6: return f(integral_constant<int, 6>{});
        case 7: return f(integral_constant<int, 7>{});
        case 8: return f(integral_constant<int, 8>{});
        default: break;
      }
    } else if constexpr (FIXED_BANKS) {
      switch (sp.npair) {
        case 2: return f(integral_constant<int, BANK_KN + 2>{});
        case 3: return f(integral_constant<int, BANK_KN + 3>{});
        case 4: return f(integral_constant<int, BANK_KN + 4>{});
        case 5: return f(integral_constant<int, BANK_KN + 5>{});
        default: break;
      }
    }
  }
  if constexpr (SET != CODES_FIXED && SET != CODES_LONG) {
    if (sp.npair == 0 && sp.kn > FIXED_KN && sp.kn <= MAX_KN)
      return f(integral_constant<int, WIDE_CHAIN>{});
    if (sp.npair >= 2 && sp.npair <= MAX_PAIRS && wide_synth(sp, FIXED_BANKS))
      return f(integral_constant<int, WIDE_BANK>{});
  }
  return (int)cudaErrorInvalidValue;
}
