// Device code shared by the two ELL kernels (ell_backup.cu, ell_spmv.cu):
// the pinned roundings, the gather of v / x under an L2 evict_last policy,
// one lane's products and the in-order K-sum at a row's leader lane.  The
// layout it assumes: a row's K slots are spread over g neighbouring lanes
// (g = 1 for a short row on the 4-byte path), VEC consecutive slots a
// lane, in chunks of g * VEC slots.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "lanes.cuh"

namespace {

constexpr int WARP = 32;
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// L2 policy for the gathers: keep v / x resident while the table streams
// past (the table itself is read evict-first: table_ld, or __ldcs on the
// 16-byte path).
__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

// A 4-byte table load: evict-first in L2, as the stream is read once, but
// kept in L1, where a lane that walks a short row (or neighbouring lanes of
// a row split 4 bytes a lane) finds the rest of the line on its next load.
__device__ __forceinline__ int32_t table_ld(const int32_t* p) {
  int32_t r;
  asm("ld.global.nc.L1::evict_last.L2::cache_hint.b32 %0, [%1], %2;"
      : "=r"(r) : "l"(p), "l"(evict_first_policy()));
  return r;
}

__device__ __forceinline__ float table_ld(const float* p) {
  float r;
  asm("ld.global.nc.L1::evict_last.L2::cache_hint.f32 %0, [%1], %2;"
      : "=f"(r) : "l"(p), "l"(evict_first_policy()));
  return r;
}

__device__ __forceinline__ float gather(const float* p, uint64_t pol) {
  float r;
  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;"
      : "=f"(r) : "l"(p), "l"(pol));
  return r;
}

__device__ __forceinline__ double gather(const double* p, uint64_t pol) {
  double r;
  asm("ld.global.nc.L2::cache_hint.f64 %0, [%1], %2;"
      : "=d"(r) : "l"(p), "l"(pol));
  return r;
}

// The products of this lane's VEC slots starting at `slot` of the row at
// `base` (each rounded on its own); zeros where the lane has no slot.
template <typename Acc, int VEC>
__device__ __forceinline__ void products(const int32_t* __restrict__ idx,
                                         const float* __restrict__ val,
                                         const Acc* __restrict__ x,
                                         int64_t base, int32_t slot,
                                         bool live, uint64_t pol,
                                         Acc (&prod)[VEC]) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) prod[e] = 0;
  if (!live) return;
  if constexpr (VEC == 4) {
    const int4 i = __ldcs(reinterpret_cast<const int4*>(idx + base + slot));
    const float4 w = __ldcs(reinterpret_cast<const float4*>(val + base + slot));
    const Acc g0 = gather(x + i.x, pol), g1 = gather(x + i.y, pol);
    const Acc g2 = gather(x + i.z, pol), g3 = gather(x + i.w, pol);
    prod[0] = mul_rn((Acc)w.x, g0);
    prod[1] = mul_rn((Acc)w.y, g1);
    prod[2] = mul_rn((Acc)w.z, g2);
    prod[3] = mul_rn((Acc)w.w, g3);
  } else {
    const int32_t i = table_ld(idx + base + slot);
    const float w = table_ld(val + base + slot);
    prod[0] = mul_rn((Acc)w, gather(x + i, pol));
  }
}

// Add a chunk's products into the row leader's `acc` in slot order: the
// leader's own VEC slots, then each other lane's (g lanes a row), by
// shuffles.  Every lane of the warp calls it, for the shuffles; only a
// leader's (lane g == 0) `acc` moves.
template <typename Acc, int VEC>
__device__ __forceinline__ Acc row_sum(Acc acc, const Acc (&prod)[VEC],
                                       int lanes, int g, int lead,
                                       int32_t chunk0, int32_t k) {
  for (int src = 0; src < lanes; ++src) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const Acc t = src == 0 ? prod[e]
                             : __shfl_sync(FULL, prod[e], lead + src);
      if (g == 0 && chunk0 + src * VEC + e < k) acc = add_rn(acc, t);
    }
  }
  return acc;
}

// On the 4-byte path a row of at most ROW_SLOTS slots takes one lane,
// which walks it: neighbouring lanes then read at most 16 bytes apart, so
// a warp's loads stay within a few L1 lines, and spreading so short a row
// over lanes would only add shuffles and warps.
constexpr int ROW_SLOTS = 4;

// Lanes a row (g, at most 32) and chunks a row for K slots, VEC a lane.
__host__ __forceinline__ void row_lanes(int k, int vec, int32_t& g,
                                        int32_t& chunks) {
  if (vec == 1 && k <= ROW_SLOTS) {
    g = 1;
    chunks = k;
    return;
  }
  const int per_row = (k + vec - 1) / vec;
  g = per_row < 1 ? 1 : (per_row < WARP ? per_row : WARP);
  chunks = (per_row + g - 1) / g;
}

// The launchers take VEC = 4 (one 16-byte load of idx and of val a lane)
// where K % 4 == 0 and both tables start 16-byte aligned, else VEC = 1.
// A fleet's lane strides are whole tables (n*m*K or n*K elements, or 0),
// multiples of 4 elements whenever K is, so every lane's base keeps the
// alignment of the first.
__host__ __forceinline__ int vector_width(const void* idx, const void* val,
                                          int k) {
  const bool aligned = (((uintptr_t)idx | (uintptr_t)val) & 15) == 0;
  return k % 4 == 0 && aligned ? 4 : 1;
}

}  // namespace
