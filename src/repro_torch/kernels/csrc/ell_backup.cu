// Fused ELL Bellman backup for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/bellman_ell.py::ell_backup
// (body _backup_kernel):  for every state row s,
//
//   Q(s, a) = cost[s, a] + gamma * sum_k val[s, a, k] * v[idx[s, a, k]]
//   out_v[s] = min_a Q(s, a),  out_pi[s] = argmin_a Q(s, a)  (first min wins)
//
// The TPU kernel streams v through VMEM-sized windows; that is a TPU
// artifact.  Here v stays in HBM and is gathered directly: at n = 10^6 a
// float32 v (4 MB) or float64 v (8 MB) sits in the 50 MB L2.
//
// Rounding contract (bit-equal to repro_torch.kernels.ref.ell_backup):
//   * each product val * v[idx] is rounded on its own (__fmul_rn);
//   * the K-sum runs k = 0 .. K-1 from a +0 accumulator (__fadd_rn);
//   * gamma * pv is rounded before + cost; no FMA contraction anywhere
//     (explicit _rn intrinsics, and the build passes -fmad=false).
// Acc is float when v is float32, double when v is float64 (val and cost
// are widened exactly); gamma arrives already rounded to Acc.
//
// Bound on the H100: bytes.  One backup must read the table once —
// n*m*K*8 bytes (idx + val) + n*m*4 (cost) — plus v and the two outputs:
// at n = 10^6, m = 16, K = 8 about 1.09 GB, 0.33 ms at 3.35 TB/s, against
// about 0.29 GFLOP (far below any compute bound).
//
// Design (simple and right first): one thread per state row walks its
// actions in order with a running strict-< minimum.  All row offsets are
// 64-bit (n*m*K passes 2^31 at n = 1.7*10^7, m = 16, K = 8).  Each thread
// reads its own contiguous m*K slots, so a warp's loads are strided by a
// row; coalesced warp-per-row loads and cp.async/TMA staging are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename Acc>
__global__ void ell_backup_kernel(const int32_t* __restrict__ idx,
                                  const float* __restrict__ val,
                                  const float* __restrict__ cost,
                                  const Acc* __restrict__ v, Acc gamma,
                                  int64_t n, int32_t m, int32_t k,
                                  Acc* __restrict__ out_v,
                                  int32_t* __restrict__ out_pi) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const int64_t row_base = row * (int64_t)m * k;
  Acc best = 0;
  int32_t arg = 0;
  for (int32_t a = 0; a < m; ++a) {
    const int64_t base = row_base + (int64_t)a * k;
    Acc acc = 0;
    for (int32_t j = 0; j < k; ++j) {
      const Acc p = mul_rn((Acc)val[base + j], v[idx[base + j]]);
      acc = add_rn(acc, p);
    }
    const Acc q = add_rn((Acc)cost[row * m + a], mul_rn(gamma, acc));
    if (a == 0 || q < best) {
      best = q;
      arg = a;
    }
  }
  out_v[row] = best;
  out_pi[row] = arg;
}

template <typename Acc>
int launch(const void* idx, const void* val, const void* cost, const void* v,
           Acc gamma, long long n, int m, int k, void* out_v, void* out_pi,
           void* stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  ell_backup_kernel<Acc><<<(unsigned int)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const float*)val, (const float*)cost,
      (const Acc*)v, gamma, (int64_t)n, m, k, (Acc*)out_v,
      (int32_t*)out_pi);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ell_backup_f32(const void* idx, const void* val,
                              const void* cost, const void* v, float gamma,
                              long long n, int m, int k, void* out_v,
                              void* out_pi, void* stream) {
  return launch<float>(idx, val, cost, v, gamma, n, m, k, out_v, out_pi,
                       stream);
}

extern "C" int ell_backup_f64(const void* idx, const void* val,
                              const void* cost, const void* v, double gamma,
                              long long n, int m, int k, void* out_v,
                              void* out_pi, void* stream) {
  return launch<double>(idx, val, cost, v, gamma, n, m, k, out_v, out_pi,
                        stream);
}
