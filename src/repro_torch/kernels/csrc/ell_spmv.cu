// Policy-restricted ELL SpMV for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/spmv_ell.py::ell_matvec
// (body _spmv_kernel):  y[i] = sum_k val[i, k] * x[idx[i, k]]  over the
// (n, K) rows of P_pi.  It runs once per inner iteration of every KSP; the
// A_pi x = x - gamma * y epilogue stays outside, in torch.
//
// The TPU kernel streams x through VMEM windows; here x stays in HBM and
// is gathered directly (L2-resident at n = 10^6).
//
// Rounding contract (bit-equal to repro_torch.kernels.ref.ell_matvec):
// each product rounded on its own (__fmul_rn), K-sum in order k = 0..K-1
// from a +0 accumulator (__fadd_rn), built with -fmad=false.  Acc is float
// for a float32 x, double for a float64 x (val widened exactly).
//
// Bound on the H100: bytes.  n*K*8 bytes of table (idx + val) + x + the
// output: at n = 10^6, K = 8 about 76 MB (f64 x, y), 0.023 ms at
// 3.35 TB/s; 16 MFLOP is far below any compute bound.
//
// Design (simple and right first): one thread per row, 64-bit offsets.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename Acc>
__global__ void ell_spmv_kernel(const int32_t* __restrict__ idx,
                                const float* __restrict__ val,
                                const Acc* __restrict__ x, int64_t n,
                                int32_t k, Acc* __restrict__ y) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const int64_t base = row * (int64_t)k;
  Acc acc = 0;
  for (int32_t j = 0; j < k; ++j) {
    acc = add_rn(acc, mul_rn((Acc)val[base + j], x[idx[base + j]]));
  }
  y[row] = acc;
}

template <typename Acc>
int launch(const void* idx, const void* val, const void* x, long long n,
           int k, void* y, void* stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  ell_spmv_kernel<Acc><<<(unsigned int)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const float*)val, (const Acc*)x, (int64_t)n, k,
      (Acc*)y);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ell_spmv_f32(const void* idx, const void* val, const void* x,
                            long long n, int k, void* y, void* stream) {
  return launch<float>(idx, val, x, n, k, y, stream);
}

extern "C" int ell_spmv_f64(const void* idx, const void* val, const void* x,
                            long long n, int k, void* y, void* stream) {
  return launch<double>(idx, val, x, n, k, y, stream);
}
