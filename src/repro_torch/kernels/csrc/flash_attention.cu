// Causal / non-causal GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel):
//
//   o[b, t, h, :] = sum_s softmax_s(scale * q[b, t, h, :] . k[b, s, g, :]) v[b, s, g, :]
//
// with g = h / (H / KV) (grouped-query heads), scale = d^-0.5, keys s > t
// masked when causal, keys s >= S always excluded, online softmax with f32
// accumulators (m, l, o), NEG_INF = -1e30 and l clamped at 1e-30 as in the
// TPU kernel.  Inputs are bf16 or f32; the output has q's dtype.
//
// What the TPU kernel's layout did and this one does not: it repeated K/V
// per query head (jnp.repeat) and transposed everything to (B*H, T, d),
// and padded T and S to block multiples.  Here q, k, v and o are read and
// written in place through their (batch, sequence, head) strides, the KV
// head is h / (H / KV), ragged T and S tails are bounds-checked, and key
// tiles past the causal frontier are never visited.
//
// Bound on the H100: operations.  At minitron-8b's prefill shape (B=4,
// T=S=2048, H=32, KV=8, d=128, causal) one call is 137.5 GFLOP against
// 168 MB of q/k/v/o: 0.14 ms at the bf16 tensor-core peak, 0.05 ms of
// bytes.  This first design does its products on the f32 CUDA cores (no
// mma/wgmma, no TMA), so it cannot come near that bound; the tensor-core
// rewrite is later work.
//
// Design (simple and right first): one CTA of 256 threads per (b*H + h,
// 64-row q block), heaviest (last) causal q blocks scheduled first.  The
// q tile (pre-scaled by `scale`) stays in shared memory; 64-row K and V
// tiles are staged in shared memory as f32 (bf16 converted with
// __bfloat162float), with d padded to DP = 16*DC columns of zeros.  Thread
// (ty, tx) of the 16x16 grid owns score rows 4*ty..4*ty+3 and key columns
// tx + 16*jj, and output columns tx + 16*cc: each score is a d-long f32
// dot with explicit __fmaf_rn, row max and row sum are reduced over the 16
// lanes that share ty (__shfl_xor_sync), the probabilities go through
// shared memory to the P.V product.  exp is expf (no fast math).  The
// library's -fmad=false is kept: every fused multiply-add here is the
// explicit intrinsic, so the build flags change nothing in this file.
// Shared memory is 116 KB at d = 128 (above the 48 KB static limit:
// cudaFuncSetAttribute raises the dynamic limit before the launch).
// All element offsets are 64-bit: B*T*H*d passes 2^31 at prefill_32k.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // keys per staged tile
constexpr int kThreads = 256;  // 16 x 16 thread grid
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* dst, float x) { *dst = __float2bfloat16(x); }

struct Strides {
  long long b, s, h;   // elements; the head dim has stride 1
};

template <int DC>
struct Smem {
  static constexpr int DP = 16 * DC;      // padded head dim
  static constexpr int QK_LD = DP + 4;    // q/k row stride: 16-byte rows,
                                          // float4 reads without conflicts
  static constexpr int V_LD = DP;
  static constexpr int P_LD = kBQ + 4;    // p stored transposed, [key][row]
  static constexpr int kFloats = kBQ * QK_LD + kBK * QK_LD + kBK * V_LD + kBK * P_LD;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

// Stage rows [row0, row0 + rows) x [0, DP) of one head of x into dst (row
// stride ld), multiplied by mul; rows >= n_rows and columns >= d are zero.
template <int DP, typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* __restrict__ x,
                                      long long base, long long row_stride,
                                      int row0, int rows, int n_rows, int d,
                                      float mul) {
  for (int e = threadIdx.x; e < rows * DP; e += kThreads) {
    const int r = e / DP, c = e % DP;
    const int row = row0 + r;
    float val = 0.f;
    if (row < n_rows && c < d) {
      val = to_f32(x[base + (long long)row * row_stride + c]) * mul;
    }
    dst[r * ld + c] = val;
  }
}

template <int DC, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int KV,
                 int n_q, int n_k, int d, Strides qs, Strides ks, Strides vs,
                 Strides os, float scale, int causal) {
  using S = Smem<DC>;
  constexpr int DP = S::DP;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + kBQ * S::QK_LD;
  float* v_s = k_s + kBK * S::QK_LD;
  float* p_s = v_s + kBK * S::V_LD;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int g = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // heavy blocks first

  const long long q_base = (long long)b * qs.b + (long long)h * qs.h;
  const long long k_base = (long long)b * ks.b + (long long)g * ks.h;
  const long long v_base = (long long)b * vs.b + (long long)g * vs.h;
  const long long o_base = (long long)b * os.b + (long long)h * os.h;

  stage<DP>(q_s, S::QK_LD, q, q_base, qs.s, q0, kBQ, n_q, d, scale);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) acc[i][cc] = 0.f;
  }

  // causal: the last key any row of this block may see is min(q0+63, T-1)
  const int k_end = causal ? min(n_k, min(q0 + kBQ, n_q)) : n_k;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();   // previous tile's k_s / v_s / p_s reads are done
    stage<DP>(k_s, S::QK_LD, k, k_base, ks.s, k0, kBK, n_k, d, 1.f);
    stage<DP>(v_s, S::V_LD, v, v_base, vs.s, k0, kBK, n_k, d, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 2
    for (int c = 0; c < DP; c += 4) {
      float4 a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(q_s + (4 * ty + i) * S::QK_LD + c);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        bk[jj] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * jj) * S::QK_LD + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float t = s[i][jj];
          t = __fmaf_rn(a[i].x, bk[jj].x, t);
          t = __fmaf_rn(a[i].y, bk[jj].y, t);
          t = __fmaf_rn(a[i].z, bk[jj].z, t);
          t = __fmaf_rn(a[i].w, bk[jj].w, t);
          s[i][jj] = t;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
      float row_max = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kpos = k0 + tx + 16 * jj;
        if (kpos >= n_k || (causal && kpos > qpos)) s[i][jj] = kNegInf;
        row_max = fmaxf(row_max, s[i][jj]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      float row_sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[i][jj] - m_new);
        row_sum += p;
        p_s[(tx + 16 * jj) * S::P_LD + 4 * ty + i] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) acc[i][cc] *= alpha;
    }
    __syncthreads();   // p_s complete

    const int k_rows = min(kBK, k_end - k0);
    for (int j = 0; j < k_rows; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(p_s + j * S::P_LD + 4 * ty);
      const float* vrow = v_s + j * S::V_LD + tx;
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const float vv = vrow[16 * cc];
        acc[0][cc] = __fmaf_rn(p.x, vv, acc[0][cc]);
        acc[1][cc] = __fmaf_rn(p.y, vv, acc[1][cc]);
        acc[2][cc] = __fmaf_rn(p.z, vv, acc[2][cc]);
        acc[3][cc] = __fmaf_rn(p.w, vv, acc[3][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= n_q) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = o + o_base + (long long)row * os.s;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) {
      const int c = tx + 16 * cc;
      if (c < d) from_f32(orow + c, acc[i][cc] * inv);
    }
  }
}

template <int DC, typename T>
int launch_dc(const void* q, const void* k, const void* v, void* o, int B,
              int T_, int S_, int H, int KV, int d, Strides qs, Strides ks,
              Strides vs, Strides os, float scale, int causal,
              cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<DC, T>;
  const size_t bytes = Smem<DC>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((long long)B * H), (unsigned)((T_ + kBQ - 1) / kBQ));
  kernel<<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H, KV, T_, S_, d, qs, ks,
      vs, os, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int T_, int S_, int H, int KV, int d, const long long* st,
           float scale, int causal, void* stream) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  cudaStream_t s = (cudaStream_t)stream;
  switch ((d + 15) / 16) {
#define FLASH_CASE(DC)                                                      \
  case DC:                                                                  \
    return launch_dc<DC, T>(q, k, v, o, B, T_, S_, H, KV, d, qs, ks, vs, os, \
                            scale, causal, s);
    FLASH_CASE(1) FLASH_CASE(2) FLASH_CASE(3) FLASH_CASE(4)
    FLASH_CASE(5) FLASH_CASE(6) FLASH_CASE(7) FLASH_CASE(8)
#undef FLASH_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 12 int64 element strides, (batch, sequence, head) for q, k, v, o.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int B, int T, int S,
                                   int H, int KV, int d,
                                   const long long* strides, float scale,
                                   int causal, void* stream) {
  return launch<float>(q, k, v, o, B, T, S, H, KV, d, strides, scale, causal,
                       stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int B, int T,
                                    int S, int H, int KV, int d,
                                    const long long* strides, float scale,
                                    int causal, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, T, S, H, KV, d, strides, scale,
                               causal, stream);
}
