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
// tiles past the causal frontier are never visited.  All element offsets
// are 64-bit: B*T*H*d passes 2^31 at prefill_32k.
//
// Bound on the H100: operations.  At minitron-8b's prefill shape (B=4,
// T=S=2048, H=32, KV=8, d=128, causal) one call is 137.5 GFLOP against
// 168 MB of q/k/v/o: 0.14 ms at the bf16 tensor-core peak, 0.05 ms of
// bytes.
//
// bf16 (the serving path): FlashAttention-2's online softmax on Hopper's
// warpgroup tensor-core products (wgmma).  One CTA of 3 warpgroups per
// (b*H + h, 192-row q block), the heaviest (last) causal q blocks first;
// each warpgroup owns 64 query rows, each of its warps 16.
//  * Shared memory: the q tile and a 3-slot ring of 64-key K and V tiles,
//    bf16, d padded with zeros to DP = 16*DC, in wgmma's no-swizzle core
//    matrix layout (8 consecutive threads fill one 128-byte core matrix).
//    Tile j+1 is fetched with 16-byte cp.async.cg copies while tile j is
//    computed; one barrier per tile.  A tensor whose rows are not 16-byte
//    aligned (d*2, a stride or the base pointer not a multiple of 16
//    bytes) is staged by the same code with element loads; rows >= T or S
//    and columns >= d are zeros.
//  * S = q k^T: wgmma m64n64k16, q and k from shared memory (both K-major),
//    bf16 x bf16 -> f32: the products are exact, the sums f32.  The
//    softmax takes the unscaled scores as 2^(scale*log2(e) * s), which is
//    exp(scale * s): row max and row sum over the 4 lanes that share a
//    fragment row (__shfl_xor_sync; the sum once, at the end), ex2.approx
//    (<= 2 ulp).  l sums the f32 probabilities, as the reference does.
//  * O += P v: wgmma m64n(DP)k16 with P from registers (the accumulator
//    fragment of S is the A fragment of P: no P tile in shared memory) and
//    v from shared memory, MN-major (its rows are keys).  P is split into
//    P_hi = bf16(P) and P_lo = bf16(P - P_hi), both multiplied by v (exact
//    in bf16), so P carries ~16 bits: bf16 P alone is off the plain
//    version by up to 2^-9 max|v| per output, tens of times the
//    one-bf16-ulp tolerance at T = 2048 (tests/test_torch_flash.py).  The
//    tensor cores then do 1.5x the algorithm's operations; the bound above
//    counts the algorithm's.
//  * Per warpgroup, the products of tile j overlap: O is scaled by
//    alpha_{j-1}, S_j and P_{j-1} v_{j-1} are issued, the softmax of S_j
//    runs while the tensor cores work on P_{j-1} v_{j-1}.  Tiles wholly
//    past a warpgroup's causal frontier are computed fully masked (they
//    leave m, l and O as they are); the masking itself runs only on tiles
//    that cross the frontier or S.
// Shared memory at d = 128: 144 KB (cudaFuncSetAttribute raises the
// dynamic limit before the launch); 168 registers a thread.
//
// float32 (checks, not the serving path): one CTA of 256 threads per
// (b*H + h, 64-row q block) on the f32 CUDA cores.  The q tile (pre-scaled
// by `scale`) and 64-row K and V tiles are staged in shared memory with d
// padded to DP = 16*DC columns of zeros.  Thread (ty, tx) of the 16x16
// grid owns score rows 4*ty..4*ty+3 and key columns tx + 16*jj, and
// output columns tx + 16*cc: each score is a d-long f32 dot with explicit
// __fmaf_rn, row max and row sum are reduced over the 16 lanes that share
// ty, the probabilities go through shared memory to the P.V product, exp
// is expf.  116 KB of shared memory at d = 128.
//
// The library's -fmad=false is kept: every fused multiply-add in this
// file is an explicit intrinsic or an mma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // keys per staged tile
constexpr int kThreads = 256;  // 16 x 16 thread grid
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void from_f32(float* dst, float x) { *dst = x; }

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


// ---- bf16: tensor cores ------------------------------------------------ //
namespace tc {

constexpr int kWarpgroups = 3;            // 64 query rows each
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kBQ = 64 * kWarpgroups;     // query rows per CTA
constexpr int kBK = 64;                   // keys per K/V tile
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

// Tiles in shared memory are in wgmma's no-swizzle layout: core matrices
// of 8 rows x 16 bytes, each 128 contiguous bytes; the core matrices of
// one 8-row group lie side by side along d, 128 bytes apart, and the
// 8-row groups DP*16 bytes apart.
template <int DC>
struct Smem {
  static constexpr int DP = 16 * DC;            // padded head dim
  static constexpr int kGroupBytes = DP * 16;   // one 8-row group
  static constexpr int kQ = kBQ * DP;           // elements of the q tile
  static constexpr int kKV = kBK * DP;          // of one K or V tile
  static constexpr int kStages = 3;             // the K/V ring
  static constexpr size_t kBytes = sizeof(bf16) * (kQ + 2 * kStages * kKV);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, bypassing L1; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// this thread's generic-proxy writes to shared memory become visible to
// the async proxy (wgmma's operand reads)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving uses of an accumulator across a wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// no-swizzle matrix descriptor: start address, leading-dimension byte
// offset (between core matrices along K), stride byte offset (between
// core matrices along M/N), all >> 4
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

// wgmma's f32 accumulator operands: WG_ACC<n> names the asm operands
// %0 .. %(8n-1) and WG_OUT<n> binds them to d[0 .. 8n), read and written.
#define WG_ACC1 "%0, %1, %2, %3, %4, %5, %6, %7"
#define WG_ACC2 WG_ACC1 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define WG_ACC3 WG_ACC2 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define WG_ACC4 WG_ACC3 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define WG_ACC5 WG_ACC4 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define WG_ACC6 WG_ACC5 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define WG_ACC7 WG_ACC6 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define WG_ACC8 WG_ACC7 ", %56, %57, %58, %59, %60, %61, %62, %63"
#define WG_F8(i)                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),               \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_OUT1 WG_F8(0)
#define WG_OUT2 WG_OUT1, WG_F8(8)
#define WG_OUT3 WG_OUT2, WG_F8(16)
#define WG_OUT4 WG_OUT3, WG_F8(24)
#define WG_OUT5 WG_OUT4, WG_F8(32)
#define WG_OUT6 WG_OUT5, WG_F8(40)
#define WG_OUT7 WG_OUT6, WG_F8(48)
#define WG_OUT8 WG_OUT7, WG_F8(56)

// s (64x64 f32 per warpgroup) (+)= q (64x16, K-major) . k^T (16x64, k
// K-major); scale_d = 0 overwrites s
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_ACC4 "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_OUT4
      : "l"(a), "l"(b), "r"(scale_d));
}

// o (64 x 16*DC f32 per warpgroup) += p (64x16 bf16, registers) . v (16 x
// 16*DC, MN-major: v's rows are keys, d contiguous).  Pv<DC> is wgmma
// m64n(16*DC)k16 with 8*DC accumulators, operands %(8*DC) .. %(8*DC+3)
// for p, %(8*DC+4) for v's descriptor and %(8*DC+5) for scale-d.
template <int DC>
struct Pv;

#define WG_PV(DC, N, A0, A1, A2, A3, B, SCALE_D)                              \
  template <>                                                               \
  struct Pv<DC> {                                                           \
    static __device__ __forceinline__ void mma(float (&d)[8 * DC],          \
                                               const uint32_t (&a)[4],      \
                                               uint64_t b) {                \
      asm volatile(                                                         \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %" #SCALE_D ", 0;\n"            \
          "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 "       \
          "{" WG_ACC##DC "}, {%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #B \
          ", p, 1, 1, 1;\n}\n"                                              \
          : WG_OUT##DC                                                      \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));    \
    }                                                                       \
  };
WG_PV(1, 16, 8, 9, 10, 11, 12, 13)
WG_PV(2, 32, 16, 17, 18, 19, 20, 21)
WG_PV(3, 48, 24, 25, 26, 27, 28, 29)
WG_PV(4, 64, 32, 33, 34, 35, 36, 37)
WG_PV(5, 80, 40, 41, 42, 43, 44, 45)
WG_PV(6, 96, 48, 49, 50, 51, 52, 53)
WG_PV(7, 112, 56, 57, 58, 59, 60, 61)
WG_PV(8, 128, 64, 65, 66, 67, 68, 69)
#undef WG_PV

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) -> bf16x2 hi = round(x) and lo = round(x - hi); x0 in the low half
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(__fsub_rn(x0, hf.x), __fsub_rn(x1, hf.y)));
}

// Stage rows [row0, row0 + ROWS) of one head of x into dst in the core
// matrix layout: 16-byte cp.async chunks where `vec` says the rows are
// 16-byte aligned, element loads otherwise and for a chunk that straddles
// d; rows >= n_rows and columns >= d are zeros.  Eight consecutive threads
// fill one core matrix (128 contiguous bytes: no bank conflicts) from
// eight rows.
template <int DC, int ROWS>
__device__ __forceinline__ void stage(bf16* dst, const bf16* __restrict__ x,
                                      long long base, long long row_stride,
                                      int row0, int n_rows, int d, bool vec) {
  constexpr int kChunks = 2 * DC;   // 16-byte chunks per padded row
  constexpr int kIters = (ROWS * kChunks + kThreads - 1) / kThreads;
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if ((ROWS * kChunks) % kThreads != 0 && e >= ROWS * kChunks) break;
    const int r = (e / (8 * kChunks)) * 8 + e % 8;
    const int c = ((e / 8) % kChunks) * 8;
    const int row = row0 + r;
    bf16* s = dst + (e / 8) * 64 + (e % 8) * 8;
    const bool in = row < n_rows;
    const bf16* src = x + base + (in ? (long long)row * row_stride + c : 0);
    if (vec && c + 8 <= d) {
      cp_async16(smem_u32(s), src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        s[j] = (in && c + j < d) ? src[j] : __float2bfloat16(0.f);
    }
  }
}

template <int DC>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o, int H, int KV,
               int n_q, int n_k, int d, Strides qs, Strides ks, Strides vs,
               Strides os, float scale, int causal, int vec) {
  using S = Smem<DC>;
  constexpr int kG = S::kGroupBytes;
  constexpr int kO = 8 * DC;   // o registers per thread: 64 x 16*DC / 128
  extern __shared__ float4 smem4[];
  bf16* q_s = reinterpret_cast<bf16*>(smem4);
  bf16* k_s = q_s + S::kQ;                  // kStages tiles
  bf16* v_s = k_s + S::kStages * S::kKV;    // kStages tiles

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int g = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // heavy blocks first
  const int qg0 = q0 + 64 * wg;                        // this warpgroup's rows

  const long long q_base = (long long)b * qs.b + (long long)h * qs.h;
  const long long k_base = (long long)b * ks.b + (long long)g * ks.h;
  const long long v_base = (long long)b * vs.b + (long long)g * vs.h;
  const long long o_base = (long long)b * os.b + (long long)h * os.h;
  const bool q_vec = vec & 1, k_vec = vec & 2, v_vec = vec & 4;

  // causal: the last key any row of this block may see is min(q0+kBQ-1, T-1)
  const int k_end = causal ? min(n_k, min(q0 + kBQ, n_q)) : n_k;
  const int n_tiles = (k_end + kBK - 1) / kBK;

  stage<DC, kBQ>(q_s, q, q_base, qs.s, q0, n_q, d, q_vec);
  if (n_tiles > 0) {
    stage<DC, kBK>(k_s, k, k_base, ks.s, 0, n_k, d, k_vec);
    stage<DC, kBK>(v_s, v, v_base, vs.s, 0, n_k, d, v_vec);
  }
  cp_async_commit();

  // fragment rows gq and gq + 8 of the warp's 16, columns 2*tq, 2*tq + 1
  const int gq = lane >> 2, tq = lane & 3;
  const int row_a = qg0 + 16 * warp + gq;   // and row_a + 8
  float acc[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) acc[i] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};

  // Software pipeline, per warpgroup: tile j scales O by alpha_{j-1},
  // issues S_j = q k_j^T, then O += P_{j-1} v_{j-1}, and runs the softmax
  // of S_j while the tensor cores work on P_{j-1} v_{j-1}.  P_{j-1} (ph,
  // pl) is overwritten only after that product has completed.
  uint32_t ph[4][4], pl[4][4];
  const float sl2 = __fmul_rn(scale, kLog2e);   // exp(scale x) = 2^(sl2 x)
  float alpha_p[2] = {0.f, 0.f};   // alpha of the pending P

  // O = alpha_p O, where no product is in flight (the wait is a no-op
  // at run time: it keeps ptxas from guarding acc inside a branch)
  auto rescale_o = [&]() {
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kO; ++i) acc[i] = __fmul_rn(acc[i], alpha_p[(i >> 1) & 1]);
  };
  auto issue_pv = [&](int jt) {   // O += P v_jt, not awaited
    const bf16* vt = v_s + (jt % S::kStages) * S::kKV;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t vd = make_desc(vt + kk * kG, kG, 128);
      Pv<DC>::mma(acc, ph[kk], vd);
      Pv<DC>::mma(acc, pl[kk], vd);
    }
    wgmma_commit();
  };

  // One tile.  Every product it issues has completed when it returns, and
  // the branches between its instances (masking or not, first tile or
  // not) enclose it whole: ptxas keeps the products asynchronous only
  // where no divergent path lies between a wgmma and its wait.
  auto step = [&](int j, auto edge_c, auto first_c) {
    constexpr bool kEdge = decltype(edge_c)::value;
    constexpr bool kFirst = decltype(first_c)::value;
    const int k0 = j * kBK;
    const bf16* kt = k_s + (j % S::kStages) * S::kKV;
    float s[32];
    if constexpr (!kFirst) rescale_o();
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < DC; ++kd)
      wgmma_qk(s, make_desc(q_s + 64 * wg * DC * 16 + 128 * kd, 128, kG),
               make_desc(kt + 128 * kd, 128, kG), kd > 0);
    wgmma_commit();
    if constexpr (kFirst) {
      wgmma_wait<0>();
    } else {
      issue_pv(j - 1);
      wgmma_wait<1>();   // S_j
    }
    fence_regs(s);

    // s[4*nt + e]: row row_a + 8*(e>>1), key k0 + 8*nt + 2*tq + (e&1),
    // unscaled: max and exp take it as 2^(sl2 s)
    if constexpr (kEdge) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * nt + 2 * tq + (e & 1);
          const int qpos = row_a + 8 * (e >> 1);
          float& x = s[4 * nt + e];
          x = ((kpos >= n_k) | (causal & (kpos > qpos))) ? kNegInf : x;
        }
    }

    float m_new[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      m_new[0] = fmaxf(m_new[0], fmaxf(s[4 * nt], s[4 * nt + 1]));
      m_new[1] = fmaxf(m_new[1], fmaxf(s[4 * nt + 2], s[4 * nt + 3]));
    }
    float neg_m[2], row_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_new[i] = fmaxf(m_new[i], __shfl_xor_sync(0xffffffffu, m_new[i], 1));
      m_new[i] = fmaxf(m_new[i], __shfl_xor_sync(0xffffffffu, m_new[i], 2));
      alpha_p[i] = ex2(__fmul_rn(__fsub_rn(m_r[i], m_new[i]), sl2));
      neg_m[i] = -__fmul_rn(m_new[i], sl2);
      m_r[i] = m_new[i];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = ex2(__fmaf_rn(s[i], sl2, neg_m[(i >> 1) & 1]));
      s[i] = p;
      row_sum[(i >> 1) & 1] = __fadd_rn(row_sum[(i >> 1) & 1], p);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_r[i] = __fmaf_rn(l_r[i], alpha_p[i], row_sum[i]);

    if constexpr (!kFirst) {   // P_{j-1} v_{j-1} has read ph, pl
      wgmma_wait<0>();
      fence_regs(acc);
    }
    // P as the A operand, 16 keys per step: S's n-tiles 2kk and 2kk+1
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      split2(s[8 * kk], s[8 * kk + 1], ph[kk][0], pl[kk][0]);
      split2(s[8 * kk + 2], s[8 * kk + 3], ph[kk][1], pl[kk][1]);
      split2(s[8 * kk + 4], s[8 * kk + 5], ph[kk][2], pl[kk][2]);
      split2(s[8 * kk + 6], s[8 * kk + 7], ph[kk][3], pl[kk][3]);
    }
  };

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBK;
    cp_async_wait_all();   // tile j (and, first, the q tile)
    fence_proxy_async();
    // Tile j is in shared memory for every thread, and every warpgroup
    // has finished tile j-1, whose products read tiles j-1 (k) and j-2
    // (v): the slot of tile j-2 takes tile j+1.
    __syncthreads();
    if (j + 1 < n_tiles) {
      const int nxt = (j + 1) % S::kStages;
      stage<DC, kBK>(k_s + nxt * S::kKV, k, k_base, ks.s, k0 + kBK, n_k, d,
                     k_vec);
      stage<DC, kBK>(v_s + nxt * S::kKV, v, v_base, vs.s, k0 + kBK, n_k, d,
                     v_vec);
      cp_async_commit();
    }
    // Tiles wholly past this warpgroup's causal frontier are computed and
    // fully masked: they leave m, l and O as they are.
    const bool edge = k0 + kBK > n_k || (causal && k0 + kBK - 1 > qg0);
    using T_ = std::true_type;
    using F_ = std::false_type;
    if (j == 0) {
      if (edge) step(j, T_{}, T_{}); else step(j, F_{}, T_{});
    } else {
      if (edge) step(j, T_{}, F_{}); else step(j, F_{}, F_{});
    }
  }
  if (n_tiles > 0) {
    rescale_o();
    issue_pv(n_tiles - 1);
    wgmma_wait<0>();
    fence_regs(acc);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l = __fadd_rn(l, __shfl_xor_sync(0xffffffffu, l, 1));
    l = __fadd_rn(l, __shfl_xor_sync(0xffffffffu, l, 2));
    const int row = row_a + 8 * i;
    if (row >= n_q) continue;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    bf16* orow = o + o_base + (long long)row * os.s;
#pragma unroll
    for (int nt = 0; nt < 2 * DC; ++nt) {
      const int c = 8 * nt + 2 * tq;
      if (c < d) orow[c] = __float2bfloat16(__fmul_rn(acc[4 * nt + 2 * i], inv));
      if (c + 1 < d)
        orow[c + 1] = __float2bfloat16(__fmul_rn(acc[4 * nt + 2 * i + 1], inv));
    }
  }
}

// Whether every row a kernel reads of x starts on 16 bytes: base pointer
// and the strides of every extent > 1 (elements of 2 bytes).
bool rows_16b(const void* x, const Strides& st, int nb, int ns, int nh) {
  return (uintptr_t)x % 16 == 0 && (nb == 1 || st.b % 8 == 0) &&
         (ns == 1 || st.s % 8 == 0) && (nh == 1 || st.h % 8 == 0);
}

template <int DC>
int launch_dc(const void* q, const void* k, const void* v, void* o, int B,
              int T_, int S_, int H, int KV, int d, Strides qs, Strides ks,
              Strides vs, Strides os, float scale, int causal,
              cudaStream_t stream) {
  auto kernel = flash_fwd_bf16<DC>;
  const size_t bytes = Smem<DC>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int vec = (rows_16b(q, qs, B, T_, H) ? 1 : 0) |
                  (rows_16b(k, ks, B, S_, KV) ? 2 : 0) |
                  (rows_16b(v, vs, B, S_, KV) ? 4 : 0);
  dim3 grid((unsigned)((long long)B * H), (unsigned)((T_ + kBQ - 1) / kBQ));
  kernel<<<grid, kThreads, bytes, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, H, KV, T_,
      S_, d, qs, ks, vs, os, scale, causal, vec);
  return (int)cudaGetLastError();
}

// The bf16 kernel's attributes as the runtime holds them: out[0] registers
// a thread, out[1] the dynamic shared memory its launches set, out[2]
// local memory a thread (spills), out[3] static shared memory.
template <int DC>
int attributes(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, flash_fwd_bf16<DC>);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = a.maxDynamicSharedSizeBytes;
  out[2] = (int)a.localSizeBytes;
  out[3] = (int)a.sharedSizeBytes;
  return 0;
}

}  // namespace tc

// ---- host side ----------------------------------------------------------- //
template <int DC>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int T_, int S_, int H, int KV, int d, Strides qs, Strides ks,
               Strides vs, Strides os, float scale, int causal,
               cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<DC, float>;
  const size_t bytes = Smem<DC>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((long long)B * H), (unsigned)((T_ + kBQ - 1) / kBQ));
  kernel<<<grid, kThreads, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, H, KV, T_,
      S_, d, qs, ks, vs, os, scale, causal);
  return (int)cudaGetLastError();
}

template <bool kBf16>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int T_, int S_, int H, int KV, int d, const long long* st,
           float scale, int causal, void* stream) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  cudaStream_t s = (cudaStream_t)stream;
  switch ((d + 15) / 16) {
#define FLASH_CASE(DC)                                                        \
  case DC:                                                                    \
    return kBf16 ? tc::launch_dc<DC>(q, k, v, o, B, T_, S_, H, KV, d, qs, ks, \
                                     vs, os, scale, causal, s)                \
                 : launch_f32<DC>(q, k, v, o, B, T_, S_, H, KV, d, qs, ks,    \
                                  vs, os, scale, causal, s);
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
  return launch<false>(q, k, v, o, B, T, S, H, KV, d, strides, scale, causal,
                       stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int B, int T,
                                    int S, int H, int KV, int d,
                                    const long long* strides, float scale,
                                    int causal, void* stream) {
  return launch<true>(q, k, v, o, B, T, S, H, KV, d, strides, scale, causal,
                      stream);
}

// tc::attributes of the bf16 kernel for head dim d (after a launch at that
// d, out[1] is the shared memory the launch asked for).
extern "C" int flash_attention_bf16_attributes(int d, int* out) {
  switch ((d + 15) / 16) {
#define FLASH_CASE(DC) \
  case DC:             \
    return tc::attributes<DC>(out);
    FLASH_CASE(1) FLASH_CASE(2) FLASH_CASE(3) FLASH_CASE(4)
    FLASH_CASE(5) FLASH_CASE(6) FLASH_CASE(7) FLASH_CASE(8)
#undef FLASH_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
