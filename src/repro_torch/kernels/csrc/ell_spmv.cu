// Policy-restricted ELL SpMV for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/spmv_ell.py::ell_matvec
// (body _spmv_kernel):  y[i] = sum_k val[i, k] * x[idx[i, k]]  over the
// (n, K) rows of P_pi.  It runs once per inner iteration of every KSP; the
// A_pi x = x - gamma * y epilogue stays outside, in torch.  Run over the
// (n*m, K) rows of the whole table it is also the product of ell_qvalues.
//
// The TPU kernel streams x through VMEM windows; here x stays in HBM and
// is gathered directly (L2-resident at n = 10^6).
//
// Rounding contract (bit-equal to repro_torch.kernels.ref.ell_matvec):
// each product rounded on its own (__fmul_rn), K-sum in order k = 0..K-1
// from a +0 accumulator (__fadd_rn), built with -fmad=false.  Acc is float
// for a float32 x, double for a float64 x (val widened exactly).
//
// What bounds it on the H100, at n = 10^6, K = 8, f64:
//   * the table stream from HBM: n*K*8 bytes of idx + val, plus x and y,
//     about 76 MB, 0.023 ms at 3.35 TB/s (16 MFLOP is far below any
//     compute bound);
//   * the random gather of x from L2: x (8 MB) stays L2-resident, but each
//     of the n*K = 8 M gathers moves a 32-byte sector from L2 to an SM,
//     about 256 MB, more than the stream's bytes.
//
// Design, for those two:
//   * coalesced table loads: a row's K slots are spread over g lanes, VEC
//     consecutive slots a lane, so a warp reads 32 * VEC * 4 contiguous
//     bytes of idx and of val.  VEC = 4 (one int4 / float4 a lane) where
//     K % 4 == 0 and both tables are 16-byte aligned, else VEC = 1 (the
//     launcher picks from the pointers and K).  At K = 8, VEC = 4: 2 lanes
//     a row, 16 rows a warp.  On the 4-byte path a row of K <= 4 slots
//     takes one lane, which walks it: neighbours read 8-16 bytes apart and
//     find the rest of a line in L1;
//   * the table is read evict-first in L2 (streamed once: __ldcs on the
//     16-byte path, an evict_first policy with L1::evict_last on the
//     4-byte path), the gathers with an L2 evict_last policy
//     (createpolicy), so the stream does not push x out of L2.  No
//     access-policy window is set;
//   * every lane issues its VEC gathers before it needs any of them, and
//     the block holds 4, 8 or 16 warps (the launch's `threads`, 8 by
//     default), so many independent gathers are in flight;
//   * the sum keeps its order: the row's leader lane (the one holding slots
//     0 .. VEC-1) adds its own products, then each other lane's, in slot
//     order, by shuffles.  Rows longer than 32 * VEC slots take several
//     32-lane chunks, in order.
//   * one tile a warp, no shared memory: at 31-32 registers 64 warps fit
//     on an SM.
// On the H100 the gather sets the time: with local idx (chip_smoke phase
// 2) the kernel runs near its byte bound, with random idx it takes more
// than twice as long, whatever the L1 policy of the gathers (PERF.md).
// Row and slot offsets are 64-bit (n*K may pass 2^31).
//
// Fleets: one launch covers B lanes (lanes.cuh), each with its own val
// and y and its own or a shared idx and x; an unbatched call is B = 1.

#include "ell_common.cuh"

namespace {

// Lane layout: g lanes a row, VEC slots a lane, `chunks` passes of g * VEC
// slots over a row, `rows` rows a warp (32 / g, rounded down).
struct Plan {
  int32_t g, chunks, rows;
};

template <typename Acc, int VEC, int THREADS>
__global__ void __launch_bounds__(THREADS)
ell_spmv_kernel(const int32_t* __restrict__ idx,
                const float* __restrict__ val, const Acc* __restrict__ x,
                int64_t n, int32_t k, Plan p, Lanes l, int64_t blocks,
                Acc* __restrict__ y) {
  int32_t fleet_lane;
  int64_t block;
  lane_block(l, blocks, fleet_lane, block);
  idx += fleet_lane * l.idx;
  val += fleet_lane * l.val;
  x += fleet_lane * l.vec;
  y += fleet_lane * l.out;
  const int lane = threadIdx.x % WARP;
  const int64_t warp = (block * THREADS + threadIdx.x) / WARP;
  const int r = lane / p.g;           // this lane's row within the warp
  const int g = lane - r * p.g;       // its place within the row
  const int lead = lane - g;          // the row's leader lane
  const int64_t row = warp * p.rows + r;
  const bool ok = r < p.rows && row < n;
  const int64_t base = row * k;
  const uint64_t pol = evict_last_policy();
  Acc acc = 0;
  for (int32_t c = 0; c < p.chunks; ++c) {
    const int32_t chunk0 = c * p.g * VEC;   // first slot of this chunk
    Acc prod[VEC];
    products<Acc, VEC>(idx, val, x, base, chunk0 + g * VEC,
                       ok && chunk0 + g * VEC < k, pol, prod);
    acc = row_sum<Acc, VEC>(acc, prod, p.g, g, lead, chunk0, k);
  }
  if (g == 0 && ok) y[row] = acc;
}

template <typename Acc, int VEC, int THREADS>
int launch_cta(const int32_t* idx, const float* val, const Acc* x,
               long long n, int k, const Lanes& l, Acc* y,
               cudaStream_t stream) {
  Plan p;
  row_lanes(k, VEC, p.g, p.chunks);
  p.rows = WARP / p.g;
  const long long warps = (n + p.rows - 1) / p.rows;
  const long long blocks = (warps + THREADS / WARP - 1) / (THREADS / WARP);
  const unsigned int grid = lane_grid(l, blocks);
  if (grid == 0) return (int)cudaErrorInvalidConfiguration;
  ell_spmv_kernel<Acc, VEC, THREADS><<<grid, THREADS, 0, stream>>>(
      idx, val, x, (int64_t)n, k, p, l, (int64_t)blocks, y);
  return (int)cudaGetLastError();
}

template <typename Acc, int VEC>
int launch_vec(const int32_t* idx, const float* val, const Acc* x,
               long long n, int k, const Lanes& l, int threads, Acc* y,
               cudaStream_t stream) {
  switch (threads) {
    case CTA_SMALL:
      return launch_cta<Acc, VEC, CTA_SMALL>(idx, val, x, n, k, l, y, stream);
    case CTA_DEFAULT:
      return launch_cta<Acc, VEC, CTA_DEFAULT>(idx, val, x, n, k, l, y,
                                               stream);
    case CTA_LARGE:
      return launch_cta<Acc, VEC, CTA_LARGE>(idx, val, x, n, k, l, y, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename Acc>
int launch(const void* idx, const void* val, const void* x, long long n,
           int k, const Lanes& l, int threads, void* y, void* stream) {
  if (n < 0 || k < 0 || l.count < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const auto* i = (const int32_t*)idx;
  const auto* w = (const float*)val;
  const auto s = (cudaStream_t)stream;
  return vector_width(idx, val, k) == 4
             ? launch_vec<Acc, 4>(i, w, (const Acc*)x, n, k, l, threads,
                                  (Acc*)y, s)
             : launch_vec<Acc, 1>(i, w, (const Acc*)x, n, k, l, threads,
                                  (Acc*)y, s);
}

}  // namespace

// B lanes in one launch: `strides` holds the per-lane element strides of
// idx (0: shared), val, x (0: shared) and y, in that order.  `threads` is
// the CTA size (128, 256 or 512).
extern "C" int ell_spmv_f32(const void* idx, const void* val, const void* x,
                            long long n, int k, int lanes, int lane_fastest,
                            int threads, const long long* strides, void* y,
                            void* stream) {
  const Lanes l{lanes, lane_fastest, strides[0], strides[1], 0, strides[2],
                strides[3], 0};
  return launch<float>(idx, val, x, n, k, l, threads, y, stream);
}

extern "C" int ell_spmv_f64(const void* idx, const void* val, const void* x,
                            long long n, int k, int lanes, int lane_fastest,
                            int threads, const long long* strides, void* y,
                            void* stream) {
  const Lanes l{lanes, lane_fastest, strides[0], strides[1], 0, strides[2],
                strides[3], 0};
  return launch<double>(idx, val, x, n, k, l, threads, y, stream);
}
