// Fused dense Bellman backup for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/dense_backup.py::dense_backup
// (body _dense_kernel):  for every state row s,
//
//   Q(s, a) = cost[s, a] + gamma * sum_c p[s, a, c] * v[c]
//   out_v[s] = min_a Q(s, a),  out_pi[s] = argmin_a Q(s, a)  (first min wins)
//
// As in the TPU kernel, min/argmin are fused after the contraction and the
// Q table never reaches device memory.  Unlike it, the sum is not carried
// in float32 whatever the inputs (a TPU artifact): Acc is float when v is
// float32 and double when v is float64; p and cost are widened exactly.
//
// Rounding contract (bit-equal to repro_torch.kernels.ref.dense_backup):
//   * lane l of the warp sums the columns c = l (mod 32) in increasing
//     order from a +0 accumulator, each product p * v rounded on its own
//     (__fmul_rn, then __fadd_rn);
//   * a fixed halving tree then adds lane l + w into lane l for
//     w = 16, 8, 4, 2, 1 (__shfl_down_sync), leaving the sum in lane 0;
//   * gamma * pv is rounded before + cost; no FMA contraction anywhere
//     (explicit _rn intrinsics, and the build passes -fmad=false).
// gamma arrives already rounded to Acc, one value a lane.
//
// Bound on the H100: bytes.  One backup reads p once, n*m*n_cols*4 bytes:
// 17.2 GB at n = n_cols = 16384, m = 16, 5.1 ms at 3.35 TB/s, against
// 2*n*m*n_cols = 8.6 GFLOP (0.13 ms in float32, 0.25 ms in float64 at the
// non-tensor-core peaks).
//
// Design (simple and right first): one warp per state row walks its actions
// in order, keeping a running strict-< minimum in lane 0.  Within a row the
// warp's 32 lanes read 32 neighbouring columns, so each load of p is one
// 128-byte line; eight are issued before their products are summed, to keep
// enough bytes in flight.  p is read with streaming loads (__ldcs, evict
// first) so that v (64 KB in float32, 128 KB in float64), which every warp
// reads m times, stays in L1/L2.  All row offsets are 64-bit: s*m*n_cols
// passes 2^31 at n = 16384, m = 16.  Staging v in shared memory, TMA and a
// split of the columns across warps are later work.
//
// Fleets: one launch covers B lanes (lanes.cuh), each with its own p,
// cost, outputs and gamma and its own or a shared v; an unbatched call is
// B = 1.  The lanes run one after another (lane-slowest): each lane's
// rows stream their own p, so no order shares a read.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lanes.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kUnroll = 8;
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename Acc>
__global__ void dense_backup_kernel(const float* __restrict__ p,
                                    const float* __restrict__ cost,
                                    const Acc* __restrict__ v,
                                    const Acc* __restrict__ gammas,
                                    int64_t n, int32_t m, int64_t n_cols,
                                    Lanes l, int64_t blocks,
                                    Acc* __restrict__ out_v,
                                    int32_t* __restrict__ out_pi) {
  int32_t fleet_lane;
  int64_t block;
  lane_block(l, blocks, fleet_lane, block);
  p += fleet_lane * l.val;
  cost += fleet_lane * l.cost;
  v += fleet_lane * l.vec;
  out_v += fleet_lane * l.out;
  out_pi += fleet_lane * l.out;
  const Acc gamma = gammas[fleet_lane * l.gamma];
  const int lane = threadIdx.x % kWarp;
  const int64_t row = block * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= n) return;  // whole warps leave together
  const int64_t span = (int64_t)kWarp * kUnroll;
  const int64_t main_end = n_cols - n_cols % span;
  Acc best = 0;
  int32_t arg = 0;
  for (int32_t a = 0; a < m; ++a) {
    const float* prow = p + (row * m + a) * n_cols;
    Acc acc = 0;
    int64_t c0 = 0;
    for (; c0 < main_end; c0 += span) {
      float pv[kUnroll];
      Acc vv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t c = c0 + (int64_t)u * kWarp + lane;
        pv[u] = __ldcs(prow + c);
        vv[u] = __ldg(v + c);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc = add_rn(acc, mul_rn((Acc)pv[u], vv[u]));
    }
    for (int64_t c = c0 + lane; c < n_cols; c += kWarp)
      acc = add_rn(acc, mul_rn((Acc)__ldcs(prow + c), __ldg(v + c)));
#pragma unroll
    for (int w = kWarp / 2; w > 0; w /= 2)
      acc = add_rn(acc, __shfl_down_sync(0xffffffffu, acc, w));
    if (lane == 0) {
      const Acc q = add_rn((Acc)cost[row * m + a], mul_rn(gamma, acc));
      if (a == 0 || q < best) {
        best = q;
        arg = a;
      }
    }
  }
  if (lane == 0) {
    out_v[row] = best;
    out_pi[row] = arg;
  }
}

template <typename Acc>
int launch(const void* p, const void* cost, const void* v, const void* gamma,
           long long n, int m, long long n_cols, const Lanes& l, void* out_v,
           void* out_pi, void* stream) {
  if (n < 0 || m < 1 || n_cols < 1 || l.count < 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const long long blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const unsigned int grid = lane_grid(l, blocks);
  if (grid == 0) return (int)cudaErrorInvalidConfiguration;
  dense_backup_kernel<Acc><<<grid, kWarpsPerBlock * kWarp, 0,
                             (cudaStream_t)stream>>>(
      (const float*)p, (const float*)cost, (const Acc*)v,
      (const Acc*)gamma, (int64_t)n, m, (int64_t)n_cols, l, (int64_t)blocks,
      (Acc*)out_v, (int32_t*)out_pi);
  return (int)cudaGetLastError();
}

}  // namespace

// B lanes in one launch: `strides` holds the per-lane element strides of
// p, cost, v (0: shared), the outputs and gamma (0: one gamma for every
// lane), in that order; gamma points to Acc values already rounded to Acc.
extern "C" int dense_backup_f32(const void* p, const void* cost,
                                const void* v, const void* gamma,
                                long long n, int m, long long n_cols,
                                int lanes, const long long* strides,
                                void* out_v, void* out_pi, void* stream) {
  const Lanes l{lanes, 0, 0, strides[0], strides[1], strides[2], strides[3],
                strides[4]};
  return launch<float>(p, cost, v, gamma, n, m, n_cols, l, out_v, out_pi,
                       stream);
}

extern "C" int dense_backup_f64(const void* p, const void* cost,
                                const void* v, const void* gamma,
                                long long n, int m, long long n_cols,
                                int lanes, const long long* strides,
                                void* out_v, void* out_pi, void* stream) {
  const Lanes l{lanes, 0, 0, strides[0], strides[1], strides[2], strides[3],
                strides[4]};
  return launch<double>(p, cost, v, gamma, n, m, n_cols, l, out_v, out_pi,
                        stream);
}
