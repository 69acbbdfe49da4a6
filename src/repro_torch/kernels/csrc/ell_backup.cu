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
//     (explicit _rn intrinsics, and the build passes -fmad=false);
//   * the argmin is a running strict-< minimum over a = 0 .. m-1 in order,
//     so the first minimum wins, a NaN Q(s, 0) stays the minimum and a
//     later NaN is passed over, exactly as ref.rowmin_argmin.
// Acc is float when v is float32, double when v is float64 (val and cost
// are widened exactly); gamma arrives already rounded to Acc, one value
// a lane.
//
// What bounds it on the H100, at n = 10^6, m = 16, K = 8:
//   * the table stream from HBM: n*m*K*8 bytes (idx + val) + n*m*4 (cost)
//     plus v and the two outputs, about 1.10 GB, 0.33 ms at 3.35 TB/s
//     (about 0.3 GFLOP is far below any compute bound);
//   * the random gather of v from L2: v stays L2-resident, but each of the
//     n*m*K = 128 M gathers moves a 32-byte sector from L2 to an SM, about
//     4.1 GB, some 4x the stream's bytes.  This is the larger of the two.
//
// Design, for those two:
//   * coalesced table loads: each (s, a) row's K slots are spread over g
//     lanes, VEC consecutive slots a lane, so a warp reads 32 * VEC * 4
//     contiguous bytes of idx and of val.  VEC = 4 (one int4 / float4 a
//     lane) where K % 4 == 0 and both tables are 16-byte aligned, else
//     VEC = 1 (the launcher picks from the pointers and K).  At m = 16,
//     K = 8, VEC = 4: 2 lanes a row, one state a warp.  On the 4-byte path
//     a row of K <= 4 slots takes one lane, which walks it (maze2d, sis,
//     chain_walk): neighbours read 8-16 bytes apart and find the rest of a
//     line in L1;
//   * the table and cost are read evict-first in L2 (streamed once: __ldcs
//     on the 16-byte path and for cost, an evict_first policy with
//     L1::evict_last on the 4-byte path), the gathers with an L2
//     evict_last policy (createpolicy), so the 1.1 GB stream does not
//     push v out of L2.  No access-policy window is set;
//   * every lane issues its VEC gathers before it needs any of them, and
//     the block holds 8 warps, so many independent gathers are in flight;
//   * the K-sum keeps its order: the row's leader lane adds its own
//     products, then each other lane's, in slot order, by shuffles.  Q
//     (s, a) is formed at the leader; the state's first leader then takes
//     the Q of each action in order, by shuffles, for the strict-< scan.
//     A warp holds whole states (32 / (g*m) of them) when they fit, else
//     one state in passes of 32 / g actions; rows longer than 32 * VEC
//     slots take several 32-lane chunks, in order.
//   * one tile a warp, no shared memory: at 39-40 registers 48 warps fit
//     on an SM.
// On the H100 the gather sets the time, not the stream: the same kernel on
// local idx (chip_smoke phase 2) takes about half as long, and its time
// does not move with the L1 policy of the gathers (.nc, .cg,
// .L1::no_allocate) nor without their L2 hint.  A register prefetch of the
// next tile and a per-warp cp.async ring of 4 tiles were tried and were
// slower: more registers or shared memory, fewer warps (PERF.md).  One
// lane a whole state (the earlier design) is faster on short states with
// local idx (maze2d) but slower on random ones, and a shape rule cannot
// see locality, so no state takes one lane.
// All row and slot offsets are 64-bit (n*m*K passes 2^31 at
// n = 1.7*10^7, m = 16, K = 8).
//
// Fleets: one launch covers B lanes (lanes.cuh), each with its own val,
// cost, outputs and gamma, and its own or a shared idx and v.  Each lane
// runs the body above on its tables; an unbatched call is B = 1.

#include "ell_common.cuh"

namespace {

// Lane layout: g lanes a row, VEC slots a lane, `chunks` passes of g * VEC
// slots over a row.  A warp takes `states` states and their actions
// `apass` at a time, in `passes` passes: `rows` = states * apass rows a
// pass, at most 32 / g.
struct Plan {
  int32_t g, chunks, states, apass, passes, rows;
};

template <typename Acc, int VEC>
__global__ void __launch_bounds__(THREADS)
ell_backup_kernel(const int32_t* __restrict__ idx,
                  const float* __restrict__ val,
                  const float* __restrict__ cost, const Acc* __restrict__ v,
                  const Acc* __restrict__ gammas, int64_t n, int32_t m,
                  int32_t k, Plan p, Lanes l, int64_t blocks,
                  Acc* __restrict__ out_v, int32_t* __restrict__ out_pi) {
  int32_t fleet_lane;
  int64_t block;
  lane_block(l, blocks, fleet_lane, block);
  idx += fleet_lane * l.idx;
  val += fleet_lane * l.val;
  cost += fleet_lane * l.cost;
  v += fleet_lane * l.vec;
  out_v += fleet_lane * l.out;
  out_pi += fleet_lane * l.out;
  const Acc gamma = gammas[fleet_lane * l.gamma];
  const int lane = threadIdx.x % WARP;
  const int64_t tile = (block * THREADS + threadIdx.x) / WARP;
  const int r = lane / p.g;           // this lane's row within a pass
  const int g = lane - r * p.g;       // its place within the row
  const int lead = lane - g;          // the row's leader lane
  const int rs = r / p.apass;         // its state within the warp's states
  const int ra = r - rs * p.apass;    // its action within a pass
  const int first = rs * p.apass * p.g;   // the state's first leader lane
  const int64_t s = tile * p.states + rs;
  const bool state_ok = r < p.rows && s < n;
  const uint64_t pol = evict_last_policy();
  Acc best = 0;
  int32_t arg = 0;
  for (int32_t pass = 0; pass < p.passes; ++pass) {
    const int32_t a = pass * p.apass + ra;
    const bool ok = state_ok && a < m;
    const int64_t row = s * m + a;
    const int64_t base = row * k;
    Acc acc = 0;
    for (int32_t c = 0; c < p.chunks; ++c) {
      const int32_t chunk0 = c * p.g * VEC;   // first slot of this chunk
      Acc prod[VEC];
      products<Acc, VEC>(idx, val, v, base, chunk0 + g * VEC,
                         ok && chunk0 + g * VEC < k, pol, prod);
      acc = row_sum<Acc, VEC>(acc, prod, p.g, g, lead, chunk0, k);
    }
    Acc q = 0;
    if (g == 0 && ok)
      q = add_rn((Acc)__ldcs(cost + row), mul_rn(gamma, acc));
    // running strict-< minimum over this pass's actions, in order, at the
    // state's first leader
    for (int32_t j = 0; j < p.apass; ++j) {
      const Acc qj = __shfl_sync(FULL, q, first + j * p.g);
      const int32_t aj = pass * p.apass + j;
      if (lane == first && state_ok && aj < m && (aj == 0 || qj < best)) {
        best = qj;
        arg = aj;
      }
    }
  }
  if (lane == first && state_ok) {
    out_v[s] = best;
    out_pi[s] = arg;
  }
}

template <typename Acc, int VEC>
int launch_vec(const int32_t* idx, const float* val, const float* cost,
               const Acc* v, const Acc* gamma, long long n, int m, int k,
               const Lanes& l, Acc* out_v, int32_t* out_pi,
               cudaStream_t stream) {
  Plan p;
  row_lanes(k, VEC, p.g, p.chunks);
  const int rows = WARP / p.g;
  p.states = m <= rows ? rows / m : 1;
  p.apass = m <= rows ? m : rows;
  p.passes = (m + p.apass - 1) / p.apass;
  p.rows = p.states * p.apass;
  const long long warps = (n + p.states - 1) / p.states;
  const long long blocks = (warps + THREADS / WARP - 1) / (THREADS / WARP);
  const unsigned int grid = lane_grid(l, blocks);
  if (grid == 0) return (int)cudaErrorInvalidConfiguration;
  ell_backup_kernel<Acc, VEC><<<grid, THREADS, 0, stream>>>(
      idx, val, cost, v, gamma, (int64_t)n, m, k, p, l, (int64_t)blocks,
      out_v, out_pi);
  return (int)cudaGetLastError();
}

template <typename Acc>
int launch(const void* idx, const void* val, const void* cost, const void* v,
           const void* gamma, long long n, int m, int k, const Lanes& l,
           void* out_v, void* out_pi, void* stream) {
  if (n < 0 || m < 1 || k < 0 || l.count < 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const auto* i = (const int32_t*)idx;
  const auto* w = (const float*)val;
  const auto* c = (const float*)cost;
  const auto* g = (const Acc*)gamma;
  const auto s = (cudaStream_t)stream;
  return vector_width(idx, val, k) == 4
             ? launch_vec<Acc, 4>(i, w, c, (const Acc*)v, g, n, m, k, l,
                                  (Acc*)out_v, (int32_t*)out_pi, s)
             : launch_vec<Acc, 1>(i, w, c, (const Acc*)v, g, n, m, k, l,
                                  (Acc*)out_v, (int32_t*)out_pi, s);
}

}  // namespace

// B lanes in one launch: `strides` holds the per-lane element strides of
// idx (0: shared), val, cost, v (0: shared), the outputs and gamma (0:
// one gamma for every lane), in that order; gamma points to Acc values
// already rounded to Acc.
extern "C" int ell_backup_f32(const void* idx, const void* val,
                              const void* cost, const void* v,
                              const void* gamma, long long n, int m, int k,
                              int lanes, int lane_fastest,
                              const long long* strides, void* out_v,
                              void* out_pi, void* stream) {
  const Lanes l{lanes, lane_fastest, strides[0], strides[1], strides[2],
                strides[3], strides[4], strides[5]};
  return launch<float>(idx, val, cost, v, gamma, n, m, k, l, out_v, out_pi,
                       stream);
}

extern "C" int ell_backup_f64(const void* idx, const void* val,
                              const void* cost, const void* v,
                              const void* gamma, long long n, int m, int k,
                              int lanes, int lane_fastest,
                              const long long* strides, void* out_v,
                              void* out_pi, void* stream) {
  const Lanes l{lanes, lane_fastest, strides[0], strides[1], strides[2],
                strides[3], strides[4], strides[5]};
  return launch<double>(idx, val, cost, v, gamma, n, m, k, l, out_v, out_pi,
                        stream);
}
