// The fleet lane axis shared by the three MDP kernels (ell_backup.cu,
// ell_spmv.cu, dense_backup.cu).
//
// A launch covers `count` lanes (B fleet instances; 1 for an unbatched
// call).  Lane b reads every operand at its base plus b times that
// operand's lane stride, in elements: 0 for an operand all lanes share (a
// shared-topology idx, a shared v or x, one gamma for the fleet).  The
// per-lane body is the unbatched kernel's, unchanged, so the unbatched
// call is the B = 1 case of the same kernel and both give the same bits.
//
// Grid order: the launch is one flat grid of `count` x `blocks` CTAs.
// With `lane_fastest` set, CTA id = block * count + lane, so the B CTAs
// that read one tile of a shared idx run side by side and the tile is
// served from L2 after the first; otherwise id = lane * blocks + block
// and each lane streams its tiles in turn.  The ELL kernels take either
// (kernels/lanes.py::LANE_ORDER picks the second): on the H100 they are
// bound by the gather of v, and lanes side by side keep every lane's v
// live in L2 at once; at B = 4, n = 10^6 in float64 lane-fastest took
// 24-29% longer, with or without a shared idx (PERF.md).  The dense
// kernel, whose lanes share no table, always takes the second.

#pragma once

#include <stdint.h>

namespace {

struct Lanes {
  int32_t count;         // B
  int32_t lane_fastest;  // grid order (above)
  // per-lane element strides: the table operands, the vector operand,
  // the outputs and gamma
  int64_t idx, val, cost, vec, out, gamma;
};

// This CTA's lane and its block within the lane.
__device__ __forceinline__ void lane_block(const Lanes& l, int64_t blocks,
                                           int32_t& lane, int64_t& block) {
  const int64_t id = blockIdx.x;
  if (l.lane_fastest) {
    lane = (int32_t)(id % l.count);
    block = id / l.count;
  } else {
    lane = (int32_t)(id / blocks);
    block = id - (int64_t)lane * blocks;
  }
}

// The flat grid size for `blocks` CTAs a lane, or 0 where it does not fit
// one launch (gridDim.x < 2^31).
__host__ __forceinline__ unsigned int lane_grid(const Lanes& l,
                                                long long blocks) {
  if (l.count < 1 || blocks < 0) return 0;
  const long long total = blocks * (long long)l.count;
  return total > 0x7fffffffLL || total / l.count != blocks
             ? 0u : (unsigned int)total;
}

}  // namespace
