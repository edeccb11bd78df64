// The exclusive scan of B block aggregates that seeds the blocks' start
// states (K2 phase2_starts, K5 phase2_jvp_starts, K9 affine_phase2_starts),
// written once as a schedule over an element policy.
//
// A scan's time is the depth of its chain of dependent combines, not its
// bytes (at B = 2048 it reads some 0.3 MB). So each lane of one cluster of
// NB thread blocks of W warps holds F aggregates (F = 1: one, every row read
// one coalesced 32-lane access) and the scan is an inclusive Kogge-Stone at
// three levels, each in log2 steps: across the 32 lanes of a warp, across
// the W warp totals of a thread block (through its shared memory) and across
// the NB thread-block totals of the cluster (through distributed shared
// memory). At NB = W = 8, F = 1 a round covers 2048 aggregates: F - 1 folds,
// 5 + 3 + 3 dependent combines and 3 state-only applies.
//
// The policy P says what an element is and how it moves:
//   Scalar, Element, State              types; kRows rows of Scalar an element
//   identity()                          the neutral element
//   combine(ei, ej)                     ei first, then ej (not commutative)
//   shfl_up(e, delta)                   lane i gets lane i - delta's element
//   load(base, stride), store(e, ...)   rows `stride` apart (shared memory)
//   load_agg(b)                         aggregate b, from device memory
//   prior_state()                       the state the scan starts from
//   apply(s, e)                         the state part of s ∘ e, in place
//   store_start(s, b)                   block b's start state
#pragma once

#include <cooperative_groups.h>

#include "lanes.cuh"

namespace tgps {

constexpr int kScanLanes = 32;

// Inclusive Kogge-Stone scan of the elements of the first n lanes of a warp
// (n a power of two, at most 32) in register shuffles: lane i ends with
// e_0 ∘ ... ∘ e_i, the earlier operand on the left at every level. Every
// lane takes part.
template <class P>
__device__ __forceinline__ typename P::Element warp_scan(const P& p, typename P::Element e,
                                                         int lane, int n) {
#pragma unroll 1
  for (int d = 1; d < n; d *= 2) {
    const typename P::Element left = p.shfl_up(e, d);
    if (lane >= d) e = p.combine(left, e);
  }
  return e;
}

// The same scan with the left operand read from shared memory instead of
// shuffled: lane i < n keeps its element at slots + i (rows `stride` apart)
// and reads lane i - d's from there as it combines, so the left element need
// not be held whole in registers beside its own. Lane i's inclusive prefix
// is left in its slot. Every lane of the warp takes part.
template <class P>
__device__ __forceinline__ typename P::Element warp_scan_shared(const P& p,
                                                                typename P::Element e, int lane,
                                                                int n, typename P::Scalar* slots,
                                                                int stride) {
  if (lane < n) p.store(e, slots + lane, stride);
#pragma unroll 1
  for (int d = 1; d < n; d *= 2) {
    __syncwarp();
    if (lane >= d && lane < n) e = p.combine(p.load(slots + (lane - d), stride), e);
    __syncwarp();
    if (lane < n) p.store(e, slots + lane, stride);
  }
  return e;
}

// One level of the scan over the first n lanes of a warp, leaving lane i's
// inclusive prefix at slots + i: in shuffles, or from the slots themselves.
template <bool kSharedWarps, class P>
__device__ __forceinline__ typename P::Element level_scan(const P& p, typename P::Element e,
                                                          int lane, int n,
                                                          typename P::Scalar* slots, int stride) {
  if constexpr (kSharedWarps) {
    return warp_scan_shared(p, e, lane, n, slots, stride);
  } else {
    e = warp_scan(p, e, lane, n);
    if (lane < n) p.store(e, slots + lane, stride);
    return e;
  }
}

// Rows of Scalar of the scan's shared memory: the inclusive prefix of the W
// warp totals, the thread block's total, the inclusive prefix of the NB
// thread-block totals.
template <class P, int NB, int W>
__host__ __device__ constexpr int scan_shared_rows() {
  return P::kRows * (W + 1 + NB);
}

// Exclusive prefix of B aggregates, seeded with p.prior_state(): block b's
// start is the state part of prior ∘ agg_0 ∘ ... ∘ agg_{b-1}. Run by every
// thread of a cluster of NB thread blocks of W warps.
//
// Round r covers the NB W 32 F aggregates from r NB W 32 F on, thread
// t = 32 (W z + w) + lane of cluster rank z taking the F consecutive ones
// from r NB W 32 F + F t. A lane past B holds the identity and meets every
// barrier. In each round: (1) each thread folds its F aggregates; (2) an
// inclusive scan across the warp's lanes; (3) warp 0 scans the W warp
// totals; (4) warp 0 of every thread block scans the NB thread-block totals,
// read from the cluster's shared memory; (5) each thread forms its start as
// the state part of carry ∘ blocks_{<z} ∘ warps_{<w} ∘ lanes_{<lane},
// applied left to right, where carry is the prior pushed through the
// earlier rounds' totals, and pushes it through its F aggregates, storing
// each block's start on the way.
//
// `shared` holds scan_shared_rows<P, NB, W>() values. With kSharedWarps the
// lane level reads its left operands from `lane_slots` (kRows rows of
// 32 W values, lane i of warp w at 32 w + i) rather than shuffles, the two
// upper levels from their own rows likewise, and the lane prefix that
// step (5) applies is read back from the slots rather than kept in
// registers across the barriers.
template <int NB, int W, int F, bool kSharedWarps, class P>
__device__ __forceinline__ void cluster_scan(const P& p, int B, typename P::Scalar* shared,
                                             typename P::Scalar* lane_slots) {
  static_assert((NB & (NB - 1)) == 0 && NB <= 8 && (W & (W - 1)) == 0 && W <= kScanLanes &&
                    F >= 1,
                "the scan levels take 2^n warps a thread block, 2^m thread blocks a cluster of <= 8");
  using E = typename P::Element;
  using S = typename P::State;
  using T = typename P::Scalar;
  constexpr int kRound = NB * W * kScanLanes * F;
  constexpr int kLaneStride = W * kScanLanes;  // row stride of the lane slots
  T* warp_incl = shared;                      // W values a row
  T* block_total = warp_incl + P::kRows * W;  // one value a row
  T* cluster_incl = block_total + P::kRows;   // NB values a row
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int z = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x % kScanLanes;
  const int w = threadIdx.x / kScanLanes;
  T* own_slots = kSharedWarps ? lane_slots + w * kScanLanes : nullptr;  // this warp's lanes
  S carry = p.prior_state();
  const int rounds = (B + kRound - 1) / kRound;
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
    const int first = r * kRound + F * ((z * W + w) * kScanLanes + lane);
    E e = p.identity();
    if (first < B) e = p.load_agg(first);
#pragma unroll
    for (int f = 1; f < F; ++f)
      if (first + f < B) e = p.combine(e, p.load_agg(first + f));
    E lanes_before;  // lane - 1's inclusive prefix (shuffles; for lane > 0)
    if constexpr (kSharedWarps) {
      e = warp_scan_shared(p, e, lane, kScanLanes, own_slots, kLaneStride);
    } else {
      e = warp_scan(p, e, lane, kScanLanes);
      lanes_before = p.shfl_up(e, 1);
    }
    if (lane == kScanLanes - 1) p.store(e, warp_incl + w, W);
    __syncthreads();
    if (w == 0) {
      E t = p.identity();
      if (lane < W) t = p.load(warp_incl + lane, W);
      t = level_scan<kSharedWarps>(p, t, lane, W, warp_incl, W);
      if (lane == W - 1) p.store(t, block_total, 1);
    }
    cluster.sync();
    if (w == 0) {
      E t = p.identity();
      if (lane < NB) t = p.load(cluster.map_shared_rank(block_total, lane), 1);
      level_scan<kSharedWarps>(p, t, lane, NB, cluster_incl, NB);
    }
    __syncthreads();
    S s = carry;
    if (z > 0) p.apply(s, p.load(cluster_incl + (z - 1), NB));
    if (w > 0) p.apply(s, p.load(warp_incl + (w - 1), W));
    if (lane > 0) {
      if constexpr (kSharedWarps) {
        p.apply(s, p.load(own_slots + (lane - 1), kLaneStride));
      } else {
        p.apply(s, lanes_before);
      }
    }
#pragma unroll
    for (int f = 0; f < F; ++f) {
      if (first + f < B) {
        p.store_start(s, first + f);
        if (f + 1 < F) p.apply(s, p.load_agg(first + f));
      }
    }
    if (r + 1 < rounds) p.apply(carry, p.load(cluster_incl + (NB - 1), NB));
    cluster.sync();  // the shared rows stay in place until every thread block has read them
  }
}

}  // namespace tgps
