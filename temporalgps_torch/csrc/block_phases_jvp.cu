// The forward-mode twins of the three block phases: the log marginal
// likelihood together with its derivative along k parameter directions, in one
// pass, written for Hopper (sm_90a), float and double, D in 1..3.
//
//   K4 phase1_jvp         replaces temporalgps_tpu/ops/pallas_kernels.py phase1_jvp
//   K5 phase2_jvp_starts  replaces temporalgps_tpu/ops/pallas_kernels.py phase2_jvp_starts
//   K6 phase3_jvp_lml     replaces temporalgps_tpu/ops/pallas_kernels.py phase3_jvp_lml
//
// Layout as in block_phases.cu: y and s are (L, B) streams; elements and
// states are component-major (rows, B), here stacked as the primal set
// followed by k tangent sets: ((1+k)*K, B) aggregates, ((1+k)*SD, B) starts,
// (1+k, B) lml rows; K4's chunk aggregates are (C, (1+k)*K, B), chunk c's
// sets at c*(1+k)*K*B. `rows` is (1+k, PK2) row-major: row 0 the packed primal
// parameters (its last slot unused: the noise is streamed), row 1+j tangent j
// of the parameters with the time-invariant noise tangent in the last slot.
// `priors` is (1+k, SD): (m0, P0) and its k tangents.
//
// k is a runtime number and registers are the scarce thing: one thread that
// carried the primal and k tangent elements would need (1+k)*K live values
// and could not be unrolled over k. So the tangents are spread over the
// grid: blockIdx.y = j, and thread (b, j) carries the primal and tangent j
// only. The primal is recomputed k times; the j = 0 threads write it.
//
// The noise tangent enters a step as ds * (s < kMaskThresh): a missing or
// padding step has the LARGE_VAR fill in the s stream, its lml is a constant
// that the caller's compensation adds back, and its derivative with respect
// to the noise must be exactly zero.
//
// K4 is bound by operations on paper (at D = 3 a step is 738 flops for the
// primal and 1522 for the tangent, against two values read), and on this card
// by how many warps issue them: a step is a dependent chain of about 1.5k
// instructions, and one warp per (32 blocks, tangent) gives 192 warps at
// B = 2048, k = 3 for 528 schedulers. The fold is associative, so K4 splits
// each block's L steps into kPhase1JvpChunks = C contiguous chunks, one per
// warp (lane i of every warp takes block 32 * blockIdx.x + i, so the stream
// reads stay coalesced), and combines the chunk aggregates in order: C times
// the warps in flight, and a serial chain of ceil(L / C) steps instead of L.
// A thread needs all 255 registers (and spills in double at D = 3), so an
// SM holds one thread block of 8 warps; one block of 16 warps would cap a
// thread at 128 registers and spill. So the C = 16 warps of a (32 blocks,
// tangent) pair are a cluster of C / kPhase1JvpWarps = 2 thread blocks of 8
// warps, which combine their two halves through distributed shared memory:
// 384 thread blocks of 31 steps spread over 132 SMs more evenly than 192 of
// 62 steps (one block of C = 8 warps) would. K4 also writes each chunk's
// aggregate, before the tree, for K6.
//
// K6 is bound by operations on paper (at D = 3, 215 flops a step for the
// primal and 406 for the tangent), and one thread per (block, tangent) left it
// bound by the latency of an L-step serial recursion on 192 warps. The
// recursion is not associative, but a chunk of it can start on its own once
// its start state is known, and K4's chunk aggregates give that: K6 takes
// K4's grid and cluster, thread (b, j, c) pushing the primal and tangent-j
// start of block b through the aggregates of chunks 0 .. c-1 (at most C - 1
// state-only combines, apply_elem_jvp), then running the Kalman recursion
// and its tangent over chunk c's ceil(L / C) steps; the C partial sums are
// added in chunk order through shared memory and the cluster's. A re-fold of
// the chunks, as K7 does, would repeat K4's whole work. K6 is then bound by
// instruction issue: a replay step is some 480 instructions and a chain step
// some 800, and an SM holds one 8-warp thread block at K6's register count,
// so each scheduler has two dependent chains to issue from; a cluster lasts
// as long as its last chunk, the one with the longest start chain.
//
// K5 is a scan of the B block aggregates carried with one tangent: bound on
// paper by bytes ((1+k)(K + SD) B values), in practice by the depth of its
// chain of dependent combine_jvps. It is K2's cluster scan (scan.cuh) on
// (primal, tangent) pairs, one cluster of kPhase2JvpCluster thread blocks
// of kPhase2JvpWarps warps per tangent (a (NB, k) grid; the primal is
// recomputed in every cluster and written by cluster 0): one pair a lane,
// a Kogge-Stone across a warp's lanes, then across the warp totals and the
// cluster's thread-block totals, 5 + 3 + 3 dependent combine_jvps and 3
// apply_elem_jvps at B = 2048. A pair is 66 values, so a level that holds
// its own pair and the left one needs 132 registers for them in float and
// 264 in double, above the 255 a thread may have. At D = 3 the float
// shuffles take 255 registers and spill 84 B; in double they spill 3.2 KB,
// so there each level reads the left pair from shared memory instead, as
// combine_jvp needs it, and the lane prefix is read back from there rather
// than held across the barriers: 1.6 KB of spill, and 10% less time on an
// H100 (probes/torch_chunk_sweep.py).

#include <cooperative_groups.h>

#include "lanes.cuh"
#include "scan.cuh"

namespace tgps {

constexpr int kJvpLaneThreads = 32;  // K4, K6: a warp's lanes take 32 neighbouring blocks
constexpr double kMaskThresh = 1e14;  // LARGE_VAR / 10
// K4 and K6 (which replays K4's chunks): chunks of every block's steps, one
// per warp, and warps per thread block; a cluster of C / W thread blocks
// holds a block's C warps. ops/kernels.py passes its PHASE1_JVP_CHUNKS at
// both launches; the two must agree.
constexpr int kPhase1JvpChunks = 16;
constexpr int kPhase1JvpWarps = 8;
constexpr int kPhase1JvpCluster = kPhase1JvpChunks / kPhase1JvpWarps;
static_assert((kPhase1JvpWarps & (kPhase1JvpWarps - 1)) == 0 &&
              (kPhase1JvpCluster & (kPhase1JvpCluster - 1)) == 0 &&
              kPhase1JvpCluster * kPhase1JvpWarps == kPhase1JvpChunks,
              "the chunk tree takes 2^n chunks, W a thread block, 2^m thread blocks a cluster");

// K5: thread blocks of each tangent's cluster, warps a thread block, and
// the aggregates a lane folds before the scan (a round covers
// kPhase2JvpCluster * kPhase2JvpWarps * 32 * kPhase2JvpFold aggregates; a
// larger B takes several rounds in order). kPhase2JvpSharedWarpsF32 and
// F64 (0 or 1) choose, for float and double, the levels that read the left
// pair from shared memory (1) or from shuffles (0).
constexpr int kPhase2JvpCluster = 8;
constexpr int kPhase2JvpWarps = 8;
constexpr int kPhase2JvpFold = 1;
constexpr int kPhase2JvpSharedWarpsF32 = 0;
constexpr int kPhase2JvpSharedWarpsF64 = 1;

template <typename T>
__host__ __device__ constexpr bool phase2_jvp_shared_warps() {
  return (sizeof(T) == sizeof(double) ? kPhase2JvpSharedWarpsF64 : kPhase2JvpSharedWarpsF32) != 0;
}

// Dynamic shared memory of K5: the lane slots of the shared-memory levels,
// one pair of 2K rows a lane (none with shuffles).
template <typename T, int D>
constexpr int phase2_jvp_shared_bytes() {
  return phase2_jvp_shared_warps<T>()
             ? 2 * Dims<D>::kElem * kPhase2JvpWarps * kJvpLaneThreads * static_cast<int>(sizeof(T))
             : 0;
}

// Shared memory of K4's chunk tree: at each level half of the remaining
// warps hand their primal and tangent aggregates to the warp on their left,
// so W / 2 slots of 2K rows of 32 lanes suffice.
template <typename T, int D>
constexpr int phase1_jvp_shared_bytes() {
  return 2 * Dims<D>::kElem * (kPhase1JvpWarps / 2) * kJvpLaneThreads * static_cast<int>(sizeof(T));
}

// Warp w of the thread block of cluster rank z (blockIdx.z) in cluster
// (x, j) takes chunk c = z W + w: steps [c Lc, min((c+1) Lc, L)), Lc =
// ceil(L / C), of block b = 32x + lane for the primal and tangent j, folded
// from the identity element with a zero tangent (an empty chunk stays that).
// The C chunk aggregates are then combined in a log2(C)-level tree, earlier
// chunk always on the left (combine is not commutative): at span 1, 2, 4,
// ..., chunk c with c % 2span == span hands its aggregate to chunk c - span,
// which combines it on the right of its own. The levels inside a thread
// block go through its shared memory, the levels across thread blocks
// through the cluster's (warp 0 of rank z reads rank z + span's slot). Warp
// 0 of rank 0 ends with the block's total. Before the tree each thread
// stores its chunk aggregate to chunk_out (the primal from j = 0 only).
template <typename T, int D>
__global__ void __cluster_dims__(1, 1, kPhase1JvpCluster)
__launch_bounds__(kJvpLaneThreads * kPhase1JvpWarps)
phase1_jvp_kernel(const T* __restrict__ y, const T* __restrict__ s, const T* __restrict__ rows,
                  T* __restrict__ out, T* __restrict__ chunk_out, int L, int B) {
  constexpr int K = Dims<D>::kElem;
  constexpr int PK2 = Dims<D>::kParamsS;
  constexpr int C = kPhase1JvpChunks;
  constexpr int W = kPhase1JvpWarps;
  constexpr int kSlotStride = (W / 2) * kJvpLaneThreads;  // row stride of the hand-over slots
  extern __shared__ __align__(16) unsigned char shared_raw[];
  T* handed = reinterpret_cast<T*>(shared_raw);
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int z = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x % kJvpLaneThreads;
  const int w = threadIdx.x / kJvpLaneThreads;
  const int b = blockIdx.x * kJvpLaneThreads + lane;
  const int j = blockIdx.y;
  const Params<T, D> p = load_params<T, D>(rows);
  const T* drow = rows + static_cast<long long>(1 + j) * PK2;
  const Params<T, D> dp = load_params<T, D>(drow);
  const T ds = drow[PK2 - 1];
  const int Lc = (L + C - 1) / C;
  const int lo = min((z * W + w) * Lc, L);
  const int hi = b < B ? min(lo + Lc, L) : lo;  // a lane past the last block folds nothing
  Elem<T, D> acc = identity_elem<T, D>();
  Elem<T, D> dacc = zero_elem<T, D>();
  for (int l = lo; l < hi; ++l) {
    const long long i = static_cast<long long>(l) * B + b;
    const T s_l = s[i];
    const T ds_l = s_l < T(kMaskThresh) ? ds : T(0);
    const ElemJvp<T, D> e = step_element_jvp(p, dp, s_l, ds_l, y[i]);
    const ElemJvp<T, D> c = combine_jvp(acc, dacc, e.primal, e.tangent);
    acc = c.primal;
    dacc = c.tangent;
  }
  if (b < B) {
    const long long sets = static_cast<long long>(1 + gridDim.y) * K * B;
    T* chunk = chunk_out + (z * W + w) * sets + b;
    if (j == 0) store_elem(acc, chunk, B);
    store_elem(dacc, chunk + static_cast<long long>(1 + j) * K * B, B);
  }
#pragma unroll 1
  for (int span = 1; span < W; span *= 2) {
    T* slot = handed + (w / (2 * span)) * kJvpLaneThreads + lane;
    if (w % (2 * span) == span) {
      store_elem(acc, slot, kSlotStride);
      store_elem(dacc, slot + K * kSlotStride, kSlotStride);
    }
    __syncthreads();
    if (w % (2 * span) == 0) {
      const ElemJvp<T, D> c = combine_jvp(acc, dacc, load_elem<T, D>(slot, kSlotStride),
                                          load_elem<T, D>(slot + K * kSlotStride, kSlotStride));
      acc = c.primal;
      dacc = c.tangent;
    }
    __syncthreads();
  }
#pragma unroll 1
  for (int span = 1; span < kPhase1JvpCluster; span *= 2) {
    T* slot = handed + lane;
    if (w == 0 && z % (2 * span) == span) {
      store_elem(acc, slot, kSlotStride);
      store_elem(dacc, slot + K * kSlotStride, kSlotStride);
    }
    cluster.sync();
    if (w == 0 && z % (2 * span) == 0) {
      const T* remote = cluster.map_shared_rank(handed, z + span) + lane;
      const ElemJvp<T, D> c = combine_jvp(acc, dacc, load_elem<T, D>(remote, kSlotStride),
                                          load_elem<T, D>(remote + K * kSlotStride, kSlotStride));
      acc = c.primal;
      dacc = c.tangent;
    }
    cluster.sync();  // rank z + span's slot stays in place until it is read
  }
  if (w != 0 || z != 0 || b >= B) return;
  if (j == 0) store_elem(acc, out + b, B);
  store_elem(dacc, out + static_cast<long long>(1 + j) * K * B + b, B);
}

// K5's element policy for cluster_scan (scan.cuh): (primal, tangent j)
// pairs of filtering elements. The identity has an all-zero tangent (also
// in A); the prior element (0, m0, P0, 0, 0) has tangent (0, dm0, dP0, 0, 0)
// and is applied as a state (apply_elem_jvp); cluster j = 0 writes the
// primal starts, cluster j tangent j's.
template <typename T, int D>
struct ElemJvpScan {
  using Scalar = T;
  using Element = ElemJvp<T, D>;
  struct State {
    Vec<T, D> m, dm;
    Mat<T, D> P, dP;
  };
  static constexpr int kRows = 2 * Dims<D>::kElem;  // the primal rows, then the tangent's
  const T* comps;    // (K, B) primal aggregates
  const T* dcomps;   // (K, B) tangent j of them
  const T* priors;   // (1+k, SD)
  T* starts;         // (SD, B) primal starts
  T* dstarts;        // (SD, B) tangent j of them
  int B;
  int j;
  __device__ Element identity() const { return {identity_elem<T, D>(), zero_elem<T, D>()}; }
  __device__ Element combine(const Element& ei, const Element& ej) const {
    return combine_jvp(ei.primal, ei.tangent, ej.primal, ej.tangent);
  }
  __device__ Element shfl_up(const Element& e, int delta) const {
    return {shfl_up_elem(e.primal, delta), shfl_up_elem(e.tangent, delta)};
  }
  __device__ Element load(const T* base, long long stride) const {
    return {load_elem<T, D>(base, stride), load_elem<T, D>(base + Dims<D>::kElem * stride, stride)};
  }
  __device__ void store(const Element& e, T* base, long long stride) const {
    store_elem(e.primal, base, stride);
    store_elem(e.tangent, base + Dims<D>::kElem * stride, stride);
  }
  __device__ Element load_agg(int b) const {
    return {load_elem<T, D>(comps + b, B), load_elem<T, D>(dcomps + b, B)};
  }
  __device__ State prior_state() const {
    State s;
    load_state(priors, 1, s.m, s.P);
    load_state(priors + static_cast<long long>(1 + j) * Dims<D>::kState, 1, s.dm, s.dP);
    return s;
  }
  __device__ void apply(State& s, const Element& e) const {
    apply_elem_jvp(s.m, s.dm, s.P, s.dP, e.primal, e.tangent);
  }
  __device__ void store_start(const State& s, int b) const {
    if (j == 0) store_state(s.m, s.P, starts + b, B);
    store_state(s.dm, s.dP, dstarts + b, B);
  }
};

// Cluster j of the (kPhase2JvpCluster, k) grid scans the primal aggregates
// and tangent j together (cluster_scan): ((1+k)*K, B) aggregates and
// (1+k, SD) priors -> ((1+k)*SD, B) starts.
template <typename T, int D>
__global__ void __cluster_dims__(kPhase2JvpCluster, 1, 1)
__launch_bounds__(kJvpLaneThreads * kPhase2JvpWarps)
phase2_jvp_starts_kernel(const T* __restrict__ comps, const T* __restrict__ priors,
                         T* __restrict__ starts, int B) {
  using P = ElemJvpScan<T, D>;
  constexpr bool kShared = phase2_jvp_shared_warps<T>();
  __shared__ T shared[scan_shared_rows<P, kPhase2JvpCluster, kPhase2JvpWarps>()];
  extern __shared__ __align__(16) unsigned char shared_raw[];
  const int j = blockIdx.y;
  const P p{comps, comps + static_cast<long long>(1 + j) * Dims<D>::kElem * B, priors, starts,
            starts + static_cast<long long>(1 + j) * Dims<D>::kState * B, B, j};
  cluster_scan<kPhase2JvpCluster, kPhase2JvpWarps, kPhase2JvpFold, kShared>(
      p, B, shared, kShared ? reinterpret_cast<T*>(shared_raw) : nullptr);
}

// Warp w of the thread block of cluster rank z in cluster (x, j) takes chunk
// c = z W + w: steps [c Lc, min((c+1) Lc, L)), Lc = ceil(L / C), of block
// b = 32x + lane, primal and tangent j. (1) It loads the block's start and
// its tangent and pushes them through K4's aggregates of chunks 0 .. c-1,
// left to right (apply_elem_jvp: the state part of (0, m, P, 0, 0) combined
// with each); the parameters are loaded after this, so they are not live
// across it. (2) It runs kalman_step_jvp over its chunk, summing the lml and
// its tangent from zero, with the noise tangent masked at missing and
// padding steps, and y and s loaded one step ahead. (3) Warp 0 of rank 0 adds the C partial sums in chunk
// order, 0 .. C-1, from its own shared memory and rank 1's, and writes the
// block's lml row (the primal from j = 0 only). An empty chunk and a lane
// past the last block add zero but meet both cluster barriers.
template <typename T, int D>
__global__ void __cluster_dims__(1, 1, kPhase1JvpCluster)
__launch_bounds__(kJvpLaneThreads * kPhase1JvpWarps)
phase3_jvp_lml_kernel(const T* __restrict__ y, const T* __restrict__ s,
                      const T* __restrict__ rows, const T* __restrict__ starts,
                      const T* __restrict__ chunk_aggs, T* __restrict__ lml, int L, int B) {
  constexpr int K = Dims<D>::kElem;
  constexpr int SD = Dims<D>::kState;
  constexpr int PK2 = Dims<D>::kParamsS;
  constexpr int C = kPhase1JvpChunks;
  constexpr int W = kPhase1JvpWarps;
  constexpr int kSlots = W * kJvpLaneThreads;  // one partial sum a thread
  __shared__ T partials[2 * kSlots];
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int z = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x % kJvpLaneThreads;
  const int w = threadIdx.x / kJvpLaneThreads;
  const int c = z * W + w;
  const int b = blockIdx.x * kJvpLaneThreads + lane;
  const int j = blockIdx.y;
  const int Lc = (L + C - 1) / C;
  const int lo = min(c * Lc, L);
  const int hi = b < B ? min(lo + Lc, L) : lo;  // a lane past the last block runs nothing
  T acc = T(0), dacc = T(0);
  if (lo < hi) {
    // The stream values of each step are loaded one step ahead, the first
    // step's before the start chain, so no step waits a trip to memory.
    T s_next = s[static_cast<long long>(lo) * B + b];
    T y_next = y[static_cast<long long>(lo) * B + b];
    Vec<T, D> m, dm;
    Mat<T, D> P, dP;
    load_state(starts + b, B, m, P);
    load_state(starts + static_cast<long long>(1 + j) * SD * B + b, B, dm, dP);
    const long long sets = static_cast<long long>(1 + gridDim.y) * K * B;
    const long long tangent_at = static_cast<long long>(1 + j) * K * B;
#pragma unroll 1
    for (int i = 0; i < c; ++i) {
      const T* agg = chunk_aggs + i * sets + b;
      apply_elem_jvp(m, dm, P, dP, load_elem<T, D>(agg, B), load_elem<T, D>(agg + tangent_at, B));
    }
    const Params<T, D> p = load_params<T, D>(rows);
    const T* drow = rows + static_cast<long long>(1 + j) * PK2;
    const Params<T, D> dp = load_params<T, D>(drow);
    const T ds = drow[PK2 - 1];
    for (int l = lo; l < hi; ++l) {
      const T s_l = s_next, y_l = y_next;
      if (l + 1 < hi) {
        s_next = s[static_cast<long long>(l + 1) * B + b];
        y_next = y[static_cast<long long>(l + 1) * B + b];
      }
      const T ds_l = s_l < T(kMaskThresh) ? ds : T(0);
      const LmlJvp<T> step = kalman_step_jvp(m, dm, P, dP, p, dp, s_l, ds_l, y_l);
      acc += step.primal;
      dacc += step.tangent;
    }
  }
  partials[w * kJvpLaneThreads + lane] = acc;
  partials[kSlots + w * kJvpLaneThreads + lane] = dacc;
  cluster.sync();
  if (z == 0 && w == 0 && b < B) {
    T total = T(0), dtotal = T(0);
#pragma unroll 1
    for (int i = 0; i < C; ++i) {
      const T* slot = cluster.map_shared_rank(partials, i / W) + (i % W) * kJvpLaneThreads + lane;
      total += slot[0];
      dtotal += slot[kSlots];
    }
    if (j == 0) lml[b] = total;
    lml[static_cast<long long>(1 + j) * B + b] = dtotal;
  }
  cluster.sync();  // rank 1's partial sums stay in place until they are read
}

inline int jvp_lane_grid(int B) { return (B + kJvpLaneThreads - 1) / kJvpLaneThreads; }

template <typename T, int D>
int launch_phase1_jvp_d(const T* y, const T* s, const T* rows, T* out, T* chunk_out, int L,
                        int B, int k, cudaStream_t stream) {
  const int bytes = phase1_jvp_shared_bytes<T, D>();
  const cudaError_t err = cudaFuncSetAttribute(
      phase1_jvp_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(jvp_lane_grid(B), k, kPhase1JvpCluster);
  phase1_jvp_kernel<T, D><<<grid, kJvpLaneThreads * kPhase1JvpWarps, bytes, stream>>>(
      y, s, rows, out, chunk_out, L, B);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_phase1_jvp(const T* y, const T* s, const T* rows, T* out, T* chunk_out, int L, int B,
                      int D, int k, int chunks, cudaStream_t stream) {
  if (L < 1 || B < 1 || k < 1 || k > 65535 || chunks != kPhase1JvpChunks)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 1: return launch_phase1_jvp_d<T, 1>(y, s, rows, out, chunk_out, L, B, k, stream);
    case 2: return launch_phase1_jvp_d<T, 2>(y, s, rows, out, chunk_out, L, B, k, stream);
    case 3: return launch_phase1_jvp_d<T, 3>(y, s, rows, out, chunk_out, L, B, k, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int D>
int launch_phase2_jvp_d(const T* comps, const T* priors, T* starts, int B, int k,
                        cudaStream_t stream) {
  constexpr int bytes = phase2_jvp_shared_bytes<T, D>();
  if (bytes > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        phase2_jvp_starts_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(kPhase2JvpCluster, k);
  phase2_jvp_starts_kernel<T, D><<<grid, kJvpLaneThreads * kPhase2JvpWarps, bytes, stream>>>(
      comps, priors, starts, B);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_phase2_jvp(const T* comps, const T* priors, T* starts, int B, int D, int k,
                      cudaStream_t stream) {
  if (B < 1 || k < 1 || k > 65535) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 1: return launch_phase2_jvp_d<T, 1>(comps, priors, starts, B, k, stream);
    case 2: return launch_phase2_jvp_d<T, 2>(comps, priors, starts, B, k, stream);
    case 3: return launch_phase2_jvp_d<T, 3>(comps, priors, starts, B, k, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_phase3_jvp(const T* y, const T* s, const T* rows, const T* starts, const T* chunk_aggs,
                      T* lml, int L, int B, int D, int k, int chunks, cudaStream_t stream) {
  if (L < 1 || B < 1 || k < 1 || k > 65535 || chunks != kPhase1JvpChunks)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(jvp_lane_grid(B), k, kPhase1JvpCluster);
  constexpr int threads = kJvpLaneThreads * kPhase1JvpWarps;
  switch (D) {
    case 1: phase3_jvp_lml_kernel<T, 1><<<grid, threads, 0, stream>>>(y, s, rows, starts, chunk_aggs, lml, L, B); break;
    case 2: phase3_jvp_lml_kernel<T, 2><<<grid, threads, 0, stream>>>(y, s, rows, starts, chunk_aggs, lml, L, B); break;
    case 3: phase3_jvp_lml_kernel<T, 3><<<grid, threads, 0, stream>>>(y, s, rows, starts, chunk_aggs, lml, L, B); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tgps

extern "C" {

int tgps_phase1_jvp_f32(const float* y, const float* s, const float* rows, float* out,
                        float* chunk_out, int L, int B, int D, int k, int chunks, void* stream) {
  return tgps::launch_phase1_jvp<float>(y, s, rows, out, chunk_out, L, B, D, k, chunks,
                                        static_cast<cudaStream_t>(stream));
}

int tgps_phase1_jvp_f64(const double* y, const double* s, const double* rows, double* out,
                        double* chunk_out, int L, int B, int D, int k, int chunks, void* stream) {
  return tgps::launch_phase1_jvp<double>(y, s, rows, out, chunk_out, L, B, D, k, chunks,
                                         static_cast<cudaStream_t>(stream));
}

int tgps_phase2_jvp_starts_f32(const float* comps, const float* priors, float* starts, int B,
                               int D, int k, void* stream) {
  return tgps::launch_phase2_jvp<float>(comps, priors, starts, B, D, k,
                                        static_cast<cudaStream_t>(stream));
}

int tgps_phase2_jvp_starts_f64(const double* comps, const double* priors, double* starts, int B,
                               int D, int k, void* stream) {
  return tgps::launch_phase2_jvp<double>(comps, priors, starts, B, D, k,
                                         static_cast<cudaStream_t>(stream));
}

int tgps_phase3_jvp_lml_f32(const float* y, const float* s, const float* rows,
                            const float* starts, const float* chunk_aggs, float* lml, int L,
                            int B, int D, int k, int chunks, void* stream) {
  return tgps::launch_phase3_jvp<float>(y, s, rows, starts, chunk_aggs, lml, L, B, D, k, chunks,
                                        static_cast<cudaStream_t>(stream));
}

int tgps_phase3_jvp_lml_f64(const double* y, const double* s, const double* rows,
                            const double* starts, const double* chunk_aggs, double* lml, int L,
                            int B, int D, int k, int chunks, void* stream) {
  return tgps::launch_phase3_jvp<double>(y, s, rows, starts, chunk_aggs, lml, L, B, D, k, chunks,
                                         static_cast<cudaStream_t>(stream));
}

}  // extern "C"
