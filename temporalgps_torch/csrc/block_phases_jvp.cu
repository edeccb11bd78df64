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
// as long as its last chunk, the one with the longest start chain. K5 is
// bound by the latency of a serial scan.

#include <cooperative_groups.h>

#include "lanes.cuh"

namespace tgps {

constexpr int kJvpLaneThreads = 32;   // K4, K6: a warp's lanes take 32 neighbouring blocks
constexpr int kJvpScanThreads = 128;  // K5: threads of each tangent's thread block
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

// Thread block j scans the primal aggregates and tangent j together, with
// a two-level schedule (as K9's, block_states.cu), so shared memory holds two
// element sets whatever k is: 2K x 128 values, 67,584 B in double at D = 3.
// That is above the 48 KB a kernel gets statically, hence dynamic shared
// memory and cudaFuncAttributeMaxDynamicSharedMemorySize at the launch.
//
// The identity element that fills the front of the scan has an all-zero
// tangent (also in A); the prior element's tangent is (0, dm0, dP0, 0, 0).
template <typename T, int D>
__global__ void __launch_bounds__(kJvpScanThreads)
phase2_jvp_starts_kernel(const T* __restrict__ comps, const T* __restrict__ priors,
                         T* __restrict__ starts, int B) {
  constexpr int K = Dims<D>::kElem;
  constexpr int SD = Dims<D>::kState;
  extern __shared__ __align__(16) unsigned char shared_raw[];
  T* partials = reinterpret_cast<T*>(shared_raw);
  T* dpartials = partials + K * kJvpScanThreads;
  const int t = threadIdx.x;
  const int j = blockIdx.x;
  const T* dcomps = comps + static_cast<long long>(1 + j) * K * B;
  const int run = (B + kJvpScanThreads - 1) / kJvpScanThreads;
  const int lo = min(t * run, B);
  const int hi = min(lo + run, B);

  ElemJvp<T, D> own;
  own.primal = identity_elem<T, D>();
  own.tangent = zero_elem<T, D>();
  for (int b = lo; b < hi; ++b)
    own = combine_jvp(own.primal, own.tangent, load_elem<T, D>(comps + b, B),
                      load_elem<T, D>(dcomps + b, B));

  store_elem(own.primal, partials + t, kJvpScanThreads);
  store_elem(own.tangent, dpartials + t, kJvpScanThreads);
  __syncthreads();
  for (int offset = 1; offset < kJvpScanThreads; offset <<= 1) {
    ElemJvp<T, D> next = own;
    if (t >= offset)
      next = combine_jvp(load_elem<T, D>(partials + (t - offset), kJvpScanThreads),
                         load_elem<T, D>(dpartials + (t - offset), kJvpScanThreads),
                         own.primal, own.tangent);
    __syncthreads();
    own = next;
    store_elem(own.primal, partials + t, kJvpScanThreads);
    store_elem(own.tangent, dpartials + t, kJvpScanThreads);
    __syncthreads();
  }

  ElemJvp<T, D> state;
  state.primal = zero_elem<T, D>();
  state.tangent = zero_elem<T, D>();
  load_state(priors, 1, state.primal.b, state.primal.C);
  load_state(priors + static_cast<long long>(1 + j) * SD, 1, state.tangent.b, state.tangent.C);
  if (t > 0)
    state = combine_jvp(state.primal, state.tangent,
                        load_elem<T, D>(partials + (t - 1), kJvpScanThreads),
                        load_elem<T, D>(dpartials + (t - 1), kJvpScanThreads));
  T* dstarts = starts + static_cast<long long>(1 + j) * SD * B;
  for (int b = lo; b < hi; ++b) {
    if (j == 0) store_state(state.primal.b, state.primal.C, starts + b, B);
    store_state(state.tangent.b, state.tangent.C, dstarts + b, B);
    state = combine_jvp(state.primal, state.tangent, load_elem<T, D>(comps + b, B),
                        load_elem<T, D>(dcomps + b, B));
  }
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
  const int bytes = 2 * Dims<D>::kElem * kJvpScanThreads * static_cast<int>(sizeof(T));
  const cudaError_t err = cudaFuncSetAttribute(
      phase2_jvp_starts_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  phase2_jvp_starts_kernel<T, D><<<k, kJvpScanThreads, bytes, stream>>>(comps, priors, starts, B);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_phase2_jvp(const T* comps, const T* priors, T* starts, int B, int D, int k,
                      cudaStream_t stream) {
  if (B < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
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
