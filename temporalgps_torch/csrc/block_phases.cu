// The three phases of the block-parallel Kalman log marginal likelihood,
// written for Hopper (sm_90a), float and double, D in 1..3.
//
//   K1 phase1_aggregate  replaces temporalgps_tpu/ops/pallas_kernels.py phase1_aggregate
//   K2 phase2_starts     replaces temporalgps_tpu/ops/pallas_kernels.py phase2_starts
//   K3 phase3_lml        replaces temporalgps_tpu/ops/pallas_kernels.py phase3_lml
//
// Layout: y and s are (L, B) row-major streams, element l*B + b is step l of
// block b. Elements (K rows) and states (SD rows) are component-major
// (rows, B). Each kernel launches on the caller's stream and allocates
// nothing; each C entry returns cudaGetLastError() after its launch.
//
// K1 is a fold (combine is associative), bound on paper by operations (at
// D = 3 a step is 738 flops against two values read) and on this card by how
// many warps issue them: one thread a block is 64 warps at B = 2048 for 528
// schedulers, each walking a dependent chain of L steps. So K1 takes K4's
// schedule (block_phases_jvp.cu) without the tangent: each block's L steps
// split into kPhase1AggregateChunks = C contiguous chunks, one per warp (lane
// i of every warp takes block 32 * blockIdx.x + i, so the stream reads stay
// coalesced), each folded from the identity, and the chunk aggregates
// combined in order in a log2(C)-level tree: C times the warps in flight and
// a serial chain of ceil(L / C) steps instead of L. The C warps of 32 blocks
// are a cluster of C / kPhase1AggregateWarps thread blocks, whose last tree
// levels go through distributed shared memory. Before the tree each warp
// stores its chunk's aggregate, which K3 reads.
//
// K3 is bound on paper by operations (215 flops a step at D = 3), and one
// thread a block left it bound by the latency of an L-step serial recursion
// on 64 warps. The recursion is not associative, but a run of it can start
// on its own once its start state is known, and K1's run aggregates give
// that: K1 stores each warp's run aggregate before its tree, and K3 takes
// K1's grid and cluster, warp c of 32 blocks pushing the block's start
// through the aggregates of runs 0 .. c-1 (state-only combines, apply_elem)
// and replaying the Kalman recursion over run c; the C run sums are added
// in run order across the cluster. K6 (block_phases_jvp.cu) does the same
// with a tangent.
//
// K1 and K3 come in two forms, one template each over a transition policy
// of lanes.cuh: ConstantTrans, the time-invariant packed parameters (a
// RegularSpacing model), and StreamedTrans, each step's (A, a, Q) read from
// (KT, L, B) rows (irregular times), one coalesced warp access a row, the
// next step's row loaded before the current one is used. The same fold,
// replay, grid and chunk count serve both; the entry points take a null
// rows pointer for the constant form. Streamed, each step reads KT = 21
// more values at D = 3, so both kernels are bound by bytes on paper.
//
// K2 is a scan of B aggregates of K values: 270 KB in float32 at B = 2048,
// a bytes bound of 0.1 us, and a dependent chain of combines whatever the
// schedule. Its time is that chain's depth, and the trips to memory inside
// it. So it is the cluster scan of scan.cuh (which K5 and K9 share) on
// filtering elements: each lane holds one aggregate (lane i of warp w of
// cluster rank z takes block 32 (W z + w) + i, every row read one coalesced
// access) and the scan is a Kogge-Stone at three levels, across the 32 lanes
// of a warp in register shuffles, across the W warp totals of a thread block
// through its shared memory, and across the cluster's thread-block totals
// through distributed shared memory. At B = 2048 one cluster of 8 thread
// blocks of 8 warps holds every aggregate: 5 + 3 + 3 dependent combines and
// 3 state-only ones (apply_elem) to finish, on 8 SMs, in 154 registers in
// float and 255 in double (a 92 B spill) at D = 3.

#include <cooperative_groups.h>

#include "lanes.cuh"
#include "scan.cuh"

namespace tgps {

constexpr int kLaneThreads = 32;  // lanes a warp; a lane takes one block
// K1 and K3 (which replays K1's chunks), in both transition policies of
// lanes.cuh (constant, or streamed from per-step rows): chunks of every block's steps, one
// per warp, and warps per thread block; a cluster of C / W thread blocks
// holds a block's C warps. ops/kernels.py passes its PHASE1_AGGREGATE_CHUNKS
// at both launches; the two must agree.
constexpr int kPhase1AggregateChunks = 16;
constexpr int kPhase1AggregateWarps = 8;
constexpr int kPhase1AggregateCluster = kPhase1AggregateChunks / kPhase1AggregateWarps;
static_assert((kPhase1AggregateWarps & (kPhase1AggregateWarps - 1)) == 0 &&
              (kPhase1AggregateCluster & (kPhase1AggregateCluster - 1)) == 0 &&
              kPhase1AggregateCluster * kPhase1AggregateWarps == kPhase1AggregateChunks,
              "the chunk tree takes 2^n chunks, W a thread block, 2^m thread blocks a cluster");
// K2: thread blocks of its one cluster, warps a thread block, and the
// aggregates a lane folds before the scan (1: one aggregate a lane). A
// round of the scan covers kPhase2Cluster * kPhase2Warps * 32 * kPhase2Fold
// aggregates; a larger B takes several rounds in order, each seeded with the
// state the earlier ones end in. A float64 element at D = 3 is 66
// registers, so 8 warps (255 registers a thread) is the largest thread block
// that holds two.
constexpr int kPhase2Cluster = 8;
constexpr int kPhase2Warps = 8;
constexpr int kPhase2Fold = 1;

// Shared memory of K1's chunk tree: at each level half of the remaining
// warps hand their aggregates to the warp on their left, so W / 2 slots of
// K rows of 32 lanes suffice (one slot for a thread block of one warp).
template <typename T, int D>
constexpr int phase1_aggregate_shared_bytes() {
  constexpr int slots = kPhase1AggregateWarps > 1 ? kPhase1AggregateWarps / 2 : 1;
  return Dims<D>::kElem * slots * kLaneThreads * static_cast<int>(sizeof(T));
}

// Warp w of the thread block of cluster rank z (blockIdx.z) in cluster x
// takes chunk c = z W + w: steps [c Lc, min((c+1) Lc, L)), Lc = ceil(L / C),
// of block b = 32x + lane, folded from the identity element (an empty chunk
// stays that; a lane past the last block folds nothing but meets every
// barrier), and stores the chunk's aggregate to chunk_out. The C chunk
// aggregates are then combined in a log2(C)-level tree, earlier chunk
// always on the left (combine is not commutative): at span 1, 2, 4, ...,
// chunk c with c % 2span == span hands its aggregate to chunk c - span,
// which combines it on the right of its own. The levels inside a thread
// block go through its shared memory, those across thread blocks through
// the cluster's (warp 0 of rank z reads rank z + span's slot). Warp 0 of
// rank 0 ends with the block's aggregate.
template <typename T, int D, typename Trans>
__global__ void __cluster_dims__(1, 1, kPhase1AggregateCluster)
__launch_bounds__(kLaneThreads * kPhase1AggregateWarps)
phase1_aggregate_kernel(const T* __restrict__ y, const T* __restrict__ s,
                        const T* __restrict__ params, const T* __restrict__ rows,
                        T* __restrict__ out, T* __restrict__ chunk_out, int L, int B) {
  constexpr int C = kPhase1AggregateChunks;
  constexpr int W = kPhase1AggregateWarps;
  constexpr int kSlotStride = (W > 1 ? W / 2 : 1) * kLaneThreads;  // row stride of the slots
  extern __shared__ __align__(16) unsigned char shared_raw[];
  T* handed = reinterpret_cast<T*>(shared_raw);
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int z = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x % kLaneThreads;
  const int w = threadIdx.x / kLaneThreads;
  const int b = blockIdx.x * kLaneThreads + lane;
  const int Lc = (L + C - 1) / C;
  const int lo = min((z * W + w) * Lc, L);
  const int hi = b < B ? min(lo + Lc, L) : lo;  // a lane past the last block folds nothing
  const int col = min(b, B - 1);
  Trans trans(params, rows, L, B, col);
  Elem<T, D> acc = fold_steps<T, D>(trans, y + col, s + col, lo, hi, B);
  if (b < B)
    store_elem(acc, chunk_out + static_cast<long long>(z * W + w) * Dims<D>::kElem * B + b, B);
#pragma unroll 1
  for (int span = 1; span < W; span *= 2) {
    T* slot = handed + (w / (2 * span)) * kLaneThreads + lane;
    if (w % (2 * span) == span) store_elem(acc, slot, kSlotStride);
    __syncthreads();
    if (w % (2 * span) == 0) acc = combine(acc, load_elem<T, D>(slot, kSlotStride));
    __syncthreads();
  }
#pragma unroll 1
  for (int span = 1; span < kPhase1AggregateCluster; span *= 2) {
    T* slot = handed + lane;
    if (w == 0 && z % (2 * span) == span) store_elem(acc, slot, kSlotStride);
    cluster.sync();
    if (w == 0 && z % (2 * span) == 0) {
      const T* remote = cluster.map_shared_rank(handed, z + span) + lane;
      acc = combine(acc, load_elem<T, D>(remote, kSlotStride));
    }
    cluster.sync();  // rank z + span's slot stays in place until it is read
  }
  if (w == 0 && z == 0 && b < B) store_elem(acc, out + b, B);
}

// K2's element policy for cluster_scan (scan.cuh): filtering elements,
// (K, B) aggregates, the prior element (0, m0, P0, 0, 0) applied as a state
// (apply_elem), starts written as (m, P) rows.
template <typename T, int D>
struct ElemScan {
  using Scalar = T;
  using Element = Elem<T, D>;
  struct State {
    Vec<T, D> m;
    Mat<T, D> P;
  };
  static constexpr int kRows = Dims<D>::kElem;
  const T* comps;
  const T* prior;
  T* starts;
  int B;
  __device__ Element identity() const { return identity_elem<T, D>(); }
  __device__ Element combine(const Element& ei, const Element& ej) const {
    return tgps::combine(ei, ej);
  }
  __device__ Element shfl_up(const Element& e, int delta) const { return shfl_up_elem(e, delta); }
  __device__ Element load(const T* base, long long stride) const {
    return load_elem<T, D>(base, stride);
  }
  __device__ void store(const Element& e, T* base, long long stride) const {
    store_elem(e, base, stride);
  }
  __device__ Element load_agg(int b) const { return load_elem<T, D>(comps + b, B); }
  __device__ State prior_state() const {
    State s;
    load_state(prior, 1, s.m, s.P);
    return s;
  }
  __device__ void apply(State& s, const Element& e) const { apply_elem(s.m, s.P, e); }
  __device__ void store_start(const State& s, int b) const { store_state(s.m, s.P, starts + b, B); }
};

// Exclusive prefix of the B block aggregates, seeded with the prior element
// (0, m0, P0, 0, 0): starts[b] = prior ∘ agg_0 ∘ ... ∘ agg_{b-1}, written as
// (m, P) rows, by one cluster of kPhase2Cluster thread blocks of
// kPhase2Warps warps (cluster_scan).
template <typename T, int D>
__global__ void __cluster_dims__(kPhase2Cluster, 1, 1)
__launch_bounds__(kLaneThreads * kPhase2Warps)
phase2_starts_kernel(const T* __restrict__ comps, const T* __restrict__ prior,
                     T* __restrict__ starts, int B) {
  using P = ElemScan<T, D>;
  __shared__ T shared[scan_shared_rows<P, kPhase2Cluster, kPhase2Warps>()];
  cluster_scan<kPhase2Cluster, kPhase2Warps, kPhase2Fold, false>(P{comps, prior, starts, B}, B,
                                                                 shared, nullptr);
}

// Warp w of the thread block of cluster rank z in cluster x takes chunk
// c = z W + w of K1's chunks: steps [c Lc, min((c+1) Lc, L)), Lc =
// ceil(L / C), of block b = 32x + lane. (1) It loads the block's start and
// pushes it through K1's aggregates of chunks 0 .. c-1, left to right
// (apply_elem: the state part of (0, m, P, 0, 0) combined with each); the
// parameters are loaded after this, so they are not live across it. (2) It
// runs kalman_step over its chunk, summing the lml from zero, with y and s
// loaded one step ahead. (3) Warp 0 of rank 0 adds the C partial sums in
// chunk order, 0 .. C-1, from its own shared memory and the other ranks',
// and writes the block's lml. An empty chunk and a lane past the last block
// add zero but meet both cluster barriers.
template <typename T, int D, typename Trans>
__global__ void __cluster_dims__(1, 1, kPhase1AggregateCluster)
__launch_bounds__(kLaneThreads * kPhase1AggregateWarps)
phase3_lml_kernel(const T* __restrict__ y, const T* __restrict__ s,
                  const T* __restrict__ params, const T* __restrict__ rows,
                  const T* __restrict__ starts, const T* __restrict__ chunk_aggs,
                  T* __restrict__ lml, int L, int B) {
  constexpr int C = kPhase1AggregateChunks;
  constexpr int W = kPhase1AggregateWarps;
  __shared__ T partials[W * kLaneThreads];  // one partial sum a thread
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int z = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x % kLaneThreads;
  const int w = threadIdx.x / kLaneThreads;
  const int c = z * W + w;
  const int b = blockIdx.x * kLaneThreads + lane;
  const int Lc = (L + C - 1) / C;
  const int lo = min(c * Lc, L);
  const int hi = b < B ? min(lo + Lc, L) : lo;  // a lane past the last block runs nothing
  T acc = T(0);
  if (lo < hi) {
    // The stream values of each step are loaded one step ahead, the first
    // step's before the start chain, so no step waits a trip to memory.
    T s_next = s[static_cast<long long>(lo) * B + b];
    T y_next = y[static_cast<long long>(lo) * B + b];
    Vec<T, D> m;
    Mat<T, D> P;
    load_state(starts + b, B, m, P);
    const long long chunk_stride = static_cast<long long>(Dims<D>::kElem) * B;
#pragma unroll 1
    for (int i = 0; i < c; ++i) apply_elem(m, P, load_elem<T, D>(chunk_aggs + i * chunk_stride + b, B));
    Trans trans(params, rows, L, B, b);
    for_steps(trans, lo, hi, [&](int l, const Params<T, D>& p) {
      const T s_l = s_next, y_l = y_next;
      if (l + 1 < hi) {
        s_next = s[static_cast<long long>(l + 1) * B + b];
        y_next = y[static_cast<long long>(l + 1) * B + b];
      }
      acc += kalman_step(m, P, p, s_l, y_l);
    });
  }
  partials[w * kLaneThreads + lane] = acc;
  cluster.sync();
  if (z == 0 && w == 0 && b < B) {
    T total = T(0);
#pragma unroll 1
    for (int i = 0; i < C; ++i)
      total += cluster.map_shared_rank(partials, i / W)[(i % W) * kLaneThreads + lane];
    lml[b] = total;
  }
  cluster.sync();  // the other ranks' partial sums stay in place until they are read
}

inline int lane_grid(int B) { return (B + kLaneThreads - 1) / kLaneThreads; }

template <typename T, int D, typename Trans>
int launch_phase1_t(const T* y, const T* s, const T* params, const T* rows, T* out,
                    T* chunk_out, int L, int B, cudaStream_t stream) {
  const int bytes = phase1_aggregate_shared_bytes<T, D>();
  const cudaError_t err = cudaFuncSetAttribute(
      phase1_aggregate_kernel<T, D, Trans>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(lane_grid(B), 1, kPhase1AggregateCluster);
  phase1_aggregate_kernel<T, D, Trans>
      <<<grid, kLaneThreads * kPhase1AggregateWarps, bytes, stream>>>(y, s, params, rows, out,
                                                                      chunk_out, L, B);
  return static_cast<int>(cudaGetLastError());
}

// rows: the (KT, L, B) transition rows of the streamed form, or null for
// the constant one.
template <typename T, int D>
int launch_phase1_d(const T* y, const T* s, const T* params, const T* rows, T* out,
                    T* chunk_out, int L, int B, cudaStream_t stream) {
  if (rows != nullptr)
    return launch_phase1_t<T, D, StreamedTrans<T, D>>(y, s, params, rows, out, chunk_out, L, B,
                                                      stream);
  return launch_phase1_t<T, D, ConstantTrans<T, D>>(y, s, params, rows, out, chunk_out, L, B,
                                                    stream);
}

template <typename T>
int launch_phase1(const T* y, const T* s, const T* params, const T* rows, T* out, T* chunk_out,
                  int L, int B, int D, int chunks, cudaStream_t stream) {
  if (L < 1 || B < 1 || chunks != kPhase1AggregateChunks)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 1: return launch_phase1_d<T, 1>(y, s, params, rows, out, chunk_out, L, B, stream);
    case 2: return launch_phase1_d<T, 2>(y, s, params, rows, out, chunk_out, L, B, stream);
    case 3: return launch_phase1_d<T, 3>(y, s, params, rows, out, chunk_out, L, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_phase2(const T* comps, const T* prior, T* starts, int B, int D, cudaStream_t stream) {
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int threads = kLaneThreads * kPhase2Warps;
  switch (D) {
    case 1: phase2_starts_kernel<T, 1><<<kPhase2Cluster, threads, 0, stream>>>(comps, prior, starts, B); break;
    case 2: phase2_starts_kernel<T, 2><<<kPhase2Cluster, threads, 0, stream>>>(comps, prior, starts, B); break;
    case 3: phase2_starts_kernel<T, 3><<<kPhase2Cluster, threads, 0, stream>>>(comps, prior, starts, B); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
void launch_phase3_d(const T* y, const T* s, const T* params, const T* rows, const T* starts,
                     const T* chunk_aggs, T* lml, int L, int B, cudaStream_t stream) {
  const dim3 grid(lane_grid(B), 1, kPhase1AggregateCluster);
  constexpr int threads = kLaneThreads * kPhase1AggregateWarps;
  if (rows != nullptr)
    phase3_lml_kernel<T, D, StreamedTrans<T, D>><<<grid, threads, 0, stream>>>(
        y, s, params, rows, starts, chunk_aggs, lml, L, B);
  else
    phase3_lml_kernel<T, D, ConstantTrans<T, D>><<<grid, threads, 0, stream>>>(
        y, s, params, rows, starts, chunk_aggs, lml, L, B);
}

template <typename T>
int launch_phase3(const T* y, const T* s, const T* params, const T* rows, const T* starts,
                  const T* chunk_aggs, T* lml, int L, int B, int D, int chunks,
                  cudaStream_t stream) {
  if (L < 1 || B < 1 || chunks != kPhase1AggregateChunks)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 1: launch_phase3_d<T, 1>(y, s, params, rows, starts, chunk_aggs, lml, L, B, stream); break;
    case 2: launch_phase3_d<T, 2>(y, s, params, rows, starts, chunk_aggs, lml, L, B, stream); break;
    case 3: launch_phase3_d<T, 3>(y, s, params, rows, starts, chunk_aggs, lml, L, B, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tgps

extern "C" {

int tgps_phase1_aggregate_f32(const float* y, const float* s, const float* params,
                              const float* rows, float* out, float* chunk_out, int L, int B,
                              int D, int chunks, void* stream) {
  return tgps::launch_phase1<float>(y, s, params, rows, out, chunk_out, L, B, D, chunks,
                                    static_cast<cudaStream_t>(stream));
}

int tgps_phase1_aggregate_f64(const double* y, const double* s, const double* params,
                              const double* rows, double* out, double* chunk_out, int L, int B,
                              int D, int chunks, void* stream) {
  return tgps::launch_phase1<double>(y, s, params, rows, out, chunk_out, L, B, D, chunks,
                                     static_cast<cudaStream_t>(stream));
}

int tgps_phase2_starts_f32(const float* comps, const float* prior, float* starts, int B, int D,
                           void* stream) {
  return tgps::launch_phase2<float>(comps, prior, starts, B, D, static_cast<cudaStream_t>(stream));
}

int tgps_phase2_starts_f64(const double* comps, const double* prior, double* starts, int B,
                           int D, void* stream) {
  return tgps::launch_phase2<double>(comps, prior, starts, B, D, static_cast<cudaStream_t>(stream));
}

int tgps_phase3_lml_f32(const float* y, const float* s, const float* params, const float* rows,
                        const float* starts, const float* chunk_aggs, float* lml, int L, int B,
                        int D, int chunks, void* stream) {
  return tgps::launch_phase3<float>(y, s, params, rows, starts, chunk_aggs, lml, L, B, D, chunks,
                                    static_cast<cudaStream_t>(stream));
}

int tgps_phase3_lml_f64(const double* y, const double* s, const double* params,
                        const double* rows, const double* starts, const double* chunk_aggs,
                        double* lml, int L, int B, int D, int chunks, void* stream) {
  return tgps::launch_phase3<double>(y, s, params, rows, starts, chunk_aggs, lml, L, B, D,
                                     chunks, static_cast<cudaStream_t>(stream));
}

const char* tgps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
