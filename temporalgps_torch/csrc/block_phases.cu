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
// levels go through distributed shared memory.
//
// K3 runs one thread per block and is bound by the latency of its serial
// per-block recursion: at B = 2048 blocks there are only 2048 threads. A
// thread block of one warp spreads those warps over as many SMs as there
// are warps, one scheduler each. K2 is one thread block (see below).

#include <cooperative_groups.h>

#include "lanes.cuh"

namespace tgps {

constexpr int kLaneThreads = 32;   // K1: lanes a warp; K3: one warp per thread block
constexpr int kScanThreads = 128;  // K2: threads of the single thread block
// K1: chunks of every block's steps, one per warp, and warps per thread
// block; a cluster of C / W thread blocks holds a block's C warps.
// ops/kernels.py passes its PHASE1_AGGREGATE_CHUNKS at the launch; the two must agree.
constexpr int kPhase1AggregateChunks = 16;
constexpr int kPhase1AggregateWarps = 8;
constexpr int kPhase1AggregateCluster = kPhase1AggregateChunks / kPhase1AggregateWarps;
static_assert((kPhase1AggregateWarps & (kPhase1AggregateWarps - 1)) == 0 &&
              (kPhase1AggregateCluster & (kPhase1AggregateCluster - 1)) == 0 &&
              kPhase1AggregateCluster * kPhase1AggregateWarps == kPhase1AggregateChunks,
              "the chunk tree takes 2^n chunks, W a thread block, 2^m thread blocks a cluster");

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
// barrier). The C chunk aggregates are then combined in a log2(C)-level
// tree, earlier chunk always on the left (combine is not commutative): at
// span 1, 2, 4, ..., chunk c with c % 2span == span hands its aggregate to
// chunk c - span, which combines it on the right of its own. The levels
// inside a thread block go through its shared memory, those across thread
// blocks through the cluster's (warp 0 of rank z reads rank z + span's
// slot). Warp 0 of rank 0 ends with the block's aggregate.
template <typename T, int D>
__global__ void __cluster_dims__(1, 1, kPhase1AggregateCluster)
__launch_bounds__(kLaneThreads * kPhase1AggregateWarps)
phase1_aggregate_kernel(const T* __restrict__ y, const T* __restrict__ s,
                        const T* __restrict__ params, T* __restrict__ out, int L, int B) {
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
  const Params<T, D> p = load_params<T, D>(params);
  const int Lc = (L + C - 1) / C;
  const int lo = min((z * W + w) * Lc, L);
  const int hi = b < B ? min(lo + Lc, L) : lo;  // a lane past the last block folds nothing
  const int col = min(b, B - 1);
  Elem<T, D> acc = fold_steps(p, y + col, s + col, lo, hi, B);
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

// Exclusive prefix of the B block aggregates, seeded with the prior element
// (0, m0, P0, 0, 0): starts[b] = prior ∘ agg_0 ∘ ... ∘ agg_{b-1}, written as
// (m, P) rows. combine is associative but not commutative, so every step
// keeps the earlier operand on the left.
//
// The reference holds all (K, B) aggregates in TPU VMEM; at B = 2048 in
// double that is 540 KB, above the 227 KB of shared memory a block may have.
// So the scan is two-level: (1) each thread folds a contiguous run of
// ceil(B / kScanThreads) aggregates; (2) an inclusive Hillis-Steele scan of
// the kScanThreads partials in shared memory (K x 128 values: 34 KB in
// double at D = 3); (3) each thread re-folds its run from its exclusive
// prefix, seeded with the prior, writing each block's start on the way.
template <typename T, int D>
__global__ void __launch_bounds__(kScanThreads)
phase2_starts_kernel(const T* __restrict__ comps, const T* __restrict__ prior,
                     T* __restrict__ starts, int B) {
  __shared__ T partials[Dims<D>::kElem * kScanThreads];
  const int t = threadIdx.x;
  const int run = (B + kScanThreads - 1) / kScanThreads;
  const int lo = min(t * run, B);
  const int hi = min(lo + run, B);

  Elem<T, D> own = identity_elem<T, D>();
  for (int b = lo; b < hi; ++b) own = combine(own, load_elem<T, D>(comps + b, B));

  store_elem(own, partials + t, kScanThreads);
  __syncthreads();
  for (int offset = 1; offset < kScanThreads; offset <<= 1) {
    Elem<T, D> next = own;
    if (t >= offset) next = combine(load_elem<T, D>(partials + (t - offset), kScanThreads), own);
    __syncthreads();
    own = next;
    store_elem(own, partials + t, kScanThreads);
    __syncthreads();
  }

  Elem<T, D> state;
  state.A = zeros_mat<T, D>();
  load_state(prior, 1, state.b, state.C);
  state.eta = zeros_vec<T, D>();
  state.J = zeros_mat<T, D>();
  if (t > 0) state = combine(state, load_elem<T, D>(partials + (t - 1), kScanThreads));
  for (int b = lo; b < hi; ++b) {
    store_state(state.b, state.C, starts + b, B);
    state = combine(state, load_elem<T, D>(comps + b, B));
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kLaneThreads)
phase3_lml_kernel(const T* __restrict__ y, const T* __restrict__ s,
                  const T* __restrict__ params, const T* __restrict__ starts,
                  T* __restrict__ lml, int L, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Params<T, D> p = load_params<T, D>(params);
  Vec<T, D> m;
  Mat<T, D> P;
  load_state(starts + b, B, m, P);
  T acc = T(0);
  for (int l = 0; l < L; ++l) {
    const long long i = static_cast<long long>(l) * B + b;
    acc += kalman_step(m, P, p, s[i], y[i]);
  }
  lml[b] = acc;
}

inline int lane_grid(int B) { return (B + kLaneThreads - 1) / kLaneThreads; }

template <typename T, int D>
int launch_phase1_d(const T* y, const T* s, const T* params, T* out, int L, int B,
                    cudaStream_t stream) {
  const int bytes = phase1_aggregate_shared_bytes<T, D>();
  const cudaError_t err = cudaFuncSetAttribute(
      phase1_aggregate_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(lane_grid(B), 1, kPhase1AggregateCluster);
  phase1_aggregate_kernel<T, D><<<grid, kLaneThreads * kPhase1AggregateWarps, bytes, stream>>>(
      y, s, params, out, L, B);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_phase1(const T* y, const T* s, const T* params, T* out, int L, int B, int D,
                  int chunks, cudaStream_t stream) {
  if (L < 1 || B < 1 || chunks != kPhase1AggregateChunks)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 1: return launch_phase1_d<T, 1>(y, s, params, out, L, B, stream);
    case 2: return launch_phase1_d<T, 2>(y, s, params, out, L, B, stream);
    case 3: return launch_phase1_d<T, 3>(y, s, params, out, L, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_phase2(const T* comps, const T* prior, T* starts, int B, int D, cudaStream_t stream) {
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 1: phase2_starts_kernel<T, 1><<<1, kScanThreads, 0, stream>>>(comps, prior, starts, B); break;
    case 2: phase2_starts_kernel<T, 2><<<1, kScanThreads, 0, stream>>>(comps, prior, starts, B); break;
    case 3: phase2_starts_kernel<T, 3><<<1, kScanThreads, 0, stream>>>(comps, prior, starts, B); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_phase3(const T* y, const T* s, const T* params, const T* starts, T* lml, int L,
                  int B, int D, cudaStream_t stream) {
  if (L < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 1: phase3_lml_kernel<T, 1><<<lane_grid(B), kLaneThreads, 0, stream>>>(y, s, params, starts, lml, L, B); break;
    case 2: phase3_lml_kernel<T, 2><<<lane_grid(B), kLaneThreads, 0, stream>>>(y, s, params, starts, lml, L, B); break;
    case 3: phase3_lml_kernel<T, 3><<<lane_grid(B), kLaneThreads, 0, stream>>>(y, s, params, starts, lml, L, B); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tgps

extern "C" {

int tgps_phase1_aggregate_f32(const float* y, const float* s, const float* params, float* out,
                              int L, int B, int D, int chunks, void* stream) {
  return tgps::launch_phase1<float>(y, s, params, out, L, B, D, chunks,
                                    static_cast<cudaStream_t>(stream));
}

int tgps_phase1_aggregate_f64(const double* y, const double* s, const double* params,
                              double* out, int L, int B, int D, int chunks, void* stream) {
  return tgps::launch_phase1<double>(y, s, params, out, L, B, D, chunks,
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

int tgps_phase3_lml_f32(const float* y, const float* s, const float* params, const float* starts,
                        float* lml, int L, int B, int D, void* stream) {
  return tgps::launch_phase3<float>(y, s, params, starts, lml, L, B, D,
                                    static_cast<cudaStream_t>(stream));
}

int tgps_phase3_lml_f64(const double* y, const double* s, const double* params,
                        const double* starts, double* lml, int L, int B, int D, void* stream) {
  return tgps::launch_phase3<double>(y, s, params, starts, lml, L, B, D,
                                     static_cast<cudaStream_t>(stream));
}

const char* tgps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
