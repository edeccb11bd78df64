// The state-emitting phases of smoothing and prediction, written for Hopper
// (sm_90a), float and double, D in 1..3.
//
//   K7  phase3_states         replaces temporalgps_tpu/ops/pallas_kernels.py phase3_states
//   K8  affine_phase1         replaces temporalgps_tpu/ops/pallas_kernels.py affine_phase1
//   K9  affine_phase2_starts  replaces temporalgps_tpu/ops/pallas_kernels.py affine_phase2_starts
//   K10 affine_phase3_states  replaces temporalgps_tpu/ops/pallas_kernels.py affine_phase3_states
//
// Layout: y and s are (L, B) row-major streams, element l*B + b is step l of
// block b. Affine maps are (KT, L, B), KT = 2D^2 + D rows A, b, C: row k of
// step l of block b at k*L*B + l*B + b. Aggregates are (KT, B), K8's chunk
// aggregates (C, KT, B) (chunk c of block b, row k at (c*KT + k)*B + b),
// starts (SD, B), and the states written after every step (SD, L, B),
// SD = D + D^2 rows m, P. Each kernel launches on the caller's stream and
// allocates nothing; each C entry returns cudaGetLastError() after its launch.
//
// K7 is bound on paper by bytes (it writes SD values a step and does about
// 209 flops a step at D = 3), and one thread a block left it bound by the
// latency of an L-step serial recursion at B = 2048 threads. The recursion
// is not associative, but its chunks can start apart once their start
// states are known: each block's L steps are split into
// kPhase3StatesChunks = C chunks, one per warp (lane i of every warp takes
// block 32 * blockIdx.x + i, so reads and row stores stay coalesced), and in
// one launch (1) warp c folds its chunk's step elements as K1 does, (2) forms
// its chunk's start from the block start and the aggregates of chunks 0 ..
// c-1, which the C warps of 32 blocks share through shared memory (a cluster
// of C / kPhase3StatesWarps thread blocks: through distributed shared
// memory), and (3) replays the Kalman recursion over its chunk from that
// start, storing the state after every step. The serial chain becomes
// ceil(L / C) fold steps, at most C - 1 combines and ceil(L / C) replay steps.
//
// K7's streamed form (per-step (A, a, Q) read from (KT, L, B) rows, the
// StreamedTrans policy of lanes.cuh; a null rows pointer is the constant
// form) runs the same fold and replay, reading each step's row twice.
//
// K10 is bound by bytes: it reads KT and writes SD values a step and does
// about 135 flops with them at D = 3. One thread a block ran an L-step serial
// replay with one step of 21 rows in flight a thread, waiting one trip to
// device memory a step. It takes K7's scheme without K7's fold: K8 already
// holds each chunk's aggregate before its tree and writes them out, so warp c
// of a block group starts from the block start pushed through the maps of
// chunks 0 .. c-1 (at most C - 1 affine steps, read from L2) and replays its
// chunk of ceil(L / C) steps with the next step's rows loaded ahead, as K8
// does: C times the threads, and each with a step in flight. K10's chunk
// count is K8's (kAffineChunks).
//
// K9 is a scan of B affine aggregates of KT values (172 KB in float32 at
// B = 2048): bound on paper by bytes (0.1 us), in practice by the depth of
// its chain of dependent compositions. It is the cluster scan of scan.cuh,
// which K2 runs on filtering elements, on affine maps (21 values at D = 3):
// one aggregate a lane, a Kogge-Stone across a warp's lanes in shuffles,
// then across the warp totals and the cluster's thread-block totals. At
// B = 2048 one cluster of kAffineScanCluster thread blocks of
// kAffineScanWarps warps holds every aggregate: 5 + 3 + 3 dependent
// affine_combines and 3 affine_steps, in 80 registers in float and 158 in
// double at D = 3, no spill.
//
// K8 is bound by bytes: it reads KT values a step and does about 180 flops
// with them. One thread per block would keep one step of 21 rows a thread in
// flight, about 170 KB at B = 2048, where the memory needs about 3 MB (3.35
// TB/s times about 1 us of latency), and wait one trip to device memory a
// step. Composition is associative, so K8 splits each
// block's L steps into kAffineChunks contiguous chunks, one per warp of a
// thread block (lane i of every warp takes block 32 * blockIdx.x + i, so
// every row read stays one coalesced 32-lane access), has each thread load
// the next kAffinePrefetch steps before it composes the current one, and
// combines the chunk aggregates in order in shared memory. At B = 2048 that
// is 64 thread blocks of 16 warps, 32,768 threads, each with one step of 21
// rows in flight: 2.75 MB in float, 5.5 MB in double.

#include <cooperative_groups.h>

#include "lanes.cuh"
#include "scan.cuh"

namespace tgps {

constexpr int kStateThreads = 32;  // K7, K8, K10: lanes a warp
// K7: chunks of every block's steps, one per warp, and warps per thread
// block; a cluster of C / W thread blocks holds a block's C warps.
// ops/kernels.py passes its PHASE3_STATES_CHUNKS at the launch; the two must agree.
constexpr int kPhase3StatesChunks = 16;
constexpr int kPhase3StatesWarps = 8;
constexpr int kPhase3StatesCluster = kPhase3StatesChunks / kPhase3StatesWarps;
static_assert(kPhase3StatesCluster * kPhase3StatesWarps == kPhase3StatesChunks,
              "a cluster of C / W thread blocks holds the C chunks");
// K8: warps per thread block, each folding one chunk of every block's steps.
// ops/kernels.py passes its AFFINE_PHASE1_CHUNKS at the launch; the two must agree.
constexpr int kAffineChunks = 16;
static_assert((kAffineChunks & (kAffineChunks - 1)) == 0, "the chunk tree takes 2^n chunks");
// K8, K10: steps a thread loads ahead of the one it composes. More than one
// is no faster in K8, and in double two spill out of the 128 registers a
// thread of a 512-thread block may have (probes/torch_chunk_sweep.py times 1
// to 3).
constexpr int kAffinePrefetch = 1;
// K10: warps a thread block, each replaying one of the kAffineChunks chunks
// of the same 32 blocks; a grid of (ceil(B / 32), C / W) thread blocks. The
// warps share nothing, so W is free (probes/torch_chunk_sweep.py times 8 and
// 16).
constexpr int kAffinePhase3Warps = 8;
static_assert(kAffineChunks % kAffinePhase3Warps == 0, "W divides the chunk count");
// K9: thread blocks of its one cluster, warps a thread block, and the
// aggregates a lane folds before the scan (a round covers
// kAffineScanCluster * kAffineScanWarps * 32 * kAffineScanFold aggregates;
// a larger B takes several rounds in order).
constexpr int kAffineScanCluster = 8;
constexpr int kAffineScanWarps = 8;
constexpr int kAffineScanFold = 1;

// Shared memory of K7: every warp's chunk aggregate, K rows of 32 lanes a
// warp, read by the warps of later chunks.
template <typename T, int D>
constexpr int phase3_states_shared_bytes() {
  return Dims<D>::kElem * kPhase3StatesWarps * kStateThreads * static_cast<int>(sizeof(T));
}

// Warp w of the thread block of cluster rank z (blockIdx.z) takes chunk
// c = z W + w: steps [c Lc, min((c+1) Lc, L)), Lc = ceil(L / C), of block
// b = 32 * blockIdx.x + lane. (1) It folds them from the identity element
// into agg_c (the last chunk's aggregate is never read, so its warp skips
// the fold); (2) it forms its start as the state part (b, C) of
// (0, m_b, P_b, 0, 0) ∘ agg_0 ∘ ... ∘ agg_{c-1}, combined left to right,
// the seeding K2 does at block level; (3) it runs kalman_step from there
// over its chunk and stores the state after every step. An empty chunk
// stays the identity; a lane past the last block folds and replays nothing
// but meets every barrier.
template <typename T, int D, typename Trans>
__global__ void __cluster_dims__(1, 1, kPhase3StatesCluster)
__launch_bounds__(kStateThreads * kPhase3StatesWarps)
phase3_states_kernel(const T* __restrict__ y, const T* __restrict__ s,
                     const T* __restrict__ params, const T* __restrict__ rows,
                     const T* __restrict__ starts, T* __restrict__ out, int L, int B) {
  constexpr int C = kPhase3StatesChunks;
  constexpr int W = kPhase3StatesWarps;
  constexpr int kSlotStride = W * kStateThreads;  // row stride of the aggregates
  extern __shared__ __align__(16) unsigned char shared_raw[];
  T* aggs = reinterpret_cast<T*>(shared_raw);
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int z = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x % kStateThreads;
  const int w = threadIdx.x / kStateThreads;
  const int c = z * W + w;
  const int b = blockIdx.x * kStateThreads + lane;
  const int col = min(b, B - 1);
  const long long LB = static_cast<long long>(L) * B;
  Trans trans(params, rows, L, B, col);
  const int Lc = (L + C - 1) / C;
  const int lo = min(c * Lc, L);
  const int hi = b < B ? min(lo + Lc, L) : lo;  // a lane past the last block does nothing

  const Elem<T, D> agg = fold_steps<T, D>(trans, y + col, s + col, lo, c < C - 1 ? hi : lo, B);
  store_elem(agg, aggs + w * kStateThreads + lane, kSlotStride);

  Elem<T, D> state;
  state.A = zeros_mat<T, D>();
  load_state(starts + col, B, state.b, state.C);
  state.eta = zeros_vec<T, D>();
  state.J = zeros_mat<T, D>();
  cluster.sync();
#pragma unroll 1
  for (int j = 0; j < c; ++j) {
    const T* slot = cluster.map_shared_rank(aggs, j / W) + (j % W) * kStateThreads + lane;
    state = combine(state, load_elem<T, D>(slot, kSlotStride));
  }
  cluster.sync();  // every aggregate stays in place until the last chunk has read it

  Vec<T, D> m = state.b;
  Mat<T, D> P = state.C;
  for_steps(trans, lo, hi, [&](int l, const Params<T, D>& p) {
    const long long i = static_cast<long long>(l) * B + b;
    kalman_step(m, P, p, s[i], y[i]);
    store_state(m, P, out + i, LB);
  });
}

// Warp w of a thread block folds steps [w*Lc, min((w+1)*Lc, L)), Lc =
// ceil(L / C), of block b = 32 * blockIdx.x + lane, from the identity map (an
// empty chunk stays that), with the loads of the next U steps issued before
// each composition: a ring of U register sets, slot u holding step l0 + u.
// Each chunk map is stored to chunk_out (K10 starts its chunks from them),
// and the C chunk maps are then combined as K4 combines its chunks: a
// log2(C)-level tree in shared memory, the earlier chunk always on the left.
template <typename T, int D>
__global__ void __launch_bounds__(kStateThreads * kAffineChunks)
affine_phase1_kernel(const T* __restrict__ params, T* __restrict__ out,
                     T* __restrict__ chunk_out, int L, int B) {
  constexpr int C = kAffineChunks;
  constexpr int U = kAffinePrefetch;
  constexpr int kSlotStride = (C / 2) * kStateThreads;  // row stride of the hand-over slots
  __shared__ T handed[Dims<D>::kAffine * kSlotStride];
  const int lane = threadIdx.x % kStateThreads;
  const int w = threadIdx.x / kStateThreads;
  const int b = blockIdx.x * kStateThreads + lane;
  const long long LB = static_cast<long long>(L) * B;
  const int Lc = (L + C - 1) / C;
  const int lo = min(w * Lc, L);
  const int hi = b < B ? min(lo + Lc, L) : lo;  // a lane past the last block folds nothing
  const T* base = params + b;
  Affine<T, D> acc = identity_affine<T, D>();
  Affine<T, D> ahead[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    ahead[u] = identity_affine<T, D>();
    if (lo + u < hi) ahead[u] = load_affine<T, D>(base + static_cast<long long>(lo + u) * B, LB);
  }
  for (int l0 = lo; l0 < hi; l0 += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int l = l0 + u;
      if (l < hi) {
        const Affine<T, D> step = ahead[u];
        if (l + U < hi) ahead[u] = load_affine<T, D>(base + static_cast<long long>(l + U) * B, LB);
        acc = affine_combine(acc, step);
      }
    }
  }
  if (b < B)
    store_affine(acc, chunk_out + static_cast<long long>(w) * Dims<D>::kAffine * B + b, B);
#pragma unroll 1
  for (int span = 1; span < C; span *= 2) {
    T* slot = handed + (w / (2 * span)) * kStateThreads + lane;
    if (w % (2 * span) == span) store_affine(acc, slot, kSlotStride);
    __syncthreads();
    if (w % (2 * span) == 0) acc = affine_combine(acc, load_affine<T, D>(slot, kSlotStride));
    __syncthreads();
  }
  if (w == 0 && b < B) store_affine(acc, out + b, B);
}

// K9's element policy for cluster_scan (scan.cuh): affine maps, (KT, B)
// aggregates, x0 = (0, m0, P0) applied as a state (affine_step, the state
// part of a composition), starts written as (m, P) rows.
template <typename T, int D>
struct AffineScan {
  using Scalar = T;
  using Element = Affine<T, D>;
  struct State {
    Vec<T, D> m;
    Mat<T, D> P;
  };
  static constexpr int kRows = Dims<D>::kAffine;
  const T* agg;
  const T* prior;
  T* starts;
  int B;
  __device__ Element identity() const { return identity_affine<T, D>(); }
  __device__ Element combine(const Element& ei, const Element& ej) const {
    return affine_combine(ei, ej);
  }
  __device__ Element shfl_up(const Element& e, int delta) const { return shfl_up_affine(e, delta); }
  __device__ Element load(const T* base, long long stride) const {
    return load_affine<T, D>(base, stride);
  }
  __device__ void store(const Element& e, T* base, long long stride) const {
    store_affine(e, base, stride);
  }
  __device__ Element load_agg(int b) const { return load_affine<T, D>(agg + b, B); }
  __device__ State prior_state() const {
    State s;
    load_state(prior, 1, s.m, s.P);
    return s;
  }
  __device__ void apply(State& s, const Element& e) const { affine_step(s.m, s.P, e); }
  __device__ void store_start(const State& s, int b) const { store_state(s.m, s.P, starts + b, B); }
};

// Exclusive prefix of the B aggregates seeded with x0, the map (0, m0, P0):
// starts[b] = x0 then agg_0, ..., agg_{b-1}, written as (m, P) rows, by one
// cluster of kAffineScanCluster thread blocks of kAffineScanWarps warps
// (cluster_scan). Composition is associative but not commutative, so every
// level keeps the earlier operand on the left.
template <typename T, int D>
__global__ void __cluster_dims__(kAffineScanCluster, 1, 1)
__launch_bounds__(kStateThreads * kAffineScanWarps)
affine_phase2_starts_kernel(const T* __restrict__ agg, const T* __restrict__ prior,
                            T* __restrict__ starts, int B) {
  using P = AffineScan<T, D>;
  __shared__ T shared[scan_shared_rows<P, kAffineScanCluster, kAffineScanWarps>()];
  cluster_scan<kAffineScanCluster, kAffineScanWarps, kAffineScanFold, false>(
      P{agg, prior, starts, B}, B, shared, nullptr);
}

// Warp w of thread block (x, y) takes chunk c = y W + w: steps [c Lc,
// min((c+1) Lc, L)), Lc = ceil(L / C), of block b = 32x + lane. It pushes the
// block's start (m, P) through the maps of chunks 0 .. c-1 in order, each an
// affine_step (the state part of (0, m, P) composed with the chunk's map),
// then replays its chunk, storing the state after every step; the next map
// of either loop is loaded before the current one is applied. The warps
// share nothing: an empty chunk and a lane past the last block return at
// once.
template <typename T, int D>
__global__ void __launch_bounds__(kStateThreads * kAffinePhase3Warps)
affine_phase3_states_kernel(const T* __restrict__ params, const T* __restrict__ starts,
                            const T* __restrict__ chunk_aggs, T* __restrict__ out, int L,
                            int B) {
  constexpr int C = kAffineChunks;
  constexpr int U = kAffinePrefetch;
  const int lane = threadIdx.x % kStateThreads;
  const int c = blockIdx.y * kAffinePhase3Warps + threadIdx.x / kStateThreads;
  const int b = blockIdx.x * kStateThreads + lane;
  const int Lc = (L + C - 1) / C;
  const int lo = min(c * Lc, L);
  const int hi = min(lo + Lc, L);
  if (b >= B || lo >= hi) return;
  const long long LB = static_cast<long long>(L) * B;
  const T* base = params + b;
  Affine<T, D> ahead[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    ahead[u] = identity_affine<T, D>();
    if (lo + u < hi) ahead[u] = load_affine<T, D>(base + static_cast<long long>(lo + u) * B, LB);
  }
  Vec<T, D> m;
  Mat<T, D> P;
  load_state(starts + b, B, m, P);
  const long long chunk_stride = static_cast<long long>(Dims<D>::kAffine) * B;
  Affine<T, D> agg_next = identity_affine<T, D>();
  if (c > 0) agg_next = load_affine<T, D>(chunk_aggs + b, B);
#pragma unroll 1
  for (int j = 0; j < c; ++j) {
    const Affine<T, D> agg = agg_next;
    if (j + 1 < c) agg_next = load_affine<T, D>(chunk_aggs + (j + 1) * chunk_stride + b, B);
    affine_step(m, P, agg);
  }
  for (int l0 = lo; l0 < hi; l0 += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int l = l0 + u;
      if (l < hi) {
        const Affine<T, D> step = ahead[u];
        if (l + U < hi) ahead[u] = load_affine<T, D>(base + static_cast<long long>(l + U) * B, LB);
        affine_step(m, P, step);
        store_state(m, P, out + static_cast<long long>(l) * B + b, LB);
      }
    }
  }
}

inline int state_grid(int B) { return (B + kStateThreads - 1) / kStateThreads; }

template <typename T, int D, typename Trans>
int launch_phase3_states_t(const T* y, const T* s, const T* params, const T* rows,
                           const T* starts, T* out, int L, int B, cudaStream_t stream) {
  const int bytes = phase3_states_shared_bytes<T, D>();
  const cudaError_t err = cudaFuncSetAttribute(
      phase3_states_kernel<T, D, Trans>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(state_grid(B), 1, kPhase3StatesCluster);
  phase3_states_kernel<T, D, Trans><<<grid, kStateThreads * kPhase3StatesWarps, bytes, stream>>>(
      y, s, params, rows, starts, out, L, B);
  return static_cast<int>(cudaGetLastError());
}

// rows: the (KT, L, B) transition rows of the streamed form, or null for
// the constant one.
template <typename T, int D>
int launch_phase3_states_d(const T* y, const T* s, const T* params, const T* rows,
                           const T* starts, T* out, int L, int B, cudaStream_t stream) {
  if (rows != nullptr)
    return launch_phase3_states_t<T, D, StreamedTrans<T, D>>(y, s, params, rows, starts, out, L,
                                                             B, stream);
  return launch_phase3_states_t<T, D, ConstantTrans<T, D>>(y, s, params, rows, starts, out, L,
                                                           B, stream);
}

template <typename T>
int launch_phase3_states(const T* y, const T* s, const T* params, const T* rows,
                         const T* starts, T* out, int L, int B, int D, int chunks,
                         cudaStream_t stream) {
  if (L < 1 || B < 1 || chunks != kPhase3StatesChunks)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 1: return launch_phase3_states_d<T, 1>(y, s, params, rows, starts, out, L, B, stream);
    case 2: return launch_phase3_states_d<T, 2>(y, s, params, rows, starts, out, L, B, stream);
    case 3: return launch_phase3_states_d<T, 3>(y, s, params, rows, starts, out, L, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_affine_phase1(const T* params, T* out, T* chunk_out, int L, int B, int D, int chunks,
                         cudaStream_t stream) {
  if (L < 1 || B < 1 || chunks != kAffineChunks) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int threads = kStateThreads * kAffineChunks;
  switch (D) {
    case 1: affine_phase1_kernel<T, 1><<<state_grid(B), threads, 0, stream>>>(params, out, chunk_out, L, B); break;
    case 2: affine_phase1_kernel<T, 2><<<state_grid(B), threads, 0, stream>>>(params, out, chunk_out, L, B); break;
    case 3: affine_phase1_kernel<T, 3><<<state_grid(B), threads, 0, stream>>>(params, out, chunk_out, L, B); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_affine_phase2(const T* agg, const T* prior, T* starts, int B, int D,
                         cudaStream_t stream) {
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int threads = kStateThreads * kAffineScanWarps;
  switch (D) {
    case 1: affine_phase2_starts_kernel<T, 1><<<kAffineScanCluster, threads, 0, stream>>>(agg, prior, starts, B); break;
    case 2: affine_phase2_starts_kernel<T, 2><<<kAffineScanCluster, threads, 0, stream>>>(agg, prior, starts, B); break;
    case 3: affine_phase2_starts_kernel<T, 3><<<kAffineScanCluster, threads, 0, stream>>>(agg, prior, starts, B); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_affine_phase3(const T* params, const T* starts, const T* chunk_aggs, T* out, int L,
                         int B, int D, int chunks, cudaStream_t stream) {
  if (L < 1 || B < 1 || chunks != kAffineChunks) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(state_grid(B), kAffineChunks / kAffinePhase3Warps);
  constexpr int threads = kStateThreads * kAffinePhase3Warps;
  switch (D) {
    case 1: affine_phase3_states_kernel<T, 1><<<grid, threads, 0, stream>>>(params, starts, chunk_aggs, out, L, B); break;
    case 2: affine_phase3_states_kernel<T, 2><<<grid, threads, 0, stream>>>(params, starts, chunk_aggs, out, L, B); break;
    case 3: affine_phase3_states_kernel<T, 3><<<grid, threads, 0, stream>>>(params, starts, chunk_aggs, out, L, B); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tgps

extern "C" {

int tgps_phase3_states_f32(const float* y, const float* s, const float* params,
                           const float* rows, const float* starts, float* out, int L, int B,
                           int D, int chunks, void* stream) {
  return tgps::launch_phase3_states<float>(y, s, params, rows, starts, out, L, B, D, chunks,
                                           static_cast<cudaStream_t>(stream));
}

int tgps_phase3_states_f64(const double* y, const double* s, const double* params,
                           const double* rows, const double* starts, double* out, int L, int B,
                           int D, int chunks, void* stream) {
  return tgps::launch_phase3_states<double>(y, s, params, rows, starts, out, L, B, D, chunks,
                                            static_cast<cudaStream_t>(stream));
}

int tgps_affine_phase1_f32(const float* params, float* out, float* chunk_out, int L, int B,
                           int D, int chunks, void* stream) {
  return tgps::launch_affine_phase1<float>(params, out, chunk_out, L, B, D, chunks,
                                           static_cast<cudaStream_t>(stream));
}

int tgps_affine_phase1_f64(const double* params, double* out, double* chunk_out, int L, int B,
                           int D, int chunks, void* stream) {
  return tgps::launch_affine_phase1<double>(params, out, chunk_out, L, B, D, chunks,
                                            static_cast<cudaStream_t>(stream));
}

int tgps_affine_phase2_starts_f32(const float* agg, const float* prior, float* starts, int B,
                                  int D, void* stream) {
  return tgps::launch_affine_phase2<float>(agg, prior, starts, B, D,
                                           static_cast<cudaStream_t>(stream));
}

int tgps_affine_phase2_starts_f64(const double* agg, const double* prior, double* starts, int B,
                                  int D, void* stream) {
  return tgps::launch_affine_phase2<double>(agg, prior, starts, B, D,
                                            static_cast<cudaStream_t>(stream));
}

int tgps_affine_phase3_states_f32(const float* params, const float* starts,
                                  const float* chunk_aggs, float* out, int L, int B, int D,
                                  int chunks, void* stream) {
  return tgps::launch_affine_phase3<float>(params, starts, chunk_aggs, out, L, B, D, chunks,
                                           static_cast<cudaStream_t>(stream));
}

int tgps_affine_phase3_states_f64(const double* params, const double* starts,
                                  const double* chunk_aggs, double* out, int L, int B, int D,
                                  int chunks, void* stream) {
  return tgps::launch_affine_phase3<double>(params, starts, chunk_aggs, out, L, B, D, chunks,
                                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
