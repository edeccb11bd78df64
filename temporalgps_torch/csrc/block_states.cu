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
// step l of block b at k*L*B + l*B + b. Aggregates are (KT, B), starts
// (SD, B), and the states written after every step (SD, L, B), SD = D + D^2
// rows m, P. Each kernel launches on the caller's stream and allocates
// nothing; each C entry returns cudaGetLastError() after its launch.
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
// K10 runs one thread per block, like K3: a thread reads and writes its
// block's rows at l*B + b, so a warp touches 32 neighbouring addresses in
// every row. On paper it is bound by bytes (it reads KT and writes SD values
// a step, a few hundred flops at D = 3); with B = 2048 threads on 132 SMs it
// is bound in practice by the latency of the serial per-block recursion,
// which one warp per thread block spreads over as many schedulers as there
// are warps. K9 is one thread block, as K2 (see below).
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

namespace tgps {

constexpr int kStateThreads = 32;        // K7, K8: lanes a warp; K10: one warp per thread block
constexpr int kAffineScanThreads = 128;  // K9: threads of the single thread block
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
// K8: steps a thread loads ahead of the one it composes. More than one is no
// faster, and in double two spill out of the 128 registers a thread of a
// 512-thread block may have (probes/torch_chunk_sweep.py times 1 to 3).
constexpr int kAffinePrefetch = 1;

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
template <typename T, int D>
__global__ void __cluster_dims__(1, 1, kPhase3StatesCluster)
__launch_bounds__(kStateThreads * kPhase3StatesWarps)
phase3_states_kernel(const T* __restrict__ y, const T* __restrict__ s,
                     const T* __restrict__ params, const T* __restrict__ starts,
                     T* __restrict__ out, int L, int B) {
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
  const Params<T, D> p = load_params<T, D>(params);
  const int Lc = (L + C - 1) / C;
  const int lo = min(c * Lc, L);
  const int hi = b < B ? min(lo + Lc, L) : lo;  // a lane past the last block does nothing

  const Elem<T, D> agg = fold_steps(p, y + col, s + col, lo, c < C - 1 ? hi : lo, B);
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
  for (int l = lo; l < hi; ++l) {
    const long long i = static_cast<long long>(l) * B + b;
    kalman_step(m, P, p, s[i], y[i]);
    store_state(m, P, out + i, LB);
  }
}

// Warp w of a thread block folds steps [w*Lc, min((w+1)*Lc, L)), Lc =
// ceil(L / C), of block b = 32 * blockIdx.x + lane, from the identity map (an
// empty chunk stays that), with the loads of the next U steps issued before
// each composition: a ring of U register sets, slot u holding step l0 + u.
// The C chunk maps are then combined as K4 combines its chunks: a
// log2(C)-level tree in shared memory, the earlier chunk always on the left.
template <typename T, int D>
__global__ void __launch_bounds__(kStateThreads * kAffineChunks)
affine_phase1_kernel(const T* __restrict__ params, T* __restrict__ out, int L, int B) {
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

// Exclusive prefix of the B aggregates seeded with x0, the element
// (0, m0, P0): starts[b] = x0 then agg_0, ..., agg_{b-1}, written as (m, P)
// rows. Composition is associative but not commutative, so every step keeps
// the earlier operand on the left.
//
// The reference holds all (KT, B) aggregates in TPU VMEM; at B = 2048 in
// double that is 344 KB, above the 227 KB of shared memory a thread block may
// have. So the scan is two-level, as K2's: (1) each thread folds a contiguous
// run of ceil(B / kAffineScanThreads) aggregates; (2) an inclusive
// Hillis-Steele scan of the partials in shared memory (KT x 128 values:
// 21.5 KB in double at D = 3); (3) each thread re-folds its run from its
// exclusive prefix, seeded with x0, writing each block's start on the way.
template <typename T, int D>
__global__ void __launch_bounds__(kAffineScanThreads)
affine_phase2_starts_kernel(const T* __restrict__ agg, const T* __restrict__ prior,
                            T* __restrict__ starts, int B) {
  __shared__ T partials[Dims<D>::kAffine * kAffineScanThreads];
  const int t = threadIdx.x;
  const int run = (B + kAffineScanThreads - 1) / kAffineScanThreads;
  const int lo = min(t * run, B);
  const int hi = min(lo + run, B);

  Affine<T, D> own = identity_affine<T, D>();
  for (int b = lo; b < hi; ++b) own = affine_combine(own, load_affine<T, D>(agg + b, B));

  store_affine(own, partials + t, kAffineScanThreads);
  __syncthreads();
  for (int offset = 1; offset < kAffineScanThreads; offset <<= 1) {
    Affine<T, D> next = own;
    if (t >= offset) {
      next = affine_combine(load_affine<T, D>(partials + (t - offset), kAffineScanThreads), own);
    }
    __syncthreads();
    own = next;
    store_affine(own, partials + t, kAffineScanThreads);
    __syncthreads();
  }

  Affine<T, D> state;
  state.A = zeros_mat<T, D>();
  load_state(prior, 1, state.b, state.C);
  if (t > 0) {
    state = affine_combine(state, load_affine<T, D>(partials + (t - 1), kAffineScanThreads));
  }
  for (int b = lo; b < hi; ++b) {
    store_state(state.b, state.C, starts + b, B);
    state = affine_combine(state, load_affine<T, D>(agg + b, B));
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kStateThreads)
affine_phase3_states_kernel(const T* __restrict__ params, const T* __restrict__ starts,
                            T* __restrict__ out, int L, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const long long LB = static_cast<long long>(L) * B;
  Vec<T, D> m;
  Mat<T, D> P;
  load_state(starts + b, B, m, P);
  for (int l = 0; l < L; ++l) {
    const long long i = static_cast<long long>(l) * B + b;
    affine_step(m, P, load_affine<T, D>(params + i, LB));
    store_state(m, P, out + i, LB);
  }
}

inline int state_grid(int B) { return (B + kStateThreads - 1) / kStateThreads; }

template <typename T, int D>
int launch_phase3_states_d(const T* y, const T* s, const T* params, const T* starts, T* out,
                           int L, int B, cudaStream_t stream) {
  const int bytes = phase3_states_shared_bytes<T, D>();
  const cudaError_t err = cudaFuncSetAttribute(
      phase3_states_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(state_grid(B), 1, kPhase3StatesCluster);
  phase3_states_kernel<T, D><<<grid, kStateThreads * kPhase3StatesWarps, bytes, stream>>>(
      y, s, params, starts, out, L, B);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_phase3_states(const T* y, const T* s, const T* params, const T* starts, T* out,
                         int L, int B, int D, int chunks, cudaStream_t stream) {
  if (L < 1 || B < 1 || chunks != kPhase3StatesChunks)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 1: return launch_phase3_states_d<T, 1>(y, s, params, starts, out, L, B, stream);
    case 2: return launch_phase3_states_d<T, 2>(y, s, params, starts, out, L, B, stream);
    case 3: return launch_phase3_states_d<T, 3>(y, s, params, starts, out, L, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_affine_phase1(const T* params, T* out, int L, int B, int D, int chunks,
                         cudaStream_t stream) {
  if (L < 1 || B < 1 || chunks != kAffineChunks) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int threads = kStateThreads * kAffineChunks;
  switch (D) {
    case 1: affine_phase1_kernel<T, 1><<<state_grid(B), threads, 0, stream>>>(params, out, L, B); break;
    case 2: affine_phase1_kernel<T, 2><<<state_grid(B), threads, 0, stream>>>(params, out, L, B); break;
    case 3: affine_phase1_kernel<T, 3><<<state_grid(B), threads, 0, stream>>>(params, out, L, B); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_affine_phase2(const T* agg, const T* prior, T* starts, int B, int D,
                         cudaStream_t stream) {
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 1: affine_phase2_starts_kernel<T, 1><<<1, kAffineScanThreads, 0, stream>>>(agg, prior, starts, B); break;
    case 2: affine_phase2_starts_kernel<T, 2><<<1, kAffineScanThreads, 0, stream>>>(agg, prior, starts, B); break;
    case 3: affine_phase2_starts_kernel<T, 3><<<1, kAffineScanThreads, 0, stream>>>(agg, prior, starts, B); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_affine_phase3(const T* params, const T* starts, T* out, int L, int B, int D,
                         cudaStream_t stream) {
  if (L < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 1: affine_phase3_states_kernel<T, 1><<<state_grid(B), kStateThreads, 0, stream>>>(params, starts, out, L, B); break;
    case 2: affine_phase3_states_kernel<T, 2><<<state_grid(B), kStateThreads, 0, stream>>>(params, starts, out, L, B); break;
    case 3: affine_phase3_states_kernel<T, 3><<<state_grid(B), kStateThreads, 0, stream>>>(params, starts, out, L, B); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tgps

extern "C" {

int tgps_phase3_states_f32(const float* y, const float* s, const float* params,
                           const float* starts, float* out, int L, int B, int D, int chunks,
                           void* stream) {
  return tgps::launch_phase3_states<float>(y, s, params, starts, out, L, B, D, chunks,
                                           static_cast<cudaStream_t>(stream));
}

int tgps_phase3_states_f64(const double* y, const double* s, const double* params,
                           const double* starts, double* out, int L, int B, int D, int chunks,
                           void* stream) {
  return tgps::launch_phase3_states<double>(y, s, params, starts, out, L, B, D, chunks,
                                            static_cast<cudaStream_t>(stream));
}

int tgps_affine_phase1_f32(const float* params, float* out, int L, int B, int D, int chunks,
                           void* stream) {
  return tgps::launch_affine_phase1<float>(params, out, L, B, D, chunks,
                                           static_cast<cudaStream_t>(stream));
}

int tgps_affine_phase1_f64(const double* params, double* out, int L, int B, int D, int chunks,
                           void* stream) {
  return tgps::launch_affine_phase1<double>(params, out, L, B, D, chunks,
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

int tgps_affine_phase3_states_f32(const float* params, const float* starts, float* out, int L,
                                  int B, int D, void* stream) {
  return tgps::launch_affine_phase3<float>(params, starts, out, L, B, D,
                                           static_cast<cudaStream_t>(stream));
}

int tgps_affine_phase3_states_f64(const double* params, const double* starts, double* out, int L,
                                  int B, int D, void* stream) {
  return tgps::launch_affine_phase3<double>(params, starts, out, L, B, D,
                                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
