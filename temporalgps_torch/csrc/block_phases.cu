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
// K1 and K3 run one thread per block and are bound by the latency of their
// serial per-block recursion: at B = 2048 blocks there are only 2048 threads.
// A thread block of one warp spreads those warps over as many SMs as there
// are warps, one scheduler each. K2 is one thread block (see below).

#include "lanes.cuh"

namespace tgps {

constexpr int kLaneThreads = 32;   // K1, K3: one warp per thread block
constexpr int kScanThreads = 128;  // K2: threads of the single thread block

template <typename T, int D>
__global__ void __launch_bounds__(kLaneThreads)
phase1_aggregate_kernel(const T* __restrict__ y, const T* __restrict__ s,
                        const T* __restrict__ params, T* __restrict__ out, int L, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Params<T, D> p = load_params<T, D>(params);
  Elem<T, D> acc = identity_elem<T, D>();
  for (int l = 0; l < L; ++l) {
    const long long i = static_cast<long long>(l) * B + b;
    acc = combine(acc, step_element(p, s[i], y[i]));
  }
  store_elem(acc, out + b, B);
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

template <typename T>
int launch_phase1(const T* y, const T* s, const T* params, T* out, int L, int B, int D,
                  cudaStream_t stream) {
  if (L < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 1: phase1_aggregate_kernel<T, 1><<<lane_grid(B), kLaneThreads, 0, stream>>>(y, s, params, out, L, B); break;
    case 2: phase1_aggregate_kernel<T, 2><<<lane_grid(B), kLaneThreads, 0, stream>>>(y, s, params, out, L, B); break;
    case 3: phase1_aggregate_kernel<T, 3><<<lane_grid(B), kLaneThreads, 0, stream>>>(y, s, params, out, L, B); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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
                              int L, int B, int D, void* stream) {
  return tgps::launch_phase1<float>(y, s, params, out, L, B, D, static_cast<cudaStream_t>(stream));
}

int tgps_phase1_aggregate_f64(const double* y, const double* s, const double* params,
                              double* out, int L, int B, int D, void* stream) {
  return tgps::launch_phase1<double>(y, s, params, out, L, B, D, static_cast<cudaStream_t>(stream));
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
