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
// (1+k, B) lml rows. `rows` is (1+k, PK2) row-major: row 0 the packed primal
// parameters (its last slot unused: the noise is streamed), row 1+j tangent j
// of the parameters with the time-invariant noise tangent in the last slot.
// `priors` is (1+k, SD): (m0, P0) and its k tangents.
//
// k is a runtime number and registers are the scarce thing: one thread that
// carried the primal and k tangent elements would need (1+k)*K live values
// and could not be unrolled over k. So the tangents are spread over the
// grid: blockIdx.y = j, and thread (b, j) carries the primal and tangent j
// only. The primal is recomputed k times; the j = 0 threads write it. This
// also puts k times more warps in flight than K1 and K3 have.
//
// The noise tangent enters a step as ds * (s < kMaskThresh): a missing or
// padding step has the LARGE_VAR fill in the s stream, its lml is a constant
// that the caller's compensation adds back, and its derivative with respect
// to the noise must be exactly zero.
//
// All three are bound, like K1-K3, by the latency of a serial recursion.

#include "lanes.cuh"

namespace tgps {

constexpr int kJvpLaneThreads = 32;   // K4, K6: one warp per thread block
constexpr int kJvpScanThreads = 128;  // K5: threads of each tangent's thread block
constexpr double kMaskThresh = 1e14;  // LARGE_VAR / 10

template <typename T, int D>
__global__ void __launch_bounds__(kJvpLaneThreads)
phase1_jvp_kernel(const T* __restrict__ y, const T* __restrict__ s, const T* __restrict__ rows,
                  T* __restrict__ out, int L, int B) {
  constexpr int K = Dims<D>::kElem;
  constexpr int PK2 = Dims<D>::kParamsS;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  if (b >= B) return;
  const Params<T, D> p = load_params<T, D>(rows);
  const T* drow = rows + static_cast<long long>(1 + j) * PK2;
  const Params<T, D> dp = load_params<T, D>(drow);
  const T ds = drow[PK2 - 1];
  Elem<T, D> acc = identity_elem<T, D>();
  Elem<T, D> dacc = zero_elem<T, D>();
  for (int l = 0; l < L; ++l) {
    const long long i = static_cast<long long>(l) * B + b;
    const T s_l = s[i];
    const T ds_l = s_l < T(kMaskThresh) ? ds : T(0);
    const ElemJvp<T, D> e = step_element_jvp(p, dp, s_l, ds_l, y[i]);
    const ElemJvp<T, D> c = combine_jvp(acc, dacc, e.primal, e.tangent);
    acc = c.primal;
    dacc = c.tangent;
  }
  if (j == 0) store_elem(acc, out + b, B);
  store_elem(dacc, out + static_cast<long long>(1 + j) * K * B + b, B);
}

// Thread block j scans the primal aggregates and tangent j together, with
// the two-level schedule of K2 (block_phases.cu), so shared memory holds two
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

template <typename T, int D>
__global__ void __launch_bounds__(kJvpLaneThreads)
phase3_jvp_lml_kernel(const T* __restrict__ y, const T* __restrict__ s,
                      const T* __restrict__ rows, const T* __restrict__ starts,
                      T* __restrict__ lml, int L, int B) {
  constexpr int SD = Dims<D>::kState;
  constexpr int PK2 = Dims<D>::kParamsS;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  if (b >= B) return;
  const Params<T, D> p = load_params<T, D>(rows);
  const T* drow = rows + static_cast<long long>(1 + j) * PK2;
  const Params<T, D> dp = load_params<T, D>(drow);
  const T ds = drow[PK2 - 1];
  Vec<T, D> m, dm;
  Mat<T, D> P, dP;
  load_state(starts + b, B, m, P);
  load_state(starts + static_cast<long long>(1 + j) * SD * B + b, B, dm, dP);
  T acc = T(0), dacc = T(0);
  for (int l = 0; l < L; ++l) {
    const long long i = static_cast<long long>(l) * B + b;
    const T s_l = s[i];
    const T ds_l = s_l < T(kMaskThresh) ? ds : T(0);
    const LmlJvp<T> step = kalman_step_jvp(m, dm, P, dP, p, dp, s_l, ds_l, y[i]);
    acc += step.primal;
    dacc += step.tangent;
  }
  if (j == 0) lml[b] = acc;
  lml[static_cast<long long>(1 + j) * B + b] = dacc;
}

inline int jvp_lane_grid(int B) { return (B + kJvpLaneThreads - 1) / kJvpLaneThreads; }

template <typename T>
int launch_phase1_jvp(const T* y, const T* s, const T* rows, T* out, int L, int B, int D, int k,
                      cudaStream_t stream) {
  if (L < 1 || B < 1 || k < 1 || k > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(jvp_lane_grid(B), k);
  switch (D) {
    case 1: phase1_jvp_kernel<T, 1><<<grid, kJvpLaneThreads, 0, stream>>>(y, s, rows, out, L, B); break;
    case 2: phase1_jvp_kernel<T, 2><<<grid, kJvpLaneThreads, 0, stream>>>(y, s, rows, out, L, B); break;
    case 3: phase1_jvp_kernel<T, 3><<<grid, kJvpLaneThreads, 0, stream>>>(y, s, rows, out, L, B); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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
int launch_phase3_jvp(const T* y, const T* s, const T* rows, const T* starts, T* lml, int L,
                      int B, int D, int k, cudaStream_t stream) {
  if (L < 1 || B < 1 || k < 1 || k > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(jvp_lane_grid(B), k);
  switch (D) {
    case 1: phase3_jvp_lml_kernel<T, 1><<<grid, kJvpLaneThreads, 0, stream>>>(y, s, rows, starts, lml, L, B); break;
    case 2: phase3_jvp_lml_kernel<T, 2><<<grid, kJvpLaneThreads, 0, stream>>>(y, s, rows, starts, lml, L, B); break;
    case 3: phase3_jvp_lml_kernel<T, 3><<<grid, kJvpLaneThreads, 0, stream>>>(y, s, rows, starts, lml, L, B); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tgps

extern "C" {

int tgps_phase1_jvp_f32(const float* y, const float* s, const float* rows, float* out, int L,
                        int B, int D, int k, void* stream) {
  return tgps::launch_phase1_jvp<float>(y, s, rows, out, L, B, D, k,
                                        static_cast<cudaStream_t>(stream));
}

int tgps_phase1_jvp_f64(const double* y, const double* s, const double* rows, double* out, int L,
                        int B, int D, int k, void* stream) {
  return tgps::launch_phase1_jvp<double>(y, s, rows, out, L, B, D, k,
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
                            const float* starts, float* lml, int L, int B, int D, int k,
                            void* stream) {
  return tgps::launch_phase3_jvp<float>(y, s, rows, starts, lml, L, B, D, k,
                                        static_cast<cudaStream_t>(stream));
}

int tgps_phase3_jvp_lml_f64(const double* y, const double* s, const double* rows,
                            const double* starts, double* lml, int L, int B, int D, int k,
                            void* stream) {
  return tgps::launch_phase3_jvp<double>(y, s, rows, starts, lml, L, B, D, k,
                                         static_cast<cudaStream_t>(stream));
}

}  // extern "C"
