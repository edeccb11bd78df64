// Unrolled small-matrix Kalman algebra as device functions, templated on the
// scalar type T (float or double) and the state dimension D (1..3).
//
// The same algebra as temporalgps_torch/ops/lanes.py (the plain versions),
// in the same order of operations; nvcc may contract a*b+c into one fused
// multiply-add where the CPU rounds twice, so results agree to rounding, not
// bit for bit. One thread holds one block's matrices in registers.
#pragma once

#include <cuda_runtime.h>

namespace tgps {

template <int D>
struct Dims {
  static constexpr int kElem = 3 * D * D + 2 * D;    // filtering-element rows
  static constexpr int kState = D + D * D;           // state rows (m, P)
  static constexpr int kParams = 2 * D * D + 2 * D + 1;
};

__device__ __forceinline__ float dev_log(float x) { return logf(x); }
__device__ __forceinline__ double dev_log(double x) { return log(x); }

template <typename T, int D>
struct Mat {
  T m[D][D];
};

template <typename T, int D>
struct Vec {
  T v[D];
};

template <typename T, int D>
__device__ __forceinline__ Mat<T, D> eye() {
  Mat<T, D> out;
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) out.m[i][j] = (i == j) ? T(1) : T(0);
  return out;
}

template <typename T, int D>
__device__ __forceinline__ Mat<T, D> zeros_mat() {
  Mat<T, D> out;
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) out.m[i][j] = T(0);
  return out;
}

template <typename T, int D>
__device__ __forceinline__ Vec<T, D> zeros_vec() {
  Vec<T, D> out;
#pragma unroll
  for (int i = 0; i < D; ++i) out.v[i] = T(0);
  return out;
}

// X @ Y
template <typename T, int D>
__device__ __forceinline__ Mat<T, D> mm(const Mat<T, D>& X, const Mat<T, D>& Y) {
  Mat<T, D> out;
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      T acc = X.m[i][0] * Y.m[0][j];
#pragma unroll
      for (int k = 1; k < D; ++k) acc += X.m[i][k] * Y.m[k][j];
      out.m[i][j] = acc;
    }
  return out;
}

// X @ Y^T
template <typename T, int D>
__device__ __forceinline__ Mat<T, D> mmT(const Mat<T, D>& X, const Mat<T, D>& Y) {
  Mat<T, D> out;
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      T acc = X.m[i][0] * Y.m[j][0];
#pragma unroll
      for (int k = 1; k < D; ++k) acc += X.m[i][k] * Y.m[j][k];
      out.m[i][j] = acc;
    }
  return out;
}

// X^T @ Y
template <typename T, int D>
__device__ __forceinline__ Mat<T, D> mTm(const Mat<T, D>& X, const Mat<T, D>& Y) {
  Mat<T, D> out;
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      T acc = X.m[0][i] * Y.m[0][j];
#pragma unroll
      for (int k = 1; k < D; ++k) acc += X.m[k][i] * Y.m[k][j];
      out.m[i][j] = acc;
    }
  return out;
}

// X @ x
template <typename T, int D>
__device__ __forceinline__ Vec<T, D> mv(const Mat<T, D>& X, const Vec<T, D>& x) {
  Vec<T, D> out;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    T acc = X.m[i][0] * x.v[0];
#pragma unroll
    for (int j = 1; j < D; ++j) acc += X.m[i][j] * x.v[j];
    out.v[i] = acc;
  }
  return out;
}

// X^T @ x
template <typename T, int D>
__device__ __forceinline__ Vec<T, D> mTv(const Mat<T, D>& X, const Vec<T, D>& x) {
  Vec<T, D> out;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    T acc = X.m[0][i] * x.v[0];
#pragma unroll
    for (int j = 1; j < D; ++j) acc += X.m[j][i] * x.v[j];
    out.v[i] = acc;
  }
  return out;
}

template <typename T, int D>
__device__ __forceinline__ T vdot(const Vec<T, D>& a, const Vec<T, D>& b) {
  T acc = a.v[0] * b.v[0];
#pragma unroll
  for (int i = 1; i < D; ++i) acc += a.v[i] * b.v[i];
  return acc;
}

template <typename T, int D>
__device__ __forceinline__ Mat<T, D> outer(const Vec<T, D>& a, const Vec<T, D>& b) {
  Mat<T, D> out;
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) out.m[i][j] = a.v[i] * b.v[j];
  return out;
}

template <typename T, int D>
__device__ __forceinline__ Mat<T, D> madd(const Mat<T, D>& X, const Mat<T, D>& Y) {
  Mat<T, D> out;
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) out.m[i][j] = X.m[i][j] + Y.m[i][j];
  return out;
}

template <typename T, int D>
__device__ __forceinline__ Mat<T, D> msub(const Mat<T, D>& X, const Mat<T, D>& Y) {
  Mat<T, D> out;
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) out.m[i][j] = X.m[i][j] - Y.m[i][j];
  return out;
}

template <typename T, int D>
__device__ __forceinline__ Mat<T, D> mscale(T c, const Mat<T, D>& X) {
  Mat<T, D> out;
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) out.m[i][j] = c * X.m[i][j];
  return out;
}

template <typename T, int D>
__device__ __forceinline__ Vec<T, D> vadd(const Vec<T, D>& a, const Vec<T, D>& b) {
  Vec<T, D> out;
#pragma unroll
  for (int i = 0; i < D; ++i) out.v[i] = a.v[i] + b.v[i];
  return out;
}

template <typename T, int D>
__device__ __forceinline__ Vec<T, D> vsub(const Vec<T, D>& a, const Vec<T, D>& b) {
  Vec<T, D> out;
#pragma unroll
  for (int i = 0; i < D; ++i) out.v[i] = a.v[i] - b.v[i];
  return out;
}

template <typename T, int D>
__device__ __forceinline__ Vec<T, D> vscale(T c, const Vec<T, D>& a) {
  Vec<T, D> out;
#pragma unroll
  for (int i = 0; i < D; ++i) out.v[i] = c * a.v[i];
  return out;
}

// 0.5 (X + X^T)
template <typename T, int D>
__device__ __forceinline__ Mat<T, D> sym(const Mat<T, D>& X) {
  Mat<T, D> out;
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) out.m[i][j] = T(0.5) * (X.m[i][j] + X.m[j][i]);
  return out;
}

// Adjugate inverse.
template <typename T, int D>
__device__ __forceinline__ Mat<T, D> inv(const Mat<T, D>& X) {
  static_assert(D >= 1 && D <= 3, "inv takes D in 1..3");
  Mat<T, D> out;
  if constexpr (D == 1) {
    out.m[0][0] = T(1) / X.m[0][0];
  } else if constexpr (D == 2) {
    const T det = X.m[0][0] * X.m[1][1] - X.m[0][1] * X.m[1][0];
    const T r = T(1) / det;
    out.m[0][0] = X.m[1][1] * r;
    out.m[0][1] = -X.m[0][1] * r;
    out.m[1][0] = -X.m[1][0] * r;
    out.m[1][1] = X.m[0][0] * r;
  } else {
    const T a = X.m[0][0], b = X.m[0][1], c = X.m[0][2];
    const T d = X.m[1][0], e = X.m[1][1], f = X.m[1][2];
    const T g = X.m[2][0], h = X.m[2][1], i = X.m[2][2];
    const T c00 = e * i - f * h;
    const T c01 = f * g - d * i;
    const T c02 = d * h - e * g;
    const T det = a * c00 + b * c01 + c * c02;
    const T r = T(1) / det;
    const T c10 = c * h - b * i;
    const T c11 = a * i - c * g;
    const T c12 = b * g - a * h;
    const T c20 = b * f - c * e;
    const T c21 = c * d - a * f;
    const T c22 = a * e - b * d;
    out.m[0][0] = c00 * r; out.m[0][1] = c10 * r; out.m[0][2] = c20 * r;
    out.m[1][0] = c01 * r; out.m[1][1] = c11 * r; out.m[1][2] = c21 * r;
    out.m[2][0] = c02 * r; out.m[2][1] = c12 * r; out.m[2][2] = c22 * r;
  }
  return out;
}

// Time-invariant transition (A, a, Q) and scalar emission (H, h).
template <typename T, int D>
struct Params {
  Mat<T, D> A;
  Vec<T, D> a;
  Mat<T, D> Q;
  Vec<T, D> H;
  T h;
};

// From the packed (PK,) layout: A (D*D, row-major), a (D), Q (D*D), H (D), h.
template <typename T, int D>
__device__ __forceinline__ Params<T, D> load_params(const T* __restrict__ p) {
  Params<T, D> out;
  int k = 0;
#pragma unroll
  for (int r = 0; r < D; ++r)
#pragma unroll
    for (int c = 0; c < D; ++c) out.A.m[r][c] = p[k++];
#pragma unroll
  for (int i = 0; i < D; ++i) out.a.v[i] = p[k++];
#pragma unroll
  for (int r = 0; r < D; ++r)
#pragma unroll
    for (int c = 0; c < D; ++c) out.Q.m[r][c] = p[k++];
#pragma unroll
  for (int i = 0; i < D; ++i) out.H.v[i] = p[k++];
  out.h = p[k];
  return out;
}

// Filtering element: the affine-Gaussian summary of a run of steps.
template <typename T, int D>
struct Elem {
  Mat<T, D> A;
  Vec<T, D> b;
  Mat<T, D> C;
  Vec<T, D> eta;
  Mat<T, D> J;
};

template <typename T, int D>
__device__ __forceinline__ Elem<T, D> identity_elem() {
  Elem<T, D> e;
  e.A = eye<T, D>();
  e.b = zeros_vec<T, D>();
  e.C = zeros_mat<T, D>();
  e.eta = zeros_vec<T, D>();
  e.J = zeros_mat<T, D>();
  return e;
}

// Component-major rows: row k of column `col` is base[k * stride] with base
// pointing at column col. Element rows: A, b, C, eta, J.
template <typename T, int D>
__device__ __forceinline__ Elem<T, D> load_elem(const T* base, long long stride) {
  Elem<T, D> e;
  int k = 0;
#pragma unroll
  for (int r = 0; r < D; ++r)
#pragma unroll
    for (int c = 0; c < D; ++c) e.A.m[r][c] = base[(k++) * stride];
#pragma unroll
  for (int i = 0; i < D; ++i) e.b.v[i] = base[(k++) * stride];
#pragma unroll
  for (int r = 0; r < D; ++r)
#pragma unroll
    for (int c = 0; c < D; ++c) e.C.m[r][c] = base[(k++) * stride];
#pragma unroll
  for (int i = 0; i < D; ++i) e.eta.v[i] = base[(k++) * stride];
#pragma unroll
  for (int r = 0; r < D; ++r)
#pragma unroll
    for (int c = 0; c < D; ++c) e.J.m[r][c] = base[(k++) * stride];
  return e;
}

template <typename T, int D>
__device__ __forceinline__ void store_elem(const Elem<T, D>& e, T* base, long long stride) {
  int k = 0;
#pragma unroll
  for (int r = 0; r < D; ++r)
#pragma unroll
    for (int c = 0; c < D; ++c) base[(k++) * stride] = e.A.m[r][c];
#pragma unroll
  for (int i = 0; i < D; ++i) base[(k++) * stride] = e.b.v[i];
#pragma unroll
  for (int r = 0; r < D; ++r)
#pragma unroll
    for (int c = 0; c < D; ++c) base[(k++) * stride] = e.C.m[r][c];
#pragma unroll
  for (int i = 0; i < D; ++i) base[(k++) * stride] = e.eta.v[i];
#pragma unroll
  for (int r = 0; r < D; ++r)
#pragma unroll
    for (int c = 0; c < D; ++c) base[(k++) * stride] = e.J.m[r][c];
}

// State rows: m (D), then P (D*D, row-major).
template <typename T, int D>
__device__ __forceinline__ void load_state(const T* base, long long stride, Vec<T, D>& m,
                                           Mat<T, D>& P) {
#pragma unroll
  for (int i = 0; i < D; ++i) m.v[i] = base[i * stride];
#pragma unroll
  for (int r = 0; r < D; ++r)
#pragma unroll
    for (int c = 0; c < D; ++c) P.m[r][c] = base[(D + r * D + c) * stride];
}

template <typename T, int D>
__device__ __forceinline__ void store_state(const Vec<T, D>& m, const Mat<T, D>& P, T* base,
                                            long long stride) {
#pragma unroll
  for (int i = 0; i < D; ++i) base[i * stride] = m.v[i];
#pragma unroll
  for (int r = 0; r < D; ++r)
#pragma unroll
    for (int c = 0; c < D; ++c) base[(D + r * D + c) * stride] = P.m[r][c];
}

// Filtering element of one step with scalar observation y, noise variance s.
template <typename T, int D>
__device__ __forceinline__ Elem<T, D> step_element(const Params<T, D>& p, T s, T y) {
  const Vec<T, D> QH = mv(p.Q, p.H);
  const T S = vdot(p.H, QH) + s;
  const T rS = T(1) / S;
  const Vec<T, D> K = vscale(rS, QH);
  const Mat<T, D> ImKH = msub(eye<T, D>(), outer(K, p.H));
  const T resid = y - (vdot(p.H, p.a) + p.h);
  const Vec<T, D> w = mTv(p.A, p.H);
  Elem<T, D> e;
  e.A = mm(ImKH, p.A);
  e.b = vadd(p.a, vscale(resid, K));
  e.C = sym(mm(ImKH, p.Q));
  e.eta = vscale(resid / S, w);
  e.J = mscale(rS, outer(w, w));
  return e;
}

// Associative, non-commutative combination: ei first, then ej.
template <typename T, int D>
__device__ __forceinline__ Elem<T, D> combine(const Elem<T, D>& ei, const Elem<T, D>& ej) {
  const Mat<T, D> CiJj = mm(ei.C, ej.J);
  const Mat<T, D> M = inv(madd(CiJj, eye<T, D>()));
  const Mat<T, D> AjM = mm(ej.A, M);
  const Mat<T, D> MAi = mm(M, ei.A);
  Elem<T, D> out;
  out.A = mm(ej.A, MAi);
  out.b = vadd(mv(AjM, vadd(ei.b, mv(ei.C, ej.eta))), ej.b);
  out.C = sym(madd(mmT(mm(AjM, ei.C), ej.A), ej.C));
  out.eta = vadd(mTv(MAi, vsub(ej.eta, mv(ej.J, ei.b))), ei.eta);
  out.J = sym(madd(mTm(MAi, mm(ej.J, ei.A)), ei.J));
  return out;
}

// Predict, scalar update (in place on m, P), and the step's log marginal
// likelihood.
template <typename T, int D>
__device__ __forceinline__ T kalman_step(Vec<T, D>& m, Mat<T, D>& P, const Params<T, D>& p,
                                         T s, T y) {
  const T kLog2Pi = T(1.8378770664093453);  // log(2 pi)
  const Vec<T, D> mp = vadd(mv(p.A, m), p.a);
  const Mat<T, D> Pp = madd(sym(mmT(mm(p.A, P), p.A)), p.Q);
  const Vec<T, D> V = mv(Pp, p.H);
  const T S = vdot(p.H, V) + s;
  const T resid = y - (vdot(p.H, mp) + p.h);
  const T lml = T(-0.5) * (kLog2Pi + dev_log(S) + resid * resid / S);
  const Vec<T, D> K = vscale(T(1) / S, V);
  m = vadd(mp, vscale(resid, K));
  P = sym(msub(Pp, outer(K, V)));
  return lml;
}

}  // namespace tgps
