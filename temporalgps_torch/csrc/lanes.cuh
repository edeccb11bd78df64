// Unrolled small-matrix Kalman algebra as device functions, templated on the
// scalar type T (float or double) and the state dimension D (1..3).
//
// The same algebra as temporalgps_torch/ops/lanes.py (the plain versions),
// in the same order of operations; nvcc may contract a*b+c into one fused
// multiply-add where the CPU rounds twice, so results agree to rounding, not
// bit for bit. One thread holds one block's matrices in registers.
//
// Beside each of step_element, combine and kalman_step stands its tangent,
// *_jvp: the primal and ONE directional derivative from (primal inputs,
// tangent inputs), written out by hand at matrix level (the reference
// linearises the same functions in-kernel with jax.linearize; the plain
// versions get theirs from PyTorch's forward-mode autodiff).
#pragma once

#include <cuda_runtime.h>

namespace tgps {

template <int D>
struct Dims {
  static constexpr int kElem = 3 * D * D + 2 * D;    // filtering-element rows
  static constexpr int kState = D + D * D;           // state rows (m, P)
  static constexpr int kParams = 2 * D * D + 2 * D + 1;
  static constexpr int kParamsS = kParams + 1;       // params plus the noise slot
  static constexpr int kAffine = 2 * D * D + D;      // affine-map rows (A, b, C)
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

// Left fold of steps [lo, hi) of one block from the identity element; y and
// s point at the block's column of the (L, B) streams (an empty run stays the
// identity). K1 and K7 fold one chunk of a block's steps each with this.
template <typename T, int D>
__device__ __forceinline__ Elem<T, D> fold_steps(const Params<T, D>& p, const T* y, const T* s,
                                                 int lo, int hi, int B) {
  Elem<T, D> acc = identity_elem<T, D>();
  for (int l = lo; l < hi; ++l) {
    const long long i = static_cast<long long>(l) * B;
    acc = combine(acc, step_element(p, s[i], y[i]));
  }
  return acc;
}

// ---------------------------------------------------------------------------
// Tangents. Every *_jvp returns the primal (the same operations, in the same
// order, as the function above it) and its directional derivative along one
// tangent of the inputs. The observation y is data and carries no tangent.
// ---------------------------------------------------------------------------

template <typename T, int D>
__device__ __forceinline__ Elem<T, D> zero_elem() {
  Elem<T, D> e;
  e.A = zeros_mat<T, D>();
  e.b = zeros_vec<T, D>();
  e.C = zeros_mat<T, D>();
  e.eta = zeros_vec<T, D>();
  e.J = zeros_mat<T, D>();
  return e;
}

template <typename T, int D>
struct ElemJvp {
  Elem<T, D> primal;
  Elem<T, D> tangent;
};

// step_element and its tangent along (dp, ds). With r = 1/S:
//   dS = dH.QH + H.(dQ H + Q dH) + ds,   dr = -dS r^2,
//   dK = dr QH + r d(QH),   d(I - K H^T) = -(dK H^T + K dH^T),
// and the product rule for the five outputs; sym is linear.
template <typename T, int D>
__device__ __forceinline__ ElemJvp<T, D> step_element_jvp(const Params<T, D>& p,
                                                          const Params<T, D>& dp, T s, T ds,
                                                          T y) {
  const Vec<T, D> QH = mv(p.Q, p.H);
  const Vec<T, D> dQH = vadd(mv(dp.Q, p.H), mv(p.Q, dp.H));
  const T S = vdot(p.H, QH) + s;
  const T dS = vdot(dp.H, QH) + vdot(p.H, dQH) + ds;
  const T rS = T(1) / S;
  const T drS = -dS * rS * rS;
  const Vec<T, D> K = vscale(rS, QH);
  const Vec<T, D> dK = vadd(vscale(drS, QH), vscale(rS, dQH));
  const Mat<T, D> ImKH = msub(eye<T, D>(), outer(K, p.H));
  const Mat<T, D> dImKH = msub(zeros_mat<T, D>(), madd(outer(dK, p.H), outer(K, dp.H)));
  const T resid = y - (vdot(p.H, p.a) + p.h);
  const T dresid = -(vdot(dp.H, p.a) + vdot(p.H, dp.a) + dp.h);
  const Vec<T, D> w = mTv(p.A, p.H);
  const Vec<T, D> dw = vadd(mTv(dp.A, p.H), mTv(p.A, dp.H));
  const T c = resid / S;
  const T dc = dresid * rS + resid * drS;
  ElemJvp<T, D> out;
  out.primal.A = mm(ImKH, p.A);
  out.tangent.A = madd(mm(dImKH, p.A), mm(ImKH, dp.A));
  out.primal.b = vadd(p.a, vscale(resid, K));
  out.tangent.b = vadd(dp.a, vadd(vscale(dresid, K), vscale(resid, dK)));
  out.primal.C = sym(mm(ImKH, p.Q));
  out.tangent.C = sym(madd(mm(dImKH, p.Q), mm(ImKH, dp.Q)));
  out.primal.eta = vscale(c, w);
  out.tangent.eta = vadd(vscale(dc, w), vscale(c, dw));
  const Mat<T, D> ww = outer(w, w);
  out.primal.J = mscale(rS, ww);
  out.tangent.J = madd(mscale(drS, ww), mscale(rS, madd(outer(dw, w), outer(w, dw))));
  return out;
}

// combine and its tangent: (ei, dei) first, then (ej, dej). The inverse
// M = (I + Ci Jj)^-1 is differentiated as dM = -M (dCi Jj + Ci dJj) M, not
// through the adjugate's cofactors.
template <typename T, int D>
__device__ __forceinline__ ElemJvp<T, D> combine_jvp(const Elem<T, D>& ei, const Elem<T, D>& dei,
                                                     const Elem<T, D>& ej,
                                                     const Elem<T, D>& dej) {
  const Mat<T, D> CiJj = mm(ei.C, ej.J);
  const Mat<T, D> dCiJj = madd(mm(dei.C, ej.J), mm(ei.C, dej.J));
  const Mat<T, D> M = inv(madd(CiJj, eye<T, D>()));
  const Mat<T, D> dM = msub(zeros_mat<T, D>(), mm(M, mm(dCiJj, M)));
  const Mat<T, D> AjM = mm(ej.A, M);
  const Mat<T, D> dAjM = madd(mm(dej.A, M), mm(ej.A, dM));
  const Mat<T, D> MAi = mm(M, ei.A);
  const Mat<T, D> dMAi = madd(mm(dM, ei.A), mm(M, dei.A));
  ElemJvp<T, D> out;
  out.primal.A = mm(ej.A, MAi);
  out.tangent.A = madd(mm(dej.A, MAi), mm(ej.A, dMAi));

  const Vec<T, D> u = vadd(ei.b, mv(ei.C, ej.eta));
  const Vec<T, D> du = vadd(dei.b, vadd(mv(dei.C, ej.eta), mv(ei.C, dej.eta)));
  out.primal.b = vadd(mv(AjM, u), ej.b);
  out.tangent.b = vadd(vadd(mv(dAjM, u), mv(AjM, du)), dej.b);

  const Mat<T, D> X = mm(AjM, ei.C);
  const Mat<T, D> dX = madd(mm(dAjM, ei.C), mm(AjM, dei.C));
  out.primal.C = sym(madd(mmT(X, ej.A), ej.C));
  out.tangent.C = sym(madd(madd(mmT(dX, ej.A), mmT(X, dej.A)), dej.C));

  const Vec<T, D> v = vsub(ej.eta, mv(ej.J, ei.b));
  const Vec<T, D> dv = vsub(dej.eta, vadd(mv(dej.J, ei.b), mv(ej.J, dei.b)));
  out.primal.eta = vadd(mTv(MAi, v), ei.eta);
  out.tangent.eta = vadd(vadd(mTv(dMAi, v), mTv(MAi, dv)), dei.eta);

  const Mat<T, D> Y = mm(ej.J, ei.A);
  const Mat<T, D> dY = madd(mm(dej.J, ei.A), mm(ej.J, dei.A));
  out.primal.J = sym(madd(mTm(MAi, Y), ei.J));
  out.tangent.J = sym(madd(madd(mTm(dMAi, Y), mTm(MAi, dY)), dei.J));
  return out;
}

// The step's log marginal likelihood and its tangent.
template <typename T>
struct LmlJvp {
  T primal;
  T tangent;
};

// kalman_step and its tangent, in place on (m, P) and (dm, dP):
//   d log S = dS / S,   d(resid^2 / S) = 2 resid dresid / S - resid^2 dS / S^2,
//   dS = dH.V + H.dV + ds with V = Pp H.
template <typename T, int D>
__device__ __forceinline__ LmlJvp<T> kalman_step_jvp(Vec<T, D>& m, Vec<T, D>& dm, Mat<T, D>& P,
                                                     Mat<T, D>& dP, const Params<T, D>& p,
                                                     const Params<T, D>& dp, T s, T ds, T y) {
  const T kLog2Pi = T(1.8378770664093453);  // log(2 pi)
  const Vec<T, D> mp = vadd(mv(p.A, m), p.a);
  const Vec<T, D> dmp = vadd(vadd(mv(dp.A, m), mv(p.A, dm)), dp.a);
  const Mat<T, D> AP = mm(p.A, P);
  const Mat<T, D> dAP = madd(mm(dp.A, P), mm(p.A, dP));
  const Mat<T, D> Pp = madd(sym(mmT(AP, p.A)), p.Q);
  const Mat<T, D> dPp = madd(sym(madd(mmT(dAP, p.A), mmT(AP, dp.A))), dp.Q);
  const Vec<T, D> V = mv(Pp, p.H);
  const Vec<T, D> dV = vadd(mv(dPp, p.H), mv(Pp, dp.H));
  const T S = vdot(p.H, V) + s;
  const T dS = vdot(dp.H, V) + vdot(p.H, dV) + ds;
  const T resid = y - (vdot(p.H, mp) + p.h);
  const T dresid = -(vdot(dp.H, mp) + vdot(p.H, dmp) + dp.h);
  const T rS = T(1) / S;
  const T drS = -dS * rS * rS;
  LmlJvp<T> lml;
  lml.primal = T(-0.5) * (kLog2Pi + dev_log(S) + resid * resid / S);
  lml.tangent = T(-0.5) * (dS * rS + T(2) * resid * dresid * rS + resid * resid * drS);
  const Vec<T, D> K = vscale(rS, V);
  const Vec<T, D> dK = vadd(vscale(drS, V), vscale(rS, dV));
  m = vadd(mp, vscale(resid, K));
  dm = vadd(dmp, vadd(vscale(dresid, K), vscale(resid, dK)));
  P = sym(msub(Pp, outer(K, V)));
  dP = sym(msub(dPp, madd(outer(dK, V), outer(K, dV))));
  return lml;
}

// ---------------------------------------------------------------------------
// Affine-Gaussian maps x -> A x + b + N(0, C): the steps of a chain's
// marginals (ops/lanes.py affine_combine, affine_step).
// ---------------------------------------------------------------------------

template <typename T, int D>
struct Affine {
  Mat<T, D> A;
  Vec<T, D> b;
  Mat<T, D> C;
};

template <typename T, int D>
__device__ __forceinline__ Affine<T, D> identity_affine() {
  Affine<T, D> e;
  e.A = eye<T, D>();
  e.b = zeros_vec<T, D>();
  e.C = zeros_mat<T, D>();
  return e;
}

// Component-major affine rows A (D*D), b (D), C (D*D), row k at base[k * stride]:
// stride B for (KT, B) aggregates, L * B for a step of (KT, L, B) maps.
template <typename T, int D>
__device__ __forceinline__ Affine<T, D> load_affine(const T* base, long long stride) {
  Affine<T, D> e;
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
  return e;
}

template <typename T, int D>
__device__ __forceinline__ void store_affine(const Affine<T, D>& e, T* base, long long stride) {
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
}

// Composition: ei first, then ej.
template <typename T, int D>
__device__ __forceinline__ Affine<T, D> affine_combine(const Affine<T, D>& ei,
                                                       const Affine<T, D>& ej) {
  Affine<T, D> out;
  out.A = mm(ej.A, ei.A);
  out.b = vadd(mv(ej.A, ei.b), ej.b);
  out.C = madd(sym(mmT(mm(ej.A, ei.C), ej.A)), ej.C);
  return out;
}

// One step of the affine recursion, in place: m <- A m + b, P <- sym(A P A^T) + C.
template <typename T, int D>
__device__ __forceinline__ void affine_step(Vec<T, D>& m, Mat<T, D>& P, const Affine<T, D>& e) {
  m = vadd(mv(e.A, m), e.b);
  P = madd(sym(mmT(mm(e.A, P), e.A)), e.C);
}

}  // namespace tgps
