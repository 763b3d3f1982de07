// Forward-mode dual numbers for the generated model functions.
//
// The model header that diffsol_tpu_torch/ops/eqn_codegen.py generates
// templates rhs(t, y, p) on its scalar type; instantiated with Dual<double>
// and a unit seed on state c it returns column c of the Jacobian df/dy.
// The tangent rules are those of DualAlgebra (diffsol_tpu/ops/dfinterp.py)
// and of the IR's torch evaluator, operation for operation.
#pragma once

#include <math.h>

template <typename S>
struct Dual {
  S v, d;
  __device__ __forceinline__ Dual() {}
  __device__ __forceinline__ Dual(S v_) : v(v_), d(S(0)) {}
  __device__ __forceinline__ Dual(S v_, S d_) : v(v_), d(d_) {}
};

template <typename S>
__device__ __forceinline__ Dual<S> operator+(const Dual<S>& a, const Dual<S>& b) {
  return Dual<S>(a.v + b.v, a.d + b.d);
}
template <typename S>
__device__ __forceinline__ Dual<S> operator-(const Dual<S>& a, const Dual<S>& b) {
  return Dual<S>(a.v - b.v, a.d - b.d);
}
template <typename S>
__device__ __forceinline__ Dual<S> operator*(const Dual<S>& a, const Dual<S>& b) {
  return Dual<S>(a.v * b.v, a.v * b.d + a.d * b.v);
}
template <typename S>
__device__ __forceinline__ Dual<S> operator/(const Dual<S>& a, const Dual<S>& b) {
  const S q = a.v / b.v;
  return Dual<S>(q, (a.d - q * b.d) / b.v);
}
template <typename S>
__device__ __forceinline__ Dual<S> operator-(const Dual<S>& a) {
  return Dual<S>(-a.v, -a.d);
}

__device__ __forceinline__ double dsol_exp(double x) { return exp(x); }
__device__ __forceinline__ double dsol_log(double x) { return log(x); }
__device__ __forceinline__ double dsol_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ double dsol_sin(double x) { return sin(x); }
__device__ __forceinline__ double dsol_cos(double x) { return cos(x); }
__device__ __forceinline__ double dsol_tanh(double x) { return tanh(x); }

template <typename S>
__device__ __forceinline__ Dual<S> dsol_exp(const Dual<S>& x) {
  const S e = exp(x.v);
  return Dual<S>(e, e * x.d);
}
template <typename S>
__device__ __forceinline__ Dual<S> dsol_log(const Dual<S>& x) {
  return Dual<S>(log(x.v), x.d / x.v);
}
template <typename S>
__device__ __forceinline__ Dual<S> dsol_sqrt(const Dual<S>& x) {
  const S s = sqrt(x.v);
  return Dual<S>(s, x.d / (s * S(2)));
}
template <typename S>
__device__ __forceinline__ Dual<S> dsol_sin(const Dual<S>& x) {
  return Dual<S>(sin(x.v), cos(x.v) * x.d);
}
template <typename S>
__device__ __forceinline__ Dual<S> dsol_cos(const Dual<S>& x) {
  return Dual<S>(cos(x.v), -(sin(x.v) * x.d));
}
template <typename S>
__device__ __forceinline__ Dual<S> dsol_tanh(const Dual<S>& x) {
  const S th = tanh(x.v);
  return Dual<S>(th, (S(1) - th * th) * x.d);
}
