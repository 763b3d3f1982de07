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
__device__ __forceinline__ double dsol_expm1(double x) { return expm1(x); }
__device__ __forceinline__ double dsol_log1p(double x) { return log1p(x); }
__device__ __forceinline__ double dsol_rsqrt(double x) { return 1.0 / sqrt(x); }
__device__ __forceinline__ double dsol_tan(double x) { return tan(x); }
__device__ __forceinline__ double dsol_sinh(double x) { return sinh(x); }
__device__ __forceinline__ double dsol_cosh(double x) { return cosh(x); }
__device__ __forceinline__ double dsol_sigmoid(double x) { return 1.0 / (1.0 + exp(-x)); }
// x^k for a constant k, and x^y for a traced exponent
__device__ __forceinline__ double dsol_powc(double x, double k) { return pow(x, k); }
__device__ __forceinline__ double dsol_pow(double x, double y) { return pow(x, y); }
// comparisons act on the value part (an order predicate has zero tangent
// almost everywhere, the usual forward-mode convention)
__device__ __forceinline__ bool dsol_lt(double a, double b) { return a < b; }
__device__ __forceinline__ bool dsol_le(double a, double b) { return a <= b; }
__device__ __forceinline__ bool dsol_gt(double a, double b) { return a > b; }
__device__ __forceinline__ bool dsol_ge(double a, double b) { return a >= b; }
__device__ __forceinline__ bool dsol_eq(double a, double b) { return a == b; }
__device__ __forceinline__ bool dsol_ne(double a, double b) { return a != b; }
__device__ __forceinline__ double dsol_where(bool m, double a, double b) { return m ? a : b; }

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
template <typename S>
__device__ __forceinline__ Dual<S> dsol_expm1(const Dual<S>& x) {
  const S e = expm1(x.v);
  return Dual<S>(e, (e + S(1)) * x.d);
}
template <typename S>
__device__ __forceinline__ Dual<S> dsol_log1p(const Dual<S>& x) {
  return Dual<S>(log1p(x.v), x.d / (x.v + S(1)));
}
template <typename S>
__device__ __forceinline__ Dual<S> dsol_rsqrt(const Dual<S>& x) {
  const S r = S(1) / sqrt(x.v);
  return Dual<S>(r, -(r * x.d) / (x.v * S(2)));
}
template <typename S>
__device__ __forceinline__ Dual<S> dsol_tan(const Dual<S>& x) {
  const S tn = tan(x.v);
  return Dual<S>(tn, (S(1) + tn * tn) * x.d);
}
template <typename S>
__device__ __forceinline__ Dual<S> dsol_sinh(const Dual<S>& x) {
  return Dual<S>(sinh(x.v), cosh(x.v) * x.d);
}
template <typename S>
__device__ __forceinline__ Dual<S> dsol_cosh(const Dual<S>& x) {
  return Dual<S>(cosh(x.v), sinh(x.v) * x.d);
}
template <typename S>
__device__ __forceinline__ Dual<S> dsol_sigmoid(const Dual<S>& x) {
  const S sg = S(1) / (S(1) + exp(-x.v));
  return Dual<S>(sg, sg * (S(1) - sg) * x.d);
}
template <typename S, typename K>
__device__ __forceinline__ Dual<S> dsol_powc(const Dual<S>& x, K kc) {
  const S k = S(kc);  // the exponent is emitted as a double literal
  return Dual<S>(pow(x.v, k), k * pow(x.v, k - S(1)) * x.d);
}
template <typename S>
__device__ __forceinline__ Dual<S> dsol_pow(const Dual<S>& x, const Dual<S>& y) {
  const S v = pow(x.v, y.v);
  return Dual<S>(v, v * (y.d * log(x.v) + y.v * x.d / x.v));
}
template <typename S>
__device__ __forceinline__ bool dsol_lt(const Dual<S>& a, const Dual<S>& b) { return a.v < b.v; }
template <typename S>
__device__ __forceinline__ bool dsol_le(const Dual<S>& a, const Dual<S>& b) { return a.v <= b.v; }
template <typename S>
__device__ __forceinline__ bool dsol_gt(const Dual<S>& a, const Dual<S>& b) { return a.v > b.v; }
template <typename S>
__device__ __forceinline__ bool dsol_ge(const Dual<S>& a, const Dual<S>& b) { return a.v >= b.v; }
template <typename S>
__device__ __forceinline__ bool dsol_eq(const Dual<S>& a, const Dual<S>& b) { return a.v == b.v; }
template <typename S>
__device__ __forceinline__ bool dsol_ne(const Dual<S>& a, const Dual<S>& b) { return a.v != b.v; }
template <typename S>
__device__ __forceinline__ Dual<S> dsol_where(bool m, const Dual<S>& a, const Dual<S>& b) {
  return m ? a : b;
}

// |x|, sign(x), max and min with the tangent rules of DualAlgebra
// (dfinterp.py:384-397, :494-499): abs flips the tangent only where
// x < 0 (at x = 0 the tangent is +dx); maximum takes x where x >= y and
// minimum where x <= y, value and tangent; sign has a zero tangent.
// sign(NaN) is 0, as torch.sign's.
__device__ __forceinline__ double dsol_abs(double x) { return fabs(x); }
__device__ __forceinline__ double dsol_sign(double x) {
  return double(x > 0.0) - double(x < 0.0);
}
__device__ __forceinline__ double dsol_maximum(double a, double b) { return a >= b ? a : b; }
__device__ __forceinline__ double dsol_minimum(double a, double b) { return a <= b ? a : b; }
template <typename S>
__device__ __forceinline__ Dual<S> dsol_abs(const Dual<S>& x) {
  return Dual<S>(fabs(x.v), x.v < S(0) ? -x.d : x.d);
}
template <typename S>
__device__ __forceinline__ Dual<S> dsol_sign(const Dual<S>& x) {
  return Dual<S>(S(x.v > S(0)) - S(x.v < S(0)), S(0));
}
// A cast to float32 in the model (OdeBuilder.dtype's wrapper): value and
// tangent rounded to float to nearest, as torch's _to_copy and its jvp;
// the arithmetic after it stays in the scalar type.
__device__ __forceinline__ double dsol_f32(double x) { return double(__double2float_rn(x)); }
__device__ __forceinline__ float dsol_f32(float x) { return x; }
template <typename S>
__device__ __forceinline__ Dual<S> dsol_f32(const Dual<S>& x) {
  return Dual<S>(dsol_f32(x.v), dsol_f32(x.d));
}
template <typename S>
__device__ __forceinline__ Dual<S> dsol_maximum(const Dual<S>& a, const Dual<S>& b) {
  return a.v >= b.v ? a : b;
}
template <typename S>
__device__ __forceinline__ Dual<S> dsol_minimum(const Dual<S>& a, const Dual<S>& b) {
  return a.v <= b.v ? a : b;
}
