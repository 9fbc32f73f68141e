// Forward-mode dual numbers for the fused JVP kernels.
//
// Dual<T> carries a value and one tangent.  The residual kernels' device
// physics (csrc/residual.cu) is templated on its scalar type S: with S = T
// it computes the residual, with S = Dual<T> the directional derivative
// J(u)·v in the same pass, which is what jax.jvp does to the reference's
// residual inside thermalporous_tpu/kernels/residual_pallas.py:fused_jvp.
//
// Each tangent rule follows the forward-mode formula that torch.func.jvp
// applies to the plain PyTorch version (torch's derivatives.yaml), with the
// same operands in the same order where the order changes the rounding:
//   a * b   -> a'b + ab'            a / b -> (a' - b'q) / b,  q = a/b
//   c / b   -> c * (1/b), tangent (-b' (r r)) c with r = 1/b (torch's
//              rtruediv is a reciprocal times c)
//   exp(x)  -> x' e                 10^x  -> x' (e ln10)
//   x^n     -> x' (n x^(n-1))       (x^2 is x*x, as torch computes it)
// Comparisons (upwinding, inflow, the rate sign) read only the value, and
// the tangent follows the branch taken, as torch.where's and jnp.where's do.
// The clip of the effective saturation passes half the tangent at exactly
// 0 or 1: the tie rule of maximum/minimum in both frameworks.
#pragma once

#include <type_traits>

namespace tp {

constexpr double kLn10 = 2.302585092994046;

template <typename T>
struct Dual {
  T v, d;
  __device__ __forceinline__ Dual() {}
  __device__ __forceinline__ Dual(T value) : v(value), d(T(0)) {}
  __device__ __forceinline__ Dual(T value, T tangent) : v(value), d(tangent) {}
};

template <typename S>
struct is_dual : std::false_type {};
template <typename T>
struct is_dual<Dual<T>> : std::true_type {};

// the value of a scalar of either kind (what a comparison reads)
template <typename T>
__device__ __forceinline__ T val(T x) { return x; }
template <typename T>
__device__ __forceinline__ T val(Dual<T> x) { return x.v; }

template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a) { return {-a.v, -a.d}; }

template <typename T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> a, Dual<T> b) { return {a.v + b.v, a.d + b.d}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> a, T b) { return {a.v + b, a.d}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator+(T a, Dual<T> b) { return {a + b.v, b.d}; }

template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a, Dual<T> b) { return {a.v - b.v, a.d - b.d}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a, T b) { return {a.v - b, a.d}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator-(T a, Dual<T> b) { return {a - b.v, -b.d}; }

template <typename T>
__device__ __forceinline__ Dual<T> operator*(Dual<T> a, Dual<T> b) {
  return {a.v * b.v, b.d * a.v + a.d * b.v};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator*(Dual<T> a, T b) { return {a.v * b, a.d * b}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator*(T a, Dual<T> b) { return {a * b.v, a * b.d}; }

template <typename T>
__device__ __forceinline__ Dual<T> operator/(Dual<T> a, Dual<T> b) {
  const T q = a.v / b.v;
  return {q, (a.d - b.d * q) / b.v};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator/(Dual<T> a, T b) { return {a.v / b, a.d / b}; }

// c / x for a constant c, as torch evaluates a Python number over a tensor:
// reciprocal, then the product
template <typename T>
__device__ __forceinline__ T rdiv(T c, T x) { return (T(1) / x) * c; }
template <typename T>
__device__ __forceinline__ Dual<T> rdiv(T c, Dual<T> x) {
  const T r = T(1) / x.v;
  return {r * c, (-x.d * (r * r)) * c};
}

__device__ __forceinline__ float exp10_(float x) { return exp10f(x); }
__device__ __forceinline__ double exp10_(double x) { return exp10(x); }
__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float pow_(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double pow_(double x, double y) { return pow(x, y); }

template <typename T>
__device__ __forceinline__ Dual<T> exp10_(Dual<T> x) {
  const T e = exp10_(x.v);
  return {e, x.d * (e * T(kLn10))};
}
template <typename T>
__device__ __forceinline__ Dual<T> exp_(Dual<T> x) {
  const T e = exp_(x.v);
  return {e, x.d * e};
}
template <typename T>
__device__ __forceinline__ Dual<T> pow_(Dual<T> x, T n) {
  return {pow_(x.v, n), x.d * (n * pow_(x.v, n - T(1)))};
}

// clip(x, 0, 1) = minimum(maximum(x, 0), 1) with the frameworks' tie rule
template <typename T>
__device__ __forceinline__ T clip01(T x) {
  return x < T(0) ? T(0) : (x > T(1) ? T(1) : x);
}
template <typename T>
__device__ __forceinline__ Dual<T> clip01(Dual<T> x) {
  if (x.v < T(0)) return {T(0), T(0)};
  if (x.v > T(1)) return {T(1), T(0)};
  if (x.v == T(0) || x.v == T(1)) return {x.v, T(0.5) * x.d};
  return x;
}

// a state value: the value alone, or the value and its tangent
template <typename S, typename T>
__device__ __forceinline__ S load(const T* __restrict__ u, const T* __restrict__ v, long i) {
  if constexpr (is_dual<S>::value)
    return S(u[i], v[i]);
  else
    return u[i];
}

// what a kernel writes: the value (residual) or the tangent (J v)
template <typename T>
__device__ __forceinline__ T out_part(T x) { return x; }
template <typename T>
__device__ __forceinline__ T out_part(Dual<T> x) { return x.d; }

}  // namespace tp
