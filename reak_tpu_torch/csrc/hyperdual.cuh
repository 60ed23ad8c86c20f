// Forward-mode dual and hyper-dual numbers for the rollout-step kernel.
//
// The JAX kernel differentiates with jax.linearize (outer, along each state
// direction) and jax.jvp (inner, along q̇, for the J̇q̇ bias accelerations).
// A CUDA kernel has no autodiff, so it carries both derivatives itself:
//
//   HD<T> = v + e·ε + d·δ + ed·εδ      (ε² = δ² = 0)
//
// where ε is the inner tangent (configuration moving along q̇) and δ the
// outer one (one unit state direction per thread).  Four values per scalar
// keep the per-thread state small.  D1<T> = v + d·δ is the outer tangent
// alone, used once the inner derivative has been read off.
#pragma once

#include <cuda_runtime.h>

namespace reak {

template <typename T>
struct HD {
  T v, e, d, ed;
  __device__ HD() {}
  __device__ HD(T c) : v(c), e(0), d(0), ed(0) {}
  __device__ HD(T v_, T e_, T d_, T ed_) : v(v_), e(e_), d(d_), ed(ed_) {}
};

template <typename T>
__device__ inline HD<T> operator+(const HD<T>& a, const HD<T>& b) {
  return HD<T>(a.v + b.v, a.e + b.e, a.d + b.d, a.ed + b.ed);
}
template <typename T>
__device__ inline HD<T> operator-(const HD<T>& a, const HD<T>& b) {
  return HD<T>(a.v - b.v, a.e - b.e, a.d - b.d, a.ed - b.ed);
}
template <typename T>
__device__ inline HD<T> operator-(const HD<T>& a) {
  return HD<T>(-a.v, -a.e, -a.d, -a.ed);
}
template <typename T>
__device__ inline HD<T> operator*(const HD<T>& a, const HD<T>& b) {
  return HD<T>(a.v * b.v, a.v * b.e + a.e * b.v, a.v * b.d + a.d * b.v,
               a.v * b.ed + a.e * b.d + a.d * b.e + a.ed * b.v);
}
template <typename T>
__device__ inline HD<T> operator*(T s, const HD<T>& a) {
  return HD<T>(s * a.v, s * a.e, s * a.d, s * a.ed);
}

__device__ inline void sincos_t(float a, float* s, float* c) { sincosf(a, s, c); }
__device__ inline void sincos_t(double a, double* s, double* c) { ::sincos(a, s, c); }

// f(v) + f'(v)(e ε + d δ + ed εδ) + f''(v) e d εδ
template <typename T>
__device__ inline void hd_sincos(const HD<T>& a, HD<T>* s, HD<T>* c) {
  T sv, cv;
  sincos_t(a.v, &sv, &cv);
  *s = HD<T>(sv, cv * a.e, cv * a.d, cv * a.ed - sv * a.e * a.d);
  *c = HD<T>(cv, -sv * a.e, -sv * a.d, -sv * a.ed - cv * a.e * a.d);
}

template <typename T>
struct D1 {
  T v, d;
  __device__ D1() {}
  __device__ D1(T c) : v(c), d(0) {}
  __device__ D1(T v_, T d_) : v(v_), d(d_) {}
};

template <typename T>
__device__ inline D1<T> operator+(const D1<T>& a, const D1<T>& b) {
  return D1<T>(a.v + b.v, a.d + b.d);
}
template <typename T>
__device__ inline D1<T> operator-(const D1<T>& a, const D1<T>& b) {
  return D1<T>(a.v - b.v, a.d - b.d);
}
template <typename T>
__device__ inline D1<T> operator-(const D1<T>& a) {
  return D1<T>(-a.v, -a.d);
}
template <typename T>
__device__ inline D1<T> operator*(const D1<T>& a, const D1<T>& b) {
  return D1<T>(a.v * b.v, a.v * b.d + a.d * b.v);
}
template <typename T>
__device__ inline D1<T> operator*(T s, const D1<T>& a) {
  return D1<T>(s * a.v, s * a.d);
}

// the outer tangent of a value (v, d) and of its inner derivative (e, ed)
template <typename T>
__device__ inline D1<T> outer_of_value(const HD<T>& a) { return D1<T>(a.v, a.d); }
template <typename T>
__device__ inline D1<T> outer_of_inner(const HD<T>& a) { return D1<T>(a.e, a.ed); }

}  // namespace reak
