// Forward-mode dual and hyper-dual numbers for the rollout-step kernel
// (csrc/kte_step.cu: K1 and K5).
//
// The JAX kernel (reak_tpu/ops/kte_core_pallas.py) differentiates with
// jax.linearize (outer, along each state direction) and jax.jvp (inner,
// along q̇, for the J̇q̇ bias accelerations).  A CUDA kernel has no autodiff,
// so it carries both derivatives itself:
//
//   HD<T>   = v + e·ε + d·δ + ed·εδ      (ε² = δ² = 0)
//   HDq<T>  = v + e·ε + ed·εδ            (HD with d ≡ 0)
//   Dual<T> = v + t·τ                    (τ² = 0)
//
// ε is the inner tangent (the configuration moving along q̇), δ the outer one
// (one unit state direction per thread).  Along a q̇ direction no position
// quantity has a δ part, only an εδ one (the inner tangent moves with q̇), so
// those directions run the kinematics in HDq and skip a quarter of each
// product.  The kernel's primal phase runs the kinematics once per scenario
// in Dual numbers with τ = ε (value and inner tangent, the part every
// direction shares); each direction then runs it in HD or HDq numbers,
// taking v and e of the chain's quantities back from the primal phase
// (kte_step.cu, "anchors").  Once the inner derivative has been read off,
// the outer tangent alone is a Dual with τ = δ (outer_of_value,
// outer_of_inner; an HDq value has no δ part and gives a zero one).
//
// What bounds these types on the H100 is registers: an HD value is four
// numbers, so the kernel keeps only what a direction needs live and unrolls
// every chain loop at compile-time widths, which keeps the arrays of these
// types in registers rather than in local memory.
#pragma once

#include <cuda_runtime.h>

namespace reak {

template <typename T>
struct Dual {
  T v, t;
  __device__ Dual() {}
  __device__ Dual(T c) : v(c), t(0) {}
  __device__ Dual(T v_, T t_) : v(v_), t(t_) {}
};

template <typename T>
__device__ inline Dual<T> operator+(const Dual<T>& a, const Dual<T>& b) {
  return Dual<T>(a.v + b.v, a.t + b.t);
}
template <typename T>
__device__ inline Dual<T> operator-(const Dual<T>& a, const Dual<T>& b) {
  return Dual<T>(a.v - b.v, a.t - b.t);
}
template <typename T>
__device__ inline Dual<T> operator-(const Dual<T>& a) {
  return Dual<T>(-a.v, -a.t);
}
template <typename T>
__device__ inline Dual<T> operator*(const Dual<T>& a, const Dual<T>& b) {
  return Dual<T>(a.v * b.v, a.v * b.t + a.t * b.v);
}
template <typename T>
__device__ inline Dual<T> operator*(T s, const Dual<T>& a) {
  return Dual<T>(s * a.v, s * a.t);
}

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

template <typename T>
struct HDq {
  T v, e, ed;
  __device__ HDq() {}
  __device__ HDq(T c) : v(c), e(0), ed(0) {}
  __device__ HDq(T v_, T e_, T ed_) : v(v_), e(e_), ed(ed_) {}
};

template <typename T>
__device__ inline HDq<T> operator+(const HDq<T>& a, const HDq<T>& b) {
  return HDq<T>(a.v + b.v, a.e + b.e, a.ed + b.ed);
}
template <typename T>
__device__ inline HDq<T> operator-(const HDq<T>& a, const HDq<T>& b) {
  return HDq<T>(a.v - b.v, a.e - b.e, a.ed - b.ed);
}
template <typename T>
__device__ inline HDq<T> operator-(const HDq<T>& a) {
  return HDq<T>(-a.v, -a.e, -a.ed);
}
template <typename T>
__device__ inline HDq<T> operator*(const HDq<T>& a, const HDq<T>& b) {
  return HDq<T>(a.v * b.v, a.v * b.e + a.e * b.v, a.v * b.ed + a.ed * b.v);
}
template <typename T>
__device__ inline HDq<T> operator*(T s, const HDq<T>& a) {
  return HDq<T>(s * a.v, s * a.e, s * a.ed);
}

__device__ inline void sincos_t(float a, float* s, float* c) { sincosf(a, s, c); }
__device__ inline void sincos_t(double a, double* s, double* c) { ::sincos(a, s, c); }

// sin and cos of a from sv = sin a.v and cv = cos a.v:
// f(v) + f'(v)(e ε + d δ + ed εδ) + f''(v) e d εδ
template <typename T>
__device__ inline void sincos_of(const Dual<T>& a, T sv, T cv, Dual<T>* s,
                                 Dual<T>* c) {
  *s = Dual<T>(sv, cv * a.t);
  *c = Dual<T>(cv, -sv * a.t);
}
template <typename T>
__device__ inline void sincos_of(const HD<T>& a, T sv, T cv, HD<T>* s,
                                 HD<T>* c) {
  *s = HD<T>(sv, cv * a.e, cv * a.d, cv * a.ed - sv * a.e * a.d);
  *c = HD<T>(cv, -sv * a.e, -sv * a.d, -sv * a.ed - cv * a.e * a.d);
}
template <typename T>
__device__ inline void sincos_of(const HDq<T>& a, T sv, T cv, HDq<T>* s,
                                 HDq<T>* c) {
  *s = HDq<T>(sv, cv * a.e, cv * a.ed);
  *c = HDq<T>(cv, -sv * a.e, -sv * a.ed);
}

template <typename N>
__device__ inline void sincos_own(const N& a, N* s, N* c) {
  decltype(a.v) sv, cv;
  sincos_t(a.v, &sv, &cv);
  sincos_of(a, sv, cv, s, c);
}

// the outer tangent of a value (v, d) and of its inner derivative (e, ed)
template <typename T>
__device__ inline Dual<T> outer_of_value(const HD<T>& a) {
  return Dual<T>(a.v, a.d);
}
template <typename T>
__device__ inline Dual<T> outer_of_inner(const HD<T>& a) {
  return Dual<T>(a.e, a.ed);
}
template <typename T>
__device__ inline Dual<T> outer_of_value(const HDq<T>& a) {
  return Dual<T>(a.v, T(0));
}
template <typename T>
__device__ inline Dual<T> outer_of_inner(const HDq<T>& a) {
  return Dual<T>(a.e, a.ed);
}

}  // namespace reak
