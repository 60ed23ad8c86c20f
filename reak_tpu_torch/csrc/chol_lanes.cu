// Batched Cholesky factor and solve of tiny SPD systems (n <= 32), one or k
// right-hand sides: the hand-written Hopper port of the Pallas kernels
// reak_tpu/ops/chol_lanes.py::solve_lanes (K3a, one right-hand side) and
// ::solve_lanes_multi (K3b, k right-hand sides, one factorization).
//
// Lanes layout, scenario last: G (n, n, B), rhs (n, k, B) → x (n, k, B) with
// G[:, :, b] x[:, c, b] = rhs[:, c, b]; K3a is the case k = 1, where
// (n, 1, B) and (n, B) are the same memory.  Only the lower triangle of G is
// read, as in the TPU kernel.
//
// What bounds it on the H100: nothing but latency.  At the shapes of the
// port's paths (n = 6, k = 1, B = 8192 in the line-search rollout; n = 12,
// k = 36, B = 2048 in the floating-arm linearization) a launch moves a few
// MB and does a few tens of MFLOP, so the time is the launch and the chain
// of dependent, division-free multiply-adds of the recurrence.
//
// Design: one thread per (scenario, right-hand side): blockIdx.y is the
// column, so the k columns of K3b run in parallel and each thread factors
// its scenario's G itself (the redundant factorizations of one scenario hit
// L1/L2, not device memory).  Neighbouring threads take neighbouring
// scenarios, so every load and store of the scenario-last layout coalesces
// with no transpose.  N is a template argument (1..32, picked by a switch at
// launch) so the packed factor unrolls into registers: N(N+1)/2 <= 136
// values up to n = 16, the systems of the fixed-base arms and the floating
// arm; beyond, up to 528 values for a floating beam's n = 32, what exceeds a
// thread's 255 registers spills to local memory, which the L1 cache holds
// (ptxas' stack frame in the build report).  The recurrence is the TPU
// kernel's, operation for operation:
// d = rsqrt(s), L_jj = s·d, off-diagonals and both substitutions multiply by
// the inverse diagonal d.  Any B >= 1 is taken: the TPU's B % 1024 rule is a
// tile rule, not part of the function.
#include <cuda_runtime.h>

namespace reak {
namespace {

__device__ inline float rsqrt_t(float v) { return rsqrtf(v); }
__device__ inline double rsqrt_t(double v) { return rsqrt(v); }

// packed lower triangle, row-major: element (i, j), j <= i
__host__ __device__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }

template <typename T, int N>
__global__ void chol_lanes_kernel(const T* __restrict__ G,
                                  const T* __restrict__ rhs,
                                  T* __restrict__ x, int k, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;  // the ragged edge: scenarios are independent
  const int c = blockIdx.y;
  const size_t Bs = static_cast<size_t>(B);
  T L[N * (N + 1) / 2], inv_d[N], y[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    T s = G[(j * N + j) * Bs + b];
#pragma unroll
    for (int kk = 0; kk < j; ++kk) s -= L[tri(j, kk)] * L[tri(j, kk)];
    const T d = rsqrt_t(s);
    inv_d[j] = d;
    L[tri(j, j)] = s * d;
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      T t = G[(i * N + j) * Bs + b];
#pragma unroll
      for (int kk = 0; kk < j; ++kk) t -= L[tri(i, kk)] * L[tri(j, kk)];
      L[tri(i, j)] = t * d;
    }
  }
  // forward substitution L y = r
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T t = rhs[(static_cast<size_t>(i) * k + c) * Bs + b];
#pragma unroll
    for (int kk = 0; kk < i; ++kk) t -= L[tri(i, kk)] * y[kk];
    y[i] = t * inv_d[i];
  }
  // backward substitution Lᵀ x = y, in place of y
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    T t = y[i];
#pragma unroll
    for (int kk = i + 1; kk < N; ++kk) t -= L[tri(kk, i)] * y[kk];
    y[i] = t * inv_d[i];
    x[(static_cast<size_t>(i) * k + c) * Bs + b] = y[i];
  }
}

template <typename T>
int launch(const void* G, const void* rhs, void* x, int n, int k, int B,
           void* stream) {
  if (n < 1 || n > 32 || k < 1 || k > 65535 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 128;
  const dim3 grid((B + threads - 1) / threads, k);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* g = static_cast<const T*>(G);
  const T* r = static_cast<const T*>(rhs);
  T* o = static_cast<T*>(x);
  switch (n) {
#define REAK_CHOL_CASE(NN) \
  case NN:                 \
    chol_lanes_kernel<T, NN><<<grid, threads, 0, s>>>(g, r, o, k, B); break;
    REAK_CHOL_CASE(1) REAK_CHOL_CASE(2) REAK_CHOL_CASE(3) REAK_CHOL_CASE(4)
    REAK_CHOL_CASE(5) REAK_CHOL_CASE(6) REAK_CHOL_CASE(7) REAK_CHOL_CASE(8)
    REAK_CHOL_CASE(9) REAK_CHOL_CASE(10) REAK_CHOL_CASE(11)
    REAK_CHOL_CASE(12) REAK_CHOL_CASE(13) REAK_CHOL_CASE(14)
    REAK_CHOL_CASE(15) REAK_CHOL_CASE(16) REAK_CHOL_CASE(17)
    REAK_CHOL_CASE(18) REAK_CHOL_CASE(19) REAK_CHOL_CASE(20)
    REAK_CHOL_CASE(21) REAK_CHOL_CASE(22) REAK_CHOL_CASE(23)
    REAK_CHOL_CASE(24) REAK_CHOL_CASE(25) REAK_CHOL_CASE(26)
    REAK_CHOL_CASE(27) REAK_CHOL_CASE(28) REAK_CHOL_CASE(29)
    REAK_CHOL_CASE(30) REAK_CHOL_CASE(31) REAK_CHOL_CASE(32)
#undef REAK_CHOL_CASE
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace reak

extern "C" {

// K3a: rhs and x (n, B)
int reak_chol_solve_lanes_f32(const void* G, const void* rhs, void* x, int n,
                              int B, void* stream) {
  return reak::launch<float>(G, rhs, x, n, 1, B, stream);
}

int reak_chol_solve_lanes_f64(const void* G, const void* rhs, void* x, int n,
                              int B, void* stream) {
  return reak::launch<double>(G, rhs, x, n, 1, B, stream);
}

// K3b: rhs and x (n, k, B)
int reak_chol_solve_lanes_multi_f32(const void* G, const void* rhs, void* x,
                                    int n, int k, int B, void* stream) {
  return reak::launch<float>(G, rhs, x, n, k, B, stream);
}

int reak_chol_solve_lanes_multi_f64(const void* G, const void* rhs, void* x,
                                    int n, int k, int B, void* stream) {
  return reak::launch<double>(G, rhs, x, n, k, B, stream);
}

const char* reak_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
