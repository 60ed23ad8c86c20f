// Batched Cholesky factor and solve of small SPD systems, any n, one or k
// right-hand sides: the hand-written Hopper port of the Pallas kernels
// reak_tpu/ops/chol_lanes.py::solve_lanes (K3a, one right-hand side) and
// ::solve_lanes_multi (K3b, k right-hand sides, one factorization).
//
// Lanes layout, scenario last: G (n, n, B), rhs (n, k, B) → x (n, k, B) with
// G[:, :, b] x[:, c, b] = rhs[:, c, b]; K3a is the case k = 1, where
// (n, 1, B) and (n, B) are the same memory.  Only the lower triangle of G is
// read, as in the TPU kernel.  The recurrence is the TPU kernel's, operation
// for operation and in its order: s = G_jj − Σ_k L_jk² and
// t = G_ij − Σ_k L_ik L_jk with k ascending, d = rsqrt(s), L_ij = t·d, and
// both substitutions multiply by d (sums over k ascending), each product
// rounded before it is subtracted (no fused multiply-add), so the kernel's
// result is its plain version's (ctrl/riccati_soa._chol_solve_lanes) bit
// for bit.  L_jj = s·d is never read by the substitutions, so the diagonal
// slot keeps d instead.
//
// What bounds it on the H100: at the port's shapes (n = 6, k = 1, B = 8192
// in the line-search rollout; n = 12, k = 36, B = 2048 in the floating-arm
// linearization) a launch moves a few MB and does a few MFLOP, so the
// launch and the dependent chain of the recurrence bound it; the launches
// themselves are replayed from CUDA graphs on those routes (ops/graphs.py).
// Past n ≈ 16 a scenario's factor is too long a chain for one thread, and
// its packed L too large for a thread's registers.
//
// Design.  A block takes a tile of TS neighbouring scenarios (a power of
// two ≤ 32: halved while the tile passes 96 KB of shared memory, then
// while the grid would leave one of the 132 SMs without a block, down to
// 4).  Each scenario is factored once, and its L and d (a packed triangle,
// padded to an odd length so neighbouring scenarios fall in other banks)
// land in the block's work area for all its right-hand sides:
// - n ≤ 12 (compile-time instances; the hot widths 6 and 12): one thread a
//   scenario loads its triangle from G, every load issued before the
//   first is used (neighbouring threads read neighbouring scenarios, so
//   each load is one row of the scenario-last layout), and factors it
//   unrolled in registers;
// - any other n: the block copies the tile's triangles into the work area
//   (each row of TS scenarios one coalesced load), then one warp factors a
//   scenario: at step j each lane forms column j's entries of its rows
//   (dot products over L's rows in the work area, all lanes reading row j
//   at once), lane 0 passes d to the warp by __shfl_sync, and a __syncwarp
//   publishes the column.  No thread holds a packed L, so nothing spills
//   at any n.
// The TS·k (scenario, column) pairs are then spread over the block's
// threads; each substitutes its column reading L from the work area, its
// vector in registers (n ≤ 12), in local memory (n ≤ 64, cached in L1) or
// in its own column of x (any n).  The work area is the block's shared
// memory, or, where one scenario's triangle does not fit it (n(n+1)/2 · 8 B
// above 227 KB in f64: n > 240), the wrapper's workspace in device memory,
// the same layout.  Scenarios past B (the ragged edge) factor an identity
// and store nothing.
#include <cuda_runtime.h>

namespace reak {
namespace {

// an H100 block's dynamic shared memory, and the tile size aimed at
constexpr long long kSmemMax = 232448;
constexpr long long kSmemTile = 98304;
constexpr int kSMs = 132;
// threads a block: 512, but 256 for the unrolled f64 instances, whose
// factor holds up to 78 doubles a thread (more than 512 threads' 128
// registers each)
template <typename T, int NC>
__host__ __device__ constexpr int max_threads() {
  return NC > 0 && sizeof(T) == 8 ? 256 : 512;
}
// widths factored by one thread, with the recurrence unrolled
constexpr int kUnrolledMax = 12;
// widths whose substitutions keep their vector in local memory
constexpr int kLocalMax = 64;

__device__ inline float rsqrt_t(float v) { return rsqrtf(v); }
__device__ inline double rsqrt_t(double v) { return rsqrt(v); }
// a product rounded on its own, so that t − a·b is not contracted into one
// fused multiply-add: two roundings, as in the TPU kernel and the plain
// version, whose results the kernel then gives bit for bit
__device__ inline float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ inline double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// packed lower triangle, row-major: element (i, j), j <= i; I is int for
// the unrolled widths and long long for any n
template <typename I = int>
__host__ __device__ constexpr I tri(I i, I j) { return i * (i + 1) / 2 + j; }

// a scenario's stride in the work area: its packed triangle, odd
__host__ __device__ constexpr long long stride_of(long long n) {
  return (n * (n + 1) / 2) | 1;
}

// one thread factors scenario b of compile-time width N: its lower triangle
// loaded from G at once (every load independent of the others), the
// recurrence in registers, L and d stored to its slot A of the work area;
// past B an identity
template <typename T, int N>
__device__ void factor_thread(const T* __restrict__ G, size_t Bs, long long b,
                              int B, T* A) {
  T L[N * (N + 1) / 2];
  const bool live = b < B;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j)
      L[tri(i, j)] = live ? G[(static_cast<size_t>(i) * N + j) * Bs + b]
                          : (i == j ? T(1) : T(0));
#pragma unroll
  for (int j = 0; j < N; ++j) {
    T s = L[tri(j, j)];
#pragma unroll
    for (int kk = 0; kk < j; ++kk)
      s -= mul_rn(L[tri(j, kk)], L[tri(j, kk)]);
    const T d = rsqrt_t(s);
    L[tri(j, j)] = d;
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      T t = L[tri(i, j)];
#pragma unroll
      for (int kk = 0; kk < j; ++kk)
        t -= mul_rn(L[tri(i, kk)], L[tri(j, kk)]);
      L[tri(i, j)] = t * d;
    }
  }
#pragma unroll
  for (int e = 0; e < N * (N + 1) / 2; ++e) A[e] = L[e];
}

// one warp factors one scenario of run-time width n in place, left-looking
// as the recurrence runs: at step j lane l takes rows j+l, j+32+l, …: it
// forms t_i = A_ij − Σ_k L_ik L_jk (k ascending; row j is read by every
// lane at once), lane 0 turns t_j into d = rsqrt(t_j) and passes it to the
// warp, and each lane scales its entries of column j by d
template <typename T>
__device__ void factor_warp(T* A, long long n, int lane) {
  using LL = long long;
  for (LL j = 0; j < n; ++j) {
    const T* Lj = A + tri<LL>(j, 0);
    for (LL i = j + lane; i < n; i += 32) {
      T* Li = A + tri<LL>(i, 0);
      T t = Li[j];
#pragma unroll 4
      for (LL kk = 0; kk < j; ++kk) t -= mul_rn(Li[kk], Lj[kk]);
      Li[j] = t;
    }
    // row j is lane 0's (every lane wrote its own rows only)
    T d = T(0);
    if (lane == 0) d = rsqrt_t(A[tri<LL>(j, j)]);
    d = __shfl_sync(0xffffffffu, d, 0);
    for (LL i = j + lane; i < n; i += 32) {
      T* a = A + tri<LL>(i, j);
      *a = i == j ? d : *a * d;  // the diagonal slot keeps d
    }
    __syncwarp();  // column j is final before step j+1 reads row j+1
  }
}

// the substitutions L y = r, Lᵀ x = y of one column, for run-time n: the
// vector in the thread's local memory (cached in L1) up to kLocalMax,
// above in its own column of x
template <typename T>
__device__ void substitute(const T* Ls, const T* __restrict__ r, T* xc,
                           long long n, size_t step) {
  using LL = long long;
  if (n <= kLocalMax) {
    T y[kLocalMax];
    for (LL i = 0; i < n; ++i) {
      const T* Li = Ls + tri<LL>(i, 0);
      T t = r[i * step];
#pragma unroll 4
      for (LL kk = 0; kk < i; ++kk) t -= mul_rn(Li[kk], y[kk]);
      y[i] = t * Li[i];
    }
    for (LL i = n - 1; i >= 0; --i) {
      T t = y[i];
      LL ki = tri<LL>(i + 1, i);  // (kk, i), kk = i+1, i+2, …
#pragma unroll 4
      for (LL kk = i + 1; kk < n; ++kk) {
        t -= mul_rn(Ls[ki], y[kk]);
        ki += kk + 1;
      }
      y[i] = t * Ls[tri<LL>(i, i)];
      xc[i * step] = y[i];
    }
    return;
  }
  for (LL i = 0; i < n; ++i) {
    const T* Li = Ls + tri<LL>(i, 0);
    T t = r[i * step];
    for (LL kk = 0; kk < i; ++kk) t -= mul_rn(Li[kk], xc[kk * step]);
    xc[i * step] = t * Li[i];
  }
  for (LL i = n - 1; i >= 0; --i) {
    T t = xc[i * step];
    LL ki = tri<LL>(i + 1, i);
    for (LL kk = i + 1; kk < n; ++kk) {
      t -= mul_rn(Ls[ki], xc[kk * step]);
      ki += kk + 1;
    }
    xc[i * step] = t * Ls[tri<LL>(i, i)];
  }
}

// NC > 0: compile-time width NC (n == NC), one thread a factor; NC == 0:
// any n, one warp a factor
template <typename T, int NC>
__global__ void __launch_bounds__(max_threads<T, NC>())
    chol_lanes_kernel(const T* __restrict__ G, const T* __restrict__ rhs,
                      T* __restrict__ x, T* __restrict__ ws, int n_rt, int k,
                      int B, int ts_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = NC > 0 ? NC : n_rt;
  const int ts = 1 << ts_log2;
  const long long sp = stride_of(n);
  const long long b0 = static_cast<long long>(blockIdx.x) * ts;
  const size_t Bs = static_cast<size_t>(B);
  T* work = reinterpret_cast<T*>(smem_raw);

  if constexpr (NC > 0) {
    // 1–2. each scenario's thread loads and factors it
    if (threadIdx.x < ts)
      factor_thread<T, NC>(G, Bs, b0 + threadIdx.x, B,
                           work + threadIdx.x * sp);
  } else {
    if (ws != nullptr) work = ws + b0 * sp;
    // 1. the tile's lower triangles: entry (i, j) of TS neighbouring
    // scenarios is one row of G, e runs over (i, j, s) with s fastest
    const long long count = static_cast<long long>(n) * n << ts_log2;
#pragma unroll 4
    for (long long e = threadIdx.x; e < count; e += blockDim.x) {
      const long long ij = e >> ts_log2;
      const int s = static_cast<int>(e & (ts - 1));
      const long long i = ij / n, j = ij - i * n;
      const long long b = b0 + s;
      if (j <= i)
        work[s * sp + tri<long long>(i, j)] =
            b < B ? G[ij * Bs + b] : (i == j ? T(1) : T(0));
    }
    __syncthreads();
    // 2. one warp a scenario
    const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
    for (int s = threadIdx.x >> 5; s < ts; s += warps)
      factor_warp(work + s * sp, n, lane);
  }
  __syncthreads();

  // 3. the substitutions, one (scenario, column) pair a thread
  const long long pairs = static_cast<long long>(k) << ts_log2;
  const size_t step = static_cast<size_t>(k) * Bs;  // from row i to i+1
  for (long long p = threadIdx.x; p < pairs; p += blockDim.x) {
    const int s = static_cast<int>(p & (ts - 1));
    const long long b = b0 + s;
    if (b >= B) continue;
    const size_t col = static_cast<size_t>(p >> ts_log2) * Bs + b;
    const T* Ls = work + s * sp;
    const T* r = rhs + col;
    T* xc = x + col;
    if constexpr (NC > 0) {
      T y[NC];
#pragma unroll
      for (int i = 0; i < NC; ++i) {  // forward: L y = r
        T t = r[i * step];
#pragma unroll
        for (int kk = 0; kk < i; ++kk)
          t -= mul_rn(Ls[tri(i, kk)], y[kk]);
        y[i] = t * Ls[tri(i, i)];
      }
#pragma unroll
      for (int i = NC - 1; i >= 0; --i) {  // backward: Lᵀ x = y, in place
        T t = y[i];
#pragma unroll
        for (int kk = i + 1; kk < NC; ++kk)
          t -= mul_rn(Ls[tri(kk, i)], y[kk]);
        y[i] = t * Ls[tri(i, i)];
        xc[i * step] = y[i];
      }
    } else {
      substitute(Ls, r, xc, n, step);
    }
  }
}

template <typename T>
int launch(const void* G, const void* rhs, void* x, void* ws,
           long long ws_count, int n, int k, int B, void* stream) {
  if (n < 1 || k < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long sp = stride_of(n);
  const long long per = sp * static_cast<long long>(sizeof(T));
  // past a block's shared memory the work area is the wrapper's workspace:
  // sp values for each of B scenarios rounded up to 32
  const bool in_device_memory = per > kSmemMax;
  if (in_device_memory &&
      (ws == nullptr || ws_count < (B + 31LL) / 32 * 32 * sp))
    return static_cast<int>(cudaErrorInvalidValue);
  int ts_log2 = 5;
  while (ts_log2 > 0 && (per << ts_log2) > kSmemTile) --ts_log2;
  while (ts_log2 > 2 && (B + (1LL << ts_log2) - 1) >> ts_log2 < kSMs)
    --ts_log2;
  const int ts = 1 << ts_log2;
  const bool unrolled = n <= kUnrolledMax;
  // every pair a thread where the block allows; the warp factor wants a
  // warp a scenario, up to 16
  long long want = static_cast<long long>(k) * ts;
  const long long factor_threads = unrolled ? ts : 32LL * (ts < 16 ? ts : 16);
  if (want < factor_threads) want = factor_threads;
  const int cap = unrolled ? max_threads<T, 1>() : max_threads<T, 0>();
  const int threads =
      static_cast<int>(want >= cap ? cap : (want + 31) / 32 * 32);
  const size_t smem = in_device_memory ? 0 : static_cast<size_t>(per) * ts;
  const int blocks = static_cast<int>((B + ts - 1LL) / ts);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* g = static_cast<const T*>(G);
  const T* r = static_cast<const T*>(rhs);
  T* o = static_cast<T*>(x);
  T* w = in_device_memory ? static_cast<T*>(ws) : nullptr;
  switch (unrolled ? n : 0) {
#define REAK_CHOL_CASE(NN)                                                   \
  case NN:                                                                   \
    chol_lanes_kernel<T, NN><<<blocks, threads, smem, s>>>(g, r, o, w, n, k, \
                                                           B, ts_log2);      \
    break;
    REAK_CHOL_CASE(1) REAK_CHOL_CASE(2) REAK_CHOL_CASE(3) REAK_CHOL_CASE(4)
    REAK_CHOL_CASE(5) REAK_CHOL_CASE(6) REAK_CHOL_CASE(7) REAK_CHOL_CASE(8)
    REAK_CHOL_CASE(9) REAK_CHOL_CASE(10) REAK_CHOL_CASE(11)
    REAK_CHOL_CASE(12)
#undef REAK_CHOL_CASE
    default: {
      auto kernel = chol_lanes_kernel<T, 0>;
      if (smem > 48 * 1024) {
        const cudaError_t rc = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (rc != cudaSuccess) return static_cast<int>(rc);
      }
      kernel<<<blocks, threads, smem, s>>>(g, r, o, w, n, k, B, ts_log2);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace reak

extern "C" {

// K3a (k = 1: rhs and x (n, B)) and K3b (rhs and x (n, k, B)); ws: the
// workspace of ws_count values where one scenario's triangle does not fit
// a block's shared memory, else null
int reak_chol_solve_f32(const void* G, const void* rhs, void* x, void* ws,
                        long long ws_count, int n, int k, int B,
                        void* stream) {
  return reak::launch<float>(G, rhs, x, ws, ws_count, n, k, B, stream);
}

int reak_chol_solve_f64(const void* G, const void* rhs, void* x, void* ws,
                        long long ws_count, int n, int k, int B,
                        void* stream) {
  return reak::launch<double>(G, rhs, x, ws, ws_count, n, k, B, stream);
}

const char* reak_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
