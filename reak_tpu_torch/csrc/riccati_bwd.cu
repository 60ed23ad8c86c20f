// The per-pass kernels of the scan-fused Mehrotra PDIP, one launch per
// horizon pass: the hand-written Hopper port of the Pallas kernels
// reak_tpu/ops/riccati_bwd_pallas.py::make_fused_backward (K4a),
// ::make_vector_backward (K4b) and ::make_forward (K4c).
//
// Lanes layout, scenario last (H stages, state n, input m, B scenarios):
//   K4a  A (H,n,n,B), Bm (H,n,m,B), q (H,n,B), u_eff (H,m,B), D (H,m,B),
//        Q, QN (n,n), R (m,m) → grad (H,m,B), K (H,m,n,B), G (H,m,m,B),
//        k (H,m,B): the cost-gradient adjoint, the Riccati matrix recursion
//        and the affine vector recursion in one reverse pass over the
//        stages, with the carries V (n,n), λ (n), v (n);
//   K4b  A, Bm, rhs (H,m,B), K, G → k (H,m,B): the corrector's vector
//        reverse pass, carry v (n), each G factored again;
//   K4c  A, Bm, K, k, dx0 (n,B) → du (H,m,B), dx (H,n,B): the closed-loop
//        forward pass du = −K dx − k, dx' = A dx + B du, carry dx (n).
// The inputs are never written.
//
// What bounds them on the H100: by the card's peaks, bytes.  Each stage of
// a scenario reads A and B (216 values at n = 12, m = 6) and a few vectors
// and writes its gains: in f32 K4a moves 1,440 B per stage and scenario
// against ~14k flops, K4b 1,344 B, K4c 1,248 B, so at H = 256, B = 8192 one
// pass moves 2.6-3.0 GB, 0.8-0.9 ms at 3.35 TB/s.  The stages of a scenario
// form a chain (each needs the carry of the stage before it), so what a
// kernel reaches depends on how it hides the latency along that chain.
//
// Design.  The TPU kernels' grid walks the stages in order and keeps the
// carries in VMEM scratch from one grid step to the next; the blocks of a
// CUDA grid run in no order, so every kernel loops over the stages itself.
// All three run the passes of riccati_tile.cuh that the whole-solve kernel
// runs: a tile of scenarios per block, a warp per matrix column, the widths
// at compile time, the carries and the stage's A and B in shared memory,
// the next stage copied in by cp.async while this one computes (see that
// header).  K4a runs its reverse pass, taking q, u_eff and D as they come
// and writing G unfactored.  K4b runs its vector pass on G unfactored: the
// last column factors each stage's G in shared memory, by the recurrence of
// the plain _chol_solve_lanes (d = 1/√s, multiply by d), while the other
// columns form w, so f64 agrees with the plain version to rounding.  K4c
// runs its forward pass from dx0.  Instances: (12, 6) for the fixed-base
// arms and the satellite, (24, 12) for the floating arm's tangent, (32, 16)
// for a 16-segment beam, and padded (16, 8), (24, 12) and (32, 16) ones for
// every other width within (32, 16); past it, one runtime-width instance a
// type (REAK_RUNTIME), the same code on the tile's runtime policy.  Any B >= 1 is taken (the TPU's B % 512 is a tile
// rule).
#include <cuda_runtime.h>

#include "riccati_tile.cuh"

namespace reak {
namespace {

// K4a: what the reverse pass of riccati_tile.cuh reads and writes a stage
template <typename T>
struct FusedBackwardIo {
  static constexpr bool kStageCost = false, kStoreG = true,
                        kStoreFactor = false;
  TileArr<const T> q, u, D;
  TileArr<T> grad, K, G, k;
  const TileThread& th;
  __device__ T x_term(int h, int i) const { return q.load(h, i, 0, th); }
  __device__ T u_eff(int h, int i) const { return u.load(h, i, 0, th); }
  __device__ T barrier(int h, int i) const { return D.load(h, i, 0, th); }
  __device__ void store_grad(int h, int i, T v) const {
    grad.store(h, i, 0, th, v);
  }
  __device__ void store_K(int h, int i, int j, T v) const {
    K.store(h, i, j, th, v);
  }
  __device__ void store_G(int h, int i, int j, T v) const {
    G.store(h, i, j, th, v);
  }
  __device__ void store_factor(int, int, int, T) const {}
  __device__ void store_k(int h, int i, T v) const { k.store(h, i, 0, th, v); }
};

// Registers are held to two blocks an SM where two fit its shared memory:
// measured for K4a at (12, 6) in f32, 80 registers and a 144 B stack with 24
// warps an SM beat 168 registers with 12 (3.70 against 4.31 ms at H = 256,
// B = 8192 on an H100 at 700 W; ops/tile_shapes.py).
#define REAK_TILE_BOUNDS                        \
  __launch_bounds__(Tile<T, NB, MB, EXACT>::NT, \
                    Tile<T, NB, MB, EXACT>::BLOCKS_PER_SM)

template <typename T, int NB, int MB, bool EXACT>
__global__ void REAK_TILE_BOUNDS fused_backward_kernel(
    const T* A_, const T* Bm_, const T* q_, const T* u_, const T* D_,
    const T* Q, const T* QN, const T* R, T* grad_, T* K_, T* G_, T* k_, int H,
    int n_, int m_, int B_, int vec16_) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  using TL = Tile<T, NB, MB, EXACT>;
  const TL wd{};
  const int n = EXACT ? NB : n_, m = EXACT ? MB : m_;
  const long long B = B_;
  const bool vec16 = vec16_ != 0;
  const TileThread th = tile_thread<TL>();
  const TileSmem<T> sm(wd, reinterpret_cast<T*>(tile_smem));
  tile_setup(wd, sm, Q, QN, R, n, m, th);
  const TileLtv<T> ltv{{A_, n, n, B, B, vec16}, {Bm_, n, m, B, B, vec16}};
  FusedBackwardIo<T> io{{q_, n, 1, B, B, vec16},    {u_, m, 1, B, B, vec16},
                        {D_, m, 1, B, B, vec16},    {grad_, m, 1, B, B, vec16},
                        {K_, m, n, B, B, vec16},    {G_, m, m, B, B, vec16},
                        {k_, m, 1, B, B, vec16},    th};
  reverse_pass(wd, sm, io, ltv, H, th);
}

template <typename T, int NB, int MB, bool EXACT>
__global__ void REAK_TILE_BOUNDS vector_backward_kernel(
    const T* A_, const T* Bm_, const T* rhs_, const T* K_, const T* G_, T* k_,
    int H, int n_, int m_, int B_, int vec16_) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  using TL = Tile<T, NB, MB, EXACT>;
  const TL wd{};
  const int n = EXACT ? NB : n_, m = EXACT ? MB : m_;
  const long long B = B_;
  const bool vec16 = vec16_ != 0;
  const TileThread th = tile_thread<TL>();
  const TileSmem<T> sm(wd, reinterpret_cast<T*>(tile_smem));
  tile_clear_stages(wd, sm, th);
  const TileLtv<T> ltv{{A_, n, n, B, B, vec16}, {Bm_, n, m, B, B, vec16}};
  const TileArr<const T> rhs{rhs_, m, 1, B, B, vec16},
      K{K_, m, n, B, B, vec16}, G{G_, m, m, B, B, vec16};
  const TileArr<T> k{k_, m, 1, B, B, vec16};
  vector_pass<TL, true>(wd, sm, ltv, K, G, rhs, k, H, th);
}

template <typename T, int NB, int MB, bool EXACT>
__global__ void REAK_TILE_BOUNDS forward_kernel(const T* A_, const T* Bm_,
                                                const T* K_, const T* k_,
                                                const T* dx0_, T* du_, T* dx_,
                                                int H, int n_, int m_, int B_,
                                                int vec16_) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  using TL = Tile<T, NB, MB, EXACT>;
  const TL wd{};
  const int n = EXACT ? NB : n_, m = EXACT ? MB : m_;
  const long long B = B_;
  const bool vec16 = vec16_ != 0;
  const TileThread th = tile_thread<TL>();
  const TileSmem<T> sm(wd, reinterpret_cast<T*>(tile_smem));
  tile_clear_stages(wd, sm, th);
  const TileLtv<T> ltv{{A_, n, n, B, B, vec16}, {Bm_, n, m, B, B, vec16}};
  const TileArr<const T> K{K_, m, n, B, B, vec16}, k{k_, m, 1, B, B, vec16},
      dx0{dx0_, n, 1, B, B, vec16};
  const TileArr<T> du{du_, m, 1, B, B, vec16}, dx{dx_, n, 1, B, B, vec16};
  forward_pass(wd, sm, ltv, K, k, du, &dx0, &dx, H, th);
}

// Launch one pass's kernel on the instance TL, a block a tile of scenarios;
// the wrapper's launch shape (ops/_tile.py) must be this instance's.
template <class TL, class Kernel, class... Args>
int launch_on_tile(Kernel kernel, int B, int smem_bytes, void* stream,
                   Args... args) {
  if (smem_bytes != TL::SMEM)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<(B + TL::TS - 1) / TL::TS, TL::NT, TL::SMEM,
           static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// The three passes on one instance.
template <typename T, int NB, int MB, bool EXACT>
struct Passes {
  using TL = Tile<T, NB, MB, EXACT>;
  static int fused_backward(const void* A, const void* Bm, const void* q,
                            const void* u, const void* D, const void* Q,
                            const void* QN, const void* R, void* grad,
                            void* K, void* G, void* k, int H, int n, int m,
                            int B, int smem_bytes, void* stream) {
    return launch_on_tile<TL>(
        fused_backward_kernel<T, NB, MB, EXACT>, B, smem_bytes, stream,
        static_cast<const T*>(A), static_cast<const T*>(Bm),
        static_cast<const T*>(q), static_cast<const T*>(u),
        static_cast<const T*>(D), static_cast<const T*>(Q),
        static_cast<const T*>(QN), static_cast<const T*>(R),
        static_cast<T*>(grad), static_cast<T*>(K), static_cast<T*>(G),
        static_cast<T*>(k), H, n, m, B, streams16<T>(B, {A, Bm}));
  }
  static int vector_backward(const void* A, const void* Bm, const void* rhs,
                             const void* K, const void* G, void* k, int H,
                             int n, int m, int B, int smem_bytes,
                             void* stream) {
    return launch_on_tile<TL>(
        vector_backward_kernel<T, NB, MB, EXACT>, B, smem_bytes, stream,
        static_cast<const T*>(A), static_cast<const T*>(Bm),
        static_cast<const T*>(rhs), static_cast<const T*>(K),
        static_cast<const T*>(G), static_cast<T*>(k), H, n, m, B,
        streams16<T>(B, {A, Bm, rhs, K, G}));
  }
  static int forward(const void* A, const void* Bm, const void* K,
                     const void* k, const void* dx0, void* du, void* dx, int H,
                     int n, int m, int B, int smem_bytes, void* stream) {
    return launch_on_tile<TL>(
        forward_kernel<T, NB, MB, EXACT>, B, smem_bytes, stream,
        static_cast<const T*>(A), static_cast<const T*>(Bm),
        static_cast<const T*>(K), static_cast<const T*>(k),
        static_cast<const T*>(dx0), static_cast<T*>(du), static_cast<T*>(dx),
        H, n, m, B, streams16<T>(B, {A, Bm, K, k}));
  }
};

#ifdef REAK_RUNTIME
// The three passes at run-time widths (riccati_tile.cuh's runtime policy),
// the grid walking the batch a tile at a time; `area` is the device-memory
// work area.
template <typename T>
__global__ void __launch_bounds__(ANY_THREADS) fused_backward_any_kernel(
    const T* A_, const T* Bm_, const T* q_, const T* u_, const T* D_,
    const T* Q, const T* QN, const T* R, T* grad_, T* K_, T* G_, T* k_, int H,
    int B_, AnyTile tl, T* area) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  const AnyBlock<T> blk(tl, area);
  const AnyWidths<T> wd = blk.widths(threadIdx.x % tl.ts);
  const TileSmem<T> sm(wd, blk.rows(tile_smem));
  const int n = tl.n, m = tl.m, tiles = (B_ + tl.ts - 1) / tl.ts;
  const long long B = B_;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const TileThread th = any_thread(tl, tile);
    __syncthreads();  // the tile before has left the rows
    tile_setup(wd, sm, Q, QN, R, n, m, th);
    const TileLtv<T> ltv{{A_, n, n, B, B, false}, {Bm_, n, m, B, B, false}};
    FusedBackwardIo<T> io{{q_, n, 1, B, B, false},    {u_, m, 1, B, B, false},
                          {D_, m, 1, B, B, false},    {grad_, m, 1, B, B, false},
                          {K_, m, n, B, B, false},    {G_, m, m, B, B, false},
                          {k_, m, 1, B, B, false},    th};
    reverse_pass(wd, sm, io, ltv, H, th);
  }
}

template <typename T>
__global__ void __launch_bounds__(ANY_THREADS) vector_backward_any_kernel(
    const T* A_, const T* Bm_, const T* rhs_, const T* K_, const T* G_, T* k_,
    int H, int B_, AnyTile tl, T* area) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  const AnyBlock<T> blk(tl, area);
  const AnyWidths<T> wd = blk.widths(threadIdx.x % tl.ts);
  const TileSmem<T> sm(wd, blk.rows(tile_smem));
  const int n = tl.n, m = tl.m, tiles = (B_ + tl.ts - 1) / tl.ts;
  const long long B = B_;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const TileThread th = any_thread(tl, tile);
    __syncthreads();  // the tile before has left the rows
    tile_clear_stages(wd, sm, th);
    const TileLtv<T> ltv{{A_, n, n, B, B, false}, {Bm_, n, m, B, B, false}};
    const TileArr<const T> rhs{rhs_, m, 1, B, B, false},
        K{K_, m, n, B, B, false}, G{G_, m, m, B, B, false};
    const TileArr<T> k{k_, m, 1, B, B, false};
    vector_pass<AnyWidths<T>, true>(wd, sm, ltv, K, G, rhs, k, H, th);
  }
}

template <typename T>
__global__ void __launch_bounds__(ANY_THREADS) forward_any_kernel(
    const T* A_, const T* Bm_, const T* K_, const T* k_, const T* dx0_,
    T* du_, T* dx_, int H, int B_, AnyTile tl, T* area) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  const AnyBlock<T> blk(tl, area);
  const AnyWidths<T> wd = blk.widths(threadIdx.x % tl.ts);
  const TileSmem<T> sm(wd, blk.rows(tile_smem));
  const int n = tl.n, m = tl.m, tiles = (B_ + tl.ts - 1) / tl.ts;
  const long long B = B_;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const TileThread th = any_thread(tl, tile);
    __syncthreads();  // the tile before has left the rows
    tile_clear_stages(wd, sm, th);
    const TileLtv<T> ltv{{A_, n, n, B, B, false}, {Bm_, n, m, B, B, false}};
    const TileArr<const T> K{K_, m, n, B, B, false}, k{k_, m, 1, B, B, false},
        dx0{dx0_, n, 1, B, B, false};
    const TileArr<T> du{du_, m, 1, B, B, false}, dx{dx_, n, 1, B, B, false};
    forward_pass(wd, sm, ltv, K, k, du, &dx0, &dx, H, th);
  }
}

// The three passes of the runtime-width instance.
template <typename T>
struct AnyPasses {
  static int fused_backward(const void* A, const void* Bm, const void* q,
                            const void* u, const void* D, const void* Q,
                            const void* QN, const void* R, void* grad,
                            void* K, void* G, void* k, int H, int n, int m,
                            int B, int ts, int grid, void* work,
                            long long work_count, int smem_bytes,
                            void* stream) {
    const AnyTile tl = any_tile(n, m, int(sizeof(T)));
    return any_launch(
        fused_backward_any_kernel<T>, tl, B, ts, grid, work_count, smem_bytes,
        stream, static_cast<const T*>(A), static_cast<const T*>(Bm),
        static_cast<const T*>(q), static_cast<const T*>(u),
        static_cast<const T*>(D), static_cast<const T*>(Q),
        static_cast<const T*>(QN), static_cast<const T*>(R),
        static_cast<T*>(grad), static_cast<T*>(K), static_cast<T*>(G),
        static_cast<T*>(k), H, B, tl, static_cast<T*>(work));
  }
  static int vector_backward(const void* A, const void* Bm, const void* rhs,
                             const void* K, const void* G, void* k, int H,
                             int n, int m, int B, int ts, int grid,
                             void* work, long long work_count,
                             int smem_bytes, void* stream) {
    const AnyTile tl = any_tile(n, m, int(sizeof(T)));
    return any_launch(
        vector_backward_any_kernel<T>, tl, B, ts, grid, work_count,
        smem_bytes, stream, static_cast<const T*>(A),
        static_cast<const T*>(Bm), static_cast<const T*>(rhs),
        static_cast<const T*>(K), static_cast<const T*>(G),
        static_cast<T*>(k), H, B, tl, static_cast<T*>(work));
  }
  static int forward(const void* A, const void* Bm, const void* K,
                     const void* k, const void* dx0, void* du, void* dx,
                     int H, int n, int m, int B, int ts, int grid, void* work,
                     long long work_count, int smem_bytes, void* stream) {
    const AnyTile tl = any_tile(n, m, int(sizeof(T)));
    return any_launch(
        forward_any_kernel<T>, tl, B, ts, grid, work_count, smem_bytes,
        stream, static_cast<const T*>(A), static_cast<const T*>(Bm),
        static_cast<const T*>(K), static_cast<const T*>(k),
        static_cast<const T*>(dx0), static_cast<T*>(du), static_cast<T*>(dx),
        H, B, tl, static_cast<T*>(work));
  }
};
#endif  // REAK_RUNTIME

template <int NMAX, int MMAX>
bool shape_ok(int H, int n, int m, int B) {
  return H >= 1 && n >= 1 && n <= NMAX && m >= 1 && m <= MMAX && B >= 1;
}

}  // namespace
}  // namespace reak

#ifdef REAK_RUNTIME

extern "C" {

// The runtime-width entry points of this library's type (the library
// riccati_bwd@any_<type>), reak_riccati_<pass>_any_<type>: any (n, m),
// with the tile, grid and work area of ops/_tile.py::tile_config.
#define REAK_ANY_PASS(PASS, ARGS)                          \
  if (H < 1 || n < 1 || m < 1 || B < 1)                    \
    return static_cast<int>(cudaErrorInvalidValue);        \
  return reak::AnyPasses<REAK_TYPE>::PASS ARGS;

#define REAK_RICCATI_ANY_ENTRIES(SUFFIX)                                      \
  int reak_riccati_fused_backward_any_##SUFFIX(                               \
      const void* A, const void* Bm, const void* q, const void* u,            \
      const void* D, const void* Q, const void* QN, const void* R,            \
      void* grad, void* K, void* G, void* k, int H, int n, int m, int B,      \
      int ts, int grid, void* work, long long work_count, int smem_bytes,     \
      void* stream) {                                                         \
    REAK_ANY_PASS(fused_backward,                                             \
                  (A, Bm, q, u, D, Q, QN, R, grad, K, G, k, H, n, m, B, ts,   \
                   grid, work, work_count, smem_bytes, stream))               \
  }                                                                           \
  int reak_riccati_vector_backward_any_##SUFFIX(                              \
      const void* A, const void* Bm, const void* rhs, const void* K,          \
      const void* G, void* k, int H, int n, int m, int B, int ts, int grid,   \
      void* work, long long work_count, int smem_bytes, void* stream) {       \
    REAK_ANY_PASS(vector_backward,                                            \
                  (A, Bm, rhs, K, G, k, H, n, m, B, ts, grid, work,           \
                   work_count, smem_bytes, stream))                           \
  }                                                                           \
  int reak_riccati_forward_any_##SUFFIX(                                      \
      const void* A, const void* Bm, const void* K, const void* k,            \
      const void* dx0, void* du, void* dx, int H, int n, int m, int B,        \
      int ts, int grid, void* work, long long work_count, int smem_bytes,     \
      void* stream) {                                                         \
    REAK_ANY_PASS(forward, (A, Bm, K, k, dx0, du, dx, H, n, m, B, ts, grid,   \
                            work, work_count, smem_bytes, stream))            \
  }
#define REAK_RICCATI_ANY_ENTRIES_OF(SUFFIX) REAK_RICCATI_ANY_ENTRIES(SUFFIX)

REAK_RICCATI_ANY_ENTRIES_OF(REAK_SUFFIX)

const char* reak_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

#else
#if !defined(REAK_NMAX) || !defined(REAK_MMAX) || !defined(REAK_TYPE) || \
    !defined(REAK_SUFFIX)
#error "one bound and type a library: -DREAK_NMAX -DREAK_MMAX -DREAK_TYPE -DREAK_SUFFIX (ops/_build.py)"
#endif

extern "C" {

// The entry points of this library's bound and type, one per pass:
// reak_riccati_<pass>_<NMAX>x<MMAX>_<type>.  Each takes the instance of the
// exact widths where (n, m) are just those, else the padded (NMAX, MMAX).
#define REAK_ON_INSTANCE(NM, MM, T, PASS, ARGS)                  \
  using E = reak::ExactWidths<NM, MM>;                          \
  if (!reak::shape_ok<NM, MM>(H, n, m, B))                      \
    return static_cast<int>(cudaErrorInvalidValue);             \
  if (n == E::N && m == E::M)                                   \
    return reak::Passes<T, E::N, E::M, true>::PASS ARGS;        \
  return reak::Passes<T, NM, MM, false>::PASS ARGS;

#define REAK_RICCATI_ENTRIES(NM, MM, T, SUFFIX)                               \
  int reak_riccati_fused_backward_##NM##x##MM##_##SUFFIX(                     \
      const void* A, const void* Bm, const void* q, const void* u,            \
      const void* D, const void* Q, const void* QN, const void* R,            \
      void* grad, void* K, void* G, void* k, int H, int n, int m, int B,      \
      int smem_bytes, void* stream) {                                         \
    REAK_ON_INSTANCE(NM, MM, T, fused_backward,                               \
                     (A, Bm, q, u, D, Q, QN, R, grad, K, G, k, H, n, m, B,    \
                      smem_bytes, stream))                                    \
  }                                                                           \
  int reak_riccati_vector_backward_##NM##x##MM##_##SUFFIX(                    \
      const void* A, const void* Bm, const void* rhs, const void* K,          \
      const void* G, void* k, int H, int n, int m, int B, int smem_bytes,     \
      void* stream) {                                                         \
    REAK_ON_INSTANCE(NM, MM, T, vector_backward,                              \
                     (A, Bm, rhs, K, G, k, H, n, m, B, smem_bytes, stream))   \
  }                                                                           \
  int reak_riccati_forward_##NM##x##MM##_##SUFFIX(                            \
      const void* A, const void* Bm, const void* K, const void* k,            \
      const void* dx0, void* du, void* dx, int H, int n, int m, int B,        \
      int smem_bytes, void* stream) {                                         \
    REAK_ON_INSTANCE(NM, MM, T, forward,                                      \
                     (A, Bm, K, k, dx0, du, dx, H, n, m, B, smem_bytes,       \
                      stream))                                                \
  }

#define REAK_RICCATI_ENTRIES_OF(NM, MM, T, SUFFIX) \
  REAK_RICCATI_ENTRIES(NM, MM, T, SUFFIX)

REAK_RICCATI_ENTRIES_OF(REAK_NMAX, REAK_MMAX, REAK_TYPE, REAK_SUFFIX)

const char* reak_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

#endif  // REAK_RUNTIME
