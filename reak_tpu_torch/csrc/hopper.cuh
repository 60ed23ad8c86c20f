// Hopper's asynchronous copy and synchronisation, one small function each,
// for the whole-solve kernel's pipeline (pdip_whole.cu): tensor maps and
// their tiled loads by the tensor memory accelerator (TMA), shared-memory
// barriers (mbarrier) that count arrivals and the bytes of those loads, a
// named barrier among a subset of the block's warps, register reallocation
// between warpgroups (setmaxnreg, sm_90a only) and the fence between the
// generic and the async proxy.  tests/test_torch_emulated_kernels.py puts
// host versions of these functions in this header's place to run the
// kernel on the CPU.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace reak {

using TmaMap = CUtensorMap;

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime's entry
// points, so the library does not link libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// A tiled tensor map of `rank` dimensions over `base`: dims innermost first,
// the byte strides of dims 1 .. rank - 1, the box a load copies; elements
// outside the tensor load as zeros.  0, or a CUDA error code.
inline int tma_encode(TmaMap* map, const void* base, int rank,
                      const uint64_t* dims, const uint64_t* strides,
                      const uint32_t* box, int elem_size) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (rc != cudaSuccess) return static_cast<int>(rc);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorNotSupported);
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  cuuint64_t d[5], st[4];
  cuuint32_t bx[5], one[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    bx[i] = box[i];
    one[i] = 1;
  }
  for (int i = 0; i + 1 < rank; ++i) st[i] = strides[i];
  const CUresult r = encode(
      map,
      elem_size == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT64,
      static_cast<cuuint32_t>(rank), const_cast<void*>(base), d, st, bx, one,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// an mbarrier that completes a phase after `count` arrivals and the bytes
// it was told to expect
__device__ inline void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// after the inits, before the block's barrier that publishes them
__device__ inline void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ inline void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// one arrival that also expects `bytes` of loads to complete on `bar`
__device__ inline void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// whether the phase of parity `parity` has completed
__device__ inline bool mbar_test(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_test(bar, parity)) {
  }
}

// the box of `map` at (c0, c1, c2[, c3]) into shared memory at dst, its
// bytes counted on `bar`
__device__ inline void tma_load(void* dst, const TmaMap* map, uint64_t* bar,
                                int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ inline void tma_load(void* dst, const TmaMap* map, uint64_t* bar,
                                int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// barrier `id` among `threads` threads of the block (whole warps)
__device__ inline void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// this thread's stores to device memory before the tensor loads that follow
__device__ inline void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// a warpgroup's registers a thread, down or up (every warp of it at once)
template <int R>
__device__ inline void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ inline void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

}  // namespace reak
