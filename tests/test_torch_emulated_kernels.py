"""The port's CUDA C++ sources run on the CPU, against their plain versions.

A CUDA kernel has no interpret mode, so the tile (K2, K4a-c) and the
rollout step (K1, K5) are compiled here by the host's C++ compiler under a
small emulation of the CUDA runtime: each block's threads run as
``std::thread``s, ``__syncthreads`` is a ``std::barrier``, a kernel launch
runs the blocks one after another, and ``cp.async`` copies at once.  The
libraries take CPU pointers through the entry points the wrappers call.
This holds the one source of each kernel at compile-time and at run-time
widths (the runtime policy's shared and device-memory branches, a tile of
one and two scenarios) to the plain torch versions: f64 within 1e-9
relative, f32 within twice the plain f32 path's error.  Small shapes; the
libraries are built once per module.
"""
import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from reak_tpu_torch.ctrl import riccati_soa
from reak_tpu_torch.kte import models
from reak_tpu_torch.ops import _build, _tile, kte_core, kte_step, pdip_whole
from reak_tpu_torch.ops import riccati_bwd

CXX = shutil.which("g++")
pytestmark = pytest.mark.skipif(CXX is None, reason="no host C++ compiler")

# what the sources take from the CUDA runtime, on host threads
RUNTIME_H = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __restrict__
#define __grid_constant__
#define __launch_bounds__(...)
#define __align__(n)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 gridDim, blockDim;
inline std::barrier<>* emu_barrier = nullptr;
inline unsigned char* emu_shared = nullptr;
inline unsigned char* emu_smem() { return emu_shared; }
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
inline unsigned long long __cvta_generic_to_shared(const void*) { return 0; }
inline void sincos(double a, double* s, double* c) {
  *s = std::sin(a);
  *c = std::cos(a);
}
inline void sincosf(float a, float* s, float* c) {
  *s = std::sin(a);
  *c = std::cos(a);
}
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorInvalidConfiguration = 9 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
typedef struct CUstream_st* cudaStream_t;
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* b, K, int,
                                                          size_t) {
  *b = 1;
  return 0;
}
using std::fmax;
using std::fmin;
using std::sqrt;
template <class K>
struct EmuLaunch {
  K k;
  dim3 grid, block;
  size_t smem;
  template <class... A>
  void operator()(A... a) {
    std::vector<unsigned char> buf(smem + 16);
    gridDim = grid;
    blockDim = block;
    const int nt = block.x * block.y;
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::barrier<> bar(nt);
      emu_barrier = &bar;
      std::memset(buf.data(), 0xff, buf.size());  // not zeros, as on a card
      emu_shared = reinterpret_cast<unsigned char*>(
          (reinterpret_cast<uintptr_t>(buf.data()) + 15) & ~uintptr_t(15));
      std::vector<std::thread> threads;
      for (int t = 0; t < nt; ++t)
        threads.emplace_back([&, t, bx] {
          threadIdx = dim3(t % block.x, t / block.x);
          blockIdx = dim3(bx);
          k(a...);
        });
      for (auto& th : threads) th.join();
    }
  }
};
template <class K, class G, class B, class S, class St>
EmuLaunch<K> emu_launch(K k, G g, B b, S smem, St) {
  return {k, dim3(g), dim3(b), size_t(smem)};
}
"""


# csrc/hopper.cuh on host threads: a tensor map holds its array's layout and
# a load copies its box at once (zeros outside the array), counting its
# bytes on the mbarrier; an mbarrier completes a phase after its arrivals
# and the bytes it expects, as on the card
HOPPER_H = r"""
#pragma once
#include <condition_variable>
#include <map>
#include <mutex>
namespace reak {
struct TmaMap {
  const unsigned char* base;
  int rank, esize;
  uint64_t dims[5], strides[5];
  uint32_t box[5];
};
inline int tma_encode(TmaMap* m, const void* base, int rank,
                      const uint64_t* dims, const uint64_t* strides,
                      const uint32_t* box, int esize) {
  if (reinterpret_cast<uintptr_t>(base) % 16 || (box[0] * esize) % 16)
    return cudaErrorInvalidValue;
  m->base = static_cast<const unsigned char*>(base);
  m->rank = rank;
  m->esize = esize;
  m->strides[0] = esize;
  for (int i = 0; i < rank; ++i) {
    if (box[i] < 1 || box[i] > 256) return cudaErrorInvalidValue;
    m->dims[i] = dims[i];
    m->box[i] = box[i];
    if (i > 0) {
      if (strides[i - 1] % 16) return cudaErrorInvalidValue;
      m->strides[i] = strides[i - 1];
    }
  }
  return 0;
}
struct EmuMbar {
  int count, pending;
  long long tx;
  unsigned phase;
};
inline std::mutex emu_mbar_mu;
inline std::map<const void*, EmuMbar> emu_mbars;
inline void emu_complete(EmuMbar& b) {
  if (b.pending == 0 && b.tx == 0) {
    b.phase ^= 1u;
    b.pending = b.count;
  }
}
inline void mbar_init(uint64_t* bar, int count) {
  std::lock_guard<std::mutex> l(emu_mbar_mu);
  emu_mbars[bar] = {count, count, 0, 0};
}
inline void mbar_fence_init() {}
inline void mbar_arrive(uint64_t* bar) {
  std::lock_guard<std::mutex> l(emu_mbar_mu);
  EmuMbar& b = emu_mbars.at(bar);
  --b.pending;
  emu_complete(b);
}
inline void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  std::lock_guard<std::mutex> l(emu_mbar_mu);
  EmuMbar& b = emu_mbars.at(bar);
  b.tx += bytes;
  --b.pending;
  emu_complete(b);
}
inline bool mbar_test(uint64_t* bar, uint32_t parity) {
  std::lock_guard<std::mutex> l(emu_mbar_mu);
  return emu_mbars.at(bar).phase != parity;
}
inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_test(bar, parity)) std::this_thread::yield();
}
inline void emu_tma(void* dst, const TmaMap* m, uint64_t* bar,
                    const long long* c) {
  unsigned char* out = static_cast<unsigned char*>(dst);
  long long idx[5] = {0, 0, 0, 0, 0};
  long long total = 1;
  for (int i = 0; i < m->rank; ++i) total *= m->box[i];
  for (long long e = 0; e < total; ++e) {
    long long r = e, off = 0;
    bool in = true;
    for (int i = 0; i < m->rank; ++i) {
      idx[i] = r % m->box[i];
      r /= m->box[i];
      const long long g = c[i] + idx[i];
      in = in && g >= 0 && g < static_cast<long long>(m->dims[i]);
      off += g * static_cast<long long>(m->strides[i]);
    }
    if (in)
      std::memcpy(out + e * m->esize, m->base + off, m->esize);
    else
      std::memset(out + e * m->esize, 0, m->esize);
  }
  std::lock_guard<std::mutex> l(emu_mbar_mu);
  EmuMbar& b = emu_mbars.at(bar);
  b.tx -= total * m->esize;
  emu_complete(b);
}
inline void tma_load(void* dst, const TmaMap* m, uint64_t* bar, int c0,
                     int c1, int c2) {
  const long long c[5] = {c0, c1, c2, 0, 0};
  emu_tma(dst, m, bar, c);
}
inline void tma_load(void* dst, const TmaMap* m, uint64_t* bar, int c0,
                     int c1, int c2, int c3) {
  const long long c[5] = {c0, c1, c2, c3, 0};
  emu_tma(dst, m, bar, c);
}
struct EmuNamed {
  std::mutex mu;
  std::condition_variable cv;
  int arrived = 0;
  unsigned gen = 0;
};
inline EmuNamed emu_named[16];
inline void named_sync(int id, int threads) {
  EmuNamed& b = emu_named[id];
  std::unique_lock<std::mutex> l(b.mu);
  const unsigned g = b.gen;
  if (++b.arrived == threads) {
    b.arrived = 0;
    ++b.gen;
    b.cv.notify_all();
  } else {
    b.cv.wait(l, [&] { return b.gen != g; });
  }
}
inline void fence_proxy_async_global() {}
template <int R>
inline void regs_dec() {}
template <int R>
inline void regs_inc() {}
}  // namespace reak
"""

def _emulated_sources(dst):
    """The sources with the launches, the dynamic shared memory and the
    cp.async instructions rewritten for the host."""
    for src in list(_build.CSRC.glob("*.cu")) + list(_build.CSRC.glob("*.cuh")):
        s = src.read_text()
        s = re.sub(r"([\w:]+(?:<[^<>]*>)?)\s*<<<(.*?)>>>\s*\(",
                   r"emu_launch(\1, \2)(", s, flags=re.S)
        s = re.sub(r"extern __shared__ __align__\(\d+\) unsigned char "
                   r"(\w+)\[\];", r"unsigned char* \1 = emu_smem();", s)
        s = re.sub(r"(void cp_async_16\(void\* dst, const void\* src, "
                   r"int src_bytes\) )\{.*?\n\}",
                   r"\1{ if (src_bytes) std::memcpy(dst, src, 16); "
                   r"else std::memset(dst, 0, 16); }", s, flags=re.S)
        s = re.sub(r"(void cp_async_value\(void\* dst, const void\* src,"
                   r"\s*int src_bytes\) )\{.*?\n\}",
                   r"\1{ if (src_bytes) std::memcpy(dst, src, BYTES); "
                   r"else std::memset(dst, 0, BYTES); }", s, flags=re.S)
        s = re.sub(r"asm volatile\(.*?\);", "", s, flags=re.S)
        (dst / src.name).write_text(s)
    (dst / "cuda_runtime.h").write_text(RUNTIME_H)
    (dst / "hopper.cuh").write_text(HOPPER_H)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """{library name: the library}, built from the emulated sources at
    first use."""
    src = tmp_path_factory.mktemp("csrc")
    _emulated_sources(src)
    libs = {}

    def get(name):
        if name not in libs:
            source, defines = _build._source_and_defines(name)
            out = src / f"lib{name.replace('@', '_')}.so"
            subprocess.run([CXX, "-std=c++20", "-O1", "-shared", "-fPIC",
                            "-pthread", "-w", "-x", "c++", "-I", str(src),
                            *defines, str(src / source.name), "-o", str(out)],
                           check=True)
            libs[name] = ctypes.CDLL(str(out))
        return libs[name]

    return get


def _fn(lib, name, argtypes):
    f = getattr(lib, name)
    f.argtypes, f.restype = argtypes, ctypes.c_int
    return f


def _p(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _nan(*shape, dtype):
    return torch.full(shape, float("nan"), dtype=dtype)


def _k2(emulated, p, iters=8, refs=(None, None)):
    """K2 on the problem ``p`` through its C entry point, the batch padded
    as the wrapper pads it for the pipeline's tensor maps; ``refs`` are
    x_ref (H, n, B) and u_ref (H, m, B) or None."""
    A = p["A"]
    H, n, _, B_out = A.shape
    m, dtype = p["Bm"].shape[2], A.dtype
    tile = _tile.k2_config(n, m, dtype)
    ins = [p[k] for k in ("A", "Bm", "c", "x0")]
    refs, B = list(refs), B_out
    if not tile.runtime:
        *ins, refs, B = pdip_whole._tma_batch(tile, *ins, refs)
    name = pdip_whole.library(tile.bound, dtype)
    f = _fn(emulated(name), pdip_whole.entry_point(tile.bound, dtype),
            pdip_whole.LIBRARIES[name][pdip_whole.entry_point(tile.bound,
                                                              dtype)])
    u, xs = _nan(H, m, B, dtype=dtype), _nan(H, n, B, dtype=dtype)
    scratch = _nan(pdip_whole.scratch_values(H, n, m)
                   * tile.padded_batch(B), dtype=dtype)
    args = [_p(t) for t in ins[:3]] + [_p(r) for r in refs] + [
        _p(ins[3])] + [_p(p[k]) for k in ("Q", "QN", "R", "lb", "ub")] + [
        _p(u), _p(xs), _p(scratch), scratch.numel()]
    if tile.runtime:
        work = _nan(tile.work_values(B), dtype=dtype)
        rc = f(*args, _p(work), work.numel(), H, n, m, B, iters,
               tile.scenarios, tile.blocks(B), tile.shared_bytes, None)
    else:
        rc = f(*args, H, n, m, B, iters, tile.shared_bytes, None)
    assert rc == 0
    return u[..., :B_out], xs[..., :B_out]


def _k4(emulated, entry, ins, outs):
    """One of K4a-c through its C entry point; returns ``outs``."""
    H, n, _, B = ins[0].shape
    m, dtype = ins[1].shape[2], ins[0].dtype
    tile = _tile.tile_config(n, m, dtype)
    name = riccati_bwd.library(tile.bound, dtype)
    fn = riccati_bwd.entry_point(entry, tile.bound, dtype)
    f = _fn(emulated(name), fn, riccati_bwd.LIBRARIES[name][fn])
    ptrs = [_p(t.contiguous()) for t in ins] + [_p(t) for t in outs]
    if tile.runtime:
        work = _nan(tile.work_values(B), dtype=dtype)
        rc = f(*ptrs, H, n, m, B, tile.scenarios, tile.blocks(B), _p(work),
               work.numel(), tile.shared_bytes, None)
    else:
        rc = f(*ptrs, H, n, m, B, tile.shared_bytes, None)
    assert rc == 0
    return outs


def _problem(n, m, batch, horizon, seed):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64).contiguous()
    return {"A": t(0.1 * rng.standard_normal((horizon, n, n, batch))
                   + np.eye(n)[None, :, :, None]),
            "Bm": t(0.2 * rng.standard_normal((horizon, n, m, batch))),
            "c": t(0.05 * rng.standard_normal((horizon, n, batch))),
            "Q": t(np.eye(n) + 0.01), "QN": t(5.0 * np.eye(n)),
            "R": t(0.1 * np.eye(m) + 0.01),
            "x0": t(rng.standard_normal((n, batch))),
            "lb": t(np.full(m, -1.5)), "ub": t(np.full(m, 1.5)),
            "q": t(rng.standard_normal((horizon, n, batch))),
            "u_eff": t(rng.standard_normal((horizon, m, batch))),
            "D": t(rng.uniform(0.5, 2.0, (horizon, m, batch))),
            "rhs": t(rng.standard_normal((horizon, m, batch))),
            "k": t(rng.standard_normal((horizon, m, batch))),
            "dx0": t(rng.standard_normal((n, batch)))}


def _tile_outputs(emulated, p, K, G):
    """K2's (u, xs) and K4a-c's outputs on ``p``, by kernel and by plain
    version; K4b and K4c on the gains K, G."""
    dtype = p["A"].dtype
    H, n, _, B = p["A"].shape
    m = p["Bm"].shape[2]
    k2 = [p[k] for k in ("A", "Bm", "c", "Q", "QN", "R", "x0", "lb", "ub")]
    pa = [p[k] for k in ("A", "Bm", "q", "u_eff", "D", "Q", "QN", "R")]
    vb = [p["A"], p["Bm"], p["rhs"], K, G]
    fw = [p["A"], p["Bm"], K, p["k"], p["dx0"]]
    got = {"k2": _k2(emulated, p),
           "fused_backward": _k4(emulated, "fused_backward", pa, (
               _nan(H, m, B, dtype=dtype), _nan(H, m, n, B, dtype=dtype),
               _nan(H, m, m, B, dtype=dtype), _nan(H, m, B, dtype=dtype))),
           "vector_backward": _k4(emulated, "vector_backward", vb,
                                  (_nan(H, m, B, dtype=dtype),)),
           "forward": _k4(emulated, "forward", fw, (
               _nan(H, m, B, dtype=dtype), _nan(H, n, B, dtype=dtype)))}
    plain = {"k2": riccati_soa._fused_scan(*k2, iters=8),
             "fused_backward": riccati_soa.fused_backward_plain(*pa),
             "vector_backward": (riccati_soa.vector_backward_plain(*vb),),
             "forward": riccati_soa.forward_plain(*fw)}
    return got, plain


@pytest.mark.parametrize("nm,batch,horizon,branch", [
    ((13, 7), 5, 3, "compile-time"),
    ((33, 17), 5, 2, "shared"),
    ((62, 31), 9, 2, "device")])
def test_tile_kernels_match_the_plain_passes_f64(emulated, nm, batch,
                                                 horizon, branch):
    """K2 and K4a-c at f64 within 1e-9 relative of the plain versions: the
    padded compile-time instance (13, 7) and the runtime policy with its
    rows in shared and in device memory; K4 leaves its inputs as they
    were."""
    tile = _tile.tile_config(*nm, torch.float64)
    assert (tile.branch if tile.runtime else "compile-time") == branch
    p = _problem(*nm, batch, horizon, seed=sum(nm))
    K, G = riccati_soa.fused_backward_plain(*[
        p[k] for k in ("A", "Bm", "q", "u_eff", "D", "Q", "QN", "R")])[1:3]
    before = {k: v.clone() for k, v in p.items()}
    got, plain = _tile_outputs(emulated, p, K, G)
    for key in got:
        for g, w in zip(got[key], plain[key]):
            assert float((g - w).abs().max() / w.abs().max()) <= 1e-9, key
    assert all(torch.equal(p[k], before[k]) for k in p)


@pytest.mark.parametrize("nm", [(33, 17), (62, 31)])
def test_runtime_tile_f32_within_twice_the_plain_error(emulated, nm):
    """At f32 the runtime policy (its sums in f64; a tile of 4 and of 2
    scenarios, the latter too narrow for 16 B copies) is within twice the
    plain f32 path's error against the plain f64 result."""
    tile = _tile.tile_config(*nm, torch.float32)
    assert tile.runtime and tile.branch == "shared"
    p = _problem(*nm, 5, 2, seed=sum(nm))
    q = {k: v.float() for k, v in p.items()}
    K, G = riccati_soa.fused_backward_plain(*[
        p[k] for k in ("A", "Bm", "q", "u_eff", "D", "Q", "QN", "R")])[1:3]
    _, ref = _tile_outputs(emulated, p, K, G)
    got, plain32 = _tile_outputs(emulated, q, K.float(), G.float())
    for key in got:
        for g, pl, r in zip(got[key], plain32[key], ref[key]):
            assert (g.double() - r).abs().max() <= 2 * (
                pl.double() - r).abs().max(), key


def _step_outputs(emulated, spec, x, u, dt, monkeypatch, split=None,
                  entries=None):
    """K1's and K5's outputs through the wrappers' launch, on the emulated
    libraries (``split``: the mode, where given; ``entries`` collects the
    C functions called)."""
    def function(name, fn, sigs):
        if entries is not None:
            entries.append(fn)
        return _fn(emulated(name), fn, sigs[fn])

    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: None)
    n, nv, B = x.shape[0], spec.nv, x.shape[1]
    k1 = (_nan(n, n, B, dtype=x.dtype), _nan(n, nv, B, dtype=x.dtype),
          _nan(n, B, dtype=x.dtype), _nan(n, B, dtype=x.dtype))
    k5 = (_nan(nv, B, dtype=x.dtype), _nan(nv, n, B, dtype=x.dtype),
          _nan(nv, nv, B, dtype=x.dtype))
    kte_step.launch("step", spec, x, u, k1, dt, 4, {}, split=split)
    kte_step.launch("core", spec, x, u, k5, 0.0, 1, {}, split=split)
    return k1, k5


def _ragged_states(spec, batch):
    rng = np.random.default_rng(batch)
    nv = spec.nv
    x = torch.as_tensor(np.concatenate([rng.uniform(-0.5, 0.5, (nv, batch)),
                                        rng.uniform(-0.3, 0.3, (nv, batch))]))
    return x, torch.as_tensor(rng.uniform(-5.0, 5.0, (nv, batch)))


def _hold_to_plain(spec, k1, k5, x64, u64, dtype):
    """f64 within 1e-9 relative of the plain step and core; f32 within
    twice the plain f32 error against the plain f64 result."""
    want = (kte_step.make_step_plain(spec, 0.01)(x64, u64)
            + kte_core.make_core_plain(spec)(x64, u64))
    if dtype == torch.float64:
        for g, w in zip(k1 + k5, want):
            assert float((g - w).abs().max() / w.abs().max()) <= 1e-9
    else:
        x, u = x64.to(dtype), u64.to(dtype)
        plain = (kte_step.make_step_plain(spec, 0.01)(x, u)
                 + kte_core.make_core_plain(spec)(x, u))
        for g, p, w in zip(k1 + k5, plain, want):
            assert (g.double() - w).abs().max() <= 2 * (
                p.double() - w).abs().max()


@pytest.mark.parametrize("spec,dt", [(models.planar_2link(), 0.01),
                                     (models.flexible_beam(17), 2e-6)],
                         ids=["planar_2link", "beam17"])
def test_step_kernel_matches_the_plain_step(emulated, spec, dt,
                                            monkeypatch):
    """K1 and K5 at f64 within 1e-9 relative of the plain step and core, at
    compile-time widths (2, 2) and on the runtime-width instance (17
    joints, two tiles of the batch)."""
    rng = np.random.default_rng(spec.nv)
    nv, B = spec.nv, 9
    x = torch.as_tensor(np.concatenate([rng.uniform(-0.5, 0.5, (nv, B)),
                                        rng.uniform(-0.5, 0.5, (nv, B))]))
    u = torch.as_tensor(rng.uniform(-5.0, 5.0, (nv, B)))
    k1, k5 = _step_outputs(emulated, spec, x, u, dt, monkeypatch)
    want1 = kte_step.make_step_plain(spec, dt)(x, u)
    want5 = kte_core.make_core_plain(spec)(x, u)
    for g, w in list(zip(k1, want1)) + list(zip(k5, want5)):
        assert float((g - w).abs().max() / w.abs().max()) <= 1e-9


@pytest.mark.parametrize("chain,dtype,batch", [
    ("planar_2link", torch.float64, 77),
    ("manip_3r_planar", torch.float32, 77), ("mixed_chain", torch.float64, 41)])
def test_step_kernel_pair_slots_on_ragged_batches(emulated, chain, dtype,
                                                  batch, monkeypatch):
    """K1 and K5 at compile-time widths on ragged batches of several tiles:
    each thread's q run, its own factor of M, its columns, then its q̇ run
    and column; the primal phase on the last slot ((2, 2): two pair slots
    of 16 in one warp; the mixed chain) or on a spare one ((3, 3) f32:
    three slots in two warps); the anchors' and axes' outer parts in
    shared memory ((2, 2), (3, 3)) and in registers (the mixed chain's
    (8, 6) f64: FIXED and PRISMATIC joints, offsets, springs, dampers, full
    inertia).  f64 within 1e-9 relative of the plain step and core; f32
    within twice the plain f32 error against the plain f64 result."""
    spec = getattr(models, chain)()
    shape = kte_step.launch_shape(spec.n_joints, spec.nv, dtype)
    assert shape.blocks(batch) > 1 and batch % shape.scenarios
    spare = shape.threads // shape.scenarios > spec.nv
    assert spare == (chain == "manip_3r_planar")
    assert shape.outer_shared == (chain != "mixed_chain")
    x64, u64 = _ragged_states(spec, batch)
    k1, k5 = _step_outputs(emulated, spec, x64.to(dtype), u64.to(dtype),
                           0.01, monkeypatch)
    _hold_to_plain(spec, k1, k5, x64, u64, dtype)


@pytest.mark.parametrize("chain,dtype,batch", [
    ("planar_2link", torch.float64, 77),
    ("manip_3r_planar", torch.float32, 77), ("mixed_chain", torch.float64, 41)])
def test_step_kernel_split_mode_on_ragged_batches(emulated, chain, dtype,
                                                  batch, monkeypatch):
    """K1 and K5 in the split mode (the grids under one wave) on ragged
    batches of several tiles: a thread one direction, the q ones on the
    pair slots' warps and the q̇ ones on as many more, a q̇ one factoring
    the primal M it takes on its run; the primal phase on the last q̇ slot
    ((2, 2), the mixed chain) or on a spare slot of the q warps ((3, 3)
    f32, whose q̇ warps have a spare slot too); the outer parts in shared
    memory (the mixed chain's too, at one block an SM).  The same bars as
    the pair slots'."""
    spec = getattr(models, chain)()
    nv = spec.nv
    shape = kte_step.launch_shape(spec.n_joints, nv, dtype, split=True)
    assert shape.split and shape.blocks_per_sm == 1 and shape.outer_shared
    q_slots = shape.threads // 2 // shape.scenarios
    assert shape.primal_slot == (nv if q_slots > nv else q_slots + nv - 1)
    assert (q_slots > nv) == (chain == "manip_3r_planar")
    assert shape.blocks(batch) > 1 and batch % shape.scenarios
    x64, u64 = _ragged_states(spec, batch)
    entries = []
    k1, k5 = _step_outputs(emulated, spec, x64.to(dtype), u64.to(dtype),
                           0.01, monkeypatch, split=True, entries=entries)
    assert [e.split("_")[2] for e in entries] == ["step", "core"]
    assert all("_split_" in e for e in entries)
    _hold_to_plain(spec, k1, k5, x64, u64, dtype)


@pytest.mark.parametrize("nm,dtype,mode,batch,horizon,iters", [
    ((12, 6), torch.float64, "regulator", 5, 3, 8),
    ((12, 6), torch.float64, "x_ref+u_ref", 5, 3, 8),
    ((12, 6), torch.float64, "x_ref", 3, 2, 0),
    ((12, 6), torch.float32, "x_ref", 7, 3, 8),
    ((24, 12), torch.float64, "x_ref", 3, 2, 8)])
def test_whole_solve_pipeline_matches_the_plain_scan(emulated, nm, dtype,
                                                     mode, batch, horizon,
                                                     iters):
    """K2's TMA pipeline on its exact instances, in its three modes and at
    0 iterations: f64 within 1e-9 relative of the plain scan, f32 within
    twice the plain f32 scan's error against the plain f64 one.  The
    batches leave the last tile part empty, and in f32 (7 scenarios, 28 B a
    row) the wrapper's padding to whole 16 B rows runs first."""
    p = _problem(*nm, batch, horizon, seed=batch + horizon)
    rng = np.random.default_rng(horizon)
    refs = {"x_ref": torch.as_tensor(
        0.1 * rng.standard_normal((horizon, nm[0], batch))),
        "u_ref": torch.as_tensor(
            0.1 * rng.standard_normal((horizon, nm[1], batch)))}
    keys = ("x_ref", "u_ref") if mode == "x_ref+u_ref" else (
        ("x_ref",) if mode == "x_ref" else ())
    want = riccati_soa._fused_scan(
        *[p[k] for k in ("A", "Bm", "c", "Q", "QN", "R", "x0", "lb", "ub")],
        iters=iters, **{k: refs[k] for k in keys})
    cast = lambda d: {k: v.to(dtype) for k, v in d.items()}
    q, r = cast(p), cast(refs)
    got = _k2(emulated, q, iters=iters,
              refs=[r[k] if k in keys else None for k in ("x_ref", "u_ref")])
    assert _tile.k2_config(*nm, dtype).exact
    if dtype == torch.float64:
        # relative to the larger of the reference's scale and 1: at 0
        # iterations u is the box's middle, 0
        for g, w in zip(got, want):
            assert float((g - w).abs().max()
                         / max(float(w.abs().max()), 1.0)) <= 1e-9
    else:
        plain = riccati_soa._fused_scan(
            *[q[k] for k in ("A", "Bm", "c", "Q", "QN", "R", "x0", "lb",
                             "ub")], iters=iters, **{k: r[k] for k in keys})
        for g, pl, w in zip(got, plain, want):
            assert torch.isfinite(g).all()
            assert (g.double() - w).abs().max() <= 2 * (
                pl.double() - w).abs().max()
