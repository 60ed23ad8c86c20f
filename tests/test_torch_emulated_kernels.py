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


def _emulated_sources(dst):
    """The sources with the launches, the dynamic shared memory and the
    cp.async instructions rewritten for the host."""
    for src in list(_build.CSRC.glob("*.cu")) + list(_build.CSRC.glob("*.cuh")):
        s = src.read_text()
        s = re.sub(r"([\w:]+(?:<[^<>]*>)?)\s*<<<(.*?)>>>\s*\(",
                   r"emu_launch(\1, \2)(", s, flags=re.S)
        s = re.sub(r"extern __shared__ __align__\(16\) unsigned char "
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


def _k2(emulated, p, iters=8):
    """K2 on the problem ``p`` through its C entry point."""
    A = p["A"]
    H, n, _, B = A.shape
    m, dtype = p["Bm"].shape[2], A.dtype
    tile = _tile.tile_config(n, m, dtype)
    name = pdip_whole.library(tile.bound, dtype)
    f = _fn(emulated(name), pdip_whole.entry_point(tile.bound, dtype),
            pdip_whole.LIBRARIES[name][pdip_whole.entry_point(tile.bound,
                                                              dtype)])
    u, xs = _nan(H, m, B, dtype=dtype), _nan(H, n, B, dtype=dtype)
    scratch = _nan(pdip_whole.scratch_values(H, n, m)
                   * tile.padded_batch(B), dtype=dtype)
    args = [_p(p[k]) for k in ("A", "Bm", "c")] + [None, None] + [
        _p(p[k]) for k in ("x0", "Q", "QN", "R", "lb", "ub")] + [
        _p(u), _p(xs), _p(scratch), scratch.numel()]
    if tile.runtime:
        work = _nan(tile.work_values(B), dtype=dtype)
        rc = f(*args, _p(work), work.numel(), H, n, m, B, iters,
               tile.scenarios, tile.blocks(B), tile.shared_bytes, None)
    else:
        rc = f(*args, H, n, m, B, iters, tile.shared_bytes, None)
    assert rc == 0
    return u, xs


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


def _step_outputs(emulated, spec, x, u, dt, monkeypatch):
    """K1's and K5's outputs through the wrappers' launch, on the emulated
    libraries."""
    monkeypatch.setattr(_build, "function", lambda name, fn, sigs: _fn(
        emulated(name), fn, sigs[fn]))
    monkeypatch.setattr(_build, "stream_ptr", lambda device: None)
    n, nv, B = x.shape[0], spec.nv, x.shape[1]
    k1 = (_nan(n, n, B, dtype=x.dtype), _nan(n, nv, B, dtype=x.dtype),
          _nan(n, B, dtype=x.dtype), _nan(n, B, dtype=x.dtype))
    k5 = (_nan(nv, B, dtype=x.dtype), _nan(nv, n, B, dtype=x.dtype),
          _nan(nv, nv, B, dtype=x.dtype))
    kte_step.launch("step", spec, x, u, k1, dt, 4, {})
    kte_step.launch("core", spec, x, u, k5, 0.0, 1, {})
    return k1, k5


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
