"""A CUDA emulator for the CPU: the kernel sources under ``csrc/`` built
with g++ and run as host threads.

:data:`STUB` is a ``cuda_runtime.h`` that runs every CUDA thread as a host
thread and every block of the grid at once (so a grid barrier, or blocks
that wait on each other, meet as on the card), the warp intrinsics as
rounds in which the warp's 32 threads exchange their values,
``__shared__`` as one instance a block (:func:`shared_on_host` rewrites a
source's declarations), and :data:`ATOMIC` libcu++'s ``cuda::atomic_ref``
as ``std::atomic_ref`` (its loads yield the core, so a block spinning at
a grid barrier lets the blocks it waits for run); a test rewrites a
kernel's launch into ``srt_launch``. Used by ``test_torch_sums_source.py``
(the film and material sums) and ``test_torch_live_lanes.py`` (B5's list
of live lanes).
"""
from __future__ import annotations

import os
import re
import shutil
import subprocess

import pytest

from srt_tpu_torch.kernels import build

STUB = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <mutex>
#include <thread>
#include <typeinfo>
#include <vector>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 { unsigned x, y, z; };
inline thread_local uint3 threadIdx{0, 0, 0}, blockIdx{0, 0, 0};
inline dim3 blockDim, gridDim;
struct int2 { int x, y; };
inline int2 make_int2(int x, int y) { return {x, y}; }
struct alignas(16) int4 { int x, y, z, w; };
struct alignas(16) float4 { float x, y, z, w; };
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1,
                   cudaErrorLaunchOutOfResources = 7 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline int sim_env(const char* k, int dflt) {
  const char* v = std::getenv(k);
  return v ? std::atoi(v) : dflt;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int,
                                                          size_t) {
  *n = sim_env("SIM_PER_SM", 1);
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = sim_env("SIM_SMS", 4);
  return cudaSuccess;
}
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}

struct SimWarp {
  std::barrier<> bar{32};
  uint64_t val[32];
};
struct SimBlock {
  explicit SimBlock(unsigned threads) : bar(threads) {
    for (unsigned w = 0; w < (threads + 31) / 32; ++w)
      warps.emplace_back(new SimWarp);
  }
  std::barrier<> bar;
  std::vector<std::unique_ptr<SimWarp>> warps;
  std::mutex m;
  std::vector<std::pair<const std::type_info*, std::shared_ptr<void>>> shared;
  std::vector<char> dynamic;
};
inline thread_local SimBlock* sim_block = nullptr;
inline thread_local SimWarp* sim_warp = nullptr;

// the block's one instance of T (a kernel's __shared__ variable)
template <class T>
T& sim_shared() {
  std::lock_guard<std::mutex> g(sim_block->m);
  for (auto& e : sim_block->shared)
    if (*e.first == typeid(T)) return *static_cast<T*>(e.second.get());
  auto p = std::make_shared<T>();
  std::memset((void*)p.get(), 0xAB, sizeof(T));   // garbage, as on the card
  sim_block->shared.emplace_back(&typeid(T), p);
  return *p;
}
inline char* sim_dynamic() { return sim_block->dynamic.data(); }

inline void __syncthreads() { sim_block->bar.arrive_and_wait(); }
inline unsigned sim_lane() { return threadIdx.x % 32; }
template <class T>
uint64_t sim_bits(T v) {
  uint64_t b = 0;
  std::memcpy(&b, &v, sizeof(T));
  return b;
}
template <class T>
T sim_from(uint64_t b) {
  T v;
  std::memcpy(&v, &b, sizeof(T));
  return v;
}
// every lane publishes x; each gets what fn makes of the 32 values
template <class R>
R sim_round(uint64_t x, const std::function<R(const uint64_t*)>& fn) {
  SimWarp* w = sim_warp;
  w->val[sim_lane()] = x;
  w->bar.arrive_and_wait();
  R r = fn(w->val);
  w->bar.arrive_and_wait();
  return r;
}
template <class T>
T __shfl_sync(unsigned, T v, int src) {
  return sim_from<T>(sim_round<uint64_t>(
      sim_bits(v), [&](const uint64_t* a) { return a[src & 31]; }));
}
template <class T>
T __shfl_up_sync(unsigned, T v, unsigned o) {
  const unsigned l = sim_lane();
  return __shfl_sync(0u, v, l >= o ? (int)(l - o) : (int)l);
}
template <class T>
T __shfl_down_sync(unsigned, T v, unsigned o) {
  const unsigned l = sim_lane();
  return __shfl_sync(0u, v, l + o < 32 ? (int)(l + o) : (int)l);
}
template <class T>
T __shfl_xor_sync(unsigned, T v, int m) {
  return __shfl_sync(0u, v, (int)(sim_lane() ^ (unsigned)m));
}
inline unsigned __ballot_sync(unsigned, int p) {
  return sim_round<unsigned>(p != 0, [](const uint64_t* a) {
    unsigned m = 0;
    for (int j = 0; j < 32; ++j)
      if (a[j]) m |= 1u << j;
    return m;
  });
}
inline unsigned __match_any_sync(unsigned, int v) {
  const unsigned l = sim_lane();
  return sim_round<unsigned>(sim_bits(v), [&](const uint64_t* a) {
    unsigned m = 0;
    for (int j = 0; j < 32; ++j)
      if (a[j] == a[l]) m |= 1u << j;
    return m;
  });
}
template <class T>
T atomicAdd(T* p, T v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
template <class T>
T atomicOr(T* p, T v) { return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST); }
template <class T>
T atomicExch(T* p, T v) { return __atomic_exchange_n(p, v, __ATOMIC_SEQ_CST); }
template <class T>
T atomicCAS(T* p, T cmp, T v) {
  __atomic_compare_exchange_n(p, &cmp, v, false, __ATOMIC_SEQ_CST,
                              __ATOMIC_SEQ_CST);
  return cmp;
}
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline void __nanosleep(unsigned) { std::this_thread::yield(); }
template <class T>
T __ldcg(const T* p) {
  std::atomic_thread_fence(std::memory_order_seq_cst);
  T v;
  std::memcpy(&v, (const void*)p, sizeof(T));
  return v;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
using std::isnan;
using std::max;
using std::min;

// every block of grid at once, a thread each of block's threads
inline cudaError_t srt_launch(dim3 grid, dim3 block, size_t smem,
                              const std::function<void()>& body) {
  gridDim = grid;
  blockDim = block;
  std::vector<std::unique_ptr<SimBlock>> blocks;
  for (unsigned b = 0; b < grid.x; ++b) {
    blocks.emplace_back(new SimBlock(block.x));
    blocks.back()->dynamic.assign(smem + 16, (char)0xAB);
  }
  std::vector<std::thread> ts;
  for (unsigned b = 0; b < grid.x; ++b)
    for (unsigned t = 0; t < block.x; ++t)
      ts.emplace_back([&, b, t] {
        blockIdx = {b, 0, 0};
        threadIdx = {t, 0, 0};
        sim_block = blocks[b].get();
        sim_warp = sim_block->warps[t / 32].get();
        body();
      });
  for (auto& th : ts) th.join();
  return cudaSuccess;
}
struct float2 { float x, y; };
inline float2 make_float2(float x, float y) { return {x, y}; }
inline void __syncwarp(unsigned = 0xffffffffu) { sim_warp->bar.arrive_and_wait(); }
"""

#: libcu++'s ``cuda::atomic_ref`` on the host
ATOMIC = r"""
#pragma once
#include <atomic>
#include <thread>
namespace cuda {
using std::memory_order;
using std::memory_order_acquire;
using std::memory_order_relaxed;
using std::memory_order_release;
enum thread_scope { thread_scope_system, thread_scope_device, thread_scope_block };
template <class T, thread_scope S = thread_scope_system>
struct atomic_ref : std::atomic_ref<T> {
  using std::atomic_ref<T>::atomic_ref;
  // a load spun on at a grid barrier yields the core to the host threads
  // of the blocks it waits for
  T load(memory_order o = std::memory_order_seq_cst) const noexcept {
    std::this_thread::yield();
    return std::atomic_ref<T>::load(o);
  }
};
}  // namespace cuda
"""



def shared_on_host(src: str) -> tuple[str, int]:
    """``src`` with each ``__shared__ T name;`` the block's one instance
    of ``T``; returns the text and how many it rewrote."""
    return re.subn(r"__shared__ (\w+) (\w+);", r"\1& \2 = sim_shared<\1>();",
                   src)


def compile_source(work, name: str, src: str, main: str,
                   headers: dict | None = None) -> str:
    """Build ``main`` (which includes ``{name}.cu``, holding ``src``) with
    g++ through :data:`STUB` in the directory ``work``, with ``headers``
    (file name: text) beside it; returns the executable's path. Skips
    without g++."""
    if not shutil.which("g++"):
        pytest.skip("needs g++")
    (work / "cuda_runtime.h").write_text(STUB)
    (work / "cuda").mkdir(exist_ok=True)
    (work / "cuda" / "atomic").write_text(ATOMIC)
    for file, text in (headers or {}).items():
        (work / file).write_text(text)
    (work / f"{name}.cu").write_text(src)
    (work / f"{name}_main.cpp").write_text(main)
    exe = str(work / name)
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off",
                    "-pthread", "-I", str(work), "-o", exe,
                    str(work / f"{name}_main.cpp")], check=True)
    return exe


def source(name: str) -> str:
    """The text of ``csrc/<name>``."""
    with open(os.path.join(os.path.dirname(build.SOURCES[0]), name)) as f:
        return f.read()
