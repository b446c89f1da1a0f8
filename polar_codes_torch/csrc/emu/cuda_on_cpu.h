// Runs a CUDA kernel source on the CPU, for the tests of a machine without
// nvcc or a card (ops/_emu.py builds a source against this header with
// g++). Each CUDA thread is a std::thread; blocks run one after another;
// __syncwarp, __syncthreads and every shuffle, ballot and warp reduction
// are barriers over the warp or block. Only what the kernels that run here
// use is defined: one-dimensional launches, full-warp masks, dynamic and
// static shared memory (a `__shared__` variable is a function-local
// static, so one block runs at a time), int4, uint2 and uint4 (8- and
// 16-byte loads), __nv_bfloat16 with its two
// conversions (round to nearest even), atomicAdd, atomicOr and atomicMin on
// 32-bit words (under one lock), and a card with the H100's opt-in
// shared memory per block and SM count. A barrier that waits 60 s aborts: a
// divergent __syncwarp, shuffle or ballot, which deadlocks on the card
// too.
#pragma once
#include <algorithm>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n)
#define __shared__ static

struct int4 {
  int x, y, z, w;
};
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
struct alignas(8) uint2 {
  unsigned x, y;
};
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
struct dim3 {
  unsigned x = 1, y = 1, z = 1;
};
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum { cudaDevAttrMultiProcessorCount = 16, cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* value, int attr, int) {
  // an H100's SMs and opt-in shared memory per block
  *value = attr == cudaDevAttrMultiProcessorCount ? 132 : 232448;
  return cudaSuccess;
}

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;

class EmuBarrier {
 public:
  explicit EmuBarrier(unsigned n) : n_(n) {}
  void wait() {
    std::unique_lock<std::mutex> lock(mu_);
    const unsigned phase = phase_;
    if (++count_ == n_) {
      count_ = 0;
      ++phase_;
      cv_.notify_all();
      return;
    }
    if (!cv_.wait_for(lock, std::chrono::seconds(60), [&] { return phase_ != phase; })) {
      std::fprintf(stderr, "cuda_on_cpu: a barrier waited 60 s (divergent warp sync?)\n");
      std::abort();
    }
  }

 private:
  std::mutex mu_;
  std::condition_variable cv_;
  unsigned n_, count_ = 0, phase_ = 0;
};

struct EmuWarp {
  explicit EmuWarp(unsigned n) : bar(n) {}
  EmuBarrier bar;
  uint64_t slot[2][32];  // exchanges alternate between the two
};
inline std::vector<std::unique_ptr<EmuWarp>> emu_warps;
inline std::unique_ptr<EmuBarrier> emu_block;
inline std::vector<unsigned char> emu_dynamic;
inline thread_local unsigned emu_exchanges;  // this thread's exchanges so far

inline unsigned char* emu_smem() { return emu_dynamic.data(); }
inline EmuWarp& emu_warp() { return *emu_warps[threadIdx.x / 32]; }
inline int emu_lane() { return threadIdx.x & 31; }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_warp().bar.wait(); }
inline void __syncthreads() { emu_block->wait(); }

// every lane posts a 64-bit value, then reads what `pick` computes from
// all. Every lane of a warp makes the same exchanges in the same order, so
// consecutive exchanges use alternate slots: a lane writes a slot again
// only after the next exchange's barrier, which every lane passes after
// reading it.
template <class Pick>
inline auto emu_exchange(uint64_t mine, Pick pick) {
  EmuWarp& w = emu_warp();
  uint64_t* slot = w.slot[emu_exchanges++ & 1];
  slot[emu_lane()] = mine;
  w.bar.wait();
  return pick(static_cast<const uint64_t*>(slot));
}
template <class T>
inline T emu_shfl(T v, int src) {
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  const uint64_t got = emu_exchange(bits, [&](const uint64_t* s) { return s[src & 31]; });
  T out;
  std::memcpy(&out, &got, sizeof(T));
  return out;
}
template <class T>
inline T __shfl_sync(unsigned, T v, int src, int width = 32) {
  return emu_shfl(v, (emu_lane() & ~(width - 1)) + (src & (width - 1)));
}
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int mask, int = 32) {
  return emu_shfl(v, emu_lane() ^ mask);
}
template <class T>
inline T __shfl_up_sync(unsigned, T v, unsigned delta, int width = 32) {
  const int at = emu_lane() & (width - 1);
  return emu_shfl(v, at >= static_cast<int>(delta) ? emu_lane() - static_cast<int>(delta)
                                                   : emu_lane());
}
template <class T>
inline T __shfl_down_sync(unsigned, T v, unsigned delta, int width = 32) {
  const int at = emu_lane() & (width - 1);
  return emu_shfl(v, at + static_cast<int>(delta) < width ? emu_lane() + static_cast<int>(delta)
                                                         : emu_lane());
}
inline unsigned __ballot_sync(unsigned, int pred) {
  return emu_exchange(pred ? 1u : 0u, [](const uint64_t* s) {
    unsigned r = 0;
    for (int i = 0; i < 32; ++i) r |= static_cast<unsigned>(s[i]) << i;
    return r;
  });
}
inline int __all_sync(unsigned m, int pred) { return __ballot_sync(m, pred) == 0xffffffffu; }
inline int __any_sync(unsigned m, int pred) { return __ballot_sync(m, pred) != 0u; }
inline int __reduce_min_sync(unsigned, int v) {
  return emu_exchange(static_cast<uint32_t>(v), [](const uint64_t* s) {
    int r = static_cast<int>(static_cast<uint32_t>(s[0]));
    for (int i = 1; i < 32; ++i) r = std::min(r, static_cast<int>(static_cast<uint32_t>(s[i])));
    return r;
  });
}
inline unsigned __reduce_min_sync(unsigned, unsigned v) {
  return emu_exchange(v, [](const uint64_t* s) {
    unsigned r = static_cast<uint32_t>(s[0]);
    for (int i = 1; i < 32; ++i) r = std::min(r, static_cast<unsigned>(s[i]));
    return r;
  });
}
inline int __reduce_add_sync(unsigned, int v) {
  return emu_exchange(static_cast<uint32_t>(v), [](const uint64_t* s) {
    uint32_t r = 0;
    for (int i = 0; i < 32; ++i) r += static_cast<uint32_t>(s[i]);
    return static_cast<int>(r);
  });
}

inline unsigned __reduce_or_sync(unsigned, unsigned v) {
  return emu_exchange(v, [](const uint64_t* s) {
    unsigned r = 0;
    for (int i = 0; i < 32; ++i) r |= static_cast<unsigned>(s[i]);
    return r;
  });
}

// atomics: one lock for all (the kernels here use them on a few shared words)
inline std::mutex emu_atomic_mu;
template <class T, class Op>
inline T emu_atomic(T* at, Op op) {
  std::lock_guard<std::mutex> lock(emu_atomic_mu);
  const T old = *at;
  *at = op(old);
  return old;
}
inline int atomicAdd(int* at, int v) { return emu_atomic(at, [=](int o) { return o + v; }); }
inline unsigned atomicOr(unsigned* at, unsigned v) {
  return emu_atomic(at, [=](unsigned o) { return o | v; });
}
inline int atomicMin(int* at, int v) { return emu_atomic(at, [=](int o) { return std::min(o, v); }); }

inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __clz(int x) { return x ? __builtin_clz(static_cast<unsigned>(x)) : 32; }
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

struct __nv_bfloat16 {
  uint16_t x;
};
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  const unsigned u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {static_cast<uint16_t>((u >> 16) | 0x40u)};
  return {static_cast<uint16_t>((u + 0x7fffu + ((u >> 16) & 1u)) >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 h) {
  return __uint_as_float(static_cast<unsigned>(h.x) << 16);
}

// kernel<<<grid, block, smem, stream>>>(args...), rewritten by ops/_emu.py
template <class K, class... A>
void emu_launch(unsigned grid, unsigned block, size_t smem, void*, K kernel, A... args) {
  emu_dynamic.assign(smem + 16, 0xcd);  // garbage, as on the card
  blockDim.x = block;
  gridDim.x = grid;
  for (unsigned b = 0; b < grid; ++b) {
    emu_warps.clear();
    for (unsigned w = 0; w < (block + 31) / 32; ++w)
      emu_warps.push_back(std::make_unique<EmuWarp>(std::min(32u, block - 32 * w)));
    emu_block = std::make_unique<EmuBarrier>(block);
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < block; ++t)
      threads.emplace_back([=] {
        threadIdx.x = t;
        blockIdx.x = b;
        kernel(args...);
      });
    for (auto& th : threads) th.join();
  }
}
