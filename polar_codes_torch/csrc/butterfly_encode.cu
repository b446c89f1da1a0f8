// Polar butterfly encoder (K2): all log2 N XOR stages, the systematic
// re-freeze and the second pass, for a batch of codewords.
//
// Replaces: polar_codes_tpu/ops/butterfly_kernel.py, build_encode_kernel
// (the Pallas kernel that keeps one [N, 128] bipolar float tile in VMEM for
// all stages of both passes).
//
// What bounds it on an H100: device memory, one u8 read and one u8 write
// per bit (2 MiB at B = 1024, N = 1024: 0.63 us at 3.35 TB/s); the stages
// are a few instructions a word once the bits are packed.
//
// Design: the bits live packed in registers, position i at bit i & 31 of
// word i >> 5, with no shared memory and no barrier.
//   - A lane holds one word (two at N = 2048: words l and l + 32), so a
//     codeword of N >= 32 takes N / 32 lanes (a warp at N >= 1024) and a
//     warp holds 32 / (N / 32) codewords; below N = 32 a lane holds a
//     whole codeword and a warp 32 of them.
//   - A stage of distance h < 32 is x ^= (x >> h) & M_h inside the word,
//     M_h marking the positions p with (p & h) = 0; a stage of distance
//     32 h' (h' < 32 words) is a __shfl_xor_sync by h' lanes, XORed in on
//     the lanes whose word index has bit h' clear; at N = 2048 the last
//     stage XORs the lane's two words.
//   - The systematic re-freeze is an AND-NOT with the frozen mask packed
//     the same way (each lane packs its own words of the mask, which stay
//     in L1/L2), then the stages run a second time.
//   - A lane reads its word's 32 bytes as two 16-byte loads (a warp's
//     lanes read consecutive 32-byte pieces of the batch, so the loads
//     are coalesced), keeps bit 0 of each byte, and writes the word back
//     as 32 bytes the same way. Below N = 32, or where a pointer is not
//     16-byte aligned, it reads and writes byte by byte.
// Input contract: {0,1} bytes, the u-domain with frozen positions 0. The
// kernel computes the plain version's XORs exactly on every {0,1} input,
// also where frozen positions are not 0 (neither zeroes them before the
// first pass).
//
// C interface (bound with ctypes): every pointer and the stream are void*.
//   int butterfly_encode(const uint8 *u [B, N], const uint8 *frozen [N],
//                        uint8 *out [B, N], int batch, int n_len,
//                        int systematic, cudaStream_t stream)
// Returns cudaGetLastError() after the launch, or -1 for an N outside
// the powers of two from 2 to 2048.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kMaxN = 2048;

// bit 0 of each of the 4 bytes of w, as 4 bits (byte k -> bit k)
__device__ __forceinline__ uint32_t pack4(uint32_t w) {
  return ((w & 0x01010101u) * 0x10204080u) >> 28;
}

// 4 bits of q as 4 bytes {0, 1} (bit k -> byte k)
__device__ __forceinline__ uint32_t unpack4(uint32_t q) {
  return ((q & 0xfu) * 0x00204081u) & 0x01010101u;
}

__device__ __forceinline__ uint32_t load_word(const uint8_t* p) {
  const uint4 lo = *reinterpret_cast<const uint4*>(p);
  const uint4 hi = *reinterpret_cast<const uint4*>(p + 16);
  return pack4(lo.x) | pack4(lo.y) << 4 | pack4(lo.z) << 8 | pack4(lo.w) << 12 |
         pack4(hi.x) << 16 | pack4(hi.y) << 20 | pack4(hi.z) << 24 | pack4(hi.w) << 28;
}

__device__ __forceinline__ void store_word(uint8_t* p, uint32_t x) {
  uint4 lo, hi;
  lo.x = unpack4(x);
  lo.y = unpack4(x >> 4);
  lo.z = unpack4(x >> 8);
  lo.w = unpack4(x >> 12);
  hi.x = unpack4(x >> 16);
  hi.y = unpack4(x >> 20);
  hi.z = unpack4(x >> 24);
  hi.w = unpack4(x >> 28);
  *reinterpret_cast<uint4*>(p) = lo;
  *reinterpret_cast<uint4*>(p + 16) = hi;
}

__device__ __forceinline__ uint32_t load_bytes(const uint8_t* p, int n) {
  uint32_t x = 0;
  for (int i = 0; i < n; ++i) x |= (p[i] & 1u) << i;
  return x;
}

__device__ __forceinline__ void store_bytes(uint8_t* p, uint32_t x, int n) {
  for (int i = 0; i < n; ++i) p[i] = static_cast<uint8_t>((x >> i) & 1u);
}

// the stages of distance h < n_bits inside a word
__device__ __forceinline__ uint32_t word_stages(uint32_t x, int n_bits) {
  if (n_bits > 1) x ^= (x >> 1) & 0x55555555u;
  if (n_bits > 2) x ^= (x >> 2) & 0x33333333u;
  if (n_bits > 4) x ^= (x >> 4) & 0x0f0f0f0fu;
  if (n_bits > 8) x ^= (x >> 8) & 0x00ff00ffu;
  if (n_bits > 16) x ^= (x >> 16) & 0x0000ffffu;
  return x;
}

// every stage: inside the words, across the codeword's `group` lanes (j
// is the lane's word index), then across a lane's two words
template <int kWords>
__device__ __forceinline__ void stages(uint32_t (&x)[kWords], int n_bits, int group, int j) {
#pragma unroll
  for (int w = 0; w < kWords; ++w) x[w] = word_stages(x[w], n_bits);
  for (int h = 1; h < group; h <<= 1) {
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const uint32_t other = __shfl_xor_sync(kFull, x[w], h);
      if (!(j & h)) x[w] ^= other;
    }
  }
  if (kWords == 2) x[0] ^= x[1];
}

template <int kWords, bool kVec>
__global__ void __launch_bounds__(kThreads)
butterfly_encode_kernel(const uint8_t* __restrict__ u, const uint8_t* __restrict__ frozen,
                        uint8_t* __restrict__ out, int batch, int n_len, int systematic) {
  const int lane = threadIdx.x & 31;
  const int n_bits = n_len < 32 ? n_len : 32;
  const int group = n_len <= 32 ? 1 : (n_len >> 5) / kWords;  // lanes a codeword
  const int per_warp = 32 / group;
  const int first = ((blockIdx.x * kThreads + threadIdx.x) >> 5) * per_warp;
  if (first >= batch) return;  // the whole warp: no shuffle waits for it
  const int c = first + lane / group, j = lane & (group - 1);
  const int row = c < batch ? c : batch - 1;  // lanes past the batch: the last codeword, no store
  uint32_t x[kWords], fz[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    const int at = 32 * (j + 32 * w);
    const uint8_t* src = u + static_cast<size_t>(row) * n_len + at;
    x[w] = kVec ? load_word(src) : load_bytes(src, n_bits);
    fz[w] = !systematic ? 0u : kVec ? load_word(frozen + at) : load_bytes(frozen + at, n_bits);
  }
  stages<kWords>(x, n_bits, group, j);
  if (systematic) {
#pragma unroll
    for (int w = 0; w < kWords; ++w) x[w] &= ~fz[w];
    stages<kWords>(x, n_bits, group, j);
  }
  if (c >= batch) return;
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    uint8_t* dst = out + static_cast<size_t>(c) * n_len + 32 * (j + 32 * w);
    if (kVec) {
      store_word(dst, x[w]);
    } else {
      store_bytes(dst, x[w], n_bits);
    }
  }
}

template <int kWords, bool kVec>
void launch(const uint8_t* u, const uint8_t* frozen, uint8_t* out, int batch, int n_len,
            int systematic, cudaStream_t stream) {
  const int per_warp = n_len <= 32 ? 32 : 1024 * kWords / n_len;
  const int warps = (batch + per_warp - 1) / per_warp;
  const int blocks = (warps + kThreads / 32 - 1) / (kThreads / 32);
  butterfly_encode_kernel<kWords, kVec><<<blocks, kThreads, 0, stream>>>(
      u, frozen, out, batch, n_len, systematic);
}

}  // namespace

extern "C" int butterfly_encode(const void* u, const void* frozen, void* out,
                                int batch, int n_len, int systematic,
                                void* stream) {
  if (n_len < 2 || n_len > kMaxN || (n_len & (n_len - 1))) return -1;
  if (batch <= 0) return 0;
  auto x = static_cast<const uint8_t*>(u);
  auto fz = static_cast<const uint8_t*>(frozen);
  auto y = static_cast<uint8_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const bool vec = n_len >= 32 &&
                   ((reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(frozen) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (n_len == kMaxN) {
    if (vec) launch<2, true>(x, fz, y, batch, n_len, systematic, st);
    else launch<2, false>(x, fz, y, batch, n_len, systematic, st);
  } else {
    if (vec) launch<1, true>(x, fz, y, batch, n_len, systematic, st);
    else launch<1, false>(x, fz, y, batch, n_len, systematic, st);
  }
  return static_cast<int>(cudaGetLastError());
}
