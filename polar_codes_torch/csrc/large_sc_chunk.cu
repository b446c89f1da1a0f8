// Masked SC chunk decoder (K6): plain SC over one chunk of span M whose
// frozen mask arrives as data, for a batch of codewords.
//
// Replaces: polar_codes_tpu/ops/large_kernel.py,
// build_masked_sc_chunk_kernel.kernel (its float32 and int8 families), the
// chunk decode of LargeSCDecoder: the f/g recursion down to span-1 leaves, a
// hard decision at each leaf (frozen leaves forced to 0) and the partial
// sums combined on the way back up.
//
// Interface (batch-first, as the large-N glue holds its buffers):
//   llr [B, M] f32, mask [M] u8 (1 = frozen), family (0 float32, 1 char)
//     -> x [B, M] bipolar f32 (the chunk's codeword segment),
//        u [B, M] bipolar f32 (the leaf decisions)
// Two families, instantiations of one template:
//   float32: g = b +- a, decisions by the sign bit (-0.0 decides 1);
//   char:    integer-valued LLRs in f32 (the fip_char values of the TPU
//            kernel's int8 mode), g clipped to [-127, 127], decisions
//            llr < 0 (0 decides 0). f is not clipped: an input of -128
//            gives |f| = 128, which f32 holds exactly.
//
// Walk: the chunk's tree is full, so no schedule is passed. One warp
// decodes one codeword. Above span 32 the walk's leaves are the span-32
// nodes (level dl = log2 M - 5): before leaf k the levels d >= dl - tz(k)
// are refreshed top down (f for a left child, g for a right one, reading
// the left sibling's partial sums), the lanes spread over the node's
// positions and a __syncwarp after each level; then one lane decodes the
// span-32 node in registers, fully unrolled (f, g, decisions and partial
// sums of its 5 lower levels, its bits as 32-bit words); then tz(~k)
// combines climb back up, as XORs of bit words. A subtree whose leaves are
// all frozen (rate 0) decides u = 0 and x = 0 whatever its LLRs, in both
// families, so it is skipped at every level: no f/g, no descent, its bit
// words set to 0. The rate-1 shortcut is not taken: it is not exact in the
// char family (the pair (0, -3) gives f = 0, which decides 0). The mask is
// staged once into shared memory as 32-bit frozen words.
//
// What bounds it on an H100: the length of one codeword's dependent chain.
// At B = 128 each SM runs about one warp, so a call takes one codeword's
// walk: the serial SC of each span-32 node in one lane's registers (the
// longest part: ~32 dependent decisions with their f/g, ~5000 cycles),
// the refreshes of the upper levels, each closed by a __syncwarp, and
// nothing for a rate-0 subtree. Measured (chip_smoke.py, NVIDIA H100 80GB
// HBM3 at 700 W, B = 128, M = 2048): 0.18 ms a call on a mixed chunk of
// the N = 131072 code in either family, 0.025-0.07 ms on chunks that are
// mostly rate 0. A call moves 3.1 MB (about 0.94 us at 3.35 TB/s); the
// walk, not bytes or arithmetic, sets the time. The whole
// chunk stays on chip: the LLR of the live node at each level (2M f32,
// 16 KiB at M = 2048) and the x, u and mask bits (3 M / 8 bytes) sit in
// shared memory, device memory is read once and written once.
//
// Numerics: f is the product form sign(a) * sign(b) * min(|a|, |b|) with
// jnp.sign's rule (sign(+-0) = +-0) of the plain torch version
// (ops/large_kernel.py), computed as the sign-XOR form on the raw bits,
// which equals it on every finite input; the build disables FMA
// contraction. Kernel and plain version agree bit for bit.
//
// C interface (ctypes; every pointer and the stream are void*):
//   int masked_sc_chunk(const float *llr, const uint8_t *mask, float *x,
//                       float *u, int chunk, int batch, int family,
//                       cudaStream_t stream)
// Returns the cudaGetLastError() of the launch (or of the shared-memory
// attribute call), or -1 for a chunk the kernel does not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxChunk = 8192;
constexpr int kRegSpan = 32;  // span of the nodes decoded in registers
constexpr int kRegLevels = 5;
constexpr unsigned kAll = 0xffffffffu;

// f with jnp.sign's signed zeros, as the sign-XOR form on the raw bits
__device__ __forceinline__ float f_bits(float a, float b) {
  const unsigned ai = __float_as_uint(a), bi = __float_as_uint(b);
  const unsigned sign = (ai ^ bi) & 0x80000000u;
  const unsigned mag = min(ai & 0x7fffffffu, bi & 0x7fffffffu);
  return __uint_as_float(sign | mag);
}

__device__ __forceinline__ int sign_bit(float x) {
  return static_cast<int>(__float_as_uint(x) >> 31);
}

struct FloatFamily {
  __device__ static float g(float a, float b, int bit) { return bit ? b - a : b + a; }
  __device__ static int hard(float x) { return sign_bit(x); }
};

struct CharFamily {
  __device__ static float g(float a, float b, int bit) {
    return fminf(fmaxf(bit ? b - a : b + a, -127.f), 127.f);
  }
  __device__ static int hard(float x) { return x < 0.f; }
};

// SC of a span-S node held in registers: y its LLRs, frz bit i = leaf i
// frozen -> x (codeword bits) and u (decisions), bit i = position i.
template <int S, class Fam>
__device__ __forceinline__ void sc_reg(const float (&y)[S], unsigned frz, unsigned& x,
                                       unsigned& u) {
  constexpr unsigned kFull = S == 32 ? kAll : (1u << S) - 1u;
  if ((frz & kFull) == kFull) {  // rate 0
    x = 0u;
    u = 0u;
    return;
  }
  if constexpr (S == 1) {
    x = u = static_cast<unsigned>(Fam::hard(y[0]));
  } else {
    constexpr int H = S / 2;
    float a[H];
#pragma unroll
    for (int i = 0; i < H; ++i) a[i] = f_bits(y[i], y[i + H]);
    unsigned xl, ul, xr, ur;
    sc_reg<H, Fam>(a, frz, xl, ul);
#pragma unroll
    for (int i = 0; i < H; ++i) a[i] = Fam::g(y[i], y[i + H], (xl >> i) & 1u);
    sc_reg<H, Fam>(a, frz >> H, xr, ur);
    x = (xl ^ xr) | (xr << H);
    u = ul | (ur << H);
  }
}

// one lane: SC of the span-S node at Y (shared), words Wx/Wu at its offset
template <int S, class Fam>
__device__ void reg_leaf(const float* Y, unsigned frz, unsigned* Wx, unsigned* Wu) {
  float y[S];
#pragma unroll
  for (int i = 0; i < S; ++i) y[i] = Y[i];
  unsigned x, u;
  sc_reg<S, Fam>(y, frz, x, u);
  *Wx = x;
  *Wu = u;
}

// Offset of level d's buffer (span M >> d): level 0 is the input.
__device__ __forceinline__ int level_at(int d, int m) {
  return d == 0 ? 0 : 2 * m - (m >> (d - 1));
}

// every leaf of [off, off + span) frozen (span a multiple of 32); warp-wide
__device__ __forceinline__ bool rate0(const unsigned* Fm, int off, int span, int lane) {
  int ok = 1;
  for (int w = lane; w < (span >> 5); w += 32) ok &= Fm[(off >> 5) + w] == kAll;
  return __all_sync(kAll, ok);
}

template <class Fam>
__global__ void __launch_bounds__(32)
masked_sc_chunk_kernel(const float* __restrict__ llr,
                       const uint8_t* __restrict__ mask, float* __restrict__ x_out,
                       float* __restrict__ u_out, int m, int levels) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_words = (m + 31) >> 5;
  float* X = reinterpret_cast<float*>(smem);                // [2M] LLR pyramid
  unsigned* Wx = reinterpret_cast<unsigned*>(X + 2 * m);    // [M / 32] partial sums
  unsigned* Wu = Wx + n_words;                              // [M / 32] decisions
  unsigned* Fm = Wu + n_words;                              // [M / 32] frozen mask
  const int lane = threadIdx.x;
  const size_t row = (size_t)blockIdx.x * m;

  for (int i = lane; i < m; i += 32) X[i] = llr[row + i];
  for (int w = 0; w < n_words; ++w) {
    const int pos = 32 * w + lane;
    const unsigned word = __ballot_sync(kAll, pos < m && mask[pos] != 0);
    if (lane == 0) Fm[w] = word;
  }
  __syncwarp();

  if (m <= kRegSpan) {  // the chunk is one register node
    if (lane == 0) {
      switch (m) {
        case 2: reg_leaf<2, Fam>(X, Fm[0], Wx, Wu); break;
        case 4: reg_leaf<4, Fam>(X, Fm[0], Wx, Wu); break;
        case 8: reg_leaf<8, Fam>(X, Fm[0], Wx, Wu); break;
        case 16: reg_leaf<16, Fam>(X, Fm[0], Wx, Wu); break;
        default: reg_leaf<32, Fam>(X, Fm[0], Wx, Wu); break;
      }
    }
    __syncwarp();
  } else if (rate0(Fm, 0, m, lane)) {  // an all-frozen chunk
    for (int w = lane; w < n_words; w += 32) Wx[w] = Wu[w] = 0u;
    __syncwarp();
  } else {
    const int dl = levels - kRegLevels;  // level of the span-32 leaves
    const int n_leaves = m >> kRegLevels;
    int k = 0;
    while (k < n_leaves) {
      const int top = k == 0 ? 1 : dl - (__ffs(k) - 1);
      int skipped = -1;  // level of a rate-0 node taken whole
      for (int d = top; d <= dl; ++d) {
        const int lg = levels - d, span = 1 << lg;
        const int node = k >> (dl - d), off = node << lg;
        if (rate0(Fm, off, span, lane)) {
          for (int w = lane; w < (span >> 5); w += 32) Wx[(off >> 5) + w] = Wu[(off >> 5) + w] = 0u;
          skipped = d;
          break;
        }
        const float* P = X + level_at(d - 1, m);
        float* Y = X + level_at(d, m);
        if (node & 1) {
          const unsigned* left = Wx + ((off - span) >> 5);  // the left sibling's x
          for (int i = lane; i < span; i += 32)
            Y[i] = Fam::g(P[i], P[i + span], (left[i >> 5] >> (i & 31)) & 1u);
        } else {
          for (int i = lane; i < span; i += 32) Y[i] = f_bits(P[i], P[i + span]);
        }
        __syncwarp();
      }
      int last = k, from = 1;
      if (skipped < 0) {
        if (lane == 0) reg_leaf<kRegSpan, Fam>(X + level_at(dl, m), Fm[k], Wx + k, Wu + k);
      } else {
        last = k + (1 << (dl - skipped)) - 1;  // the skipped node's last leaf
        from = dl - skipped + 1;               // its own combines are XORs of zeros
      }
      __syncwarp();
      // climb: combine the finished nodes above the last leaf
      const int climb = __ffs(~last) - 1;
      for (int j = from; j <= climb; ++j) {
        const int hw = 1 << (j - 1);  // half the node, in words
        unsigned* B = Wx + ((last >> j) << j);
        for (int w = lane; w < hw; w += 32) B[w] ^= B[w + hw];
        __syncwarp();
      }
      k = last + 1;
    }
  }

  for (int i = lane; i < m; i += 32) {
    x_out[row + i] = (Wx[i >> 5] >> (i & 31)) & 1u ? -1.f : 1.f;
    u_out[row + i] = (Wu[i >> 5] >> (i & 31)) & 1u ? -1.f : 1.f;
  }
}

template <class Fam>
int launch(const float* llr, const uint8_t* mask, float* x, float* u, int chunk,
           int batch, cudaStream_t stream) {
  int levels = 0;
  while ((1 << levels) < chunk) ++levels;  // D = log2 M
  const size_t words = (size_t)(chunk + 31) / 32;
  const size_t smem = (size_t)2 * chunk * sizeof(float) + 3 * words * sizeof(unsigned);
  auto kernel = masked_sc_chunk_kernel<Fam>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch, 32, smem, stream>>>(llr, mask, x, u, chunk, levels);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int masked_sc_chunk(const void* llr, const void* mask, void* x, void* u,
                               int chunk, int batch, int family, void* stream) {
  if (chunk < 2 || chunk > kMaxChunk || (chunk & (chunk - 1))) return -1;
  if (batch <= 0) return 0;
  auto in = static_cast<const float*>(llr);
  auto mk = static_cast<const uint8_t*>(mask);
  auto xo = static_cast<float*>(x);
  auto uo = static_cast<float*>(u);
  auto st = static_cast<cudaStream_t>(stream);
  switch (family) {
    case 0: return launch<FloatFamily>(in, mk, xo, uo, chunk, batch, st);
    case 1: return launch<CharFamily>(in, mk, xo, uo, chunk, batch, st);
    default: return -1;
  }
}
