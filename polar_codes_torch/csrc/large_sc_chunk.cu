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
// Walk: the chunk's tree is full, so no schedule is passed. Leaves are
// taken in pairs (the span-2 nodes at level D-1, D = log2 M); before pair
// p, the levels d >= D-1 - tz(p) are refreshed top down (f for a left
// child, g for a right one, reading the left sibling's partial sums in
// place), one lane decodes the pair, and tz(~p) combines climb back up:
// the same trigger and climb rules as the outer loop of the decoder.
//
// What bounds it on an H100: latency. One warp decodes one codeword (B =
// 128 gives 128 warps, about one per SM), walking ~4 dependent steps per
// leaf pair, 4096 steps per chunk of 2048 with a __syncwarp after each; at
// most a few of them have more than 32 positions to spread over the lanes.
// A call at B = 128, M = 2048 moves 3.1 MB (about 0.94 us at 3.35 TB/s) and
// does ~4.6 M scalar operations, so the walk, not bytes or arithmetic,
// sets the time (0.55 ms a call on an H100 at 700 W). The
// design keeps the whole chunk on chip: the LLR of the live node at each
// level (2M f32, 16 KiB at M = 2048) and the bits (2M bytes) sit in shared
// memory, device memory is read once and written once, and the mask is
// read once per leaf from a [M] array shared by the whole batch. Putting
// the lowest levels in registers and shuffles is later work.
//
// Numerics: f is the product form sign(a) * sign(b) * min(|a|, |b|) with
// jnp.sign's rule (sign(+-0) = +-0), in the order of the plain torch
// version (ops/large_kernel.py); the build disables FMA contraction.
// Kernel and plain version agree bit for bit.
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

// sign with jnp.sign's rule at zero: sgn(+-0) = +-0
__device__ __forceinline__ float sgn(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}

__device__ __forceinline__ float f_prod(float a, float b) {
  return sgn(a) * sgn(b) * fminf(fabsf(a), fabsf(b));
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

// Offset of level d's buffer (span M >> d): level 0 is the input.
__device__ __forceinline__ int level_at(int d, int m) {
  return d == 0 ? 0 : 2 * m - (m >> (d - 1));
}

template <class Fam>
__global__ void __launch_bounds__(32)
masked_sc_chunk_kernel(const float* __restrict__ llr,
                       const uint8_t* __restrict__ mask, float* __restrict__ x_out,
                       float* __restrict__ u_out, int m, int levels) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* X = reinterpret_cast<float*>(smem);          // [2M] LLR pyramid
  uint8_t* W = reinterpret_cast<uint8_t*>(X + 2 * m);  // [M] partial sums
  uint8_t* U = W + m;                                  // [M] leaf decisions
  const int lane = threadIdx.x;
  const size_t row = (size_t)blockIdx.x * m;

  for (int i = lane; i < m; i += 32) X[i] = llr[row + i];
  __syncwarp();

  const int top = levels - 1;  // level of the span-2 nodes
  const int n_pairs = m >> 1;
  for (int p = 0; p < n_pairs; ++p) {
    // refresh levels 1..top whose node starts at pair p
    const int tz = p == 0 ? top : __ffs(p) - 1;
    for (int d = top - tz < 1 ? 1 : top - tz; d <= top; ++d) {
      const int span = m >> d;
      const float* P = X + level_at(d - 1, m);
      float* Y = X + level_at(d, m);
      const int node = p >> (top - d);
      if (node & 1) {
        const uint8_t* left = W + (node - 1) * span;  // the left sibling's x
        for (int i = lane; i < span; i += 32) {
          const float a = P[i], b = P[i + span];
          Y[i] = Fam::g(a, b, left[i]);
        }
      } else {
        for (int i = lane; i < span; i += 32) Y[i] = f_prod(P[i], P[i + span]);
      }
      __syncwarp();
    }
    if (lane == 0) {  // the span-2 node: f, leaf, g, leaf, combine
      const float* Y = X + level_at(top, m);
      const int k = 2 * p;
      const float a = Y[0], b = Y[1];
      const int u0 = mask[k] ? 0 : Fam::hard(f_prod(a, b));
      const int u1 = mask[k + 1] ? 0 : Fam::hard(Fam::g(a, b, u0));
      U[k] = u0;
      U[k + 1] = u1;
      W[k] = u0 ^ u1;
      W[k + 1] = u1;
    }
    __syncwarp();
    // climb: combine the finished nodes above the pair
    const int climb = p == n_pairs - 1 ? top : __ffs(~p) - 1;
    for (int c = 1; c <= climb; ++c) {
      const int h = 1 << c;  // half span of the node being combined
      uint8_t* B = W + 2 * (p + 1) - 2 * h;
      for (int i = lane; i < h; i += 32) B[i] ^= B[i + h];
      __syncwarp();
    }
  }

  for (int i = lane; i < m; i += 32) {
    x_out[row + i] = W[i] ? -1.f : 1.f;
    u_out[row + i] = U[i] ? -1.f : 1.f;
  }
}

template <class Fam>
int launch(const float* llr, const uint8_t* mask, float* x, float* u, int chunk,
           int batch, cudaStream_t stream) {
  int levels = 0;
  while ((1 << levels) < chunk) ++levels;  // D = log2 M
  const size_t smem = (size_t)2 * chunk * sizeof(float) + 2 * chunk;
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
