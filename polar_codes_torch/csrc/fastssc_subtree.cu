// Fast-SSC subtree decoder (K3): one call decodes a whole span <= 2048
// subtree of the Fast-SSC code tree for a batch of codewords, in float32
// or in the saturating char family.
//
// Replaces: polar_codes_tpu/ops/fastssc_kernel.py, build_fs_hybrid_decode,
// subtree_call.kernel (the root call, u8 hard bits out) and
// subtree_call.kernel_bits (a call below the glue, bipolar state out),
// whose body _emit/_leaf is the f/g recursion with the Rate0/Rate1/Rep/SPC
// leaf shortcuts and the ZeroR shortcut (left child all-frozen: g becomes
// b + a).
//
// Interface, in the TPU kernel's batch-minor layout:
//   llr [span, B] (f32, or int8 for the char family)
//     -> root: bits [span, B] u8;
//        below the glue: bipolar state [span, B] (+-1, f32 or int8)
//
// The TPU kernel is specialised per subtree while tracing. Here the
// subtree arrives as data, a post-order schedule of 5-int ops
//   {op, level, length, offset, kind}
// with op F (f into the next level), G (g into the next level, reading
// the left child's bits), ZERO_R (b + a into the next level, left bits 0),
// COMBINE (left bits ^= right bits) and LEAF (kind RATE0/RATE1/REP/SPC).
// One kernel per family and output form serves every subtree of every
// code; nothing is generated per code.
//
// Families (fastssc_kernel.py _Ops):
//   float: f is the sign-XOR min-sum on the raw bits, g = b +- a, ZeroR a
//          plain b + a, hard decision by the sign bit (-0.0 decides 1);
//   char:  integer LLRs held in int16 in shared memory and int32 in
//          registers, f in product form (0 at zeros), f, g and ZeroR
//          clipped to [-127, 127], hard decision llr < 0 (0 decides 0).
//          The TPU kept these integers in bf16 only to pack its vector
//          registers. (f's clip acts only on an int8 input of -128, which
//          the simulator's quantiser never produces; it keeps every value
//          an int8 for the glue.)
// The REP sum runs sequentially in span order (f32, or exact int32 in the
// char family); the SPC leaf takes the lowest index among equal minimum
// magnitudes and counts negative hard decisions for the parity. The plain
// torch version (ops/fastssc_kernel.py) does the same in the same order,
// and the build disables FMA contraction, so the two agree bit for bit.
//
// What bounds it on an H100: latency, not bytes. At B = 2048, N = 1024 a
// float call moves 8 MiB in and 2 MiB out (about 3 us at 3.35 TB/s), but
// each block walks ~300 dependent ops of the schedule with a barrier
// after each, most of them on nodes of 2 to 16 positions. The design keeps
// all state on chip: a block of 256 threads decodes 8 codewords together
// (every codeword runs the same schedule), with the per-level LLR
// buffers [2*span][8] and the bits [span][8] in shared memory (72 KiB at
// span 1024 in f32), so device memory is touched once on the way in and
// once on the way out, 8 neighbouring codewords per 32-byte sector.
// Threads cover (position, codeword) pairs in F/G/ZERO_R/COMBINE and
// RATE0/RATE1; REP and SPC run one thread per codeword. Spreading the
// small nodes and the leaf scans over more threads is later work.
//
// C interface (ctypes; every pointer and the stream are void*):
//   int fastssc_subtree(const int *ops, int n_ops, const void *llr,
//                       void *out, int char_mode, int root, int span,
//                       int batch, cudaStream_t stream)
// Returns the cudaGetLastError() of the launch (or of the shared-memory
// attribute call), or -1 for a span the kernel does not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCpb = 8;  // codewords per block
constexpr int kThreads = 256;
constexpr int kMaxSpan = 2048;
constexpr int kOpWords = 5;
enum { OP_F = 0, OP_G = 1, OP_ZERO_R = 2, OP_COMBINE = 3, OP_LEAF = 4 };
enum { K_RATE0 = 0, K_RATE1 = 1, K_REP = 2, K_SPC = 3 };

struct FloatFamily {
  using In = float;
  using State = float;
  using Acc = float;
  __device__ static float f(float a, float b) {
    const unsigned ai = __float_as_uint(a), bi = __float_as_uint(b);
    const unsigned sign = (ai ^ bi) & 0x80000000u;
    const unsigned mag = min(ai & 0x7fffffffu, bi & 0x7fffffffu);
    return __uint_as_float(sign | mag);
  }
  __device__ static float g(float a, float b, int bit) { return bit ? b - a : b + a; }
  __device__ static float zero_r(float a, float b) { return b + a; }
  __device__ static int hard(float x) { return static_cast<int>(__float_as_uint(x) >> 31); }
  __device__ static float mag(float x) { return fabsf(x); }
  __device__ static float bipolar(int bit) { return bit ? -1.f : 1.f; }
};

struct CharFamily {
  using In = int8_t;
  using State = short;
  using Acc = int;
  __device__ static int clip(int v) { return max(-127, min(127, v)); }
  __device__ static int sgn(int v) { return (v > 0) - (v < 0); }
  __device__ static short f(short a, short b) {  // clipped only for a -128 input
    return static_cast<short>(clip(sgn(a) * sgn(b) * min(abs(a), abs(b))));
  }
  __device__ static short g(short a, short b, int bit) {
    return static_cast<short>(clip(bit ? b - a : b + a));
  }
  __device__ static short zero_r(short a, short b) { return static_cast<short>(clip(b + a)); }
  __device__ static int hard(int x) { return x < 0; }
  __device__ static int mag(short x) { return abs(x); }
  __device__ static int8_t bipolar(int bit) { return bit ? -1 : 1; }
};

// First row of tree level d's LLR buffer: level 0 is the call's input
// (span rows), level d >= 1 holds span >> d rows after the levels above.
__device__ __forceinline__ int level_row(int d, int span) {
  return d == 0 ? 0 : 2 * span - (span >> (d - 1));
}

template <class Fam, bool kRoot>
__global__ void __launch_bounds__(kThreads)
fastssc_kernel(const int* __restrict__ ops, int n_ops,
               const typename Fam::In* __restrict__ llr, void* __restrict__ out,
               int span, int batch) {
  using S = typename Fam::State;
  extern __shared__ __align__(16) unsigned char smem[];
  S* x = reinterpret_cast<S*>(smem);                                    // [2*span][kCpb]
  uint8_t* bits = reinterpret_cast<uint8_t*>(x + (size_t)2 * span * kCpb);  // [span][kCpb]
  const int b0 = blockIdx.x * kCpb;
  const int tid = threadIdx.x;

  for (int t = tid; t < span * kCpb; t += kThreads) {
    const int s = t / kCpb, b = b0 + t % kCpb;
    x[t] = b < batch ? static_cast<S>(llr[(size_t)s * batch + b]) : S(0);
  }
  __syncthreads();

  for (int k = 0; k < n_ops; ++k) {
    const int* op = ops + k * kOpWords;
    const int code = op[0], d = op[1], len = op[2], off = op[3];
    const S* X = x + level_row(d, span) * kCpb;
    uint8_t* B = bits + off * kCpb;  // this node's bits, [len][kCpb]
    if (code == OP_F || code == OP_G || code == OP_ZERO_R) {
      const int hk = (len >> 1) * kCpb;
      S* Y = x + level_row(d + 1, span) * kCpb;
      for (int t = tid; t < hk; t += kThreads) {
        const S a = X[t], bb = X[t + hk];
        if (code == OP_F) {
          Y[t] = Fam::f(a, bb);
        } else if (code == OP_G) {
          Y[t] = Fam::g(a, bb, B[t]);
        } else {
          Y[t] = Fam::zero_r(a, bb);
          B[t] = 0;  // the all-frozen left child's bits
        }
      }
    } else if (code == OP_COMBINE) {
      const int hk = (len >> 1) * kCpb;
      for (int t = tid; t < hk; t += kThreads) B[t] ^= B[t + hk];
    } else {
      const int kind = op[4];
      if (kind == K_RATE0) {
        for (int t = tid; t < len * kCpb; t += kThreads) B[t] = 0;
      } else if (kind == K_RATE1) {
        for (int t = tid; t < len * kCpb; t += kThreads) B[t] = Fam::hard(X[t]);
      } else if (tid < kCpb) {  // REP and SPC: one thread per codeword
        const int c = tid;
        if (kind == K_REP) {
          typename Fam::Acc sum = 0;
          for (int i = 0; i < len; ++i) sum = sum + X[i * kCpb + c];
          const int bit = Fam::hard(sum);
          for (int i = 0; i < len; ++i) B[i * kCpb + c] = bit;
        } else {
          int neg = 0, weak = 0;
          auto best = Fam::mag(X[c]);
          for (int i = 0; i < len; ++i) {
            const S v = X[i * kCpb + c];
            neg += Fam::hard(v);
            const auto m = Fam::mag(v);
            if (m < best) {  // strict: the first index wins a tie
              best = m;
              weak = i;
            }
          }
          const int odd = neg & 1;
          for (int i = 0; i < len; ++i)
            B[i * kCpb + c] = Fam::hard(X[i * kCpb + c]) ^ (odd && i == weak);
        }
      }
    }
    __syncthreads();
  }

  for (int t = tid; t < span * kCpb; t += kThreads) {
    const int s = t / kCpb, b = b0 + t % kCpb;
    if (b >= batch) continue;
    const size_t at = (size_t)s * batch + b;
    if (kRoot) {
      static_cast<uint8_t*>(out)[at] = bits[t];
    } else {
      static_cast<typename Fam::In*>(out)[at] = Fam::bipolar(bits[t]);
    }
  }
}

template <class Fam, bool kRoot>
int launch(const int* ops, int n_ops, const void* llr, void* out, int span,
           int batch, cudaStream_t stream) {
  const size_t smem = ((size_t)2 * span * sizeof(typename Fam::State) + span) * kCpb;
  auto kernel = fastssc_kernel<Fam, kRoot>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (batch + kCpb - 1) / kCpb;
  kernel<<<blocks, kThreads, smem, stream>>>(
      ops, n_ops, static_cast<const typename Fam::In*>(llr), out, span, batch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fastssc_subtree(const void* ops, int n_ops, const void* llr,
                               void* out, int char_mode, int root, int span,
                               int batch, void* stream) {
  if (span < 1 || span > kMaxSpan || (span & (span - 1))) return -1;
  if (batch <= 0) return 0;
  auto o = static_cast<const int*>(ops);
  auto st = static_cast<cudaStream_t>(stream);
  if (char_mode) {
    return root ? launch<CharFamily, true>(o, n_ops, llr, out, span, batch, st)
                : launch<CharFamily, false>(o, n_ops, llr, out, span, batch, st);
  }
  return root ? launch<FloatFamily, true>(o, n_ops, llr, out, span, batch, st)
              : launch<FloatFamily, false>(o, n_ops, llr, out, span, batch, st);
}
