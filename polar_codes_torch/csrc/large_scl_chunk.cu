// Masked SCL chunk decoder (K7): bitwise SCL over one chunk of span M whose
// frozen mask (and, optionally, the class of each sub-block) arrives as
// data, for a batch of codewords.
//
// Replaces: polar_codes_tpu/ops/large_kernel.py,
// build_masked_scl_chunk_kernel.kernel (its float32 and int8 families), the
// mixed-chunk
// decode of LargeSCLDecoder: the f/g recursion with path-fork gathers and
// perm composition, a {keep, flip} fork and a top-L prune at every span-1
// leaf (a frozen leaf pays min(llr, 0) and its flip is killed with _NEG),
// and, at span `sub`, a switch on the sub-block's class to the SSCL leaf
// rules (rate0, rate1 with 4 candidates, rep, spc with 8) or on to the
// per-bit recursion.
//
// Interface (batch-first, as the large-N glue holds its buffers):
//   llr [B, L, M] f32, mask [M] u8 (1 = frozen), metrics [B, L] f32,
//   sub_cls [M / sub] i32 (sub = 0: no sub-block dispatch),
//   family (0 float32, 1 char)
//     -> bits [B, M] i32 (bit l of a word = path l's codeword bit),
//        perm [B, L] i32 (output slot -> input slot), metrics [B, L] f32
//
// The chunk's walk arrives as a post-order schedule of 5-int ops
//   {op, level, length, offset, skip}
// built once per (M, sub) on the host (ops/large_kernel.py
// scl_chunk_schedule): F and G into the next level (G gathers the parent
// LLRs through the left child's perm), COMBINE (fork the left bits through
// the right child's perm, XOR, compose perms), BIT (a span-1 mask leaf) and
// SUB (read the sub-block's class; a pure one takes its leaf rule and skips
// the `skip` ops of its per-bit recursion). The class is uniform over the
// batch, so the branch is uniform over the block.
//
// What bounds it on an H100: latency. A block of 256 threads decodes one
// codeword (B = 128 fills 128 SMs with one block each): F/G spread the
// (path, position) pairs over the threads, COMBINE the positions, and one
// warp runs each leaf, a lane per path for the deltas and a warp-wide
// argmax per prune round (L rounds of max and first code over L*C
// candidates, by shuffles). Every op ends in a __syncthreads, and a mixed
// sub-block of 16 is 61 ops, 16 of them leaf prunes, so the op chain, not
// bytes (1.2 MB a call at B = 128, L = 8, M = 256) or arithmetic, sets the
// time (0.16-0.50 ms a call on an H100 at 700 W, by the number of mixed
// sub-blocks). The LLR pyramid (L x 2M f32, 16 KiB at L = 8, M = 256), the
// packed bit words and the perms of the open node at each level live in
// shared memory, so device memory is read and written once per call.
//
// Two families, instantiations of one template (the TPU kernel's int8
// flag): float32, and char, integer-valued LLRs in f32 with g clipped to
// [-127, 127] and hard decisions llr < 0 (0 decides 0) in the bit leaves,
// the rate-1/SPC sub-block rules and the SPC parity. In both, f is the
// sign-XOR min-sum on the raw bits, which on integers is the char family's
// product form, unclipped.
//
// Numerics as the plain torch version (ops/large_kernel.py) and K1: float32
// hard decisions read the sign bit (-0.0 decides 1), leaf sums run
// sequentially over the span in f32 (exact on char integers), the
// build disables FMA contraction, and a prune round takes the candidate of
// largest value and, among equals, smallest flat code l*C + c, then leaves
// _NEG on it (the TPU kernel's rule: a taken candidate can be taken again
// once only values <= _NEG remain). Kernel and plain version agree bit for
// bit.
//
// C interface (ctypes; every pointer and the stream are void*):
//   int masked_scl_chunk(const int *ops, int n_ops, const int *spc_tab,
//                        const float *llr, const uint8_t *mask,
//                        const float *met, const int *sub_cls, int sub,
//                        int *bits, int *perm, float *met_out,
//                        int list_size, int chunk, int batch, int family,
//                        cudaStream_t stream)
// Returns the cudaGetLastError() of the launch (or of the shared-memory
// attribute call), or -1 for an unsupported list size, chunk or family.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 16;
constexpr int kMaxCand = 8;
constexpr int kOpWords = 5;
constexpr float kNeg = -1.0e30f;
enum { OP_F = 0, OP_G = 1, OP_COMBINE = 2, OP_BIT = 3, OP_SUB = 4 };
enum { C_MIXED = 0, C_RATE0 = 1, C_RATE1 = 2, C_REP = 3, C_SPC = 4 };

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

// Offset of level d's buffer ([L][M >> d]): level 0 is the call's input.
template <int L>
__device__ __forceinline__ int level_at(int d, int m) {
  return d == 0 ? 0 : L * (2 * m - (m >> (d - 1)));
}

template <int L>
struct Shared {
  int P[kMaxLevels][L];  // perm of the node open at each level
  float m[L];            // path metrics
  float dl[kMaxCand * L];  // candidate deltas [c][l]
  float nm[L];
  int src[L], cand[L];
  float ms[4 * L];  // weakest magnitudes [k][l] and their positions
  int is[4 * L];
  int par[L];
};

// Warp 0: top-L of the L*C candidates m[l] + dl[c*L + l] in (value desc,
// code l*C + c asc) order, leaving kNeg on each one taken.
template <int L>
__device__ void prune(Shared<L>& s, int n_cand, int lane) {
  constexpr int kPer = (L * kMaxCand + 31) / 32;
  const int total = L * n_cand;
  float v[kPer];
  int code[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    code[k] = lane + 32 * k;
    if (code[k] < total) {
      const int l = code[k] / n_cand, c = code[k] % n_cand;
      v[k] = s.m[l] + s.dl[c * L + l];
    } else {
      v[k] = -CUDART_INF_F;  // padding: loses to every candidate
      code[k] = 0x7fffffff;
    }
  }
  for (int r = 0; r < L; ++r) {
    float bv = -CUDART_INF_F;
    int bc = 0x7fffffff;
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (v[k] > bv || (v[k] == bv && code[k] < bc)) {
        bv = v[k];
        bc = code[k];
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oc = __shfl_xor_sync(0xffffffffu, bc, off);
      if (ov > bv || (ov == bv && oc < bc)) {
        bv = ov;
        bc = oc;
      }
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (code[k] == bc) v[k] = kNeg;
    if (lane == 0) {
      s.nm[r] = bv;
      s.src[r] = bc / n_cand;
      s.cand[r] = bc % n_cand;
    }
  }
  __syncwarp();
}

// Lane l < L: the `count` smallest |x| of path l over [0, len) and their
// first positions, each round excluding the positions already taken.
template <int L>
__device__ void weakest(Shared<L>& s, const float* X, int l, int len, int count) {
  for (int k = 0; k < count; ++k) {
    float best = 0.f;
    int bi = -1;
    for (int i = 0; i < len; ++i) {
      bool taken = false;
      for (int j = 0; j < k; ++j) taken |= (s.is[j * L + l] == i);
      if (taken) continue;
      const float v = fabsf(X[l * len + i]);
      if (bi < 0 || v < best) {
        best = v;
        bi = i;
      }
    }
    s.ms[k * L + l] = best;
    s.is[k * L + l] = bi;
  }
}

// Warp 0: the survivors' metrics and perm at level d, after a prune.
template <int L>
__device__ void adopt(Shared<L>& s, int d, int lane) {
  if (lane < L) {
    s.m[lane] = s.nm[lane];
    s.P[d][lane] = s.src[lane];
  }
}

// Warp 0: a span-1 mask leaf at level d, position off.
template <int L, class Fam>
__device__ void bit_leaf(Shared<L>& s, const float* Xd, int* W, int off, int frozen,
                         int lane) {
  if (lane < L) {
    const float x = Xd[lane];
    s.dl[lane] = frozen ? fminf(x, 0.f) : 0.f;
    s.dl[L + lane] = frozen ? kNeg : -fabsf(x);
  }
  __syncwarp();
  prune<L>(s, 2, lane);
  if (lane == 0) {
    int word = 0;
    if (!frozen)
      for (int j = 0; j < L; ++j)
        word |= (Fam::hard(Xd[s.src[j]]) ^ (s.cand[j] == 1)) << j;
    W[off] = word;
  }
}

// Warp 0: the SSCL leaf rule of a pure sub-block at level d.
template <int L, class Fam>
__device__ void sub_leaf(Shared<L>& s, const int* spc_tab, const float* X, int* W,
                         int d, int len, int off, int cls, int lane) {
  if (cls == C_RATE0) {
    if (lane < L) {
      float acc = 0.f;
      for (int i = 0; i < len; ++i) acc = acc + fminf(X[lane * len + i], 0.f);
      s.m[lane] = s.m[lane] + acc;
      s.P[d][lane] = lane;
    }
    for (int i = lane; i < len; i += 32) W[off + i] = 0;
    return;
  }
  int nc;
  if (cls == C_REP) {
    nc = 2;
    if (lane < L) {
      float z = 0.f, o = 0.f;
      for (int i = 0; i < len; ++i) {
        const float x = X[lane * len + i];
        z = z + fminf(x, 0.f);
        o = o + fmaxf(x, 0.f);
      }
      s.dl[lane] = z;
      s.dl[L + lane] = -o;
    }
  } else if (cls == C_RATE1) {
    nc = 4;
    if (lane < L) {
      weakest<L>(s, X, lane, len, 2);
      const float m0 = s.ms[lane], m1 = s.ms[L + lane];
      s.dl[lane] = 0.f;
      s.dl[L + lane] = -m0;
      s.dl[2 * L + lane] = -m1;
      s.dl[3 * L + lane] = -m0 - m1;
    }
  } else {  // C_SPC
    nc = 8;
    if (lane < L) {
      weakest<L>(s, X, lane, len, 4);
      int neg = 0;
      for (int i = 0; i < len; ++i) neg += Fam::hard(X[lane * len + i]);
      s.par[lane] = neg & 1;
      const float m0 = s.ms[lane];
      for (int c = 0; c < 8; ++c) {
        const int tm = spc_tab[24 + c];
        float tc = 0.f;
        for (int j = 0; j < 3; ++j)
          if ((tm >> j) & 1) tc = tc + s.ms[(1 + j) * L + lane];
        const float even = (spc_tab[16 + c] ? -m0 : -0.f * m0) - tc;
        const float odd = -m0 - tc;
        s.dl[c * L + lane] = s.par[lane] ? odd : even;
      }
    }
  }
  __syncwarp();
  prune<L>(s, nc, lane);
  for (int i = lane; i < len; i += 32) {
    int word = 0;
    for (int j = 0; j < L; ++j) {
      const int l = s.src[j], c = s.cand[j];
      int bit;
      if (cls == C_REP) {
        bit = c != 0;
      } else if (cls == C_RATE1) {
        bit = Fam::hard(X[l * len + i]) ^ (((c == 1 || c == 3) && i == s.is[l]) ||
                                          ((c == 2 || c == 3) && i == s.is[L + l]));
      } else {
        const int fm = spc_tab[(s.par[l] ? 8 : 0) + c];
        int f = 0;
        for (int j4 = 0; j4 < 4; ++j4) f |= ((fm >> j4) & 1) && i == s.is[j4 * L + l];
        bit = Fam::hard(X[l * len + i]) ^ f;
      }
      word |= bit << j;
    }
    W[off + i] = word;
  }
  __syncwarp();
  adopt<L>(s, d, lane);
}

template <int L, class Fam>
__global__ void __launch_bounds__(kThreads)
masked_scl_chunk_kernel(const int* __restrict__ ops, int n_ops,
                        const int* __restrict__ spc_tab, const float* __restrict__ llr,
                        const uint8_t* __restrict__ mask,
                        const float* __restrict__ met_in,
                        const int* __restrict__ sub_cls, int sub,
                        int* __restrict__ bits_out, int* __restrict__ perm_out,
                        float* __restrict__ met_out, int m) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* X = reinterpret_cast<float*>(smem);     // [L][2M] LLR pyramid
  int* W = reinterpret_cast<int*>(X + 2 * L * m);  // [M] packed bits
  __shared__ Shared<L> s;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const bool warp0 = tid < 32;

  const float* in = llr + (size_t)b * L * m;
  for (int t = tid; t < L * m; t += kThreads) X[t] = in[t];
  if (tid < L) {
    s.m[tid] = met_in[(size_t)b * L + tid];
    for (int d = 0; d < kMaxLevels; ++d) s.P[d][tid] = tid;
  }
  __syncthreads();

  for (int k = 0; k < n_ops; ++k) {
    const int* op = ops + k * kOpWords;
    const int code = op[0], d = op[1], len = op[2], off = op[3];
    const float* Xd = X + level_at<L>(d, m);
    if (code == OP_F || code == OP_G) {
      const int h = len >> 1;
      float* Y = X + level_at<L>(d + 1, m);
      if (code == OP_F) {
        for (int t = tid; t < L * h; t += kThreads) {
          const int l = t / h, i = t - l * h;
          Y[t] = f_bits(Xd[l * len + i], Xd[l * len + i + h]);
        }
      } else {
        for (int t = tid; t < L * h; t += kThreads) {
          const int l = t / h, i = t - l * h;
          const int p = s.P[d + 1][l];  // left child's perm: slot -> parent slot
          const float a = Xd[p * len + i], bb = Xd[p * len + i + h];
          Y[t] = Fam::g(a, bb, (W[off + i] >> l) & 1);
        }
        if (tid < L) s.P[d][tid] = s.P[d + 1][tid];
      }
    } else if (code == OP_COMBINE) {
      const int h = len >> 1;
      const int* p = s.P[d + 1];  // right child's perm
      for (int i = tid; i < h; i += kThreads) {
        const int lw = W[off + i];
        int g = 0;
        for (int j = 0; j < L; ++j) g |= ((lw >> p[j]) & 1) << j;
        W[off + i] = g ^ W[off + h + i];
      }
      if (tid == 0) {
        int comp[L];
        for (int j = 0; j < L; ++j) comp[j] = s.P[d][p[j]];
        for (int j = 0; j < L; ++j) s.P[d][j] = comp[j];
      }
    } else if (code == OP_BIT) {
      if (warp0) {
        bit_leaf<L, Fam>(s, Xd, W, off, mask[off], lane);
        __syncwarp();
        adopt<L>(s, d, lane);
      }
    } else {  // OP_SUB
      const int cls = sub_cls[off / sub];
      if (cls != C_MIXED) {
        if (warp0) sub_leaf<L, Fam>(s, spc_tab, Xd, W, d, len, off, cls, lane);
        k += op[4];  // skip the per-bit recursion of this sub-block
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < m; i += kThreads) bits_out[(size_t)b * m + i] = W[i];
  if (tid < L) {
    perm_out[(size_t)b * L + tid] = s.P[0][tid];
    met_out[(size_t)b * L + tid] = s.m[tid];
  }
}

template <int L, class Fam>
int launch(const int* ops, int n_ops, const int* spc_tab, const float* llr,
           const uint8_t* mask, const float* met, const int* sub_cls, int sub, int* bits,
           int* perm, float* met_out, int m, int batch, cudaStream_t stream) {
  const size_t smem = (size_t)2 * L * m * sizeof(float) + (size_t)m * sizeof(int);
  auto kernel = masked_scl_chunk_kernel<L, Fam>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch, kThreads, smem, stream>>>(ops, n_ops, spc_tab, llr, mask, met, sub_cls,
                                            sub, bits, perm, met_out, m);
  return static_cast<int>(cudaGetLastError());
}

template <class Fam>
int dispatch(const int* ops, int n_ops, const int* spc_tab, const float* llr,
             const uint8_t* mask, const float* met, const int* sub_cls, int sub, int* bits,
             int* perm, float* met_out, int list_size, int m, int batch,
             cudaStream_t stream) {
  switch (list_size) {
    case 2: return launch<2, Fam>(ops, n_ops, spc_tab, llr, mask, met, sub_cls, sub, bits, perm, met_out, m, batch, stream);
    case 4: return launch<4, Fam>(ops, n_ops, spc_tab, llr, mask, met, sub_cls, sub, bits, perm, met_out, m, batch, stream);
    case 8: return launch<8, Fam>(ops, n_ops, spc_tab, llr, mask, met, sub_cls, sub, bits, perm, met_out, m, batch, stream);
    case 16: return launch<16, Fam>(ops, n_ops, spc_tab, llr, mask, met, sub_cls, sub, bits, perm, met_out, m, batch, stream);
    case 32: return launch<32, Fam>(ops, n_ops, spc_tab, llr, mask, met, sub_cls, sub, bits, perm, met_out, m, batch, stream);
    default: return -1;
  }
}

}  // namespace

extern "C" int masked_scl_chunk(const void* ops, int n_ops, const void* spc_tab,
                                const void* llr, const void* mask, const void* met,
                                const void* sub_cls, int sub, void* bits, void* perm,
                                void* met_out, int list_size, int chunk, int batch,
                                int family, void* stream) {
  if (chunk < 2 || chunk > (1 << (kMaxLevels - 1)) || (chunk & (chunk - 1))) return -1;
  if (batch <= 0) return 0;
  auto o = static_cast<const int*>(ops);
  auto sp = static_cast<const int*>(spc_tab);
  auto x = static_cast<const float*>(llr);
  auto mk = static_cast<const uint8_t*>(mask);
  auto mi = static_cast<const float*>(met);
  auto sc = static_cast<const int*>(sub_cls);
  auto bt = static_cast<int*>(bits);
  auto pr = static_cast<int*>(perm);
  auto mo = static_cast<float*>(met_out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (family) {
    case 0: return dispatch<FloatFamily>(o, n_ops, sp, x, mk, mi, sc, sub, bt, pr, mo, list_size, chunk, batch, st);
    case 1: return dispatch<CharFamily>(o, n_ops, sp, x, mk, mi, sc, sub, bt, pr, mo, list_size, chunk, batch, st);
    default: return -1;
  }
}
