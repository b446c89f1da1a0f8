// Masked SCL chunk decoder (K7): bitwise SCL over one chunk of span M whose
// frozen mask (and, optionally, the class of each sub-block) arrives as
// data, for a batch of codewords.
//
// Replaces: polar_codes_tpu/ops/large_kernel.py,
// build_masked_scl_chunk_kernel.kernel (its float32 and int8 families), the
// mixed-chunk decode of LargeSCLDecoder: the f/g recursion with path-fork
// gathers and perm composition, a {keep, flip} fork and a top-L prune at
// every span-1 leaf (a frozen leaf pays min(llr, 0) and its flip is killed
// with _NEG), and, at span `sub`, a switch on the sub-block's class to the
// SSCL leaf rules (rate0, rate1 with 4 candidates, rep, spc with 8) or on
// to the per-bit recursion.
//
// Interface (batch-first, as the large-N glue holds its buffers):
//   llr [B, L, M] f32, mask [M] u8 (1 = frozen), metrics [B, L] f32,
//   sub_cls [M / sub] i32 (sub = 0: no sub-block dispatch),
//   family (0 float32, 1 char)
//     -> bits [B, M] i32 (bit l of a word = path l's codeword bit),
//        perm [B, L] i32 (output slot -> input slot), metrics [B, L] f32
//
// Walk: one warp decodes one codeword and computes the chunk's post-order
// walk itself from the leaf index, with the trigger and climb rules of K6:
// before leaf k the levels from dl - tz(k) down are refreshed (f for a
// left child, g for a right one, which gathers the parent's LLRs through
// the left sibling's perm), and after it tz(~k) combines climb back up
// (fork the left bits through the right child's perm, XOR, compose the
// perms). With sub-blocks the walk's leaves are the sub-blocks; a pure one
// takes its leaf rule and a mixed one runs the same walk over its bits.
// The order of operations is that of the host's post-order schedule
// (ops/large_kernel.py scl_chunk_schedule), which is not passed. The mask (as 32-bit words), the class codes and the SPC table are
// staged into shared memory once; inside the walk the kernel reads device
// memory not at all. Spans are powers of two: shifts and masks.
//
// The lowest kRegLevels = 3 levels of a per-bit walk run in registers:
// lane l < L holds path l's 8 LLRs of a span-8 node, f is elementwise, g's
// path-fork gather is a shuffle from the surviving path's lane, a leaf's
// candidates and their ranks live in registers (shuffles, no shared
// memory), its packed word is one __ballot_sync, a combine's fork one
// ballot per position and the perm composition one shuffle.
//
// What bounds it on an H100: the length of one codeword's dependent chain.
// At B = 128 each SM runs about one warp, so a call takes as long as one
// codeword's walk. Per bit: a prune by rank (each of the L*C candidates
// counts the candidates that beat it in (value desc, code l*C + c asc)
// order, L*C independent compares, and lands in slot = rank), plus the
// f/g refreshes and combines above span 8, each closed by a __syncwarp.
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W, B = 128,
// L = 8, M = 256): 0.174 ms a call in char with no sub-blocks (~1250
// cycles a bit), 0.111 ms in float32 with sub-blocks of 16; a call moves
// 1.2 MB (0.36 us at 3.35 TB/s), so the chain, not bytes or arithmetic,
// sets the time. A pure sub-block takes its leaf rule in shared memory
// (sums in span order by one lane per path, `weakest` by rank, the prune
// on the candidates staged through shared memory). The LLR pyramid (L x
// 2M f32, 16 KiB at L = 8, M = 256), the packed bit words and the perms of
// the open node at each level live in shared memory; device memory is
// read and written once per call.
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
// sequentially over the span in f32 (exact on char integers), the build
// disables FMA contraction. The prune reproduces the TPU kernel's
// iterative extraction, which leaves _NEG on each candidate it takes: with
// k values above _NEG, slots r < max(k, 1) take rank r with its value, and
// every later slot takes the smallest code among the candidates taken so
// far and those whose value is exactly _NEG, with value _NEG
// (ops/large_kernel.py prune_by_rank is its CPU twin). Kernel and plain
// version agree bit for bit.
//
// C interface (ctypes; every pointer and the stream are void*):
//   int masked_scl_chunk(const int *ops, int n_ops, const int *spc_tab,
//                        const float *llr, const uint8_t *mask,
//                        const float *met, const int *sub_cls, int sub,
//                        int *bits, int *perm, float *met_out,
//                        int list_size, int chunk, int batch, int family,
//                        cudaStream_t stream)
// `ops` and `n_ops` are not read (the wrapper passes NULL and 0).
// Returns the cudaGetLastError() of the launch (or of the shared-memory
// attribute call), or -1 for an unsupported list size, chunk or family.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kMaxCand = 8;
constexpr int kRegLevels = 3;  // the lowest levels of a per-bit walk, in registers
constexpr int kRegSpan = 1 << kRegLevels;
constexpr unsigned kAll = 0xffffffffu;
constexpr float kNeg = -1.0e30f;
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

__device__ __forceinline__ int log2i(int x) { return 31 - __clz(x); }

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

template <int L>
struct Shared {
  int P[kMaxLevels][L];     // perm of the node open at each level
  float V[L * kMaxCand];    // candidate values by flat code l*C + c
  int pc[L];                // prune result by slot: code and value
  float pv[L];
  float ms[4][L];           // weakest magnitudes of each path, and where
  int is[4][L];
  int par[L];               // SPC parity of each path
  int spc[32];              // SPC_TABLE
};

// One warp's view of the codeword: the shared state and the chunk.
template <int L, class Fam>
struct Walker {
  Shared<L>& s;
  float* X;                 // LLR pyramid: level d at lvl(d), [L][M >> d]
  int* W;                   // [M] packed bits
  const unsigned* Fm;       // [ceil(M / 32)] frozen mask bits
  const uint8_t* Cls;       // [M / sub] class codes
  int m, D, lane;
  float mreg;               // lane l < L: path l's metric

  __device__ int lvl(int d) const { return d == 0 ? 0 : L * (2 * m - (m >> (d - 1))); }
  __device__ int frozen(int pos) const { return (Fm[pos >> 5] >> (pos & 31)) & 1; }

  // f from level q into level q + 1
  __device__ void F(int q) {
    const int len = m >> q, lh = D - q - 1, h = 1 << lh;
    const float* Xq = X + lvl(q);
    float* Y = X + lvl(q + 1);
    for (int t = lane; t < (L << lh); t += 32) {
      const int l = t >> lh, i = t & (h - 1);
      Y[t] = f_bits(Xq[l * len + i], Xq[l * len + i + h]);
    }
    __syncwarp();
  }

  // g from level q into level q + 1 (node at offset off, whose left half's
  // bits are done), then the left child's perm becomes level q's
  __device__ void G(int q, int off) {
    const int len = m >> q, lh = D - q - 1, h = 1 << lh;
    const float* Xq = X + lvl(q);
    float* Y = X + lvl(q + 1);
    for (int t = lane; t < (L << lh); t += 32) {
      const int l = t >> lh, i = t & (h - 1);
      const int p = s.P[q + 1][l];  // left child's perm: slot -> parent slot
      Y[t] = Fam::g(Xq[p * len + i], Xq[p * len + i + h], (W[off + i] >> l) & 1);
    }
    if (lane < L) s.P[q][lane] = s.P[q + 1][lane];
    __syncwarp();
  }

  // the node at level q, offset off: left bits forked through the right
  // child's perm, XOR the right bits; perms composed
  __device__ void combine(int q, int off) {
    constexpr int kLgL = L == 2 ? 1 : L == 4 ? 2 : L == 8 ? 3 : L == 16 ? 4 : 5;
    constexpr int kPer = 32 / L;  // positions per ballot
    constexpr unsigned kMask = L == 32 ? kAll : (1u << L) - 1u;
    const int h = (m >> q) >> 1;
    const int* p = s.P[q + 1];
    const int j = lane & (L - 1);
    for (int base = 0; base < h; base += kPer) {
      const int i = base + (lane >> kLgL);
      const int bit = i < h ? (W[off + i] >> p[j]) & 1 : 0;
      const unsigned b = __ballot_sync(kAll, bit);
      if (lane < kPer && base + lane < h)
        W[off + base + lane] = static_cast<int>((b >> (lane * L)) & kMask) ^ W[off + h + base + lane];
    }
    const int c = lane < L ? s.P[q][p[lane]] : 0;
    __syncwarp();
    if (lane < L) s.P[q][lane] = c;
    __syncwarp();
  }

  // Top-L of T candidates into s.pc / s.pv (slot -> code, value). Lane
  // `lane` holds the values of codes lane + 32 r in v[r]; a candidate's rank
  // counts those that beat it in (value desc, code asc) order.
  template <int T>
  __device__ void prune(const float (&v)[(T + 31) / 32]) {
    constexpr int kPer = (T + 31) / 32;
    int k = 0;
#pragma unroll
    for (int r = 0; r < kPer; ++r)
      k += __popc(__ballot_sync(kAll, lane + 32 * r < T && v[r] > kNeg));
    const int kk = max(k, 1);
    int rank[kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r) rank[r] = 0;
#pragma unroll
    for (int ru = 0; ru < kPer; ++ru) {
#pragma unroll
      for (int j = 0; j < 32 && 32 * ru + j < T; ++j) {
        const float w = __shfl_sync(kAll, v[ru], j);
        const int u = 32 * ru + j;
#pragma unroll
        for (int r = 0; r < kPer; ++r)
          rank[r] += (w > v[r]) | ((w == v[r]) & (u < lane + 32 * r));
      }
    }
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int t = lane + 32 * r;
      if (t < T && rank[r] < kk && rank[r] < L) {
        s.pc[rank[r]] = t;
        s.pv[rank[r]] = v[r];
      }
    }
    if (kk < L) {  // warp-uniform: the re-take rule fills the rest
      int best = 0x7fffffff;
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const int t = lane + 32 * r;
        if (t < T && (rank[r] < kk || v[r] == kNeg)) best = min(best, t);
      }
      best = __reduce_min_sync(kAll, best);
      for (int r = kk + lane; r < L; r += 32) {
        s.pc[r] = best;
        s.pv[r] = kNeg;
      }
    }
    __syncwarp();
  }

  // prune the T candidates of s.V
  template <int T>
  __device__ void prune_shared() {
    float v[(T + 31) / 32];
#pragma unroll
    for (int r = 0; r < (T + 31) / 32; ++r) v[r] = lane + 32 * r < T ? s.V[lane + 32 * r] : 0.f;
    prune<T>(v);
  }

  // the survivors' metrics and perm at level d, after a prune
  __device__ void adopt(int d, int src) {
    if (lane < L) {
      mreg = s.pv[lane];
      s.P[d][lane] = src;
    }
    __syncwarp();
  }

  // A span-1 leaf at position pos with lane l < L holding path l's LLR x:
  // returns the packed word; perm (slot -> path) and the metrics follow
  // the prune.
  __device__ __forceinline__ unsigned leaf(float x, int pos, int& perm) {
    constexpr int T = 2 * L, kPer = (T + 31) / 32;
    const int fz = frozen(pos);
    float v[kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r) {  // candidate t = 2 l + c
      const int t = lane + 32 * r, l = (t >> 1) & 31;
      const float xl = __shfl_sync(kAll, x, l), ml = __shfl_sync(kAll, mreg, l);
      v[r] = ml + ((t & 1) ? (fz ? kNeg : -fabsf(xl)) : (fz ? fminf(xl, 0.f) : 0.f));
    }
    prune<T>(v);
    const int code = lane < L ? s.pc[lane] : 2 * lane;
    const float value = lane < L ? s.pv[lane] : 0.f;
    __syncwarp();  // slots read before the next prune writes them
    perm = code >> 1;
    const float xs = __shfl_sync(kAll, x, perm);
    if (lane < L) mreg = value;
    return __ballot_sync(kAll, lane < L && !fz && (Fam::hard(xs) ^ (code & 1)));
  }

  // Bitwise SCL of a span-S node held in registers (lane l < L: path l's
  // LLRs y) at position pos: its packed words w (uniform over the warp)
  // and perm (slot -> path; lanes >= L keep their own index).
  template <int S>
  __device__ __forceinline__ void rnode(const float (&y)[S], int pos, int& perm,
                                        unsigned (&w)[S]) {
    if constexpr (S == 1) {
      w[0] = leaf(y[0], pos, perm);
    } else {
      constexpr int H = S / 2;
      float a[H];
      unsigned wl[H], wr[H];
      int pl, pr;
#pragma unroll
      for (int i = 0; i < H; ++i) a[i] = f_bits(y[i], y[i + H]);
      rnode<H>(a, pos, pl, wl);
#pragma unroll
      for (int i = 0; i < H; ++i)  // g on the parent LLRs of each survivor
        a[i] = Fam::g(__shfl_sync(kAll, y[i], pl), __shfl_sync(kAll, y[i + H], pl),
                      (wl[i] >> lane) & 1u);
      rnode<H>(a, pos + H, pr, wr);
#pragma unroll
      for (int i = 0; i < H; ++i) {  // the left words forked through the right perm
        w[i] = __ballot_sync(kAll, lane < L && ((wl[i] >> pr) & 1u)) ^ wr[i];
        w[i + H] = wr[i];
      }
      perm = __shfl_sync(kAll, pl, pr);
    }
  }

  // the span-S node at level d, offset off, decoded in registers
  template <int S>
  __device__ void reg_node(int d, int off) {
    const float* Xd = X + lvl(d);
    float y[S];
#pragma unroll
    for (int i = 0; i < S; ++i) y[i] = lane < L ? Xd[lane * S + i] : 0.f;
    int perm = lane;
    unsigned w[S];
    rnode<S>(y, off, perm, w);
#pragma unroll
    for (int i = 0; i < S; ++i)
      if (lane == (i & 31)) W[off + i] = static_cast<int>(w[i]);
    if (lane < L) s.P[d][lane] = perm;
    __syncwarp();
  }

  // the per-bit walk of the node at level d0 (span 2^lg), offset off0: the
  // span-kRegSpan nodes in registers, the levels above in shared memory
  __device__ void walk_bits(int d0, int lg, int off0) {
    switch (lg) {
      case 1: reg_node<2>(d0, off0); return;
      case 2: reg_node<4>(d0, off0); return;
      case 3: reg_node<8>(d0, off0); return;
      default:
        walk(d0, lg - kRegLevels, kRegLevels, off0,
             [&](int, int off) { reg_node<kRegSpan>(d0 + lg - kRegLevels, off); });
    }
  }

  // the `count` smallest |x| of each path over the span-len node at Xd and
  // their positions, first position on ties: by rank in (|x|, position)
  __device__ void weakest(const float* Xd, int lg, int count) {
    const int len = 1 << lg;
    for (int e = lane; e < (L << lg); e += 32) {
      const int l = e >> lg, i = e & (len - 1);
      const float a = fabsf(Xd[e]);
      int n = 0;
      for (int j = 0; j < len; ++j) {
        const float b = fabsf(Xd[l * len + j]);
        n += (b < a) | ((b == a) & (j < i));
      }
      if (n < count) {
        s.ms[n][l] = a;
        s.is[n][l] = i;
      }
    }
    __syncwarp();
  }

  // the SSCL leaf rule of a pure sub-block of class cls at level d, offset off
  __device__ void sub_leaf(int d, int off, int cls) {
    const int lg = D - d, len = 1 << lg;
    const float* Xd = X + lvl(d);
    if (cls == C_RATE0) {
      if (lane < L) {
        float acc = 0.f;
        for (int i = 0; i < len; ++i) acc = acc + fminf(Xd[lane * len + i], 0.f);
        mreg = mreg + acc;
        s.P[d][lane] = lane;
      }
      for (int i = lane; i < len; i += 32) W[off + i] = 0;
      __syncwarp();
      return;
    }
    int lgc;
    if (cls == C_REP) {
      lgc = 1;
      if (lane < L) {
        float z = 0.f, o = 0.f;
        for (int i = 0; i < len; ++i) {
          const float x = Xd[lane * len + i];
          z = z + fminf(x, 0.f);
          o = o + fmaxf(x, 0.f);
        }
        s.V[2 * lane] = mreg + z;
        s.V[2 * lane + 1] = mreg + -o;
      }
    } else if (cls == C_RATE1) {
      lgc = 2;
      weakest(Xd, lg, 2);
      if (lane < L) {
        const float m = mreg, m0 = s.ms[0][lane], m1 = s.ms[1][lane];
        s.V[4 * lane] = m + 0.f;
        s.V[4 * lane + 1] = m + -m0;
        s.V[4 * lane + 2] = m + -m1;
        s.V[4 * lane + 3] = m + (-m0 - m1);
      }
    } else {  // C_SPC
      lgc = 3;
      weakest(Xd, lg, 4);
      if (lane < L) {
        int neg = 0;
        for (int i = 0; i < len; ++i) neg += Fam::hard(Xd[lane * len + i]);
        const int odd = neg & 1;
        s.par[lane] = odd;
        const float m = mreg, m0 = s.ms[0][lane];
        for (int c = 0; c < 8; ++c) {
          const int tm = s.spc[24 + c];
          float tc = 0.f;
          for (int j = 0; j < 3; ++j)
            if ((tm >> j) & 1) tc = tc + s.ms[1 + j][lane];
          const float even_d = (s.spc[16 + c] ? -m0 : -0.f * m0) - tc;
          const float odd_d = -m0 - tc;
          s.V[8 * lane + c] = m + (odd ? odd_d : even_d);
        }
      }
    }
    __syncwarp();
    if (lgc == 1)
      prune_shared<2 * L>();
    else if (lgc == 2)
      prune_shared<4 * L>();
    else
      prune_shared<8 * L>();
    int src = 0, c = 0, fm = 0, i0 = -1, i1 = -1, i2 = -1, i3 = -1;
    if (lane < L) {
      const int code = s.pc[lane];
      src = code >> lgc;
      c = code & ((1 << lgc) - 1);
      if (cls == C_RATE1) {
        fm = (c == 1 || c == 3) | ((c == 2 || c == 3) << 1);
      } else if (cls == C_SPC) {
        fm = s.spc[(s.par[src] ? 8 : 0) + c];
      }
      if (cls != C_REP) {
        i0 = s.is[0][src];
        i1 = s.is[1][src];
        if (cls == C_SPC) {
          i2 = s.is[2][src];
          i3 = s.is[3][src];
        }
      }
    }
    for (int i = 0; i < len; ++i) {
      int bit = 0;
      if (lane < L) {
        if (cls == C_REP) {
          bit = c != 0;
        } else {
          const int f = ((fm & 1) && i == i0) | ((fm & 2) && i == i1) |
                        ((fm & 4) && i == i2) | ((fm & 8) && i == i3);
          bit = Fam::hard(Xd[src * len + i]) ^ f;
        }
      }
      const unsigned word = __ballot_sync(kAll, bit);
      if (lane == (i & 31)) W[off + i] = static_cast<int>(word);
    }
    adopt(d, src);
  }

  // The post-order walk of the node at level d0, offset off0, over its
  // 2^lgn leaves of span 2^lgl, calling leaf(k, offset) at level d0 + lgn.
  template <class Leaf>
  __device__ void walk(int d0, int lgn, int lgl, int off0, Leaf leaf) {
    const int dl = d0 + lgn, n = 1 << lgn;
    for (int k = 0; k < n; ++k) {
      const int top = k == 0 ? d0 + 1 : dl - (__ffs(k) - 1);
      for (int d = top; d <= dl; ++d) {
        const int up = dl - d + 1;  // levels from the leaves to the parent
        if ((k >> (dl - d)) & 1)
          G(d - 1, off0 + (((k >> up) << up) << lgl));
        else
          F(d - 1);
      }
      leaf(k, off0 + (k << lgl));
      const int climb = __ffs(~k) - 1;
      for (int j = 1; j <= climb && j <= lgn; ++j)
        combine(dl - j, off0 + (((k >> j) << j) << lgl));
    }
  }
};

template <int L, class Fam>
__global__ void __launch_bounds__(32)
masked_scl_chunk_kernel(const int* __restrict__ spc_tab, const float* __restrict__ llr,
                        const uint8_t* __restrict__ mask,
                        const float* __restrict__ met_in,
                        const int* __restrict__ sub_cls, int sub,
                        int* __restrict__ bits_out, int* __restrict__ perm_out,
                        float* __restrict__ met_out, int m) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* X = reinterpret_cast<float*>(smem);         // [L][2M] LLR pyramid
  int* W = reinterpret_cast<int*>(X + 2 * L * m);    // [M] packed bits
  const int n_words = (m + 31) >> 5;
  unsigned* Fm = reinterpret_cast<unsigned*>(W + m);  // [M / 32] mask bits
  uint8_t* Cls = reinterpret_cast<uint8_t*>(Fm + n_words);  // [M / sub]
  __shared__ Shared<L> s;
  const int b = blockIdx.x, lane = threadIdx.x;

  const float* in = llr + (size_t)b * L * m;
  for (int t = lane; t < L * m; t += 32) X[t] = in[t];
  for (int w = 0; w < n_words; ++w) {
    const int pos = 32 * w + lane;
    const unsigned word = __ballot_sync(kAll, pos < m && mask[pos] != 0);
    if (lane == 0) Fm[w] = word;
  }
  const int n_sub = sub ? m / sub : 0;
  for (int i = lane; i < n_sub; i += 32) Cls[i] = static_cast<uint8_t>(sub_cls[i]);
  s.spc[lane] = spc_tab[lane];
  if (lane < L)
    for (int d = 0; d < kMaxLevels; ++d) s.P[d][lane] = lane;
  __syncwarp();

  Walker<L, Fam> wk{s, X, W, Fm, Cls, m, log2i(m), lane,
                    lane < L ? met_in[(size_t)b * L + lane] : 0.f};
  if (sub == 0) {
    wk.walk_bits(0, wk.D, 0);
  } else {
    const int lgs = log2i(sub), ds = wk.D - lgs;
    wk.walk(0, ds, lgs, 0, [&](int k, int off) {
      const int cls = Cls[k];
      if (cls == C_MIXED)
        wk.walk_bits(ds, lgs, off);
      else
        wk.sub_leaf(ds, off, cls);
    });
  }

  for (int i = lane; i < m; i += 32) bits_out[(size_t)b * m + i] = W[i];
  if (lane < L) {
    perm_out[(size_t)b * L + lane] = s.P[0][lane];
    met_out[(size_t)b * L + lane] = wk.mreg;
  }
}

template <int L, class Fam>
int launch(const int* spc_tab, const float* llr, const uint8_t* mask, const float* met,
           const int* sub_cls, int sub, int* bits, int* perm, float* met_out, int m,
           int batch, cudaStream_t stream) {
  const size_t words = (size_t)(m + 31) / 32;
  const size_t smem = (size_t)2 * L * m * sizeof(float) + (size_t)m * sizeof(int) +
                      words * sizeof(unsigned) + (sub ? m / sub : 0);
  auto kernel = masked_scl_chunk_kernel<L, Fam>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch, 32, smem, stream>>>(spc_tab, llr, mask, met, sub_cls, sub, bits, perm,
                                      met_out, m);
  return static_cast<int>(cudaGetLastError());
}

template <class Fam>
int dispatch(const int* spc_tab, const float* llr, const uint8_t* mask, const float* met,
             const int* sub_cls, int sub, int* bits, int* perm, float* met_out,
             int list_size, int m, int batch, cudaStream_t stream) {
  switch (list_size) {
    case 2: return launch<2, Fam>(spc_tab, llr, mask, met, sub_cls, sub, bits, perm, met_out, m, batch, stream);
    case 4: return launch<4, Fam>(spc_tab, llr, mask, met, sub_cls, sub, bits, perm, met_out, m, batch, stream);
    case 8: return launch<8, Fam>(spc_tab, llr, mask, met, sub_cls, sub, bits, perm, met_out, m, batch, stream);
    case 16: return launch<16, Fam>(spc_tab, llr, mask, met, sub_cls, sub, bits, perm, met_out, m, batch, stream);
    case 32: return launch<32, Fam>(spc_tab, llr, mask, met, sub_cls, sub, bits, perm, met_out, m, batch, stream);
    default: return -1;
  }
}

}  // namespace

extern "C" int masked_scl_chunk(const void* ops, int n_ops, const void* spc_tab,
                                const void* llr, const void* mask, const void* met,
                                const void* sub_cls, int sub, void* bits, void* perm,
                                void* met_out, int list_size, int chunk, int batch,
                                int family, void* stream) {
  (void)ops;
  (void)n_ops;
  if (chunk < 2 || chunk > (1 << (kMaxLevels - 1)) || (chunk & (chunk - 1))) return -1;
  if (sub && (sub < 2 || sub > chunk || (sub & (sub - 1)))) return -1;
  if (batch <= 0) return 0;
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
    case 0: return dispatch<FloatFamily>(sp, x, mk, mi, sc, sub, bt, pr, mo, list_size, chunk, batch, st);
    case 1: return dispatch<CharFamily>(sp, x, mk, mi, sc, sub, bt, pr, mo, list_size, chunk, batch, st);
    default: return -1;
  }
}
