// K1 and K7 with one codeword's list state past shared memory: the SCL
// subtree decoder (K1) and the masked SCL chunk decoder (K7) at every list
// size, span and chunk whose state does not fit one SM's shared memory
// (every L > 128; L <= 128 at a caller's large kernel_span or chunk).
// scl_subtree.cu, large_scl_chunk.cu and large_scl_lists.cu keep the
// shapes whose state fits; their wrappers (ops/scl_kernel_bl.py
// scl_subtree, ops/large_kernel.py masked_scl_chunk) send the rest here.
// One library beside them, so that nvcc builds it in parallel.
//
// Replaces: polar_codes_tpu/ops/scl_kernel_bl.py,
// build_bl_hybrid_decode_paths.subtree_call.kernel, in its unpacked-path
// family (any L), and polar_codes_tpu/ops/large_kernel.py,
// build_masked_scl_chunk_kernel.kernel (any n_list, any chunk), in the
// shapes the two kernels above leave out. What each computes is written
// out at the head of scl_subtree.cu and large_scl_lists.cu; this source
// computes the same, bit for bit, in another layout.
//
// Interfaces: those of the two kernels it stands in for, plus a scratch
// and the schedule's shape:
//   K1  llr [w_in, span, B] (f32, int16 char or bf16 state), metrics
//       [B, w_in] f32 -> bits [W, span, B] i32 ([span, B] at W = 1),
//       perm [B, w_out] i32, metrics [B, w_out] f32, W = ceil(L / 32);
//   K7  llr [B, L, M] f32, mask [M] u8, metrics [B, L] f32, sub_cls
//       [M / sub] i32 -> bits [B, W, M] i32 ([B, M] at W = 1), perm and
//       metrics [B, L].
// Both run one interpreter of a post-order schedule of 8-int ops
//   {op, level, length, offset, kind, aux, ncand, skip}:
// F, G, COMBINE and LEAF as in scl_subtree.cu (K1's schedule,
// ops/scl_kernel_bl.py build_schedule), and for K7 its chunk walk
// (ops/large_kernel.py scl_chunk_schedule, which the wrapper widens to 8
// ints): a span-1 leaf of kind BIT (the {keep, flip} fork, {min(x, 0),
// _NEG} where the mask freezes the position) and SUB, which reads the
// sub-block's class and either runs the SSCL leaf rule of a pure class
// (rate0, rate1, rep, spc: K1's leaf rules) and skips the `skip` ops of
// its per-bit walk, or goes on into them.
//
// Mapping: one block per codeword, ops separated by a block barrier (PTX
// barrier.sync without .aligned, which a split warp may reach): 256
// threads for K1, 1024 for K7 (a thread per candidate of a bit up to L =
// 512). Level 0 is read where the input lies; the LLR levels d >= 1 (L x
// (span - 1) values of the state type) lie in a device-memory scratch of
// the wrapper's ([B] x `scratch` bytes from PyTorch's caching allocator
// on the call's stream, codeword b's at b x scratch). The bookkeeping
// stays in shared memory: the packed bit words [W][span], the metrics,
// the perms of the open nodes [levels][L], the candidate values [L x C],
// the prune's work array, the leaf scratch. Each of these arrays goes to
// shared memory while the card's opt-in shared memory per block has room,
// in that order, and to the device scratch otherwise (make_plan, one plan
// for K1 and K7; only lists and spans far past the JAX package's defaults
// spill). Keeping K7's deepest levels in the shared memory left (levels
// >= 2 at L = 256 on chunks of 256) was measured on the card and gave the
// same time: those levels' reads and writes stay in the 50 MB L2 at these
// batches. Inside an op:
//   F, G      threads over (path, element) pairs;
//   COMBINE   a warp per (word, position): lane j forks slot 32 k + j's
//             left bit through the right child's perm, one ballot a word,
//             into a staging array; then every word of the left half is
//             replaced at once (a word reads every other word, so none
//             is written before all are read);
//   LEAF      a thread per path for the weakest magnitudes (one pass
//             keeping the K smallest (|x|, index) keys) and the sums; a
//             thread per candidate for its value; the prune; the decision
//             bits a warp per (word, 32 positions), one ballot a
//             position, lane = slot 32 k + lane.
// The prune ranks the T = w x C candidates by (value descending, flat
// code l*C + c ascending) and keeps the rule of the kernel it stands in
// for. K1: a bitonic sort of the T keys in shared memory, log2(T)
// (log2(T) + 1) / 2 stages of T / 2 compare-exchanges; each candidate
// taken once (slots r < min(T, L) take rank r; while T <= L every
// candidate keeps its code as its slot). K7: a merge of the C lists (list
// c = candidates (l, c) in path order), with the TPU kernel's _NEG
// re-take rule (with k values above _NEG, slots r < max(k, 1) take rank r
// and every later slot the smallest code among those taken and those
// exactly at _NEG, with value _NEG; ops/large_kernel.py prune_by_rank).
// Every prune leaves its slots in rank order, so at an information bit
// the keep list (value m_l) is in rank order already; the block checks
// each list (a warp OR of "v_l < v_{l+1}", one shared atomic a warp). A
// list out of order (a chunk's entry, frozen bits, sub-blocks) is ranked
// in runs of 32 paths (each candidate counts the others of its run) and
// its runs merged by binary search. A candidate's rank is its place in its
// own list plus, for each other list, a binary search for how many of it
// beat the candidate: at an information bit at L = 256, 32 compares and
// 8 searches a candidate, where the bitonic sort of the 512 keys took 45
// barrier stages. An ordered list holds paths only (the work array's 8
// bytes a candidate: the lists and each candidate's place); a search step
// reads an entry's value through its path.
//
// What bounds it on an H100: the dependent chain of one codeword's block
// steps, each closed by a barrier, at one block per codeword (B
// blocks over 132 SMs): per leaf the prune's barriers and compare chain
// (K1: the sort's O(log^2 T) barriers), per F, G and COMBINE one or two
// barriers and the level's reads and writes, which stay in the 50 MB L2
// at the batches of the paths. Bytes (each input read once, each output
// written once) and arithmetic are far below that (chip_smoke.py prints
// both beside the time). Measured (chip_profile.py k7_lists_ab, NVIDIA
// H100 80GB HBM3 at 700 W, a decode's K7 calls back to back, the parent's
// 256-thread kernel with the bitonic sort in the same run): 1.105-1.107
// ms a call at L = 256, B = 32 (parent 1.271-1.273; 512 threads
// 1.198-1.200, 256 threads 1.877-1.879); char at L = 256 2.692-2.695
// (3.066-3.069); L = 128 on chunks of 512 1.242-1.248 (1.467-1.474). K1
// at L = 256: 3.9-4.5 ms a (1024, 512) decode at B = 256.
//
// Numerics: every sum is sequential over the span in f32 on one thread,
// in the plain versions' order, and the build disables FMA contraction;
// the sort keys and the merge's float compares order -0.0 and +0.0 as
// equal (ties by code), as the plain versions' rank comparisons do; so
// kernel and plain versions agree bit for bit in every family.
//
// C interface (ctypes; every pointer and the stream are void*):
//   int scl_wide_plan(int list_size, int span, int levels, int ncand,
//                     int family, long long *out)
//     out[0] = shared-memory bytes a codeword (a block), out[1] = device
//     scratch bytes a codeword; family 0 f32, 1 char (int16), 2 bf16,
//     3 K7's char (f32 state). Returns 0, or -1 for a bad argument.
//   int scl_subtree_wide(const int *ops, int n_ops, const int *enum_masks,
//                        const int *spc_tab, const void *llr,
//                        const float *met, int *bits, int *perm,
//                        float *met_out, void *scratch, int list_size,
//                        int w_in, int w_out, int span, int levels,
//                        int ncand, int batch, int family,
//                        cudaStream_t stream)
//   int masked_scl_chunk_wide(const int *ops, int n_ops,
//                             const int *spc_tab, const float *llr,
//                             const uint8_t *mask, const float *met,
//                             const int *sub_cls, int sub, int *bits,
//                             int *perm, float *met_out, void *scratch,
//                             int list_size, int chunk, int batch,
//                             int family, cudaStream_t stream)
//     family 0 float32, 1 char. Each returns the cudaGetLastError() of the
//     launch (or of the shared-memory attribute call), or -1 for a bad
//     argument. `scratch` holds batch x out[1] bytes of scl_wide_plan
//     (K7: levels = log2(chunk) + 1, ncand = 8 with sub-blocks, else 2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreadsK1 = 256;  // one block a codeword: K1's
constexpr int kThreadsK7 = 1024;  // K7's (a thread per candidate of a bit up to L = 512)
constexpr int kMaxWarps = kThreadsK7 / 32;
constexpr int kOpWords = 8;
constexpr int kMaxLevels = 16;
constexpr int kStatic = 1024;  // shared bytes kept for the static arrays
constexpr unsigned kAll = 0xffffffffu;
constexpr float kNeg = -1.0e30f;
constexpr int kNoCode = 0x7fffffff;
enum { OP_F = 0, OP_G = 1, OP_COMBINE = 2, OP_LEAF = 3, OP_SUB = 4 };
enum { K_RATE0 = 0, K_RATE1 = 1, K_REP = 2, K_SPC = 3, K_ENUM = 4, K_BIT = 5 };
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

// sign with jnp.sign's rule at zero: sgn(+-0) = +-0
__device__ __forceinline__ float sgn(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}

__device__ __forceinline__ int log2i(int x) { return 31 - __clz(x); }

// The families: K1's three (scl_subtree.cu) and K7's char family, whose
// state is f32 and whose f is the sign-XOR form (large_scl_lists.cu); K7's
// float32 family is K1's.
struct FloatFamily {
  using State = float;
  __device__ static float load(float x) { return x; }
  __device__ static float store(float x) { return x; }
  __device__ static float f(float a, float b) { return f_bits(a, b); }
  __device__ static float g(float a, float b, int bit) { return bit ? b - a : b + a; }
  __device__ static int hard(float x) { return sign_bit(x); }
};

struct CharFamily {
  using State = short;
  __device__ static float load(short x) { return static_cast<float>(x); }
  // exact: every value is an integer in [-128, 128]
  __device__ static short store(float x) { return static_cast<short>(x); }
  __device__ static float f(float a, float b) {
    return sgn(a) * sgn(b) * fminf(fabsf(a), fabsf(b));
  }
  __device__ static float g(float a, float b, int bit) {
    return fminf(fmaxf(bit ? b - a : b + a, -127.f), 127.f);
  }
  __device__ static int hard(float x) { return x < 0.f; }
};

struct Bf16Family {
  using State = __nv_bfloat16;
  __device__ static float load(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 store(float x) { return __float2bfloat16_rn(x); }
  __device__ static float f(float a, float b) { return f_bits(a, b); }
  __device__ static float g(float a, float b, int bit) { return bit ? b - a : b + a; }
  __device__ static int hard(float x) { return sign_bit(x); }
};

struct ChunkCharFamily {
  using State = float;
  __device__ static float load(float x) { return x; }
  __device__ static float store(float x) { return x; }
  __device__ static float f(float a, float b) { return f_bits(a, b); }
  __device__ static float g(float a, float b, int bit) {
    return fminf(fmaxf(bit ? b - a : b + a, -127.f), 127.f);
  }
  __device__ static int hard(float x) { return x < 0.f; }
};

// One codeword's arrays besides the LLR levels, in the order they claim
// shared memory: metrics, perms [levels][L], prune slots (code, value),
// weakest magnitudes and indices [4][L], SPC parities, bit words
// [W][span], candidate values [L x C], and a work array (K1: the prune's
// sort keys; K7: the merge's ordered lists and places; or a combine's
// staged words).
enum { A_M, A_P, A_PC, A_PV, A_MS, A_IS, A_PAR, A_W, A_V, A_WORK, kArrays };

struct Plan {
  int nl, words, span, levels, ncand;
  long long off[kArrays];  // byte offset of each array in its memory
  unsigned in_dev;         // bit a: array a lies in the device scratch
  long long smem, scratch; // bytes a codeword: shared, device
};

long long round16(long long n) { return (n + 15) & ~15LL; }

long long pow2_at_least(long long x) {
  long long p = 1;
  while (p < x) p <<= 1;
  return p;
}

// The levels d >= 1 open the scratch; each array then takes shared memory
// while `budget` has room for it, else the scratch.
Plan make_plan(int nl, int span, int levels, int ncand, int state_bytes, long long budget) {
  Plan p{};
  p.nl = nl;
  p.words = (nl + 31) / 32;
  p.span = span;
  p.levels = levels;
  p.ncand = ncand;
  const long long T = (long long)nl * ncand;
  // K1's sort keys, K7's merge (ordered lists and places: 8 T bytes), or a
  // combine's staged words
  long long work = 8 * pow2_at_least(T);
  work = work > 2LL * p.words * span ? work : 2LL * p.words * span;
  const long long bytes[kArrays] = {4LL * nl, 4LL * levels * nl, 4LL * nl, 4LL * nl,
                                    16LL * nl, 16LL * nl, 4LL * nl, 4LL * p.words * span,
                                    4 * T, work};
  p.scratch = round16((long long)nl * (span - 1) * state_bytes);
  for (int a = 0; a < kArrays; ++a) {
    const long long n = round16(bytes[a]);
    if (p.smem + n <= budget) {
      p.off[a] = p.smem;
      p.smem += n;
    } else {
      p.off[a] = p.scratch;
      p.scratch += n;
      p.in_dev |= 1u << a;
    }
  }
  return p;
}

// What a launch reads and writes: the input (element (l, i) of codeword b
// at llr[b sb + l sl + i si]), the outputs (word k of position i of
// codeword b at bits[b ob + k ok + i oi]; perm and metrics [B, w_out]),
// the schedule, K7's mask and classes, the scratch.
template <class S>
struct Args {
  const int* ops;
  int n_ops;
  const int* enum_masks;
  const int* spc_tab;
  const S* llr;
  long long sb, sl, si;
  const float* met_in;
  int w_in, w_out;
  int* bits;
  long long ob, ok, oi;
  int* perm;
  float* met_out;
  const uint8_t* mask;
  const int* sub_cls;
  int sub;
  unsigned char* scratch;
};

// A leaf's survivor in one slot: the path it descends from, its
// candidate, and what its decision bits need (flip mask and positions, the
// ENUM codeword's bitmask; a BIT leaf's frozen flag in fm).
struct Slot {
  int src = 0, c = 0, fm = 0, i0 = -1, i1 = -1, i2 = -1, i3 = -1, emask = 0;
};

// One block's view of its codeword: K1's (NT = 256, the bitonic prune
// with K1's take-once rule) or K7's (NT = 1024, the prune by merge with the
// _NEG re-take rule).
template <class Fam, bool K7>
struct Block {
  using S = typename Fam::State;
  static constexpr int NT = K7 ? kThreadsK7 : kThreadsK1;
  static constexpr int NWARPS = NT / 32;
  float* M;
  int* P;
  int* pc;
  float* pv;
  float* ms;
  int* is;
  int* par;
  int* W;  // word k of position i at W[k span + i]
  float* V;
  unsigned long long* keys;  // the work array, as K1's sort keys
  int* tmp;                  // the work array, as staged words
  int* SL;                   // the work array, as K7's ordered lists (the
  int* R;                    // paths, list c from SL[c w]) and places
  S* X;                      // levels d >= 1
  const S* in;               // level 0: element (l, i) at in[l sl + i si]
  long long sl, si;
  const int* masks;
  const uint8_t* mask;
  const int* spc;
  int* red;    // [NWARPS]
  int* flags;  // K7's prune: lists out of order, values above kNeg, re-take code
  int nl, NW, span, tid, lane, warp;

  __device__ int bit_of(int pos, int l) const {
    return (W[(l >> 5) * span + pos] >> (l & 31)) & 1;
  }

  // the block's barrier: PTX's barrier.sync without .aligned, which a warp
  // may reach split (a loop over paths or candidates leaves the warp that
  // holds the last one split); __syncthreads is bar.sync, the aligned form
  // (the CPU runner's __syncthreads counts threads the same way)
  __device__ static void bar() {
#ifdef __CUDA_ARCH__
    asm volatile("barrier.sync 0;" ::: "memory");
#else
    __syncthreads();
#endif
  }

  __device__ S* lvl(int d) const { return X + (size_t)nl * (span - (span >> (d - 1))); }

  // element i of path l of the span-len node at level d, as f32
  __device__ float at(int d, int len, int l, int i) const {
    return Fam::load(d == 0 ? in[l * sl + i * si] : lvl(d)[(size_t)l * len + i]);
  }

  __device__ int block_sum(int v) {
    v = __reduce_add_sync(kAll, v);
    if (lane == 0) red[warp] = v;
    bar();
    int s = 0;
    for (int q = 0; q < NWARPS; ++q) s += red[q];
    bar();
    return s;
  }

  __device__ int block_min(int v) {
    v = __reduce_min_sync(kAll, v);
    if (lane == 0) red[warp] = v;
    bar();
    int s = red[0];
    for (int q = 1; q < NWARPS; ++q) s = min(s, red[q]);
    bar();
    return s;
  }

  // f from level d (span len) into level d + 1, for paths l < w
  __device__ void F(int d, int len, int w) {
    const int h = len >> 1, lh = log2i(h), n = w << lh;
    S* Y = lvl(d + 1);
    for (int t = tid; t < n; t += NT) {
      const int l = t >> lh, i = t & (h - 1);
      Y[t] = Fam::store(Fam::f(at(d, len, l, i), at(d, len, l, i + h)));
    }
    bar();
  }

  // g from level d into level d + 1 (node at offset off, whose left half's
  // bits are done), gathering the parent through the left child's perm;
  // then the left child's perm becomes level d's
  __device__ void G(int d, int len, int off, int w) {
    const int h = len >> 1, lh = log2i(h), n = w << lh;
    S* Y = lvl(d + 1);
    const int* p = P + (d + 1) * nl;  // slots -> parent slots
    for (int t = tid; t < n; t += NT) {
      const int l = t >> lh, i = t & (h - 1);
      Y[t] = Fam::store(Fam::g(at(d, len, p[l], i), at(d, len, p[l], i + h), bit_of(off + i, l)));
    }
    for (int l = tid; l < w; l += NT) P[d * nl + l] = p[l];
    bar();
  }

  // the node at level d, offset off: left bits forked through the right
  // child's perm, XOR the right bits; perms composed
  __device__ void combine(int d, int len, int off, int w) {
    const int h = len >> 1, lh = log2i(h);
    const int* p = P + (d + 1) * nl;  // right child's perm
    int* pd = P + d * nl;
    for (int pair = warp; pair < (NW << lh); pair += NWARPS) {
      const int k = pair >> lh, i = pair & (h - 1), j = 32 * k + lane;
      const int src = j < w ? p[j] : -1;
      const unsigned b = __ballot_sync(kAll, src >= 0 && bit_of(off + i, src));
      if (lane == 0) tmp[pair] = static_cast<int>(b) ^ W[k * span + off + h + i];
    }
    for (int l = tid; l < w; l += NT) pc[l] = pd[p[l]];
    bar();
    for (int t = tid; t < (NW << lh); t += NT)
      W[(t >> lh) * span + off + (t & (h - 1))] = tmp[t];
    for (int l = tid; l < w; l += NT) pd[l] = pc[l];
    bar();
  }

  // The K (|x|, index)-smallest entries of each path l < w of the span-len
  // leaf at level d into ms / is, and each path's parity of hard decisions
  // into par: a thread per path, one pass keeping the K smallest keys
  // (|x| bits, index) in order, which is K1's first-index-on-ties rule.
  template <int K>
  __device__ void weakest(int d, int len, int w) {
    for (int l = tid; l < w; l += NT) {
      unsigned long long best[K];
#pragma unroll
      for (int k = 0; k < K; ++k) best[k] = ~0ull;
      int neg = 0;
      for (int i = 0; i < len; ++i) {
        const float y = at(d, len, l, i);
        neg ^= Fam::hard(y);
        unsigned long long key =
            (static_cast<unsigned long long>(__float_as_uint(fabsf(y))) << 32) |
            static_cast<unsigned>(i);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (key < best[k]) {
            const unsigned long long t = best[k];
            best[k] = key;
            key = t;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        ms[k * nl + l] = __uint_as_float(static_cast<unsigned>(best[k] >> 32));
        is[k * nl + l] = static_cast<int>(best[k] & 0xffffffffu);
      }
      par[l] = neg;
    }
    bar();
  }

  // Candidate c of path l of a leaf of `kind`: its metric delta. Sums run
  // sequentially over the span, in the plain versions' order.
  __device__ float delta(int kind, int d, int len, int l, int c, int aux, int fz) const {
    if (kind == K_REP) {
      float acc = 0.f;
      if (c == 0) {
        for (int i = 0; i < len; ++i) acc = acc + fminf(at(d, len, l, i), 0.f);
        return acc;
      }
      for (int i = 0; i < len; ++i) acc = acc + fmaxf(at(d, len, l, i), 0.f);
      return -acc;
    }
    if (kind == K_BIT) {
      const float x = at(d, len, l, 0);
      return c == 0 ? (fz ? fminf(x, 0.f) : 0.f) : (fz ? kNeg : -fabsf(x));
    }
    if (kind == K_RATE1 && len == 1) return c == 0 ? 0.f : -fabsf(at(d, len, l, 0));
    if (kind == K_RATE1) {
      const float m0 = ms[l], m1 = ms[nl + l];
      return c == 0 ? 0.f : c == 1 ? -m0 : c == 2 ? -m1 : -m0 - m1;
    }
    if (kind == K_SPC) {
      const float m0 = ms[l];
      const int tm = spc[24 + c];
      float tc = 0.f;
      for (int j = 0; j < 3; ++j)
        if ((tm >> j) & 1) tc = tc + ms[(1 + j) * nl + l];
      const float even = (spc[16 + c] ? -m0 : -0.f * m0) - tc;
      const float odd = -m0 - tc;
      return par[l] ? odd : even;
    }
    // K_ENUM: the correlation with codeword c of the leaf's subcode, less
    // the path's sum of |x| (in ms row 0)
    const int mk = masks[aux + c];
    float sc = 0.f;
    for (int i = 0; i < len; ++i) {
      const float y = at(d, len, l, i);
      sc = sc + (((mk >> i) & 1) ? -y : y);
    }
    return 0.5f * (sc - ms[l]);
  }

  // sort key of candidate t with value v: ascending keys are (value
  // descending, code ascending), -0.0 ranked with +0.0
  __device__ static unsigned long long key_of(float v, int t) {
    unsigned u = __float_as_uint(v);
    if (u == 0x80000000u) u = 0u;
    const unsigned ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    return (static_cast<unsigned long long>(~ord) << 32) | static_cast<unsigned>(t);
  }

  // K1's prune of the T candidate values in V into pc / pv (slot -> code,
  // value): a bitonic sort of the keys, each candidate taken once; returns
  // the new width.
  __device__ int prune(int T) {
    if (T <= nl) {  // every candidate survives, its code its slot
      for (int t = tid; t < T; t += NT) {
        pc[t] = t;
        pv[t] = V[t];
      }
      bar();
      return T;
    }
    int n2 = 1;
    while (n2 < T) n2 <<= 1;
    for (int t = tid; t < n2; t += NT)
      keys[t] = t < T ? key_of(V[t], t) : (0xffffffffull << 32) | static_cast<unsigned>(t);
    bar();
    for (int size = 2; size <= n2; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int t = tid; t < (n2 >> 1); t += NT) {
          const int i = 2 * t - (t & (stride - 1)), j = i + stride;
          const unsigned long long x = keys[i], y = keys[j];
          if ((x > y) == ((i & size) == 0)) {
            keys[i] = y;
            keys[j] = x;
          }
        }
        bar();
      }
    }
    for (int r = tid; r < nl; r += NT) {
      const int code = static_cast<int>(keys[r] & 0xffffffffu);
      pc[r] = code;
      pv[r] = V[code];
    }
    bar();
    return nl;
  }

  // how many of the n entries of list c (C = 1 << lgc lists of w) from
  // place a on, in rank order, beat candidate t of value v: a binary search
  // (an entry's value read through its path)
  __device__ int beaten_by(int c, int lgc, int w, int a, int n, float v, int t) const {
    const int base = c * w + a;
    int lo = 0;
    while (n > 0) {
      const int half = n >> 1, at = base + lo + half;
      const int u = (SL[at] << lgc) | c;
      const float o = V[u];
      if (o > v || (o == v && u < t)) {
        lo += half + 1;
        n -= half + 1;
      } else {
        n = half;
      }
    }
    return lo;
  }

  // K7's prune: top-nl of the T = w << lgc candidates of V into pc / pv by
  // merging the C = 1 << lgc lists (list c: candidates (l, c), l < w),
  // ranked by (value desc, code asc), with the _NEG re-take rule. A list
  // in rank order (a bit's keep list after a prune) is taken as it is; a
  // list out of order is ranked in runs of 32 paths and its runs merged by
  // binary search; a candidate's rank is its place in its list plus, for
  // each other list, a binary search for those that beat it.
  __device__ void prune_merge(int w, int lgc) {
    const int C = 1 << lgc, T = w << lgc;
    unsigned bad = 0;
    int live = 0;
    for (int t = tid; t < T; t += NT) {
      const float v = V[t];
      live += v > kNeg;
      if (t + C < T && v < V[t + C]) bad |= 1u << (t & (C - 1));
    }
    bad = __reduce_or_sync(kAll, bad);
    live = __reduce_add_sync(kAll, live);
    if (lane == 0) {
      if (bad) atomicOr(reinterpret_cast<unsigned*>(&flags[0]), bad);
      atomicAdd(&flags[1], live);
    }
    bar();
    const unsigned unsorted = static_cast<unsigned>(flags[0]);
    const int kk = max(flags[1], 1);
    // each candidate's place in its list where the list is in rank order,
    // else in its run of 32 paths; the lists (or runs) in rank order
    for (int t = tid; t < T; t += NT) {
      const int l = t >> lgc, c = t & (C - 1);
      const float v = V[t];
      int r = l;
      if ((unsorted >> c) & 1) {
        const int g = l & ~31, e = min(g + 32, w);
        r = g;
        for (int u = g; u < e; ++u) {
          const float o = V[(u << lgc) | c];
          r += (o > v) | ((o == v) & (u < l));
        }
      }
      R[t] = r;
      SL[c * w + r] = l;
    }
    bar();
    if (unsorted && w > 32) {  // a list out of order: its runs merged
      for (int t = tid; t < T; t += NT) {
        const int l = t >> lgc, c = t & (C - 1);
        if (!((unsorted >> c) & 1)) continue;
        const float v = V[t];
        const int g = l & ~31;
        int r = R[t] - g;
        for (int a = 0; a < w; a += 32)
          if (a != g) r += beaten_by(c, lgc, w, a, min(32, w - a), v, t);
        R[t] = r;
      }
      bar();
      for (int t = tid; t < T; t += NT) {
        const int l = t >> lgc, c = t & (C - 1);
        if ((unsorted >> c) & 1) SL[c * w + R[t]] = l;
      }
      bar();
    }
    int best = kNoCode;
    for (int t = tid; t < T; t += NT) {
      const int c = t & (C - 1);
      const float v = V[t];
      int r = R[t];
      for (int c2 = 0; c2 < C; ++c2)
        if (c2 != c) r += beaten_by(c2, lgc, w, 0, w, v, t);
      if (r < kk && r < nl) {
        pc[r] = t;
        pv[r] = v;
      }
      if (r < kk || v == kNeg) best = min(best, t);
    }
    if (kk < nl) {  // block-uniform: the re-take rule's candidate
      best = __reduce_min_sync(kAll, best);
      if (lane == 0) atomicMin(&flags[2], best);
    }
    bar();
    if (kk < nl) {  // the re-take rule fills the rest
      for (int r = kk + tid; r < nl; r += NT) {
        pc[r] = flags[2];
        pv[r] = kNeg;
      }
      bar();
    }
    if (tid == 0) {  // for the next prune, past at least one more barrier
      flags[0] = 0;
      flags[1] = 0;
      flags[2] = kNoCode;
    }
  }

  // Slot j's survivor after a prune of w2 slots (j < w2), for its bits
  __device__ Slot slot(int j, int w2, int kind, int len, int aux, int nc, int fz) const {
    Slot t;
    if (j < w2) {
      const int code = pc[j];
      t.src = code / nc;
      t.c = code - t.src * nc;
      if (kind == K_BIT) {
        t.fm = fz;
      } else if (kind == K_RATE1 && len == 1) {
        t.fm = t.c == 1;
        t.i0 = 0;
      } else if (kind == K_RATE1) {
        t.fm = (t.c == 1 || t.c == 3) | ((t.c == 2 || t.c == 3) << 1);
        t.i0 = is[t.src];
        t.i1 = is[nl + t.src];
      } else if (kind == K_SPC) {
        t.fm = spc[(par[t.src] ? 8 : 0) + t.c];
        t.i0 = is[t.src];
        t.i1 = is[nl + t.src];
        t.i2 = is[2 * nl + t.src];
        t.i3 = is[3 * nl + t.src];
      } else if (kind == K_ENUM) {
        t.emask = masks[aux + t.c];
      }
    }
    return t;
  }

  // slot t's decision at position i of its path's input at level d
  __device__ int slot_bit(const Slot& t, int kind, int d, int len, int i) const {
    if (kind == K_REP) return t.c != 0;
    if (kind == K_ENUM) return (t.emask >> i) & 1;
    if (kind == K_BIT) return !t.fm && (Fam::hard(at(d, len, t.src, i)) ^ (t.c & 1));
    return Fam::hard(at(d, len, t.src, i)) ^
           (((t.fm & 1) && i == t.i0) | ((t.fm & 2) && i == t.i1) | ((t.fm & 4) && i == t.i2) |
            ((t.fm & 8) && i == t.i3));
  }

  // LEAF: candidates, prune, decision bits, the survivors' metrics and perm
  __device__ void leaf(int d, int len, int off, int kind, int aux, int nc, int& w) {
    int* pd = P + d * nl;
    if (kind == K_RATE0) {
      for (int l = tid; l < w; l += NT) {
        float acc = 0.f;
        for (int i = 0; i < len; ++i) acc = acc + fminf(at(d, len, l, i), 0.f);
        M[l] = M[l] + acc;
        pd[l] = l;
      }
      for (int t = tid; t < NW * len; t += NT) W[(t / len) * span + off + t % len] = 0;
      bar();
      return;
    }
    if (kind == K_RATE1 && len > 1) {
      weakest<2>(d, len, w);
    } else if (kind == K_SPC) {
      weakest<4>(d, len, w);
    } else if (kind == K_ENUM) {
      for (int l = tid; l < w; l += NT) {
        float sa = 0.f;
        for (int i = 0; i < len; ++i) sa = sa + fabsf(at(d, len, l, i));
        ms[l] = sa;
      }
      bar();
    }
    const int fz = kind == K_BIT && mask[off] != 0;
    const int T = w * nc;
    for (int t = tid; t < T; t += NT) {
      const int l = t / nc, c = t - l * nc;
      V[t] = M[l] + delta(kind, d, len, l, c, aux, fz);
    }
    bar();
    int w2;
    if constexpr (K7) {  // K7's candidates: 2, 4 or 8 a path, w = L
      prune_merge(w, log2i(nc));
      w2 = nl;
    } else {
      w2 = prune(T);
    }
    // decision bits: a warp per (word k, 32 positions), lane = slot 32 k + lane
    const int chunks = (len + 31) >> 5;
    for (int pair = warp; pair < NW * chunks; pair += NWARPS) {
      const int k = pair / chunks, i0 = (pair - k * chunks) << 5, j = 32 * k + lane;
      const Slot t = slot(j, w2, kind, len, aux, nc, fz);
      for (int i = i0; i < i0 + 32 && i < len; ++i) {
        const unsigned b = __ballot_sync(kAll, j < w2 && slot_bit(t, kind, d, len, i));
        if ((i & 31) == lane) W[k * span + off + i] = static_cast<int>(b);
      }
    }
    for (int l = tid; l < w2; l += NT) {
      M[l] = pv[l];
      pd[l] = pc[l] / nc;
    }
    bar();
    w = w2;
  }
};

template <class Fam, bool K7>
__global__ void __launch_bounds__(K7 ? kThreadsK7 : kThreadsK1)
wide_kernel(Args<typename Fam::State> a, Plan p) {
  using Team = Block<Fam, K7>;
  constexpr int NT = Team::NT;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int spc[32];
  __shared__ int red[kMaxWarps];
  __shared__ int flags[3];
  const int b = blockIdx.x, tid = threadIdx.x;
  unsigned char* dev = a.scratch + (size_t)b * p.scratch;
  unsigned char* base[kArrays];
  for (int q = 0; q < kArrays; ++q) base[q] = (((p.in_dev >> q) & 1) ? dev : smem) + p.off[q];
  Team k;
  k.M = reinterpret_cast<float*>(base[A_M]);
  k.P = reinterpret_cast<int*>(base[A_P]);
  k.pc = reinterpret_cast<int*>(base[A_PC]);
  k.pv = reinterpret_cast<float*>(base[A_PV]);
  k.ms = reinterpret_cast<float*>(base[A_MS]);
  k.is = reinterpret_cast<int*>(base[A_IS]);
  k.par = reinterpret_cast<int*>(base[A_PAR]);
  k.W = reinterpret_cast<int*>(base[A_W]);
  k.V = reinterpret_cast<float*>(base[A_V]);
  k.keys = reinterpret_cast<unsigned long long*>(base[A_WORK]);
  k.tmp = reinterpret_cast<int*>(base[A_WORK]);
  const int t_max = p.nl * p.ncand;
  k.SL = reinterpret_cast<int*>(base[A_WORK]);
  k.R = reinterpret_cast<int*>(base[A_WORK]) + t_max;
  k.X = reinterpret_cast<typename Fam::State*>(dev);
  k.in = a.llr + b * a.sb;
  k.sl = a.sl;
  k.si = a.si;
  k.masks = a.enum_masks;
  k.mask = a.mask;
  k.spc = spc;
  k.red = red;
  k.flags = flags;
  k.nl = p.nl;
  k.NW = p.words;
  k.span = p.span;
  k.tid = tid;
  k.lane = tid & 31;
  k.warp = tid >> 5;

  if (tid < 32) spc[tid] = a.spc_tab[tid];
  if (tid == 0) {
    flags[0] = 0;
    flags[1] = 0;
    flags[2] = kNoCode;
  }
  for (int t = tid; t < p.levels * p.nl; t += NT) k.P[t] = t % p.nl;
  for (int l = tid; l < a.w_in; l += NT) k.M[l] = a.met_in[(size_t)b * a.w_in + l];
  Team::bar();

  int w = a.w_in;
  for (int q = 0; q < a.n_ops; ++q) {
    const int* op = a.ops + q * kOpWords;
    const int code = op[0], d = op[1], len = op[2], off = op[3];
    if (code == OP_F) {
      k.F(d, len, w);
    } else if (code == OP_G) {
      k.G(d, len, off, w);
    } else if (code == OP_COMBINE) {
      k.combine(d, len, off, w);
    } else if (code == OP_LEAF) {
      k.leaf(d, len, off, op[4], op[5], op[6], w);
    } else {  // OP_SUB: a pure sub-block's leaf rule, or on into its per-bit walk
      const int cls = a.sub_cls[off / a.sub];
      if (cls != C_MIXED) {
        const int kind = cls == C_RATE0 ? K_RATE0 : cls == C_RATE1 ? K_RATE1
                         : cls == C_REP ? K_REP : K_SPC;
        const int nc = cls == C_RATE0 ? 0 : cls == C_RATE1 ? 4 : cls == C_REP ? 2 : 8;
        k.leaf(d, len, off, kind, 0, nc, w);
        q += op[7];
      }
    }
  }

  for (int t = tid; t < p.words * p.span; t += NT) {
    const int kw = t / p.span, i = t - kw * p.span;
    a.bits[b * a.ob + kw * a.ok + i * a.oi] = k.W[t];
  }
  for (int l = tid; l < a.w_out; l += NT) {
    a.perm[(size_t)b * a.w_out + l] = k.P[l];
    a.met_out[(size_t)b * a.w_out + l] = k.M[l];
  }
}

long long smem_budget() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return 0;
  return optin - kStatic;
}

int log2_host(int x) {
  int r = 0;
  while ((2 << r) <= x) ++r;
  return r;
}

int state_bytes(int family) { return family == 1 || family == 2 ? 2 : 4; }

bool bad_shape(int list_size, int span, int levels, int ncand) {
  return list_size < 1 || span < 1 || (span & (span - 1)) || levels < 1 ||
         levels > kMaxLevels || ncand < 1 || span > (1 << (kMaxLevels - 1));
}

template <class Fam, bool K7>
int launch(const Args<typename Fam::State>& a, int list_size, int span, int levels, int ncand,
           int batch, cudaStream_t stream) {
  const Plan p = make_plan(list_size, span, levels, ncand, sizeof(typename Fam::State),
                           smem_budget());
  auto kernel = wide_kernel<Fam, K7>;
  const size_t smem = static_cast<size_t>(p.smem);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int threads = Block<Fam, K7>::NT;
  kernel<<<batch, threads, smem, stream>>>(a, p);
  return static_cast<int>(cudaGetLastError());
}

template <class Fam>
Args<typename Fam::State> args_of(const void* ops, int n_ops, const void* spc_tab,
                                  const void* llr, const void* met, void* bits, void* perm,
                                  void* met_out, void* scratch, int w_in, int w_out) {
  Args<typename Fam::State> a{};
  a.ops = static_cast<const int*>(ops);
  a.n_ops = n_ops;
  a.spc_tab = static_cast<const int*>(spc_tab);
  a.llr = static_cast<const typename Fam::State*>(llr);
  a.met_in = static_cast<const float*>(met);
  a.w_in = w_in;
  a.w_out = w_out;
  a.bits = static_cast<int*>(bits);
  a.perm = static_cast<int*>(perm);
  a.met_out = static_cast<float*>(met_out);
  a.scratch = static_cast<unsigned char*>(scratch);
  return a;
}

// K1: input [w_in, span, B], bits [W, span, B]
template <class Fam>
int k1(const void* ops, int n_ops, const void* enum_masks, const void* spc_tab, const void* llr,
       const void* met, void* bits, void* perm, void* met_out, void* scratch, int list_size,
       int w_in, int w_out, int span, int levels, int ncand, int batch, cudaStream_t st) {
  auto a = args_of<Fam>(ops, n_ops, spc_tab, llr, met, bits, perm, met_out, scratch, w_in,
                        w_out);
  a.enum_masks = static_cast<const int*>(enum_masks);
  a.sb = 1;
  a.sl = (long long)span * batch;
  a.si = batch;
  a.ob = 1;
  a.ok = (long long)span * batch;
  a.oi = batch;
  return launch<Fam, false>(a, list_size, span, levels, ncand, batch, st);
}

// K7: input [B, L, M], bits [B, W, M], the prune by merge
template <class Fam>
int k7(const void* ops, int n_ops, const void* spc_tab, const void* llr, const void* mask,
       const void* met, const void* sub_cls, int sub, void* bits, void* perm, void* met_out,
       void* scratch, int list_size, int chunk, int batch, cudaStream_t st) {
  auto a = args_of<Fam>(ops, n_ops, spc_tab, llr, met, bits, perm, met_out, scratch, list_size,
                        list_size);
  const int words = (list_size + 31) / 32;
  a.mask = static_cast<const uint8_t*>(mask);
  a.sub_cls = static_cast<const int*>(sub_cls);
  a.sub = sub;
  a.sb = (long long)list_size * chunk;
  a.sl = chunk;
  a.si = 1;
  a.ob = (long long)words * chunk;
  a.ok = chunk;
  a.oi = 1;
  return launch<Fam, true>(a, list_size, chunk, log2_host(chunk) + 1, sub ? 8 : 2, batch, st);
}

}  // namespace

extern "C" int scl_wide_plan(int list_size, int span, int levels, int ncand, int family,
                             long long* out) {
  if (bad_shape(list_size, span, levels, ncand) || family < 0 || family > 3) return -1;
  const Plan p = make_plan(list_size, span, levels, ncand, state_bytes(family), smem_budget());
  out[0] = p.smem;
  out[1] = p.scratch;
  return 0;
}

extern "C" int scl_subtree_wide(const void* ops, int n_ops, const void* enum_masks,
                                const void* spc_tab, const void* llr, const void* met,
                                void* bits, void* perm, void* met_out, void* scratch,
                                int list_size, int w_in, int w_out, int span, int levels,
                                int ncand, int batch, int family, void* stream) {
  if (bad_shape(list_size, span, levels, ncand)) return -1;
  if (batch <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  switch (family) {
    case 0: return k1<FloatFamily>(ops, n_ops, enum_masks, spc_tab, llr, met, bits, perm, met_out, scratch, list_size, w_in, w_out, span, levels, ncand, batch, st);
    case 1: return k1<CharFamily>(ops, n_ops, enum_masks, spc_tab, llr, met, bits, perm, met_out, scratch, list_size, w_in, w_out, span, levels, ncand, batch, st);
    case 2: return k1<Bf16Family>(ops, n_ops, enum_masks, spc_tab, llr, met, bits, perm, met_out, scratch, list_size, w_in, w_out, span, levels, ncand, batch, st);
    default: return -1;
  }
}

extern "C" int masked_scl_chunk_wide(const void* ops, int n_ops, const void* spc_tab,
                                     const void* llr, const void* mask, const void* met,
                                     const void* sub_cls, int sub, void* bits, void* perm,
                                     void* met_out, void* scratch, int list_size, int chunk,
                                     int batch, int family, void* stream) {
  if (chunk < 2 || bad_shape(list_size, chunk, 1, 1)) return -1;
  if (sub && (sub < 2 || sub > chunk || (sub & (sub - 1)))) return -1;
  if (batch <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  switch (family) {
    case 0: return k7<FloatFamily>(ops, n_ops, spc_tab, llr, mask, met, sub_cls, sub, bits, perm, met_out, scratch, list_size, chunk, batch, st);
    case 1: return k7<ChunkCharFamily>(ops, n_ops, spc_tab, llr, mask, met, sub_cls, sub, bits, perm, met_out, scratch, list_size, chunk, batch, st);
    default: return -1;
  }
}
