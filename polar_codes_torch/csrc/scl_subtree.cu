// SCL subtree decoder (K1): one call decodes a whole span <= kernel_span
// subtree of the code tree for a batch of codewords.
//
// Replaces: polar_codes_tpu/ops/scl_kernel_bl.py,
// build_bl_hybrid_decode_paths.subtree_call.kernel, whose body
// _BlEmitter.node emits the f/g recursion, the leaf candidate sets
// (rate0/rate1/rep/spc/enum), the top-L prune, the path-fork gathers and
// the perm composition of one subtree, in the bitplane form, in each of
// the emitter's three arithmetic families.
//
// This source keeps one codeword's list state in shared memory, so it
// takes 1 <= L <= 128 where that state fits; scl_wide.cu takes every other
// list size and span (its wrapper, ops/scl_kernel_bl.py scl_subtree,
// picks), with the same interface and results.
//
// Interface, in the TPU kernel's layouts:
//   llr [w_in, span, B] (state type) at any strides (elements: sl over
//   paths, si over positions, sb over codewords; the large-N glue hands its
//   batch-first [B, L, S] leaves over as views), metrics [B, w_in] f32,
//   family, list size L (1 <= L <= 128 here)
//     -> bits [W, span, B] i32, W = ceil(L / 32) words (bit l % 32 of word
//        l / 32 = path l's decision; W = 1 is the TPU kernel's bitplane
//        form [span, B], W > 1 stands for its unpacked-path family),
//        perm [B, w_out] i32 (output slot -> input slot), metrics [B, w_out]
// Three families, instantiations of one template (family code in brackets):
//   float32 (0): f32 state, f the sign-XOR min-sum on the raw float bits,
//                g = b +- a, hard decisions by the sign bit (-0.0 decides 1);
//   char (1):    int16 state holding integer LLRs (the TPU kernel's int8
//                mode, which holds them in bf16): f in product form with
//                jnp.sign's rule, unclipped (an input of -128 gives |f| =
//                128), g clipped to [-127, 127], hard decisions llr < 0
//                (0 decides 0) in the leaves and the SPC parity;
//   bfloat16 (2): bf16 state; f and g computed in f32 and rounded to
//                nearest even once on store; decisions by the sign bit.
// Every family computes its leaves in f32 on the stored values, and every
// metric sum accumulates in f32.
//
// The TPU kernel is specialised per subtree while tracing. Here the
// subtree arrives as data: a post-order schedule of 8-int ops
//   {op, level, length, offset, kind, aux, ncand, 0}
// with op F (f into the next level), G (g into the next level, gathering
// the parent LLRs through the left child's perm), COMBINE (fork the left
// bits through the right child's perm, XOR, compose perms) and LEAF (leaf
// candidates, prune, decision bits). A leaf's prune is the path fork: it
// yields the perm that G and COMBINE apply. ENUM leaves read their
// codeword table as one bitmask per candidate at enum_masks[aux]; the SPC
// flip tables come in spc_tab. One kernel per family and list capacity (a
// power of two from 2 to 128) serves every subtree of every code at every
// list size up to that capacity: the list size is a launch argument, the
// prune keeps exactly that many paths, and the slots above it never become
// live. The list sizes 2, 4, 8, 16 and 32 have a kernel each whose list
// size is a constant of the build (the capacity's kernel is ~4% slower at L
// = 8). L = 1 has a one-path instantiation (capacity 1, kOne): a leaf keeps
// the first maximal of its C candidates, found by a butterfly of (value,
// code) pairs over the warp (lane c forms candidate c, its sums sequential
// on its lane); there is no prune, the perm is the identity, G reads no
// perm, a combine is an XOR of words, and each lane writes its positions'
// bits. Nothing is generated per code.
//
// Mapping: one team decodes one codeword. Capacities 2 to 32: a warp,
// warp-synchronous (__syncwarp, shuffles and ballots between ops), one
// codeword (warp) per block below 4 x 132 codewords, so a small batch
// spreads over every SM, four above (measured: ~10% faster at B = 2048
// than one; chip_smoke.py phase 24 times 1, 2 and 4). Capacities 64 and
// 128: a block of 2 x capacity threads (128 or 256: a thread per candidate
// of a two-way fork), one codeword a block, each step closed by a block
// barrier (PTX barrier.sync without .aligned: the warp that holds path
// w - 1 reaches it split whenever 32 does not divide w). Each team's list
// state lives in shared memory: the LLRs of tree levels d >= 1
// ([L][span >> d] each, L x (span - 1) values of the state type), the
// packed bit words [W][span], the open nodes' perms P[level][L], the path
// metrics, the candidate values, the leaf scratch and the SPC table (the
// block's perms and the merge's lists a byte a path); device memory is
// read once (the input level 0 at its strides, by the first F and G, or
// staged into the level region when the subtree is one leaf) and written
// once (bits, perm, metrics). Per codeword that is sizeof(Shared<L>) + 4 W
// span + L span sizeof(state) bytes, L the capacity: 20 KB at L = 8, span
// 512 in f32, 12 KB in int16 or bf16; 47 KB at L = 64 and 94 KB at L =
// 128, span 128 (the JAX package's span there). A one-leaf schedule whose
// staged input would not fit (the large-N tree schedule's pure leaves: L =
// 32 at span 2048 in f32 needs 256 KB) is not staged: its leaf reads the
// input from device memory where it lies, element (l, i) of codeword b at
// llr[l sl + i si + b sb], and needs sizeof(Shared<L>) + 4 W span bytes. A
// branched schedule whose state exceeds the card's opt-in shared memory
// per block (only a caller-chosen kernel_span can) is refused (-2); the
// wrapper sends such schedules to scl_wide.cu.
// Inside an op (a warp's lanes, or a block's threads):
//   F, G      threads over (path, element) pairs; G reads the parent
//             through the left child's perm (levels live in separate
//             regions, so no read aliases a write);
//   COMBINE   a warp: lanes over positions, each forking its left bit word
//             through the right child's perm, held in registers; a block:
//             a warp a position, lane j forking slot 32 k + j's bit, one
//             ballot a word, every word of the position read before any is
//             written; the perm composition a thread a path;
//   LEAF      the `weakest` magnitudes (rate-1, SPC): a warp's groups of
//             32 / w lanes per path run 2 or 4 rounds of an arg-min over
//             packed (|x|, index) keys, each lane scanning a stride of the
//             span, then shuffles; a block's two threads a path each keep
//             the K smallest keys of every other position in one pass, then
//             merge the pair's lists by a shuffle; the SPC parity rides
//             along as an XOR. Each candidate's value on its own thread
//             (path l, candidate c at code l*C + c), every metric sum
//             sequential over the span on one thread. The prune: a warp
//             ranks each candidate against all T values up to T = 64 (a
//             lane holding its candidates in registers); above, a lane
//             holds the order-preserving 32-bit keys of its ceil(T / 32)
//             candidates and the warp finds the L-th largest key thr one
//             bit a round (a __reduce_add_sync count of the keys at or
//             above a trial value), from below the high bits that the
//             largest key shares with the least of the lanes' largest;
//             the keys above thr and the first of those at thr by code
//             survive, written in code order by ballots, and each of the
//             L takes as slot its rank among them; a block merges the C
//             lists (list c: candidates (l, c) in path order): each list's
//             order is checked (a warp OR of "v_l < v_{l+1}", one shared
//             atomic a warp), a list in rank order taken as it is, a list out of
//             order ranked in runs of 32 paths and its runs merged by
//             binary search, and a candidate's rank is its place in its own
//             list plus a binary search of each other list, the searches
//             stopping once the rank reaches L. The decision bits: a warp's
//             lanes over (position, slot), one ballot per 32 / L positions;
//             a block's warp per (word, 32 positions), each lane (slot 32 k
//             + lane) loading its source path's 32 inputs before the 32
//             ballots. The leaf is a template on where its input lies
//             (shared memory, or device memory strided by B); its
//             arithmetic and order are the same either way.
//
// What bounds it on an H100: the length of one codeword's dependent chain
// of team steps (each op closes with a warp or block barrier), overlapped
// across the teams an SM holds by shared memory; bytes (each input read
// once, each output written once) and arithmetic are ~50-100x below that.
// Measured (chip_smoke.py, chip_profile.py; NVIDIA H100 80GB HBM3 at 700
// W): N = 1024, L = 8, span 512, ~0.15-0.19 ms a call at B = 181, one
// codeword's chain of ~250-310k cycles, of which the leaves' prunes ~20%,
// their other phases ~30%, F and G ~15% (the level-0 ones read device
// memory strided by B), combines 5%; 0.32-0.43 ms at B = 2048. A one-leaf
// schedule read from device memory (the rate-0 leaf of 2048 at L = 32, B
// = 128) takes 0.36 ms, against 0.11 for the same leaf staged at L = 8
// (chip_profile.py tree): each path's lane walks its span in loads
// strided by B. The block teams (chip_profile.py k1_lists_ab, the warp
// kernels they replaced in the same process): the 8 calls of an N = 1024
// decode at L = 64, B = 1024, 3.71-4.02 ms in every family (6.37-7.35),
// at L = 128, B = 256, 2.17-2.35 (8.51-9.85), L = 33 2.29-2.46 (3.73-3.96),
// L = 100 1.81-1.98 (6.81-7.20); the codeword's chain at L = 64 3.4M
// cycles (6.7M), 68% of it the prunes of the SPC and ENUM leaves (8 and
// 16 candidates a path: 15 searches a candidate before the early stop).
// At one path (chip_profile.py small_lists_ab, the 58 pure chunks of a
// (32768, 16384) CA-SCL-1 decode, B = 64) the 58 calls take 0.25 ms of
// device time (capacity 2's 0.29 plus a 0.08 ms copy before), ~4.3 us a
// call against ~45-60 us of the wrapper's host time; CA-SCL-64's 58 pure
// chunks read in place take 2.04 ms (2.19 plus 0.94 of copies).
// The warp teams above 64 candidates (chip_profile.py k1_warp_ab and
// k1_ops, the rank they replaced in the same process; a decode's calls,
// (1024, 512) CRC16, B = 2048, device ms): L = 12 0.86 (1.06), 24 1.47
// (3.08), exact 16 0.95-0.97 (1.20), 32 1.70 (3.88), L = 3 0.28 (0.29);
// the codeword's chain at L = 24 1.41M cycles (3.44M), its prunes 20%
// (66%), the weakest magnitudes 18%, F and G at level 0 21%.
// Capacities of 32 use 96 registers a thread (152-167 with the rank), 16
// and less 56-64 (16: a 32-40-byte spill), the block teams 96 (64) and
// 111 (128).
//
// Numerics: every sum is sequential over the span in f32, in the order of
// the plain torch version (ops/scl_kernel_bl.py), and the build disables
// FMA contraction, so kernel and plain version agree bit for bit in each
// family. The prune ranks the candidates by (value descending, flat code
// l*C + c ascending; float compares, so -0.0 ties +0.0, and the select's
// key gives both zeros one key); a candidate's slot is its rank, the
// first L survive, each taken once, and while w*C <= L
// every candidate survives in l-major slots. On finite values that is the
// plain version's iterative extraction order exactly.
// `weakest` takes the (|x|, index)-smallest entries, which is the plain
// version's first-index-on-ties rule.
//
// C interface (ctypes; every pointer and the stream are void*):
//   int scl_subtree(const int *ops, int n_ops, const int *enum_masks,
//                   const int *spc_tab, const void *llr, long long llr_sl,
//                   long long llr_si, long long llr_sb, const float *met,
//                   int *bits, int *perm, float *met_out, int list_size,
//                   int w_in, int w_out, int span, int batch, int family,
//                   int per_block, cudaStream_t stream)
//     llr_sl, llr_si, llr_sb: the input's strides in elements (a
//     contiguous [w_in, span, B] tensor: span B, B, 1).
//     bits holds W = ceil(list_size / 32) words per position ([W, span,
//     B]). per_block: codewords (warps) per block of the warp kernels
//     (capacities 2 to 32), 1, 2 or 4; 0 picks from the batch; the block
//     kernels (capacities 64, 128) take one codeword a block whatever it
//     says. Returns cudaGetLastError() after the launch (or of the
//     shared-memory attribute call), -1 for an unsupported list size
//     (outside 1..128), family or span, -2 when one codeword's state
//     exceeds the card's opt-in shared memory per block.
//   int scl_subtree_smem(int list_size, int span, int family, int n_ops)
//     shared-memory bytes per codeword of a schedule of n_ops ops (one op:
//     one leaf, unstaged where staging does not fit), or -1.
//   int scl_subtree_smem_limit(void)
//     the current card's opt-in shared memory per block, in bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#ifdef K1_PROFILE
// Cycles per op kind and leaf phase, summed by thread 0 of every codeword's
// team, and their counts at slot + 32 (chip_profile.py builds with
// -DK1_PROFILE and reads them with scl_subtree_profile): 0-2 F, G, COMBINE;
// 3-7 leaves by kind; 8-11 a leaf's weakest, candidates, prune, decision
// bits; 12 the whole schedule; 13-14 F and G at level 0.
__device__ unsigned long long k1_prof[64];
#define K1_CLOCK(t) long long t = clock64()
#define K1_TICK(slot, t)                                                      \
  do {                                                                        \
    const long long now_ = clock64();                                         \
    if (tid == 0) {                                                           \
      atomicAdd(&k1_prof[slot], static_cast<unsigned long long>(now_ - (t))); \
      atomicAdd(&k1_prof[(slot) + 32], 1ull);                                 \
    }                                                                         \
    t = now_;                                                                 \
  } while (0)
extern "C" int scl_subtree_profile(unsigned long long* out) {
  const cudaError_t err = cudaMemcpyFromSymbol(out, k1_prof, sizeof(k1_prof));
  const unsigned long long zero[64] = {};
  return static_cast<int>(err != cudaSuccess ? err
                                             : cudaMemcpyToSymbol(k1_prof, zero, sizeof(zero)));
}
#else
#define K1_CLOCK(t)
#define K1_TICK(slot, t)
#endif

namespace {

constexpr int kMaxLevels = 16;
constexpr int kMaxCand = 32;
constexpr int kOpWords = 8;
constexpr int kMaxPerBlock = 4;
constexpr int kLoads = 8;  // device-memory loads a thread keeps in flight
constexpr int kMaxDevices = 16;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kNoCode = 0x7fffffff;
enum { OP_F = 0, OP_G = 1, OP_COMBINE = 2, OP_LEAF = 3 };
enum { K_RATE0 = 0, K_RATE1 = 1, K_REP = 2, K_SPC = 3, K_ENUM = 4 };

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

// A block barrier that a warp may reach split (PTX barrier.sync without
// .aligned): a per-path step leaves the warp that holds path w - 1 split
// whenever 32 does not divide w, and __syncthreads (bar.sync, the aligned
// form) reached so lost a barrier phase on the card in large_scl_lists.cu.
// The CPU runner's __syncthreads counts threads the same way.
__device__ __forceinline__ void block_barrier() {
#ifdef __CUDA_ARCH__
  asm volatile("barrier.sync 0;" ::: "memory");
#else
  __syncthreads();
#endif
}

// Each family: the state type, its conversions to and from f32 (load,
// store), and f, g and the hard decision on f32 values.
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
  // the product form on f32 values, which on finite values is f_bits; the
  // result is one of the inputs' magnitudes, so its store is exact
  __device__ static float f(float a, float b) { return f_bits(a, b); }
  __device__ static float g(float a, float b, int bit) { return bit ? b - a : b + a; }
  __device__ static int hard(float x) { return sign_bit(x); }
};

// One codeword's state besides the LLR levels and the bit words, for a
// warp (capacities 2 to 32)
template <int L>
struct WarpShared {
  float M[L];                // metric of each path
  int P[kMaxLevels][L];      // perm of the node open at each level
  float V[L * kMaxCand];     // candidate values by flat code l*C + c
  int pc[L];                 // prune result by slot: code and value
  float pv[L];
  float ms[4][L];            // weakest magnitudes of each path, and where
  int is[4][L];              //   (ENUM: ms[0] holds each path's sum of |x|)
  int par[L];                // SPC parity of each path
  int spc[32];               // SPC_TABLE
};

// and for a block (capacities 64 and 128): a path index fits a byte, so the
// perms and the merge's lists in rank order (paths, from SL[c w] for list c)
// take a byte a path
template <int L>
struct BlockShared {
  float M[L];
  float V[L * kMaxCand];
  int pc[L];
  float pv[L];
  float ms[4][L];
  int is[4][L];
  int par[L];
  int spc[32];
  unsigned bad;              // the prune's lists out of rank order, a bit a list
  uint8_t P[kMaxLevels][L];
  uint8_t SL[L * kMaxCand];
};

template <int L>
using Shared = std::conditional_t<(L > 32), BlockShared<L>, WarpShared<L>>;

// int32 words a packed position holds for a list of capacity L
template <int L>
constexpr int kWords = L > 32 ? L / 32 : 1;

// Shared memory per codeword; `direct`: a one-leaf schedule whose leaf
// reads its input from device memory (no level state).
template <int L, class Fam>
size_t codeword_bytes(int span, bool direct) {
  const size_t n = sizeof(Shared<L>) + (size_t)kWords<L> * span * sizeof(int) +
                   (direct ? 0 : (size_t)L * span * sizeof(typename Fam::State));
  return (n + 15) & ~static_cast<size_t>(15);
}

int smem_limit();

// Whether a schedule of n_ops ops reads its leaf from device memory: it is
// one leaf, and its staged input would not fit.
template <int L, class Fam>
bool reads_direct(int n_ops, int span) {
  return n_ops == 1 && codeword_bytes<L, Fam>(span, false) > static_cast<size_t>(smem_limit());
}

// A candidate slot's survivor in a leaf: the path it descends from, its
// candidate, and what its decision bits need (flip mask and positions, or
// the ENUM codeword's bitmask).
struct Slot {
  int src = 0, c = 0, fm = 0, i0 = -1, i1 = -1, i2 = -1, i3 = -1, emask = 0;
};

// One codeword's team: a warp up to capacity 32, a block of 2 x capacity
// threads at 64 and 128. L is the list's capacity (a power of two), nl the
// list size (nl <= L): slots at or above nl never become live. kExact: the
// list fills its capacity (nl == L), a constant of the build.
template <int L, class Fam, bool kExact>
struct Team {
  using S = typename Fam::State;
  static constexpr bool kBlock = L > 32;
  static constexpr int NT = kBlock ? 2 * L : 32;  // threads a codeword
  static constexpr int NWARPS = NT / 32;
  static constexpr int NW = kWords<L>;  // packed words a position
  static constexpr int kPer = L * kMaxCand / NT;  // candidates a thread ranks at most
  static constexpr int kLgL = L == 1 ? 0 : L == 2 ? 1 : L == 4 ? 2 : L == 8 ? 3 : L == 16 ? 4 : 5;
  static constexpr bool kOne = L == 1;  // one path: no prune, the perm the identity
  static constexpr int kPerBallot = L >= 32 ? 1 : 32 / L;  // positions per ballot (a warp)
  static constexpr unsigned kMask = L >= 32 ? kAll : (1u << L) - 1u;

  Shared<L>& s;
  int* W;          // [NW][span] packed bit words (word k of position i at W[k span + i])
  S* X;            // levels d >= 1, or the staged input of a one-leaf subtree
  const S* in;     // the input level 0: element (l, i) at in[l * sl + i * si]
  const int* masks;
  long long sl, si;  // the input's strides (elements) over paths and positions
  int span, tid, lane, warp, nl_arg;

  // the list size
  __device__ int nl() const { return kExact ? L : nl_arg; }

  // the team's barrier
  __device__ static void sync() {
    if constexpr (kBlock) {
      block_barrier();
    } else {
      __syncwarp();
    }
  }

  // f(l) for the path l < w this thread holds (thread l: path l)
  template <class F>
  __device__ void each_path(int w, F f) const {
    if (tid < w) f(tid);
  }

  // path l's decision bit at position i
  __device__ int bit_of(int i, int l) const {
    if constexpr (NW == 1) {
      return (W[i] >> l) & 1;
    } else {
      return (W[(l >> 5) * span + i] >> (l & 31)) & 1;
    }
  }

  __device__ S* lvl(int d) const {
    return X + (d == 0 ? 0 : L * (span - (span >> (d - 1))));
  }

  // A leaf's input: path l of the span-len leaf at Xd (shared memory), or
  // with D the subtree's input in device memory at its strides (the leaf
  // is the whole subtree, len == span), and its element i as f32.
  template <bool D>
  __device__ const S* path(const S* Xd, int len, int l) const {
    return D ? in + l * sl : Xd + l * len;
  }
  template <bool D>
  __device__ float at(const S* x, int i) const {
    return Fam::load(D ? x[i * si] : x[i]);
  }

  // f from level d (span len) into level d + 1, for paths l < w: threads
  // over (path, element) pairs
  __device__ void F(int d, int len, int w) {
    const int h = len >> 1, lh = log2i(h), n = w << lh;
    S* Y = lvl(d + 1);
    if (d == 0) {  // device memory: kLoads pairs in flight per thread
      for (int t0 = tid; t0 < n; t0 += NT * kLoads) {
        float a[kLoads], c[kLoads];
#pragma unroll
        for (int q = 0; q < kLoads; ++q) {
          const int t = t0 + NT * q, l = t >> lh, i = t & (h - 1);
          a[q] = c[q] = 0.f;
          if (t < n) {
            const long long o = l * sl + i * si;
            a[q] = Fam::load(in[o]);
            c[q] = Fam::load(in[o + h * si]);
          }
        }
#pragma unroll
        for (int q = 0; q < kLoads; ++q)
          if (t0 + NT * q < n) Y[t0 + NT * q] = Fam::store(Fam::f(a[q], c[q]));
      }
    } else {
      const S* Xd = lvl(d);
#pragma unroll 4
      for (int t = tid; t < n; t += NT) {
        const int l = t >> lh, i = t & (h - 1);
        Y[t] = Fam::store(Fam::f(Fam::load(Xd[l * len + i]), Fam::load(Xd[l * len + i + h])));
      }
    }
    sync();
  }

  // g from level d into level d + 1 (node at offset off, whose left half's
  // bits are done), gathering the parent through the left child's perm;
  // then the left child's perm becomes level d's
  __device__ void G(int d, int len, int off, int w) {
    const int h = len >> 1, lh = log2i(h), n = w << lh;
    S* Y = lvl(d + 1);
    const auto* p = s.P[d + 1];  // slots -> parent slots
    if (d == 0) {  // device memory: kLoads pairs in flight per thread
      for (int t0 = tid; t0 < n; t0 += NT * kLoads) {
        float a[kLoads], c[kLoads];
#pragma unroll
        for (int q = 0; q < kLoads; ++q) {
          const int t = t0 + NT * q, l = t >> lh, i = t & (h - 1);
          a[q] = c[q] = 0.f;
          if (t < n) {
            const long long o = (kOne ? l : p[l]) * sl + i * si;
            a[q] = Fam::load(in[o]);
            c[q] = Fam::load(in[o + h * si]);
          }
        }
#pragma unroll
        for (int q = 0; q < kLoads; ++q) {
          const int t = t0 + NT * q, l = t >> lh, i = t & (h - 1);
          if (t < n) Y[t] = Fam::store(Fam::g(a[q], c[q], bit_of(off + i, l)));
        }
      }
    } else {
      const S* Xd = lvl(d);
#pragma unroll 4
      for (int t = tid; t < n; t += NT) {
        const int l = t >> lh, i = t & (h - 1);
        const S* x = Xd + (kOne ? l : p[l]) * len + i;
        Y[t] = Fam::store(Fam::g(Fam::load(x[0]), Fam::load(x[h]), bit_of(off + i, l)));
      }
    }
    if constexpr (!kOne) each_path(w, [&](int l) { s.P[d][l] = p[l]; });
    sync();
  }

  // the node at level d, offset off: left bits forked through the right
  // child's perm, XOR the right bits; perms composed
  __device__ void combine(int d, int len, int off, int w) {
    const int h = len >> 1;
    if constexpr (kOne) {  // no fork, no perm to compose
      for (int i = lane; i < h; i += 32) W[off + i] ^= W[off + h + i];
      sync();
      return;
    }
    const auto* p = s.P[d + 1];  // right child's perm
    if constexpr (NW == 1) {  // lanes over positions, the perm in registers
      int pj[L];
#pragma unroll
      for (int j = 0; j < L; ++j) pj[j] = j < w ? p[j] : 0;
      for (int i = lane; i < h; i += 32) {
        const int lw = W[off + i];
        int fork = 0;
#pragma unroll
        for (int j = 0; j < L; ++j) fork |= (j < w ? (lw >> pj[j]) & 1 : 0) << j;
        W[off + i] = fork ^ W[off + h + i];
      }
    } else {  // a warp a position: one ballot a word, lane = slot 32 k + lane
      int src[NW];
#pragma unroll
      for (int k = 0; k < NW; ++k) src[k] = 32 * k + lane < w ? p[32 * k + lane] : -1;
      for (int i = warp; i < h; i += NWARPS) {
        unsigned b[NW];
#pragma unroll
        for (int k = 0; k < NW; ++k)
          b[k] = __ballot_sync(kAll, src[k] >= 0 && bit_of(off + i, src[k]));
        // every word of the position is read (the ballots) before any is written
#pragma unroll
        for (int k = 0; k < NW; ++k)
          if (lane == k) W[k * span + off + i] = static_cast<int>(b[k]) ^ W[k * span + off + h + i];
      }
    }
    int c = 0;
    each_path(w, [&](int l) { c = s.P[d][p[l]]; });
    sync();
    each_path(w, [&](int l) { s.P[d][l] = c; });
    sync();
  }

  // The K (|x|, index)-smallest entries of each path l < w of the span-len
  // leaf at Xd into s.ms / s.is, and each path's parity of hard decisions
  // into s.par, each entry keyed by (|x| bits, index) in one unsigned
  // 64-bit word, which orders as the pair (|x| >= 0). A warp: a group of
  // 32 / w lanes per path, K rounds of an arg-min over the entries after
  // the last one taken, each lane scanning a stride of the span, then the
  // group takes the minimum by shuffles. A block: two threads a path, each
  // keeping the K smallest keys of every other position in one pass, then
  // one merge of the pair's lists by a shuffle.
  template <int K, bool D>
  __device__ void weakest(const S* Xd, int len, int w) {
    if constexpr (!kBlock) {
      weakest_of<K, D>(Xd, len, w);
    } else {
      const int l = tid >> 1, half = tid & 1;
      unsigned long long best[K];
#pragma unroll
      for (int k = 0; k < K; ++k) best[k] = ~0ull;
      int neg = 0;
      if (l < w) {
        const S* x = path<D>(Xd, len, l);
#pragma unroll 4
        for (int i = half; i < len; i += 2) {
          const float y = at<D>(x, i);
          neg ^= Fam::hard(y);
          keep<K>(best, (static_cast<unsigned long long>(__float_as_uint(fabsf(y))) << 32) |
                            static_cast<unsigned>(i));
        }
      }
      unsigned long long other[K];
#pragma unroll
      for (int k = 0; k < K; ++k) other[k] = __shfl_xor_sync(kAll, best[k], 1);
#pragma unroll
      for (int k = 0; k < K; ++k) keep<K>(best, other[k]);
      neg ^= __shfl_xor_sync(kAll, neg, 1);
      if (half == 0 && l < w) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          s.ms[k][l] = __uint_as_float(static_cast<unsigned>(best[k] >> 32));
          s.is[k][l] = static_cast<int>(best[k] & 0xffffffffu);
        }
        s.par[l] = neg;
      }
    }
    sync();
  }

  // key into the ascending list best[0..K), the largest falling off
  template <int K>
  __device__ static void keep(unsigned long long (&best)[K], unsigned long long key) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (key < best[k]) {
        const unsigned long long t = best[k];
        best[k] = key;
        key = t;
      }
    }
  }

  template <int K, bool D>
  __device__ void weakest_of(const S* Xd, int len, int w) {
    const int lgg = 5 - (w > 1 ? 32 - __clz(w - 1) : 0);
    const int g = 1 << lgg, l = lane >> lgg, gl = lane & (g - 1);
    const S* x = path<D>(Xd, len, l);
    unsigned long long prev = 0;
    int neg = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      unsigned long long best = ~0ull;
      if (l < w) {
#pragma unroll 4
        for (int i = gl; i < len; i += g) {
          const float y = at<D>(x, i);
          if (k == 0) neg ^= Fam::hard(y);
          const unsigned long long key =
              (static_cast<unsigned long long>(__float_as_uint(fabsf(y))) << 32) |
              static_cast<unsigned>(i);
          if ((k == 0 || key > prev) && key < best) best = key;
        }
      }
      for (int o = g >> 1; o > 0; o >>= 1) {
        const unsigned long long other = __shfl_xor_sync(kAll, best, o);
        best = other < best ? other : best;
      }
      if (gl == 0 && l < w) {
        s.ms[k][l] = __uint_as_float(static_cast<unsigned>(best >> 32));
        s.is[k][l] = static_cast<int>(best & 0xffffffffu);
      }
      prev = best;
    }
    for (int o = g >> 1; o > 0; o >>= 1) neg ^= __shfl_xor_sync(kAll, neg, o);
    if (gl == 0 && l < w) s.par[l] = neg;
  }

  // Candidate c of path l of a leaf of `kind`: its metric delta. Sums run
  // sequentially over the span, in the plain version's order.
  template <bool D>
  __device__ float delta(int kind, const S* x, int len, int l, int c, int aux) const {
    if (kind == K_REP) {
      float acc = 0.f;
      if (c == 0) {
#pragma unroll 8
        for (int i = 0; i < len; ++i) acc = acc + fminf(at<D>(x, i), 0.f);
        return acc;
      }
#pragma unroll 8
      for (int i = 0; i < len; ++i) acc = acc + fmaxf(at<D>(x, i), 0.f);
      return -acc;
    }
    if (kind == K_RATE1 && len == 1) return c == 0 ? 0.f : -fabsf(at<D>(x, 0));
    if (kind == K_RATE1) {
      const float m0 = s.ms[0][l], m1 = s.ms[1][l];
      return c == 0 ? 0.f : c == 1 ? -m0 : c == 2 ? -m1 : -m0 - m1;
    }
    if (kind == K_SPC) {
      const float m0 = s.ms[0][l];
      const int tm = s.spc[24 + c];
      float tc = 0.f;
      for (int j = 0; j < 3; ++j)
        if ((tm >> j) & 1) tc = tc + s.ms[1 + j][l];
      const float even = (s.spc[16 + c] ? -m0 : -0.f * m0) - tc;
      const float odd = -m0 - tc;
      return s.par[l] ? odd : even;
    }
    // K_ENUM: the correlation with codeword c of the leaf's subcode, less
    // the path's sum of |x| (in s.ms[0])
    const int mk = masks[aux + c];
    float sc = 0.f;
#pragma unroll 8
    for (int i = 0; i < len; ++i) {
      const float y = at<D>(x, i);
      sc = sc + (((mk >> i) & 1) ? -y : y);
    }
    return 0.5f * (sc - s.ms[0][l]);
  }

  // Top-min(nl, T) of the T = w x nc candidate values in s.V into s.pc /
  // s.pv (slot -> code, value): a candidate's slot is its rank under
  // (value desc, code asc), each candidate taken once; while T <= nl every
  // candidate keeps its code as its slot. A warp ranks each candidate
  // against all T values up to T = 64 (rank), above it selects by a
  // threshold (select); a block merges lists (merge). Returns the new width.
  __device__ int prune(int T, int w, int nc) {
    const int nl = this->nl();
    if (T <= nl) {
      for (int t = tid; t < T; t += NT) {
        s.pc[t] = t;
        s.pv[t] = s.V[t];
      }
    } else if constexpr (kBlock) {
      merge(w, log2i(nc));
    } else {
      const int per = (T + 31) >> 5;  // candidates a lane holds
      if (per == 1)
        rank<1>(T);
      else if (per == 2)
        rank<2>(T);
      else if (per <= 8)
        select<(L < 8 ? L : 8)>(T);
      else if (per <= 16)
        select<(L < 16 ? L : 16)>(T);
      else
        select<L>(T);
    }
    sync();
    return T < nl ? T : nl;
  }

  // A value's order-preserving key: a larger value has a larger key, -0.0
  // and +0.0 share one (float compares tie them), and every number's key
  // is above 0, which marks no candidate.
  __device__ static unsigned key_of(float v) {
    unsigned u = __float_as_uint(v);
    u = u == 0x80000000u ? 0u : u;
    return (u & 0x80000000u) ? ~u : u | 0x80000000u;
  }

  // Top-nl of T > nl candidates, lane holding the keys of candidates lane
  // + 32 r (r < R), by a threshold select: thr, the nl-th largest key, lies
  // between the largest key and the least of the lanes' largest (32 >= nl
  // keys reach that), so it shares their common high bits; warp counts of
  // the keys at or above a trial value find its other bits, one a round.
  // The survivors, the keys above thr and the first (by code) of those at
  // thr up to nl, are written in code order into s.pc / s.pv by ballots;
  // each survivor's slot is then its rank among the nl.
  template <int R>
  __device__ void select(int T) {
    const int nl = this->nl();
    unsigned k[R];
    unsigned top = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = lane + 32 * r;
      k[r] = t < T ? key_of(s.V[t]) : 0u;
      top = max(top, k[r]);
    }
    const unsigned hi = __reduce_max_sync(kAll, top), lo = __reduce_min_sync(kAll, top);
    unsigned thr = hi;
    if (hi != lo) {
      int b = 31 - __clz(static_cast<int>(hi ^ lo));
      thr = b == 31 ? 0u : hi & ~((2u << b) - 1u);
      for (; b >= 0; --b) {
        const unsigned c = thr | (1u << b);
        int n = 0;
#pragma unroll
        for (int r = 0; r < R; ++r) n += k[r] >= c;
        thr = __reduce_add_sync(kAll, n) >= nl ? c : thr;
      }
    }
    int above = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) above += k[r] > thr;
    const int need = nl - __reduce_add_sync(kAll, above);  // ties at thr that survive
    const unsigned below = (1u << lane) - 1u;
    int ties = 0, kept = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const unsigned eq = __ballot_sync(kAll, k[r] == thr);
      const bool keep = k[r] > thr || (k[r] == thr && ties + __popc(eq & below) < need);
      const unsigned kb = __ballot_sync(kAll, keep);
      if (keep) {
        const int at = kept + __popc(kb & below), t = lane + 32 * r;
        s.pc[at] = t;
        s.pv[at] = s.V[t];
      }
      ties += __popc(eq);
      kept += __popc(kb);
    }
    __syncwarp();
    int c = 0, n = 0;
    float v = 0.f;
    if (lane < nl) {  // survivors lie in code order: a lower place has the lower code
      c = s.pc[lane];
      v = s.pv[lane];
      for (int u = 0; u < nl; ++u) {
        const float o = s.pv[u];
        n += (o > v) | ((o == v) & (u < lane));
      }
    }
    __syncwarp();
    if (lane < nl) {
      s.pc[n] = c;
      s.pv[n] = v;
    }
  }

  // The ranks of candidates lane + 32 r (r < R), each counting the
  // candidates that beat it, in one pass over all T values; slot = rank.
  template <int R>
  __device__ void rank(int T) {
    const int nl = this->nl();
    float v[R];
    int n[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      v[r] = lane + 32 * r < T ? s.V[lane + 32 * r] : 0.f;
      n[r] = 0;
    }
#pragma unroll 4
    for (int u = 0; u < T; ++u) {
      const float o = s.V[u];
#pragma unroll
      for (int r = 0; r < R; ++r)
        n[r] += (o > v[r]) | ((o == v[r]) & (u < lane + 32 * r));
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = lane + 32 * r;
      if (t < T && n[r] < nl) {
        s.pc[n[r]] = t;
        s.pv[n[r]] = v[r];
      }
    }
  }

  // how many of the n entries of list c (C = 1 << lgc lists of w paths)
  // from place a on, in rank order, beat candidate t of value v: a binary
  // search, an entry's value read through its path
  __device__ int beaten_by(int c, int lgc, int w, int a, int n, float v, int t) const {
    const uint8_t* list = s.SL + c * w + a;
    int lo = 0;
    while (n > 0) {
      const int half = n >> 1;
      const int u = (static_cast<int>(list[lo + half]) << lgc) | c;
      const float o = s.V[u];
      if (o > v || (o == v && u < t)) {
        lo += half + 1;
        n -= half + 1;
      } else {
        n = half;
      }
    }
    return lo;
  }

  // A block's prune of T = w << lgc > nl candidates: top-nl into s.pc /
  // s.pv by merging the C = 1 << lgc lists (list c: candidates (l, c), l <
  // w, in path order). Each list's order is checked (a warp OR of
  // "v_l < v_{l+1}", one shared atomic a warp); a list in rank order is
  // taken as it is, a list out of order is ranked in runs of 32 paths (each
  // candidate counts the others of its run) and its runs merged by binary
  // search. A candidate's rank is then its place in its own list plus, for
  // each other list, a binary search for how many of it beat the candidate,
  // the searches stopping once the sum reaches nl (no slot). Each thread
  // holds its candidates' places (codes tid + NT q) from step to step;
  // slots r < nl take rank r.
  __device__ void merge(int w, int lgc) {
    const int C = 1 << lgc, T = w << lgc, nl = this->nl();
    unsigned bad = 0;
    for (int t = tid; t < T; t += NT)
      if (t + C < T && s.V[t] < s.V[t + C]) bad |= 1u << (t & (C - 1));
    bad = __reduce_or_sync(kAll, bad);
    if (lane == 0 && bad) atomicOr(&s.bad, bad);
    sync();
    const unsigned unsorted = s.bad;
    int place[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int t = tid + q * NT;
      if (t >= T) break;
      const int l = t >> lgc, c = t & (C - 1);
      int r = l;
      if ((unsorted >> c) & 1) {  // its place in its run of 32 paths
        const float v = s.V[t];
        const int g = l & ~31, e = min(g + 32, w);
        r = g;
        for (int u = g; u < e; ++u) {
          const float o = s.V[(u << lgc) | c];
          r += (o > v) | ((o == v) & (u < l));
        }
      }
      place[q] = r;
      s.SL[c * w + r] = static_cast<uint8_t>(l);
    }
    sync();
    if (tid == 0) s.bad = 0;  // for the next prune, past one more barrier
    if (unsorted && w > 32) {  // a list out of order: its runs merged
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int t = tid + q * NT;
        if (t >= T) break;
        const int l = t >> lgc, c = t & (C - 1);
        if (!((unsorted >> c) & 1)) continue;
        const float v = s.V[t];
        const int g = l & ~31;
        int r = place[q] - g;
        for (int a = 0; a < w; a += 32)
          if (a != g) r += beaten_by(c, lgc, w, a, min(32, w - a), v, t);
        place[q] = r;
      }
      sync();
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int t = tid + q * NT;
        if (t >= T) break;
        const int c = t & (C - 1);
        if ((unsorted >> c) & 1) s.SL[c * w + place[q]] = static_cast<uint8_t>(t >> lgc);
      }
      sync();
    }
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int t = tid + q * NT;
      if (t >= T) break;
      const int c = t & (C - 1);
      const float v = s.V[t];
      int r = place[q];
      for (int c2 = 0; c2 < C && r < nl; ++c2)  // a rank past nl takes no slot
        if (c2 != c) r += beaten_by(c2, lgc, w, 0, w, v, t);
      if (r < nl) {
        s.pc[r] = t;
        s.pv[r] = v;
      }
    }
  }

  // Slot j's survivor after a prune of w2 slots (j < w2), for its bits
  __device__ Slot slot(int j, int w2, int kind, int len, int aux, int nc) const {
    Slot t;
    if (j < w2) {
      const int code = s.pc[j];
      t.src = code >> log2i(nc);
      t.c = code & (nc - 1);
      if (kind == K_RATE1 && len == 1) {
        t.fm = t.c == 1;
        t.i0 = 0;
      } else if (kind == K_RATE1) {
        t.fm = (t.c == 1 || t.c == 3) | ((t.c == 2 || t.c == 3) << 1);
        t.i0 = s.is[0][t.src];
        t.i1 = s.is[1][t.src];
      } else if (kind == K_SPC) {
        t.fm = s.spc[(s.par[t.src] ? 8 : 0) + t.c];
        t.i0 = s.is[0][t.src];
        t.i1 = s.is[1][t.src];
        t.i2 = s.is[2][t.src];
        t.i3 = s.is[3][t.src];
      } else if (kind == K_ENUM) {
        t.emask = masks[aux + t.c];
      }
    }
    return t;
  }

  // slot t's decision at position i, its source path's hard decision there
  // being `hard` (not read by REP and ENUM)
  __device__ static int decide(const Slot& t, int kind, int hard, int i) {
    if (kind == K_REP) return t.c != 0;
    if (kind == K_ENUM) return (t.emask >> i) & 1;
    return hard ^ (((t.fm & 1) && i == t.i0) | ((t.fm & 2) && i == t.i1) |
                   ((t.fm & 4) && i == t.i2) | ((t.fm & 8) && i == t.i3));
  }

  // slot t's decision at position i of its path's input xs
  template <bool D>
  __device__ int slot_bit(const Slot& t, int kind, const S* xs, int i) const {
    return decide(t, kind, kind == K_REP || kind == K_ENUM ? 0 : Fam::hard(at<D>(xs, i)), i);
  }

  // One path: lane c < nc computes candidate c's value (its sums on its own
  // lane, sequential over the span), the warp takes the first maximal one
  // by a butterfly of (value, code) pairs (the rank-0 candidate of the
  // prune: value desc, code asc), and each lane writes its positions'
  // decision bits; the perm stays the identity.
  template <bool D>
  __device__ void one_leaf(const S* Xd, int len, int off, int kind, int aux, int nc) {
    K1_CLOCK(tp);
    const S* x = path<D>(Xd, len, 0);
    const float mt = s.M[0];
    float v = 0.f;
    int c = lane < nc ? lane : kNoCode;
    if (c != kNoCode) v = mt + delta<D>(kind, x, len, 0, c, aux);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(kAll, v, o);
      const int oc = __shfl_xor_sync(kAll, c, o);
      if (oc != kNoCode && (c == kNoCode || ov > v || (ov == v && oc < c))) {
        v = ov;
        c = oc;
      }
    }
    K1_TICK(10, tp);
    Slot t;
    t.c = c;
    if (kind == K_RATE1 && len == 1) {
      t.fm = c == 1;
      t.i0 = 0;
    } else if (kind == K_RATE1) {
      t.fm = (c == 1 || c == 3) | ((c == 2 || c == 3) << 1);
      t.i0 = s.is[0][0];
      t.i1 = s.is[1][0];
    } else if (kind == K_SPC) {
      t.fm = s.spc[(s.par[0] ? 8 : 0) + c];
      t.i0 = s.is[0][0];
      t.i1 = s.is[1][0];
      t.i2 = s.is[2][0];
      t.i3 = s.is[3][0];
    } else if (kind == K_ENUM) {
      t.emask = masks[aux + c];
    }
    for (int i = lane; i < len; i += 32) W[off + i] = slot_bit<D>(t, kind, x, i);
    K1_TICK(11, tp);
    sync();  // every lane has read s.M and the leaf scratch
    if (lane == 0) s.M[0] = v;
    sync();
  }

  // LEAF: candidates, prune, decision bits, the survivors' metrics and perm;
  // D: the input in device memory (a one-leaf schedule that is not staged)
  template <bool D>
  __device__ void leaf(int d, int len, int off, int kind, int aux, int nc, int& w) {
    const S* Xd = lvl(d);
    if (kind == K_RATE0) {
      each_path(w, [&](int l) {
        const S* x = path<D>(Xd, len, l);
        float acc = 0.f;
#pragma unroll 8
        for (int i = 0; i < len; ++i) acc = acc + fminf(at<D>(x, i), 0.f);
        s.M[l] = s.M[l] + acc;
        s.P[d][l] = l;
      });
      const int lg = log2i(len);
      for (int t = tid; t < (NW << lg); t += NT) W[(t >> lg) * span + off + (t & (len - 1))] = 0;
      sync();
      return;
    }
    K1_CLOCK(tp);
    if (kind == K_RATE1 && len > 1) {
      weakest<2, D>(Xd, len, w);
    } else if (kind == K_SPC) {
      weakest<4, D>(Xd, len, w);
    } else if (kind == K_ENUM) {
      each_path(w, [&](int l) {
        const S* x = path<D>(Xd, len, l);
        float sa = 0.f;
#pragma unroll 8
        for (int i = 0; i < len; ++i) sa = sa + fabsf(at<D>(x, i));
        s.ms[0][l] = sa;
      });
      sync();
    }
    K1_TICK(8, tp);
    if constexpr (kOne) {
      one_leaf<D>(Xd, len, off, kind, aux, nc);
      return;
    }
    const int T = w * nc, lgc = log2i(nc);  // nc: a power of two
    for (int t = tid; t < T; t += NT) {
      const int l = t >> lgc, c = t & (nc - 1);
      s.V[t] = s.M[l] + delta<D>(kind, path<D>(Xd, len, l), len, l, c, aux);
    }
    sync();
    K1_TICK(9, tp);
    const int w2 = prune(T, w, nc);
    K1_TICK(10, tp);

    if constexpr (NW == 1) {
      // decision bits of the surviving paths, packed one plane per path:
      // lane (position base + lane / L, slot lane % L)
      const int j = lane & (L - 1);
      const Slot t = slot(j, w2, kind, len, aux, nc);
      const S* xs = path<D>(Xd, len, t.src);
      for (int base = 0; base < len; base += kPerBallot) {
        const int i = base + (lane >> kLgL);
        const int bit = j < w2 && i < len ? slot_bit<D>(t, kind, xs, i) : 0;
        const unsigned b = __ballot_sync(kAll, bit);
        if (lane < kPerBallot && base + lane < len)
          W[off + base + lane] = static_cast<int>((b >> (lane * L)) & kMask);
      }
    } else {
      // a warp per (word k, 32 positions), lane = slot 32 k + lane: each
      // lane first reads its source path's 32 inputs, then one ballot a
      // position
      const int chunks = (len + 31) >> 5;
      for (int pair = warp; pair < NW * chunks; pair += NWARPS) {
        const int k = pair / chunks, i0 = (pair - k * chunks) << 5, j = 32 * k + lane;
        const int n = len - i0 < 32 ? len - i0 : 32;
        const Slot t = slot(j, w2, kind, len, aux, nc);
        unsigned hard = 0;  // bit q: the source path's hard decision at i0 + q
        if (j < w2 && kind != K_REP && kind != K_ENUM) {
          const S* xs = path<D>(Xd, len, t.src);
#pragma unroll 8
          for (int q = 0; q < n; ++q)
            hard |= static_cast<unsigned>(Fam::hard(at<D>(xs, i0 + q))) << q;
        }
        for (int q = 0; q < n; ++q) {
          const int bit = j < w2 && decide(t, kind, (hard >> q) & 1, i0 + q);
          const unsigned b = __ballot_sync(kAll, bit);
          if (lane == q) W[k * span + off + i0 + q] = static_cast<int>(b);
        }
      }
    }
    K1_TICK(11, tp);
    each_path(w2, [&](int l) {
      s.M[l] = s.pv[l];
      s.P[d][l] = s.pc[l] >> lgc;
    });
    sync();
    w = w2;
  }
};

template <int L, class Fam, bool kExact>
__global__ void __launch_bounds__(L > 32 ? 2 * L : 32 * kMaxPerBlock)
scl_subtree_kernel(const int* __restrict__ ops, int n_ops, const int* __restrict__ enum_masks,
                   const int* __restrict__ spc_tab, const typename Fam::State* __restrict__ llr,
                   long long llr_sl, long long llr_si, long long llr_sb,
                   const float* __restrict__ met_in, int* __restrict__ bits,
                   int* __restrict__ perm_out, float* __restrict__ met_out, int list_size,
                   int w_in, int w_out, int span, int batch, int per_team, int direct) {
  using Tm = Team<L, Fam, kExact>;
  using S = typename Fam::State;
  constexpr int NT = Tm::NT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int team = threadIdx.x / NT, tid = threadIdx.x % NT;
  const int b = blockIdx.x * (blockDim.x / NT) + team;
  if (b >= batch) return;  // the whole team: no collective is left behind
  unsigned char* mine = smem + (size_t)team * per_team;
  Shared<L>& s = *reinterpret_cast<Shared<L>*>(mine);
  int* W = reinterpret_cast<int*>(mine + sizeof(Shared<L>));
  S* X = reinterpret_cast<S*>(W + kWords<L> * span);
  K1_CLOCK(tk);
  const S* in = llr + b * llr_sb;
  Tm tm{s, W, X, in, enum_masks, llr_sl, llr_si, span, tid, tid & 31, tid >> 5, list_size};

  tm.each_path(w_in, [&](int l) { s.M[l] = met_in[(size_t)b * w_in + l]; });
  if (tid < 32) s.spc[tid] = spc_tab[tid];
  if constexpr (Tm::kBlock) {
    if (tid == 0) s.bad = 0;
  }
  if (ops[0] == OP_LEAF && !direct) {  // a one-leaf subtree reads its input from shared memory
    const int n = w_in * span, lgs = log2i(span);
    for (int t0 = tid; t0 < n; t0 += NT * kLoads) {
      S v[kLoads];
#pragma unroll
      for (int q = 0; q < kLoads; ++q) {
        const int t = t0 + NT * q;
        if (t < n) v[q] = in[(t >> lgs) * llr_sl + (t & (span - 1)) * llr_si];
      }
#pragma unroll
      for (int q = 0; q < kLoads; ++q)
        if (t0 + NT * q < n) X[t0 + NT * q] = v[q];
    }
  }
  tm.sync();

  int w = w_in;
  int op[7];
#pragma unroll
  for (int q = 0; q < 7; ++q) op[q] = ops[q];
  for (int k = 0; k < n_ops; ++k) {
    int next[7];  // the next op's words, loaded while this op runs
    const int* nx = ops + (k + 1 < n_ops ? k + 1 : k) * kOpWords;
#pragma unroll
    for (int q = 0; q < 7; ++q) next[q] = nx[q];
    const int code = op[0], d = op[1], len = op[2], off = op[3];
    K1_CLOCK(t0);
    if (code == OP_F)
      tm.F(d, len, w);
    else if (code == OP_G)
      tm.G(d, len, off, w);
    else if (code == OP_COMBINE)
      tm.combine(d, len, off, w);
    else if (direct)
      tm.template leaf<true>(d, len, off, op[4], op[5], op[6], w);
    else
      tm.template leaf<false>(d, len, off, op[4], op[5], op[6], w);
    K1_TICK(code == OP_LEAF ? 3 + op[4] : code < 2 && d == 0 ? 13 + code : code, t0);
#pragma unroll
    for (int q = 0; q < 7; ++q) op[q] = next[q];
  }

  K1_TICK(12, tk);
  // ceil(list_size / 32) words leave (3 for 65-96 paths in capacity 128)
  const int out_words = kWords<L> == 1 ? 1 : (tm.nl() + 31) >> 5;
  for (int i = tid; i < out_words * span; i += NT) bits[(size_t)i * batch + b] = W[i];
  tm.each_path(w_out, [&](int l) {
    perm_out[(size_t)b * w_out + l] = Tm::kOne ? 0 : s.P[0][l];
    met_out[(size_t)b * w_out + l] = s.M[l];
  });
}

int smem_limit() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return 0;
  return optin;
}

template <int L, class Fam, bool kExact>
int launch(const int* ops, int n_ops, const int* enum_masks, const int* spc_tab,
           const void* llr, long long sl, long long si, long long sb, const float* met,
           int* bits, int* perm, float* met_out,
           int list_size, int w_in, int w_out, int span, int batch, int per_block,
           cudaStream_t stream) {
  using S = typename Fam::State;
  constexpr int NT = Team<L, Fam, kExact>::NT;
  const bool direct = reads_direct<L, Fam>(n_ops, span);
  const size_t per_team = codeword_bytes<L, Fam>(span, direct);
  const size_t limit = static_cast<size_t>(smem_limit());
  if (per_team > limit) return -2;
  // codewords per block: a block's team takes one; warps one while the
  // batch leaves SMs idle, then four
  int cw = NT > 32 ? 1 : per_block > 0 ? per_block : (batch >= 4 * 132 ? 4 : 1);
  cw = cw > kMaxPerBlock ? kMaxPerBlock : cw;
  while (cw > 1 && cw * per_team > limit) cw >>= 1;
  const size_t smem = cw * per_team;
  auto kernel = scl_subtree_kernel<L, Fam, kExact>;
  static int raised[kMaxDevices] = {};  // the kernel's shared-memory limit set per card
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices || static_cast<int>(smem) > raised[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) raised[dev] = static_cast<int>(smem);
  }
  kernel<<<(batch + cw - 1) / cw, NT * cw, smem, stream>>>(
      ops, n_ops, enum_masks, spc_tab, static_cast<const S*>(llr), sl, si, sb, met, bits, perm,
      met_out,
      list_size, w_in, w_out, span, batch, static_cast<int>(per_team), static_cast<int>(direct));
  return static_cast<int>(cudaGetLastError());
}

// The list capacity that serves list_size: the next power of two up to
// 128 (0 outside 1..128; a list of one path runs in the one-path kernel).
int capacity(int list_size) {
  if (list_size < 1 || list_size > 128) return 0;
  int cap = 1;
  while (cap < list_size) cap <<= 1;
  return cap;
}

template <class Fam>
int dispatch(const int* o, int n_ops, const int* e, const int* sp, const void* x,
             long long sl, long long si, long long sb, const float* mi, int* bt, int* pr,
             float* mo, int list_size, int w_in, int w_out, int span, int batch, int pb,
             cudaStream_t st) {
#define K1_LAUNCH(CAP, EXACT)                                                             \
  launch<CAP, Fam, EXACT>(o, n_ops, e, sp, x, sl, si, sb, mi, bt, pr, mo, list_size, w_in, \
                          w_out, span, batch, pb, st)
  // the list sizes of 32 paths or fewer that fill their capacity keep the
  // list size a constant of their build (~4% faster at L = 8 than the run-
  // time list size, the two timed in one process); every other size runs
  // in its capacity's instantiation with the list size at run time
  switch (list_size) {
    case 1: return K1_LAUNCH(1, true);
    case 2: return K1_LAUNCH(2, true);
    case 4: return K1_LAUNCH(4, true);
    case 8: return K1_LAUNCH(8, true);
    case 16: return K1_LAUNCH(16, true);
    case 32: return K1_LAUNCH(32, true);
  }
  switch (capacity(list_size)) {
    case 2: return K1_LAUNCH(2, false);
    case 4: return K1_LAUNCH(4, false);
    case 8: return K1_LAUNCH(8, false);
    case 16: return K1_LAUNCH(16, false);
    case 32: return K1_LAUNCH(32, false);
    case 64: return K1_LAUNCH(64, false);
    case 128: return K1_LAUNCH(128, false);
    default: return -1;
  }
#undef K1_LAUNCH
}

template <int L, class Fam>
int bytes_at(int span, int n_ops) {
  return static_cast<int>(codeword_bytes<L, Fam>(span, reads_direct<L, Fam>(n_ops, span)));
}

template <class Fam>
int bytes_of(int list_size, int span, int n_ops) {
  switch (capacity(list_size)) {
    case 1: return bytes_at<1, Fam>(span, n_ops);
    case 2: return bytes_at<2, Fam>(span, n_ops);
    case 4: return bytes_at<4, Fam>(span, n_ops);
    case 8: return bytes_at<8, Fam>(span, n_ops);
    case 16: return bytes_at<16, Fam>(span, n_ops);
    case 32: return bytes_at<32, Fam>(span, n_ops);
    case 64: return bytes_at<64, Fam>(span, n_ops);
    case 128: return bytes_at<128, Fam>(span, n_ops);
    default: return -1;
  }
}

bool bad_span(int span) {
  return span < 1 || span > (1 << (kMaxLevels - 1)) || (span & (span - 1));
}

}  // namespace

extern "C" int scl_subtree(const void* ops, int n_ops, const void* enum_masks,
                           const void* spc_tab, const void* llr, long long llr_sl,
                           long long llr_si, long long llr_sb, const void* met, void* bits,
                           void* perm, void* met_out, int list_size, int w_in, int w_out,
                           int span, int batch, int family, int per_block, void* stream) {
  if (bad_span(span)) return -1;
  if (batch <= 0) return 0;
  auto o = static_cast<const int*>(ops);
  auto e = static_cast<const int*>(enum_masks);
  auto sp = static_cast<const int*>(spc_tab);
  auto mi = static_cast<const float*>(met);
  auto bt = static_cast<int*>(bits);
  auto pr = static_cast<int*>(perm);
  auto mo = static_cast<float*>(met_out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (family) {
    case 0: return dispatch<FloatFamily>(o, n_ops, e, sp, llr, llr_sl, llr_si, llr_sb, mi, bt, pr, mo, list_size, w_in, w_out, span, batch, per_block, st);
    case 1: return dispatch<CharFamily>(o, n_ops, e, sp, llr, llr_sl, llr_si, llr_sb, mi, bt, pr, mo, list_size, w_in, w_out, span, batch, per_block, st);
    case 2: return dispatch<Bf16Family>(o, n_ops, e, sp, llr, llr_sl, llr_si, llr_sb, mi, bt, pr, mo, list_size, w_in, w_out, span, batch, per_block, st);
    default: return -1;
  }
}

extern "C" int scl_subtree_smem(int list_size, int span, int family, int n_ops) {
  if (bad_span(span)) return -1;
  switch (family) {
    case 0: return bytes_of<FloatFamily>(list_size, span, n_ops);
    case 1: return bytes_of<CharFamily>(list_size, span, n_ops);
    case 2: return bytes_of<Bf16Family>(list_size, span, n_ops);
    default: return -1;
  }
}

extern "C" int scl_subtree_smem_limit() { return smem_limit(); }
