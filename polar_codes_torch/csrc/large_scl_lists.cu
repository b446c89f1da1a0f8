// Masked SCL chunk decoder (K7) at every list size L from 1 to 128: bitwise
// SCL over one chunk of span M whose frozen mask (and, optionally, the
// class of each sub-block) arrives as data, for a batch of codewords, in
// the kernel of the list's capacity with the list size a launch argument.
// large_scl_chunk.cu keeps the kernels whose list size is a constant of
// their build (L = 2, 4, 8, 16, 32, unchanged), which the wrapper takes
// wherever their LLR pyramid fits; this library serves every other list
// size and those five where the pyramid does not fit. The two are
// separate libraries so that nvcc builds them in parallel. Every L > 128,
// and every (L, chunk) whose state does not fit even with level 0 in
// device memory, runs in scl_wide.cu (ops/large_kernel.py scl_library).
//
// Replaces: polar_codes_tpu/ops/large_kernel.py,
// build_masked_scl_chunk_kernel.kernel (its float32 and int8 families, at
// the list size it is built for), the mixed-chunk decode of
// LargeSCLDecoder: the f/g recursion with path-fork gathers and perm
// composition, a {keep, flip} fork and a top-L prune at every span-1 leaf
// (a frozen leaf pays min(llr, 0) and its flip is killed with _NEG), and,
// at span `sub`, a switch on the sub-block's class to the SSCL leaf rules
// (rate0, rate1 with 4 candidates, rep, spc with 8) or on to the per-bit
// recursion.
//
// Interface (batch-first, as the large-N glue holds its buffers):
//   llr [B, L, M] f32, mask [M] u8 (1 = frozen), metrics [B, L] f32,
//   sub_cls [M / sub] i32 (sub = 0: no sub-block dispatch),
//   family (0 float32, 1 char)
//     -> bits [B, M] i32 (bit l of a word = path l's codeword bit), or for
//        L > 32 bits [B, W, M] with W = ceil(L / 32) words (path l: bit
//        l % 32 of word l / 32),
//        perm [B, L] i32 (output slot -> input slot), metrics [B, L] f32
//
// Capacities: 4 (L <= 4), 32 (L <= 32; one word a position, a lane a path;
// capacity 4 packs 8 positions in a combine's ballot, 32 one), 64 (two
// words) and 128 (four words). The list size is read by the prune (the
// rank cut, the re-take rule, the new width) and by the `tid < L` guards;
// slots at or above it never become live and their bits stay 0. The list
// is always full width here (metrics [B, L], inactive slots at _NEG), so
// w * C = C * L > L at every prune and the TPU kernel's
// progressive-widening branch never runs.
//
// Mapping. Capacities 4 and 32: one warp a codeword, warp-synchronous.
// Capacities 64 and 128: one block of 2 x capacity threads a codeword
// (128 or 256: a thread per candidate of a bit), steps closed by a block
// barrier (PTX barrier.sync without .aligned: the warp that holds path L -
// 1 reaches it split whenever 32 does not divide L). Thread l < L holds
// path l's metric in a register. F and
// G run over (path, element) pairs; a combine gives each warp whole
// positions (one ballot per word, lane = slot 32 k + lane, every word of
// the position read before any is written); a bit's packed word k is warp
// k's ballot; a sub-block's up to 8 L candidates spread over the block, R
// = T / (2 x capacity) <= 4 a thread, and its decision bits go a warp per
// (word, 32 positions).
//
// Walk: the block (or warp) computes the chunk's post-order walk itself
// from the leaf index, with the trigger and climb rules of K6: before leaf
// k the levels from dl - tz(k) down are refreshed (f for a left child, g
// for a right one, which gathers the parent's LLRs through the left
// sibling's perm), and after it tz(~k) combines climb back up (fork the
// left bits through the right child's perm, XOR, compose the perms). With
// sub-blocks the walk's leaves are the sub-blocks; a pure one takes its
// leaf rule and a mixed one runs the same walk over its bits. The order of
// operations is that of the host's post-order schedule (ops/large_kernel.py
// scl_chunk_schedule), which is not passed. The mask (as 32-bit words), the
// class codes and the SPC table are staged into shared memory once. Spans
// are powers of two: shifts and masks.
//
// Up to 32 paths the lowest kRegLevels = 3 levels of a per-bit walk run in
// registers, as in large_scl_chunk.cu: lane l < L holds path l's 8 LLRs
// of a span-8 node, g's path-fork gather is a shuffle, a bit's 2 x
// capacity candidates are ranked in registers (shuffles), its packed word
// is one __ballot_sync; a sub-block's candidates are ranked from shared
// memory, R of them a lane, each against all. Above 32 paths every level
// down to span 1 is in shared memory.
//
// The prune above 32 paths is a merge. The T = C x L candidates of a leaf
// (code l*C + c: path l, candidate c) form C lists, list c = {(l, c): l <
// L} in path order. Every prune leaves its slots in rank order (slot r
// takes rank r), so at an information bit the keep list (value m_l) is
// already in rank order and only the flip list (m_l - |x_l|) needs
// ordering. The kernel checks each list (a warp OR of "v_l < v_{l+1}",
// one shared atomic a warp); a list out of order (a chunk's entry, frozen
// bits, rate-0 sub-blocks, every list but rate-1's first of a sub-block)
// is ordered by rank in runs of 32 paths (each candidate counts the 31
// others of its run) and the runs merged by binary search. A candidate's
// rank is then its place in its own list plus, for every other list, a
// binary search for how many of that list beat it: at an information bit
// at L = 128 about 32 compares and 4 searches a candidate, where the warp
// kernel ranked each of the 256 against all 256. The rank is the same
// total order as before (value descending, flat code ascending; float
// compares, so -0.0 ties +0.0), so the result is the same permutation.
//
// Shared memory: the LLR pyramid (8 L M bytes: nl x 2M f32), the packed
// bit words (4 W M), the mask bits and the class codes, dynamic; the
// perms of the open node at each level, the candidates, the merge's
// ordered lists, static. Where the pyramid exceeds kMaxDynamic = 200 KiB,
// as at L = 128, M = 256 (266 KB), level 0, the chunk's input, stays in
// device memory, read where it lies by the level-0 f and g (coalesced: a
// codeword's [L, M] input is contiguous) and by a sub-block leaf at level
// 0, and only the levels below it (4 L M bytes, 135 KB there) are staged.
// A chunk that does not fit even so is refused (-2); the wrapper sends
// those to scl_wide.cu.
//
// What bounds it on an H100: the length of one codeword's dependent chain
// (a codeword a block, B blocks over 132 SMs). Per bit the prune's ~6
// barriers and its compare chain, and the f/g refreshes and combines,
// each closed by a barrier. Bytes and arithmetic are far below that
// (chip_smoke.py prints both beside the time). Measured (chip_profile.py
// k7_lists_ab, NVIDIA H100 80GB HBM3 at 700 W, the K7 calls of a (32768,
// 16384) decode, chunks of 256, sub-blocks of 16, B = 64): 0.45 ms a call
// at L = 64 and 0.64 ms at L = 128, where the one-warp kernel it replaced
// took 1.00 and 3.25 ms; char L = 64 ((8192, 4096), no sub-blocks) 0.97
// ms (2.24); bounds 1.3-2.6 us.
//
// Two families, instantiations of one template (the TPU kernel's int8
// flag): float32, and char, integer-valued LLRs in f32 with g clipped to
// [-127, 127] and hard decisions llr < 0 (0 decides 0) in the bit leaves,
// the rate-1/SPC sub-block rules and the SPC parity. In both, f is the
// sign-XOR min-sum on the raw bits, which on integers is the char family's
// product form, unclipped.
//
// Numerics as the plain torch version (ops/large_kernel.py) and
// large_scl_chunk.cu: float32 hard decisions read the sign bit (-0.0
// decides 1), leaf sums run sequentially over the span in f32 (exact on
// char integers), the build disables FMA contraction. The prune
// reproduces the TPU kernel's iterative extraction, which leaves _NEG on
// each candidate it takes: with k values above _NEG, slots r < max(k, 1)
// take rank r with its value, and every later slot takes the smallest code
// among the candidates taken so far and those whose value is exactly
// _NEG, with value _NEG (ops/large_kernel.py prune_by_rank is its twin).
// Kernel and plain version agree bit for bit.
//
// C interface (ctypes; every pointer and the stream are void*), that of
// large_scl_chunk.cu:
//   int masked_scl_chunk(const int *ops, int n_ops, const int *spc_tab,
//                        const float *llr, const uint8_t *mask,
//                        const float *met, const int *sub_cls, int sub,
//                        int *bits, int *perm, float *met_out,
//                        int list_size, int chunk, int batch, int family,
//                        cudaStream_t stream)
// `ops` and `n_ops` are not read (the wrapper passes NULL and 0).
// Returns the cudaGetLastError() of the launch (or of the shared-memory
// attribute call), -1 for an unsupported list size (outside 1..128), chunk
// or family, -2 for a chunk whose state does not fit even with level 0 in
// device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kMaxCand = 8;
constexpr int kRegLevels = 3;  // the lowest levels of a per-bit walk, in registers
constexpr int kRegSpan = 1 << kRegLevels;
constexpr int kRankRegs = 8;   // most candidates a lane ranks in one pass of prune_smem
constexpr unsigned kAll = 0xffffffffu;
constexpr float kNeg = -1.0e30f;
constexpr int kNoCode = 0x7fffffff;
// dynamic shared memory a codeword may take (ops/large_kernel.py MAX_SCL_SMEM)
constexpr size_t kMaxDynamic = 200 * 1024;
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

// A block barrier that threads of one warp may reach at different times
// (PTX barrier.sync without .aligned, sm_70 on); the CPU runner's
// __syncthreads counts threads the same way.
__device__ __forceinline__ void block_barrier() {
#ifdef __CUDA_ARCH__
  asm volatile("barrier.sync 0;" ::: "memory");
#else
  __syncthreads();
#endif
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

// int32 words a packed position holds for a list of capacity L
template <int L>
constexpr int kWords = L > 32 ? L / 32 : 1;
// threads a codeword: a warp up to 32 paths, a thread per candidate of a bit above
template <int L>
constexpr int kThreads = L > 32 ? 2 * L : 32;
// entries of the merge's ordered lists (the block kernels only)
template <int L>
constexpr int kMerge = L > 32 ? L * kMaxCand : 1;

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
  // the prune by merge (above 32 paths): list c's entries in rank order
  // from SV[c L] (value, path), each candidate's place in its list, the
  // lists out of order, the values above kNeg, the re-take candidate
  float SV[kMerge<L>];
  short R[kMerge<L>];
  uint8_t SL[kMerge<L>];
  unsigned bad;
  int live, best;
};

// Dynamic shared memory of one codeword: the LLR levels (from level 0, or
// from level 1 when level 0 is read from device memory), the packed bit
// words, the mask bits and the class codes.
template <int L>
size_t dynamic_bytes(int nl, int m, int sub, bool direct) {
  const size_t words = (size_t)(m + 31) / 32;
  const size_t levels = (size_t)(direct ? 1 : 2) * nl * m * sizeof(float);
  return levels + (size_t)kWords<L> * m * sizeof(int) + words * sizeof(unsigned) +
         (sub ? m / sub : 0);
}

// One codeword's team (a warp up to capacity 32, a block above): the
// shared state and the chunk. L is the list's capacity (a power of two),
// nl the list size (nl <= L; slots at or above it never become live).
template <int L, class Fam>
struct Walker {
  static constexpr int NW = kWords<L>;  // packed words a position
  static constexpr int NT = kThreads<L>;
  static constexpr int NWARPS = NT / 32;
  static constexpr bool kBlock = NT > 32;

  Shared<L>& s;
  const float* X0;          // level 0, [nl][M]: staged in shared memory, or the input
  float* X1;                // level 1 in shared memory (levels d >= 1 follow it)
  int* W;                   // [NW][M] packed bits (word k of position i at W[k M + i])
  const unsigned* Fm;       // [ceil(M / 32)] frozen mask bits
  const uint8_t* Cls;       // [M / sub] class codes
  int m, D, tid, lane, warp, nl_arg;
  float mreg;               // path tid's metric (tid < nl)

  __device__ int nl() const { return nl_arg; }
  __device__ int frozen(int pos) const { return (Fm[pos >> 5] >> (pos & 31)) & 1; }

  // the team's barrier: a block's is PTX's barrier.sync without .aligned,
  // which a warp may reach split (a per-path step leaves the warp holding
  // path nl - 1 split at tid = nl); __syncthreads is bar.sync, the aligned
  // form, and a split warp there lost a barrier phase on the card
  __device__ void sync() const {
    if constexpr (kBlock) {
      block_barrier();
    } else {
      __syncwarp();
    }
  }

  // level d's LLRs, [nl][M >> d]
  __device__ const float* in_lvl(int d) const {
    return d == 0 ? X0 : X1 + nl_arg * (m - (m >> (d - 1)));
  }
  __device__ float* out_lvl(int d) const {  // d >= 1
    return X1 + nl_arg * (m - (m >> (d - 1)));
  }

  // f(l) on the live path this thread holds (thread l: path l)
  template <class F>
  __device__ __forceinline__ void for_paths(F f) const {
    if (tid < nl()) f(tid);
  }

  // path l's decision bit at position pos
  __device__ int bit_of(int pos, int l) const {
    if constexpr (NW == 1) {
      return (W[pos] >> l) & 1;
    } else {
      return (W[(l >> 5) * m + pos] >> (l & 31)) & 1;
    }
  }

  // f from level q into level q + 1
  __device__ void F(int q) {
    const int len = m >> q, lh = D - q - 1, h = 1 << lh;
    const float* Xq = in_lvl(q);
    float* Y = out_lvl(q + 1);
    for (int t = tid; t < (nl() << lh); t += NT) {
      const int l = t >> lh, i = t & (h - 1);
      Y[t] = f_bits(Xq[l * len + i], Xq[l * len + i + h]);
    }
    sync();
  }

  // g from level q into level q + 1 (node at offset off, whose left half's
  // bits are done), then the left child's perm becomes level q's
  __device__ void G(int q, int off) {
    const int len = m >> q, lh = D - q - 1, h = 1 << lh;
    const float* Xq = in_lvl(q);
    float* Y = out_lvl(q + 1);
    for (int t = tid; t < (nl() << lh); t += NT) {
      const int l = t >> lh, i = t & (h - 1);
      const int p = s.P[q + 1][l];  // left child's perm: slot -> parent slot
      Y[t] = Fam::g(Xq[p * len + i], Xq[p * len + i + h], bit_of(off + i, l));
    }
    for_paths([&](int l) { s.P[q][l] = s.P[q + 1][l]; });
    sync();
  }

  // the node at level q, offset off: left bits forked through the right
  // child's perm, XOR the right bits; perms composed
  __device__ void combine(int q, int off) {
    const int h = (m >> q) >> 1;
    const int* p = s.P[q + 1];
    if constexpr (NW == 1) {
      constexpr int kLgL = L == 2 ? 1 : L == 4 ? 2 : L == 8 ? 3 : L == 16 ? 4 : 5;
      constexpr int kPer = 32 / L;  // positions per ballot
      constexpr unsigned kMask = L == 32 ? kAll : (1u << L) - 1u;
      const int j = lane & (L - 1);
      for (int base = 0; base < h; base += kPer) {
        const int i = base + (lane >> kLgL);
        const int bit = i < h && j < nl() ? (W[off + i] >> p[j]) & 1 : 0;
        const unsigned b = __ballot_sync(kAll, bit);
        if (lane < kPer && base + lane < h)
          W[off + base + lane] = static_cast<int>((b >> (lane * L)) & kMask) ^ W[off + h + base + lane];
      }
    } else {  // a warp per position: one ballot a word, lane = slot 32 k + lane
      int src[NW];
#pragma unroll
      for (int k = 0; k < NW; ++k) src[k] = lane + 32 * k < nl() ? p[lane + 32 * k] : -1;
      for (int i = warp; i < h; i += NWARPS) {
        unsigned b[NW];
#pragma unroll
        for (int k = 0; k < NW; ++k) b[k] = __ballot_sync(kAll, src[k] >= 0 && bit_of(off + i, src[k]));
        // every word of the position is read (the ballots) before any is written
#pragma unroll
        for (int k = 0; k < NW; ++k)
          if (lane == k) W[k * m + off + i] = static_cast<int>(b[k]) ^ W[k * m + off + h + i];
      }
    }
    int c = 0;
    for_paths([&](int l) { c = s.P[q][p[l]]; });
    sync();
    for_paths([&](int l) { s.P[q][l] = c; });
    sync();
  }

  // Top-nl of T <= TC candidates into s.pc / s.pv (slot -> code, value).
  // Lane `lane` holds the values of codes lane + 32 r in v[r]; a
  // candidate's rank counts those that beat it in (value desc, code asc)
  // order. With k values above kNeg, slots r < max(k, 1) take rank r, the
  // later ones the re-take rule's candidate with value kNeg.
  template <int TC>
  __device__ void prune(const float (&v)[(TC + 31) / 32], int T) {
    constexpr int kPer = (TC + 31) / 32;
    const int nl = this->nl();
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
      // a loop over the run-time count (warp-uniform), not unrolled in
      // full: a guarded body per candidate made ptxas take ~4x as long on
      // the capacity-32 kernels as on large_scl_chunk.cu's L = 32
      const int n = min(32, T - 32 * ru);
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
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
      if (t < T && rank[r] < kk && rank[r] < nl) {
        s.pc[rank[r]] = t;
        s.pv[rank[r]] = v[r];
      }
    }
    if (kk < nl) {  // warp-uniform: the re-take rule fills the rest
      int best = kNoCode;
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const int t = lane + 32 * r;
        if (t < T && (rank[r] < kk || v[r] == kNeg)) best = min(best, t);
      }
      best = __reduce_min_sync(kAll, best);
      for (int r = kk + lane; r < nl; r += 32) {
        s.pc[r] = best;
        s.pv[r] = kNeg;
      }
    }
    __syncwarp();
  }

  // A sub-block's candidates up to 32 paths: the same prune on the T
  // candidates of s.V. Lanes hold R candidates each (R from T: 1, 2, 4,
  // or 8 in passes of 256), and each pass reads every value once from
  // shared memory.
  __device__ void prune_smem(int T) {
    const int nl = this->nl();
    int k = 0;
    for (int t = lane; t < T; t += 32) k += s.V[t] > kNeg;
    const int kk = max(__reduce_add_sync(kAll, k), 1);
    int best = kNoCode;
    const int per = (T + 31) >> 5;
    if (per == 1) {
      rank_pass<1>(T, 0, kk, best);
    } else if (per == 2) {
      rank_pass<2>(T, 0, kk, best);
    } else if (per <= 4) {
      rank_pass<4>(T, 0, kk, best);
    } else {
      for (int base = 0; base < T; base += 32 * kRankRegs) rank_pass<kRankRegs>(T, base, kk, best);
    }
    if (kk < nl) {  // warp-uniform: the re-take rule fills the rest
      best = __reduce_min_sync(kAll, best);
      for (int r = kk + lane; r < nl; r += 32) {
        s.pc[r] = best;
        s.pv[r] = kNeg;
      }
    }
    __syncwarp();
  }

  // One pass of prune_smem: the ranks of candidates base + lane + 32 r (r <
  // R) against all T values, each landing in its slot; `best` gathers the
  // re-take rule's candidates (taken, or exactly kNeg) of this lane.
  template <int R>
  __device__ void rank_pass(int T, int base, int kk, int& best) {
    const int nl = this->nl();
    float v[R];
    int n[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = base + lane + 32 * r;
      v[r] = t < T ? s.V[t] : 0.f;
      n[r] = 0;
    }
#pragma unroll 4
    for (int u = 0; u < T; ++u) {
      const float o = s.V[u];
#pragma unroll
      for (int r = 0; r < R; ++r)
        n[r] += (o > v[r]) | ((o == v[r]) & (u < base + lane + 32 * r));
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = base + lane + 32 * r;
      if (t >= T) continue;
      if (n[r] < kk && n[r] < nl) {
        s.pc[n[r]] = t;
        s.pv[n[r]] = v[r];
      }
      if (n[r] < kk || v[r] == kNeg) best = min(best, t);
    }
  }

  // how many of the n entries of list c (C = 1 << lgc lists) from place a
  // on, in rank order, beat candidate t of value v: a binary search
  __device__ int beaten_by(int c, int lgc, int a, int n, float v, int t) const {
    const int base = c * nl() + a;
    int lo = 0;
    while (n > 0) {
      const int half = n >> 1, at = base + lo + half;
      const float o = s.SV[at];
      const int u = (static_cast<int>(s.SL[at]) << lgc) | c;
      if (o > v || (o == v && u < t)) {
        lo += half + 1;
        n -= half + 1;
      } else {
        n = half;
      }
    }
    return lo;
  }

  // Above 32 paths: top-nl of the T = nl << lgc candidates of s.V into
  // s.pc / s.pv by merging the C = 1 << lgc lists (list c: candidates (l,
  // c), l < nl), with the rank rule and the re-take rule of prune().
  __device__ void prune_merge(int lgc) {
    const int nl = this->nl(), C = 1 << lgc, T = nl << lgc;
    // the lists out of rank order, and the values above kNeg
    unsigned bad = 0;
    int live = 0;
    for (int t = tid; t < T; t += NT) {
      const float v = s.V[t];
      live += v > kNeg;
      if (t + C < T && v < s.V[t + C]) bad |= 1u << (t & (C - 1));
    }
    bad = __reduce_or_sync(kAll, bad);
    live = __reduce_add_sync(kAll, live);
    if (lane == 0) {
      if (bad) atomicOr(&s.bad, bad);
      atomicAdd(&s.live, live);
    }
    sync();
    const unsigned unsorted = s.bad;
    const int kk = max(s.live, 1);
    // each candidate's place in its list where the list is in rank order,
    // else in its run of 32 paths; the lists (or runs) in rank order
    for (int t = tid; t < T; t += NT) {
      const int l = t >> lgc, c = t & (C - 1);
      const float v = s.V[t];
      int r = l;
      if ((unsorted >> c) & 1) {
        const int g = l & ~31, e = min(g + 32, nl);
        r = g;
        for (int u = g; u < e; ++u) {
          const float o = s.V[(u << lgc) | c];
          r += (o > v) | ((o == v) & (u < l));
        }
      }
      s.R[t] = static_cast<short>(r);
      s.SV[c * nl + r] = v;
      s.SL[c * nl + r] = static_cast<uint8_t>(l);
    }
    sync();
    if (unsorted && nl > 32) {  // a list out of order: its runs merged
      for (int t = tid; t < T; t += NT) {
        const int l = t >> lgc, c = t & (C - 1);
        if (!((unsorted >> c) & 1)) continue;
        const float v = s.V[t];
        const int g = l & ~31;
        int r = s.R[t] - g;
        for (int a = 0; a < nl; a += 32)
          if (a != g) r += beaten_by(c, lgc, a, min(32, nl - a), v, t);
        s.R[t] = static_cast<short>(r);
      }
      sync();
      for (int t = tid; t < T; t += NT) {
        const int l = t >> lgc, c = t & (C - 1);
        if ((unsorted >> c) & 1) {
          s.SV[c * nl + s.R[t]] = s.V[t];
          s.SL[c * nl + s.R[t]] = static_cast<uint8_t>(l);
        }
      }
      sync();
    }
    // rank: the place in its own list and, in each other list, how many beat it
    int best = kNoCode;
    for (int t = tid; t < T; t += NT) {
      const int c = t & (C - 1);
      const float v = s.V[t];
      int r = s.R[t];
      for (int c2 = 0; c2 < C; ++c2)
        if (c2 != c) r += beaten_by(c2, lgc, 0, nl, v, t);
      if (r < kk && r < nl) {
        s.pc[r] = t;
        s.pv[r] = v;
      }
      if (r < kk || v == kNeg) best = min(best, t);
    }
    if (kk < nl) {  // block-uniform: the re-take rule's candidate
      best = __reduce_min_sync(kAll, best);
      if (lane == 0) atomicMin(&s.best, best);
    }
    sync();
    if (kk < nl) {  // the re-take rule fills the rest
      for (int r = kk + tid; r < nl; r += NT) {
        s.pc[r] = s.best;
        s.pv[r] = kNeg;
      }
      sync();
    }
    if (tid == 0) {  // for the next prune, past at least one more barrier
      s.bad = 0;
      s.live = 0;
      s.best = kNoCode;
    }
  }

  // A span-1 leaf at position pos with lane l < nl holding path l's LLR x:
  // returns the packed word; perm (slot -> path) and the metrics follow
  // the prune.
  __device__ __forceinline__ unsigned leaf(float x, int pos, int& perm) {
    constexpr int T = 2 * L, kPer = (T + 31) / 32;  // T: the capacity's
    const int nl = this->nl();
    const int fz = frozen(pos);
    float v[kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r) {  // candidate t = 2 l + c
      const int t = lane + 32 * r, l = (t >> 1) & 31;
      const float xl = __shfl_sync(kAll, x, l), ml = __shfl_sync(kAll, mreg, l);
      v[r] = ml + ((t & 1) ? (fz ? kNeg : -fabsf(xl)) : (fz ? fminf(xl, 0.f) : 0.f));
    }
    prune<T>(v, 2 * nl);
    const int code = lane < nl ? s.pc[lane] : 2 * lane;
    const float value = lane < nl ? s.pv[lane] : 0.f;
    __syncwarp();  // slots read before the next prune writes them
    perm = code >> 1;
    const float xs = __shfl_sync(kAll, x, perm);
    if (lane < nl) mreg = value;
    return __ballot_sync(kAll, lane < nl && !fz && (Fam::hard(xs) ^ (code & 1)));
  }

  // Bitwise SCL of a span-S node held in registers (lane l < nl: path l's
  // LLRs y) at position pos: its packed words w (uniform over the warp)
  // and perm (slot -> path; lanes >= nl keep their own index).
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
        w[i] = __ballot_sync(kAll, lane < nl() && ((wl[i] >> pr) & 1u)) ^ wr[i];
        w[i + H] = wr[i];
      }
      perm = __shfl_sync(kAll, pl, pr);
    }
  }

  // the span-S node at level d, offset off, decoded in registers
  template <int S>
  __device__ void reg_node(int d, int off) {
    const float* Xd = in_lvl(d);
    float y[S];
#pragma unroll
    for (int i = 0; i < S; ++i) y[i] = lane < nl() ? Xd[lane * S + i] : 0.f;
    int perm = lane;
    unsigned w[S];
    rnode<S>(y, off, perm, w);
#pragma unroll
    for (int i = 0; i < S; ++i)
      if (lane == (i & 31)) W[off + i] = static_cast<int>(w[i]);
    if (lane < nl()) s.P[d][lane] = perm;
    __syncwarp();
  }

  // Above 32 paths: a span-1 leaf at level d (path l's LLR at level d's
  // element l), position pos: its candidates and the prune by merge in
  // shared memory, word k of its bits warp k's ballot
  __device__ void bit_leaf(int d, int pos) {
    const float* Xd = in_lvl(d);
    const int fz = frozen(pos);
    for_paths([&](int l) {
      const float x = Xd[l];
      s.V[2 * l] = mreg + (fz ? fminf(x, 0.f) : 0.f);
      s.V[2 * l + 1] = mreg + (fz ? kNeg : -fabsf(x));
    });
    sync();
    prune_merge(1);
    if (warp < NW) {  // word k = warp: lane = slot 32 k + lane
      const int j = 32 * warp + lane;
      int bit = 0;
      if (j < nl() && !fz) {
        const int code = s.pc[j];
        bit = Fam::hard(Xd[code >> 1]) ^ (code & 1);
      }
      const unsigned b = __ballot_sync(kAll, bit);
      if (lane == 0) W[warp * m + pos] = static_cast<int>(b);
    }
    for_paths([&](int l) {
      mreg = s.pv[l];
      s.P[d][l] = s.pc[l] >> 1;
    });
    sync();
  }

  // the per-bit walk of the node at level d0 (span 2^lg), offset off0: up
  // to 32 paths the span-kRegSpan nodes in registers (a lane a path) and
  // the levels above in shared memory; above 32 paths every level in
  // shared memory, down to the span-1 leaves
  __device__ void walk_bits(int d0, int lg, int off0) {
    if constexpr (kBlock) {
      walk(d0, lg, 0, off0, [&](int, int off) { bit_leaf(d0 + lg, off); });
    } else {
      switch (lg) {
        case 1: reg_node<2>(d0, off0); return;
        case 2: reg_node<4>(d0, off0); return;
        case 3: reg_node<8>(d0, off0); return;
        default:
          walk(d0, lg - kRegLevels, kRegLevels, off0,
               [&](int, int off) { reg_node<kRegSpan>(d0 + lg - kRegLevels, off); });
      }
    }
  }

  // the `count` smallest |x| of each path over the span-len node at Xd and
  // their positions, first position on ties: by rank in (|x|, position)
  __device__ void weakest(const float* Xd, int lg, int count) {
    const int len = 1 << lg;
    for (int e = tid; e < (nl() << lg); e += NT) {
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
    sync();
  }

  // the survivor in slot j (j < nl) of a sub-block's prune: its source
  // path and candidate, and the bits its candidate flips
  struct Slot {
    int src = 0, c = 0, fm = 0, i0 = -1, i1 = -1, i2 = -1, i3 = -1;
  };
  __device__ Slot slot(int j, int lgc, int cls) const {
    Slot t;
    const int code = s.pc[j];
    t.src = code >> lgc;
    t.c = code & ((1 << lgc) - 1);
    if (cls == C_RATE1) {
      t.fm = (t.c == 1 || t.c == 3) | ((t.c == 2 || t.c == 3) << 1);
    } else if (cls == C_SPC) {
      t.fm = s.spc[(s.par[t.src] ? 8 : 0) + t.c];
    }
    if (cls != C_REP) {
      t.i0 = s.is[0][t.src];
      t.i1 = s.is[1][t.src];
      if (cls == C_SPC) {
        t.i2 = s.is[2][t.src];
        t.i3 = s.is[3][t.src];
      }
    }
    return t;
  }
  __device__ int slot_bit(const Slot& t, int cls, const float* Xd, int len, int i) const {
    if (cls == C_REP) return t.c != 0;
    const int f = ((t.fm & 1) && i == t.i0) | ((t.fm & 2) && i == t.i1) |
                  ((t.fm & 4) && i == t.i2) | ((t.fm & 8) && i == t.i3);
    return Fam::hard(Xd[t.src * len + i]) ^ f;
  }

  // the SSCL leaf rule of a pure sub-block of class cls at level d, offset off
  __device__ void sub_leaf(int d, int off, int cls) {
    const int lg = D - d, len = 1 << lg;
    const float* Xd = in_lvl(d);
    if (cls == C_RATE0) {
      for_paths([&](int l) {
        float acc = 0.f;
        for (int i = 0; i < len; ++i) acc = acc + fminf(Xd[l * len + i], 0.f);
        mreg = mreg + acc;
        s.P[d][l] = l;
      });
      for (int t = tid; t < NW * len; t += NT) W[(t >> lg) * m + off + (t & (len - 1))] = 0;
      sync();
      return;
    }
    int lgc;
    if (cls == C_REP) {
      lgc = 1;
      for_paths([&](int l) {
        float z = 0.f, o = 0.f;
        for (int i = 0; i < len; ++i) {
          const float x = Xd[l * len + i];
          z = z + fminf(x, 0.f);
          o = o + fmaxf(x, 0.f);
        }
        s.V[2 * l] = mreg + z;
        s.V[2 * l + 1] = mreg + -o;
      });
    } else if (cls == C_RATE1) {
      lgc = 2;
      weakest(Xd, lg, 2);
      for_paths([&](int l) {
        const float mt = mreg, m0 = s.ms[0][l], m1 = s.ms[1][l];
        s.V[4 * l] = mt + 0.f;
        s.V[4 * l + 1] = mt + -m0;
        s.V[4 * l + 2] = mt + -m1;
        s.V[4 * l + 3] = mt + (-m0 - m1);
      });
    } else {  // C_SPC
      lgc = 3;
      weakest(Xd, lg, 4);
      for_paths([&](int l) {
        int neg = 0;
        for (int i = 0; i < len; ++i) neg += Fam::hard(Xd[l * len + i]);
        const int odd = neg & 1;
        s.par[l] = odd;
        const float mt = mreg, m0 = s.ms[0][l];
        for (int c = 0; c < 8; ++c) {
          const int tm = s.spc[24 + c];
          float tc = 0.f;
          for (int j = 0; j < 3; ++j)
            if ((tm >> j) & 1) tc = tc + s.ms[1 + j][l];
          const float even_d = (s.spc[16 + c] ? -m0 : -0.f * m0) - tc;
          const float odd_d = -m0 - tc;
          s.V[8 * l + c] = mt + (odd ? odd_d : even_d);
        }
      });
    }
    sync();
    if constexpr (kBlock) {
      prune_merge(lgc);
    } else {
      prune_smem(nl() << lgc);
    }
    // the decision bits: a warp per (word, 32 positions), one ballot per
    // position, lane = slot 32 k + lane
    const int chunks = (len + 31) >> 5;
#pragma unroll 1
    for (int pair = warp; pair < NW * chunks; pair += NWARPS) {
      const int k = pair / chunks, i0 = (pair - k * chunks) << 5, j = 32 * k + lane;
      const bool live = j < nl();
      const Slot t = live ? slot(j, lgc, cls) : Slot{};
      for (int i = i0; i < i0 + 32 && i < len; ++i) {
        const unsigned word = __ballot_sync(kAll, live && slot_bit(t, cls, Xd, len, i));
        if (lane == (i & 31)) W[k * m + off + i] = static_cast<int>(word);
      }
    }
    for_paths([&](int l) {
      mreg = s.pv[l];
      s.P[d][l] = s.pc[l] >> lgc;
    });
    sync();
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
__global__ void __launch_bounds__(kThreads<L>)
masked_scl_chunk_kernel(const int* __restrict__ spc_tab, const float* __restrict__ llr,
                        const uint8_t* __restrict__ mask,
                        const float* __restrict__ met_in,
                        const int* __restrict__ sub_cls, int sub,
                        int* __restrict__ bits_out, int* __restrict__ perm_out,
                        float* __restrict__ met_out, int m, int list_size, int direct) {
  using Team = Walker<L, Fam>;
  constexpr int NW = kWords<L>, NT = Team::NT, NWARPS = Team::NWARPS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nl = list_size;
  const bool dir = direct;
  float* X = reinterpret_cast<float*>(smem);  // [nl][2M] LLR pyramid, or its levels >= 1
  int* W = reinterpret_cast<int*>(X + (dir ? 1 : 2) * nl * m);  // [NW][M] packed bits
  const int n_words = (m + 31) >> 5;
  unsigned* Fm = reinterpret_cast<unsigned*>(W + NW * m);  // [M / 32] mask bits
  uint8_t* Cls = reinterpret_cast<uint8_t*>(Fm + n_words);  // [M / sub]
  __shared__ Shared<L> s;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const float* in = llr + (size_t)b * nl * m;
  if (!dir)
    for (int t = tid; t < nl * m; t += NT) X[t] = in[t];
  for (int w = warp; w < n_words; w += NWARPS) {
    const int pos = 32 * w + lane;
    const unsigned word = __ballot_sync(kAll, pos < m && mask[pos] != 0);
    if (lane == 0) Fm[w] = word;
  }
  const int n_sub = sub ? m / sub : 0;
  for (int i = tid; i < n_sub; i += NT) Cls[i] = static_cast<uint8_t>(sub_cls[i]);
  if (tid < 32) s.spc[tid] = spc_tab[tid];
  for (int l = tid; l < L; l += NT)
    for (int d = 0; d < kMaxLevels; ++d) s.P[d][l] = l;
  if (tid == 0) {
    s.bad = 0;
    s.live = 0;
    s.best = kNoCode;
  }

  Team wk{s, dir ? in : X, dir ? X : X + nl * m, W, Fm, Cls, m, log2i(m), tid, lane, warp, nl,
          0.f};
  wk.sync();
  wk.for_paths([&](int l) { wk.mreg = met_in[(size_t)b * nl + l]; });
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

  // bits [B, M] (one word), or [B, ceil(nl / 32), M]
  const int out_words = NW == 1 ? 1 : (nl + 31) >> 5;
  for (int i = tid; i < out_words * m; i += NT) bits_out[(size_t)b * out_words * m + i] = W[i];
  wk.for_paths([&](int l) {
    perm_out[(size_t)b * nl + l] = s.P[0][l];
    met_out[(size_t)b * nl + l] = wk.mreg;
  });
}

template <int L, class Fam>
int launch(const int* spc_tab, const float* llr, const uint8_t* mask, const float* met,
           const int* sub_cls, int sub, int* bits, int* perm, float* met_out, int m,
           int list_size, int batch, cudaStream_t stream) {
  // level 0 is read from device memory when the whole pyramid does not fit
  const bool direct = dynamic_bytes<L>(list_size, m, sub, false) > kMaxDynamic;
  const size_t smem = dynamic_bytes<L>(list_size, m, sub, direct);
  if (smem > kMaxDynamic) return -2;
  auto kernel = masked_scl_chunk_kernel<L, Fam>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int threads = kThreads<L>;
  kernel<<<batch, threads, smem, stream>>>(spc_tab, llr, mask, met, sub_cls, sub, bits, perm,
                                           met_out, m, list_size, static_cast<int>(direct));
  return static_cast<int>(cudaGetLastError());
}

template <class Fam>
int dispatch(const int* spc_tab, const float* llr, const uint8_t* mask, const float* met,
             const int* sub_cls, int sub, int* bits, int* perm, float* met_out,
             int list_size, int m, int batch, cudaStream_t stream) {
#define K7_LAUNCH(CAP)                                                                    \
  launch<CAP, Fam>(spc_tab, llr, mask, met, sub_cls, sub, bits, perm, met_out, m, \
                          list_size, batch, stream)
  if (list_size <= 4) return K7_LAUNCH(4);
  if (list_size <= 32) return K7_LAUNCH(32);
  if (list_size <= 64) return K7_LAUNCH(64);
  return K7_LAUNCH(128);
#undef K7_LAUNCH
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
  if (list_size < 1 || list_size > 128) return -1;
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
