// Fast-SSC subtree decoder (K3): one call decodes a whole span <= 2048
// subtree of the Fast-SSC code tree for a batch of codewords, in float32,
// in bf16 or in the saturating char family.
//
// Replaces: polar_codes_tpu/ops/fastssc_kernel.py, build_fs_hybrid_decode,
// subtree_call.kernel (the root call, u8 hard bits out) and
// subtree_call.kernel_bits (a call below the glue, bipolar state out),
// whose body _emit/_leaf is the f/g recursion with the Rate0/Rate1/Rep/SPC
// leaf shortcuts and the ZeroR shortcut (left child all-frozen: g becomes
// b + a).
//
// Interface, in the TPU kernel's batch-minor layout:
//   llr [span, B] (f32, bf16, or int8 for the char family)
//     -> root: bits [span, B] u8;
//        below the glue: bipolar state [span, B] (+-1, f32, bf16 or int8)
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
// Families (fastssc_kernel.py _Float, _Bf16, _Char):
//   float: f is the sign-XOR min-sum on the raw bits, g = b +- a, ZeroR a
//          plain b + a, hard decision by the sign bit (-0.0 decides 1);
//   bf16:  the TPU kernel's _Ops for a 16-bit float state: values held in
//          bf16 in shared memory and device memory, in f32 in registers;
//          f the product form (exact on the stored values, the float f's
//          value bit for bit), g and ZeroR rounded to bf16 (nearest even)
//          once each, as a store rounds them; leaves in f32 on the stored
//          values, as the float family's (REP summed in span order,
//          decisions by the sign bit);
//   char:  integer LLRs held in int16 in shared memory and int32 in
//          registers, f in product form (0 at zeros), f, g and ZeroR
//          clipped to [-127, 127], hard decision llr < 0 (0 decides 0).
//          The TPU kept these integers in bf16 only to pack its vector
//          registers. (f's clip acts only on an int8 input of -128, which
//          the simulator's quantiser never produces; it keeps every value
//          an int8 for the glue.)
// The float REP sum runs sequentially in span order, from +0.0, as the
// plain version adds; the char REP sum is an exact int32 sum (any order).
// The SPC leaf counts negative hard decisions for the parity (ballots)
// and flips the lowest index among equal minimum magnitudes (a warp
// minimum over the magnitude's bits, then over the indices that hold
// it). The build disables FMA contraction, so kernel and plain version
// agree bit for bit.
//
// What bounds it on an H100: latency, not bytes. At B = 2048, N = 1024 a
// float call moves 8 MiB in and 2 MiB out (about 3 us at 3.35 TB/s), but
// each codeword is a chain of 273 dependent ops of the schedule (pcsim's
// (1024, 512) code), most of them on nodes of 4 to 32 positions. The
// design shortens the chain:
//   - one warp decodes one codeword: the block's one __syncthreads before
//     the decode comes after the prologue, where the block stages the
//     schedule into shared memory (one packed 32-bit word an op, and each
//     node's kind in a heap of the tree) and loads its 8 codewords' LLRs
//     together (8 neighbouring codewords a row, so a float row is one
//     32-byte sector, 16 rows a thread in flight); a second __syncthreads
//     before the block stores its codewords' results together;
//   - a node of up to 1024 positions, with everything below it, runs in
//     registers as one step (a register subtree; at span <= 1024 the
//     whole tree): lane l holds positions 32 j + l of a node of 32 kP
//     positions in x[j], so the F, G and ZeroR of nodes of 64 or more run
//     inside the lane, and their two children run one after the other
//     through one copy of the code of the level below (a loop over the
//     halves). A node of 32 positions runs with lane l holding position
//     l: one LLR register a tree level and one bit; F, G and ZeroR are a
//     shuffle and the f/g arithmetic, COMBINE a shuffle and an XOR. Its
//     walk is the heap of 32 positions unrolled at compile time (every
//     shuffle distance, lane range and level a constant), reading only
//     the nodes' kinds, all 63 of them loaded at its start. Leaves are
//     lane-parallel (REP: the char sum a warp reduction, the float sum
//     broadcast shuffles added in span order; SPC: ballots for the parity,
//     a warp minimum for the weakest position). No __syncwarp inside;
//   - above 1024 positions (span 2048) the nodes run from shared memory,
//     op by op, fetching the next op's word while they run: a loop over
//     the lanes in batches of up to 8 items a lane, loads before stores
//     and no guard (lengths are multiples of 32), then a __syncwarp. The
//     level rows for them are kept for every span: each codeword's LLRs
//     [2 * span] (level d at row 2 (span - len), len = span >> d; f32, or
//     int16 in char) and bits [span] u8 in shared memory, 9 KiB a
//     codeword at span 1024 in f32;
//   - 128 registers a thread at most, so two blocks of 8 warps fit an SM
//     and B = 2048 runs in one wave.
// Blocks past the batch hold idle warps; they skip the schedule.
// Measured (chip_profile.py k3_ops; NVIDIA H100 80GB HBM3, 700 W), at
// B = 2048, span 1024: ~0.034 ms (float32) and ~0.031 ms (char) a call on
// the device, from 0.096 and 0.120 for the block of 8 codewords that
// walked every op in shared memory with a __syncthreads after each. On
// the way: an interpreter of single ops in registers (op words dispatched
// at run time) reached only 0.073 and 0.078, its branches costing more
// than the shared-memory round trips they saved; the unrolled 32-position
// walk with nodes of 64 and more in shared memory 0.043 and 0.049; nodes
// of 64 in registers 0.037 and 0.038.
//
// C interface (ctypes; every pointer and the stream are void*):
//   int fastssc_subtree(const int *ops, int n_ops, const void *llr,
//                       void *out, int family, int root, int span,
//                       int batch, cudaStream_t stream)
// family: 0 float32, 1 char (int8), 2 bf16.
// Returns the cudaGetLastError() of the launch (or of the shared-memory
// attribute call), or -1 for a span or family the kernel does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifdef K3_PROFILE
// Cycles per op kind, summed over every warp (one codeword's chain) by its
// lane 0 with a device-memory atomic per op, and their counts at slot + 32
// (chip_profile.py builds with -DK3_PROFILE and reads them with
// fastssc_subtree_profile). Slots: 0-3 F, G, ZERO_R, COMBINE and 4-7
// RATE0, RATE1, REP, SPC leaves in registers, each from the op before it
// (a node of 64 or more: its in-lane F, G, ZeroR over the kP values a
// lane, its COMBINE of bit words); 8-15 the same kinds from shared memory
// (nodes of more than 1024); 16 the prologue up to the block barrier; 17
// the whole schedule; 18 the barrier and the store; 19 the op loop's own
// work (fetches, register subtree entry, its bits' store).
// The probes add their clock reads and atomics to each op.
__device__ unsigned long long k3_prof[64];
struct OpClock {
  long long t = 0;
  __device__ void reset() { t = clock64(); }
  __device__ void add(int slot, long long since, int lane) {
    if (lane == 0) {
      atomicAdd(&k3_prof[slot], static_cast<unsigned long long>(clock64() - since));
      atomicAdd(&k3_prof[slot + 32], 1ull);
    }
  }
  __device__ void tick(int slot, int lane) {
    add(slot, t, lane);
    t = clock64();
  }
  __device__ long long now() const { return clock64(); }
};
extern "C" int fastssc_subtree_profile(unsigned long long* out) {
  const cudaError_t err = cudaMemcpyFromSymbol(out, k3_prof, sizeof(k3_prof));
  const unsigned long long zero[64] = {};
  return static_cast<int>(err != cudaSuccess ? err
                                             : cudaMemcpyToSymbol(k3_prof, zero, sizeof(zero)));
}
#else
struct OpClock {
  __device__ void reset() {}
  __device__ void add(int, long long, int) {}
  __device__ void tick(int, int) {}
  __device__ long long now() const { return 0; }
};
#endif

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // codewords a block, one warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSpan = 2048;
constexpr int kReg = 1024;  // nodes of at most kReg positions run in registers
constexpr int kMaxDevices = 64;
enum { OP_F = 0, OP_G = 1, OP_ZERO_R = 2, OP_COMBINE = 3, OP_LEAF = 4 };  // schedule ops
// The kernel's op word: code | log2(length) << 3 | flags | offset << 12,
// code one of C_F .. C_SPC (a leaf's code is C_R0 + its kind).
enum { C_F = 0, C_G = 1, C_Z = 2, C_C = 3, C_R0 = 4, C_R1 = 5, C_REP = 6, C_SPC = 7 };
constexpr unsigned W_REG = 1u << 7;   // a node of a register subtree
constexpr unsigned W_EXIT = 1u << 8;  // the register subtree's last op
constexpr unsigned kNoKey = 0xffffffffu;  // above every magnitude key

struct FloatFamily {
  using In = float;
  using State = float;
  using Reg = float;
  // a state value in a register and back
  __device__ static float load(float x) { return x; }
  __device__ static float store(float x) { return x; }
  __device__ static float f(float a, float b) {
    const unsigned ai = __float_as_uint(a), bi = __float_as_uint(b);
    const unsigned sign = (ai ^ bi) & 0x80000000u;
    const unsigned mag = min(ai & 0x7fffffffu, bi & 0x7fffffffu);
    return __uint_as_float(sign | mag);
  }
  __device__ static float g(float a, float b, int bit) { return bit ? b - a : b + a; }
  __device__ static float zero_r(float a, float b) { return b + a; }
  __device__ static int hard(float x) { return static_cast<int>(__float_as_uint(x) >> 31); }
  // |x|'s bits, ordered as |x| (no NaN arises)
  __device__ static unsigned key(float x) { return __float_as_uint(x) & 0x7fffffffu; }
  __device__ static float bipolar(int bit) { return bit ? -1.f : 1.f; }
  // REP over a node of kLen registers at lanes o..o+kLen-1: in span order
  template <int kLen>
  __device__ static float rep_reg(float v, int o, bool) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kLen; ++i) acc = acc + __shfl_sync(kFull, v, o + i);
    return acc;
  }
  // REP over 32 kP positions, lane l holding 32 j + l (x[j]): in span order
  template <int kP>
  __device__ static float rep_wide(const float (&x)[kP]) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < kP; ++j) {
#pragma unroll 8
      for (int i = 0; i < 32; ++i) acc = acc + __shfl_sync(kFull, x[j], i);
    }
    return acc;
  }
  // REP over a node of len >= 32 in shared memory (state type T, read as
  // f32 by Fam::load): lane 0 in span order
  template <class Fam, class T>
  __device__ static float rep_smem_of(const T* X, int len, int lane) {
    float acc = 0.f;
    if (lane == 0) {
      int i = 0;
      for (; i + 8 <= len; i += 8) {
        float t[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) t[u] = Fam::load(X[i + u]);
#pragma unroll
        for (int u = 0; u < 8; ++u) acc = acc + t[u];
      }
      for (; i < len; ++i) acc = acc + Fam::load(X[i]);
    }
    return __shfl_sync(kFull, acc, 0);
  }
  __device__ static float rep_smem(const float* X, int len, int lane) {
    return rep_smem_of<FloatFamily>(X, len, lane);
  }
};

// bf16 state (the TPU kernel's _Ops for a 16-bit float state): values in
// registers as f32, each f, g and ZeroR result rounded to bf16 once, as a
// store rounds it (f is exact: its result is one of the inputs'
// magnitudes); leaves compute in f32 on the stored values, the REP sum in
// span order, decisions by the sign bit: the float family's leaves.
struct Bf16Family : FloatFamily {
  using In = __nv_bfloat16;
  using State = __nv_bfloat16;
  using Reg = float;
  __device__ static float round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
  __device__ static float load(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 store(float x) { return __float2bfloat16_rn(x); }
  __device__ static float g(float a, float b, int bit) { return round(bit ? b - a : b + a); }
  __device__ static float zero_r(float a, float b) { return round(b + a); }
  __device__ static __nv_bfloat16 bipolar(int bit) { return __float2bfloat16_rn(bit ? -1.f : 1.f); }
  __device__ static float rep_smem(const __nv_bfloat16* X, int len, int lane) {
    return rep_smem_of<Bf16Family>(X, len, lane);
  }
};

struct CharFamily {
  using In = int8_t;
  using State = short;
  using Reg = int;
  __device__ static int load(short x) { return x; }
  __device__ static short store(int x) { return static_cast<short>(x); }
  __device__ static int clip(int v) { return max(-127, min(127, v)); }
  // sign(a) sign(b) min(|a|, |b|) clipped to 127 (only a -128 input
  // needs it): 0 where a or b is 0, as the product form gives
  __device__ static int f(int a, int b) {
    const int m = min(min(abs(a), abs(b)), 127);
    return (a ^ b) < 0 ? -m : m;
  }
  __device__ static int g(int a, int b, int bit) { return clip(bit ? b - a : b + a); }
  __device__ static int zero_r(int a, int b) { return clip(b + a); }
  __device__ static int hard(int x) { return x < 0; }
  __device__ static unsigned key(int x) { return static_cast<unsigned>(abs(x)); }
  __device__ static int8_t bipolar(int bit) { return bit ? -1 : 1; }
  template <int kLen>
  __device__ static int rep_reg(int v, int, bool mine) {  // exact: any order
    return __reduce_add_sync(kFull, mine ? v : 0);
  }
  template <int kP>
  __device__ static int rep_wide(const int (&x)[kP]) {
    int acc = 0;
#pragma unroll
    for (int j = 0; j < kP; ++j) acc += x[j];
    return __reduce_add_sync(kFull, acc);
  }
  __device__ static int rep_smem(const short* X, int len, int lane) {
    int acc = 0;
    for (int i = lane; i < len; i += 32) acc += X[i];
    return __reduce_add_sync(kFull, acc);
  }
};

// The schedule's op `op` as the kernel's word. A node of at most
// min(span, kReg) positions belongs to a register subtree; the subtree's
// last op (its root's COMBINE, or its root leaf) is marked.
__device__ __forceinline__ unsigned pack_op(const int* op, int span) {
  const int code = op[0], len = op[2], off = op[3];
  const int c = code == OP_LEAF ? C_R0 + op[4] : code;
  const int lr = span < kReg ? span : kReg;
  unsigned w = c | (31 - __clz(len)) << 3 | static_cast<unsigned>(off) << 12;
  if (len <= lr) {
    w |= W_REG;
    if (len == lr && (c == C_C || c >= C_R0)) w |= W_EXIT;
  }
  return w;
}

// v, held in a register: the compiler may not recompute it in the loop
// (it would re-read the thread index with S2R on the op chain)
__device__ __forceinline__ int opaque(int v) {
#ifdef __CUDA_ARCH__
  asm volatile("mov.b32 %0, %1;" : "=r"(v) : "r"(v));
#endif
  return v;
}

// Register subtrees. The nodes of the span's tree are numbered as a heap
// (node P's children 2P and 2P + 1, the root 1; below span 32 as the
// heap of 32 positions, where the root is node 32 / span), and `kinds`
// holds each node's code: C_F for a branch, C_Z for a branch whose left
// child is all-frozen, C_R0 + kind for a leaf (the prologue writes it
// from the schedule). A node of 32 positions runs with lane l holding its
// position l: v[d] the lane's LLR at the tree level of nodes of 32 >> d
// positions, `bit` its decision so far. The walk below it unrolls the
// heap at compile time, so every shuffle distance, lane range and level is
// a constant and only the kinds are read; node P of L positions under the
// 32-position node R is heap node P + (R - 1) 32 / L.
template <class Fam, int L, int P>
__device__ __forceinline__ void reg_leaf(int kind, typename Fam::Reg x, int& bit, int lane,
                                         OpClock& clk) {
  constexpr int kO = (P - 32 / L) * L;  // the node's first lane
  const bool mine = static_cast<unsigned>(lane - kO) < static_cast<unsigned>(L);
  if (kind == C_R0) {
    if (mine) bit = 0;
  } else if (kind == C_R1) {
    if (mine) bit = Fam::hard(x);
  } else if constexpr (L >= 2) {
    if (kind == C_REP) {
      const int hb = Fam::hard(Fam::template rep_reg<L>(x, kO, mine));
      if (mine) bit = hb;
    } else {  // C_SPC
      const int hb = Fam::hard(x);
      const int odd = __popc(__ballot_sync(kFull, mine && hb)) & 1;
      const unsigned key = mine ? Fam::key(x) : kNoKey;
      const unsigned weakest = __reduce_min_sync(kFull, key);
      const int at = __ffs(__ballot_sync(kFull, key == weakest)) - 1;  // the lowest index
      if (mine) bit = hb ^ (odd && lane == at);
    }
  }
  clk.tick(kind, lane);
}

// Node P of L positions, its LLRs in v[D]: F (or ZeroR) into v[D + 1],
// the left child, G, the right child, COMBINE; or its leaf. F and G write
// the next level on every lane: outside the node's child that level holds
// nodes that are finished or not yet reached, whose values nothing reads.
// Bits change only inside the node.
template <class Fam, int L, int P>
__device__ __forceinline__ void reg_node(const uint32_t (&kw)[16], typename Fam::Reg (&v)[6],
                                         int& bit, int lane, OpClock& clk) {
  using R = typename Fam::Reg;
  constexpr int D = (L == 32 ? 0 : L == 16 ? 1 : L == 8 ? 2 : L == 4 ? 3 : L == 2 ? 4 : 5);
  const int kind = (kw[P >> 2] >> (8 * (P & 3))) & 0xff;
  if constexpr (L >= 2) {
    if (kind == C_F || kind == C_Z) {
      constexpr int H = L / 2, kO = (P - 32 / L) * L;
      const bool left = static_cast<unsigned>(lane - kO) < static_cast<unsigned>(H);
      if (kind == C_F) {
        v[D + 1] = Fam::f(v[D], __shfl_down_sync(kFull, v[D], H));
        clk.tick(C_F, lane);
        reg_node<Fam, H, 2 * P>(kw, v, bit, lane, clk);
        const R a = __shfl_up_sync(kFull, v[D], H);
        v[D + 1] = Fam::g(a, v[D], __shfl_up_sync(kFull, bit, H));
        clk.tick(C_G, lane);
      } else {
        v[D + 1] = Fam::zero_r(__shfl_up_sync(kFull, v[D], H), v[D]);
        if (left) bit = 0;  // the all-frozen left child's bits
        clk.tick(C_Z, lane);
      }
      reg_node<Fam, H, 2 * P + 1>(kw, v, bit, lane, clk);
      const int right = __shfl_down_sync(kFull, bit, H);
      if (left) bit ^= right;
      clk.tick(C_C, lane);
      return;
    }
  }
  reg_leaf<Fam, L, P>(kind, v[D], bit, lane, clk);
}

// The kinds of the 32-position node `root` and its descendants, as the
// 64 bytes of their own heap (byte P: node P + (root - 1) 32 / L), read
// at once: its nodes of L positions lie together in `kinds`, 32 / L of
// them from root 32 / L.
__device__ __forceinline__ void load_kinds(const uint8_t* kinds, int root, uint32_t (&kw)[16]) {
  const uint4 l1a = *reinterpret_cast<const uint4*>(kinds + 32 * root);
  const uint4 l1b = *reinterpret_cast<const uint4*>(kinds + 32 * root + 16);
  const uint4 l2 = *reinterpret_cast<const uint4*>(kinds + 16 * root);
  const uint2 l4 = *reinterpret_cast<const uint2*>(kinds + 8 * root);
  kw[0] = static_cast<uint32_t>(kinds[root]) << 8 |
          static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(kinds + 2 * root)) << 16;
  kw[1] = *reinterpret_cast<const uint32_t*>(kinds + 4 * root);
  kw[2] = l4.x;
  kw[3] = l4.y;
  kw[4] = l2.x;
  kw[5] = l2.y;
  kw[6] = l2.z;
  kw[7] = l2.w;
  kw[8] = l1a.x;
  kw[9] = l1a.y;
  kw[10] = l1a.z;
  kw[11] = l1a.w;
  kw[12] = l1b.x;
  kw[13] = l1b.y;
  kw[14] = l1b.z;
  kw[15] = l1b.w;
}

// The 32-position node `root` on LLRs x (lane l: position l): its bits.
template <class Fam>
__device__ __forceinline__ int reg32(const uint8_t* kinds, int root, typename Fam::Reg x,
                                     int lane, OpClock& clk) {
  uint32_t kw[16];
  load_kinds(kinds, root, kw);
  typename Fam::Reg v[6] = {x};
  int bit = 0;
  reg_node<Fam, 32, 1>(kw, v, bit, lane, clk);
  return bit;
}

// A leaf of 32 kP positions, lane l holding positions 32 j + l (x[j]):
// their bits, bit j for x[j].
template <class Fam, int kP>
__device__ __forceinline__ unsigned reg_leaf_wide(int kind, const typename Fam::Reg (&x)[kP],
                                                  int lane, OpClock& clk) {
  unsigned bits = 0;
#pragma unroll
  for (int j = 0; j < kP; ++j) bits |= static_cast<unsigned>(Fam::hard(x[j])) << j;
  if (kind == C_R0) {
    bits = 0;
  } else if (kind == C_REP) {
    constexpr unsigned kAll = kP == 32 ? 0xffffffffu : (1u << kP) - 1;
    bits = Fam::hard(Fam::template rep_wide<kP>(x)) ? kAll : 0u;
  } else if (kind == C_SPC) {  // a lane's positions in order: strict <, the first wins a tie
    unsigned best = kNoKey;
    int at = 0;
#pragma unroll
    for (int j = 0; j < kP; ++j) {
      const unsigned k = Fam::key(x[j]);
      if (k < best) {
        best = k;
        at = 32 * j + lane;
      }
    }
    const int odd = __popc(__ballot_sync(kFull, __popc(bits) & 1)) & 1;
    const unsigned weakest = __reduce_min_sync(kFull, best);
    if (odd) {
      const int flip = __reduce_min_sync(kFull, best == weakest ? at : 0x7fffffff);
      if ((flip & 31) == lane) bits ^= 1u << (flip >> 5);
    }
  }
  clk.tick(kind, lane);
  return bits;
}

// The node `node` of 32 kP positions, lane l holding positions 32 j + l
// in x[j]: its bits, bit j for position 32 j + l. F, G and ZeroR run
// inside the lane; the two children run one after the other through one
// copy of the walk below (a loop over the halves), so each level's code
// exists once. The register subtree's root has 32 top positions a lane:
// it loads them from shared memory (X), and the levels above it pass
// through to it.
template <class Fam, int kP>
__device__ __forceinline__ unsigned reg_tree(const uint8_t* kinds, int node,
                                             typename Fam::Reg (&x)[kP], int top,
                                             const typename Fam::State* X, int lane,
                                             OpClock& clk) {
  using R = typename Fam::Reg;
  if (kP == top) {
#pragma unroll
    for (int j = 0; j < kP; ++j) x[j] = Fam::load(X[32 * j + lane]);
  }
  if constexpr (kP == 1) {
    return reg32<Fam>(kinds, node, x[0], lane, clk);
  } else {
    constexpr int H = kP / 2;
    const bool here = kP <= top;
    const int kind = here ? kinds[node] : C_F;
    if (kind >= C_R0) return reg_leaf_wide<Fam, kP>(kind, x, lane, clk);
    unsigned left = 0, right = 0;
    R y[H];
#pragma unroll 1
    for (int half = here && kind == C_Z; half < (here ? 2 : 1); ++half) {
      if (here) {
#pragma unroll
        for (int j = 0; j < H; ++j)
          y[j] = half == 0      ? Fam::f(x[j], x[j + H])
                 : kind == C_Z ? Fam::zero_r(x[j], x[j + H])
                               : Fam::g(x[j], x[j + H], (left >> j) & 1);
        clk.tick(half == 0 ? C_F : kind == C_Z ? C_Z : C_G, lane);
      }
      const unsigned b = reg_tree<Fam, H>(kinds, here ? 2 * node + half : node, y, top, X, lane,
                                          clk);
      if (half == 0) {
        left = b;
      } else {
        right = b;
      }
    }
    if (!here) return left;
    clk.tick(C_C, lane);
    return (left ^ right) | right << H;
  }
}

// A whole register subtree, node `root` of lr = min(span, kReg)
// positions, first position `base`: its LLRs from the level of nodes of
// lr positions, its bits into shared memory.
template <class Fam>
__device__ __forceinline__ void reg_subtree(const uint8_t* kinds, int root,
                                            const typename Fam::State* x, uint8_t* bits,
                                            int span, int base, int lane, OpClock& clk) {
  using R = typename Fam::Reg;
  const int lr = span < kReg ? span : kReg;
  const typename Fam::State* X = x + 2 * (span - lr);
  if (lr >= 32) {
    R xt[32];
    const unsigned w = reg_tree<Fam, 32>(kinds, root, xt, lr / 32, X, lane, clk);
#pragma unroll
    for (int j = 0; j < 32; ++j)
      if (32 * j < lr) bits[base + 32 * j + lane] = static_cast<uint8_t>((w >> j) & 1);
    return;
  }
  // a span below 32: its root is heap node 32 / span
  const R x0 = lane < lr ? Fam::load(X[lane]) : R(0);
  uint32_t kw[16];
  load_kinds(kinds, 1, kw);
  R v[6] = {};
  int bit = 0;
  switch (lr) {
    case 16: v[1] = x0; reg_node<Fam, 16, 2>(kw, v, bit, lane, clk); break;
    case 8: v[2] = x0; reg_node<Fam, 8, 4>(kw, v, bit, lane, clk); break;
    case 4: v[3] = x0; reg_node<Fam, 4, 8>(kw, v, bit, lane, clk); break;
    case 2: v[4] = x0; reg_node<Fam, 2, 16>(kw, v, bit, lane, clk); break;
    default: v[5] = x0; reg_node<Fam, 1, 32>(kw, v, bit, lane, clk); break;
  }
  if (lane < lr) bits[base + lane] = static_cast<uint8_t>(bit);
}

// kU items a lane of a branch op of half-length h >= 1024 on the node's
// LLRs X (level row), its children's level Y = X + 2h and its bits B:
// item t = first + 32 u. Loads first, then stores (X, Y and the two
// halves of B never overlap).
template <class Fam, int kU>
__device__ __forceinline__ void big_batch(int code, const typename Fam::State* X,
                                          typename Fam::State* Y, uint8_t* B, int h,
                                          int first) {
  using R = typename Fam::Reg;
  using S = typename Fam::State;
  if (code == C_C) {
    uint8_t l[kU], r[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      l[u] = B[first + 32 * u];
      r[u] = B[first + 32 * u + h];
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) B[first + 32 * u] = l[u] ^ r[u];
    return;
  }
  R a[kU], b[kU];
  int l[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    a[u] = Fam::load(X[first + 32 * u]);
    b[u] = Fam::load(X[first + 32 * u + h]);
    l[u] = code == C_G ? B[first + 32 * u] : 0;
  }
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int t = first + 32 * u;
    if (code == C_F) {
      Y[t] = Fam::store(Fam::f(a[u], b[u]));
    } else if (code == C_G) {
      Y[t] = Fam::store(Fam::g(a[u], b[u], l[u]));
    } else {
      Y[t] = Fam::store(Fam::zero_r(a[u], b[u]));
      B[t] = 0;  // the all-frozen left child's bits
    }
  }
}

// An op outside the register subtrees: a branch op or a leaf of more
// than kReg positions (h >= 1024, a multiple of 256).
template <class Fam>
__device__ __forceinline__ void big_op(unsigned w, typename Fam::State* x, uint8_t* bits,
                                       int span, int lane) {
  using R = typename Fam::Reg;
  using S = typename Fam::State;
  const int code = w & 7, len = 1 << ((w >> 3) & 15), off = static_cast<int>(w >> 12);
  S* X = x + 2 * (span - len);
  uint8_t* B = bits + off;
  if (code <= C_C) {
    const int h = len >> 1;
    S* Y = X + len;
    for (int first = lane; first < h; first += 256) big_batch<Fam, 8>(code, X, Y, B, h, first);
    return;
  }
  if (code == C_R0) {
    for (int i = lane; i < len; i += 32) B[i] = 0;
  } else if (code == C_R1) {
    for (int i = lane; i < len; i += 32) B[i] = static_cast<uint8_t>(Fam::hard(Fam::load(X[i])));
  } else if (code == C_REP) {
    const int hb = Fam::hard(Fam::rep_smem(X, len, lane));
    for (int i = lane; i < len; i += 32) B[i] = static_cast<uint8_t>(hb);
  } else {  // C_SPC: each lane scans its positions in order (strict <: the first wins a tie)
    int par = 0, at = 0x7fffffff;
    unsigned best = kNoKey;
    for (int i = lane; i < len; i += 32) {
      const R v = Fam::load(X[i]);
      par ^= Fam::hard(v);
      const unsigned k = Fam::key(v);
      if (k < best) {
        best = k;
        at = i;
      }
    }
    const int odd = __popc(__ballot_sync(kFull, par)) & 1;
    const unsigned weakest = __reduce_min_sync(kFull, best);
    const int flip = odd ? __reduce_min_sync(kFull, best == weakest ? at : 0x7fffffff) : -1;
    for (int i = lane; i < len; i += 32)
      B[i] = static_cast<uint8_t>(Fam::hard(Fam::load(X[i])) ^ (i == flip));
  }
}

template <class Fam, bool kRoot>
__global__ void __launch_bounds__(kThreads, 2)
fastssc_kernel(const int* __restrict__ ops_g, int n_ops,
               const typename Fam::In* __restrict__ llr, void* __restrict__ out, int span,
               int batch, int ops_bytes, int cw_bytes) {
  using S = typename Fam::State;
  extern __shared__ __align__(16) unsigned char smem[];
  OpClock clk;
  clk.reset();
  // prologue: the schedule, each register subtree's node kinds and last
  // op, and the block's codewords into shared memory
  unsigned* ops = reinterpret_cast<unsigned*>(smem);
  const int lr = span < kReg ? span : kReg, lg_lr = 31 - __clz(lr);  // register subtrees
  const int kspan = span < 32 ? 32 : span;  // the heap's span
  uint8_t* kinds = smem + ((n_ops * 4 + 15) & ~15);  // [2 kspan]: each node's code
  int* exits = reinterpret_cast<int*>(kinds + ((2 * kspan + 15) & ~15));  // [span / lr]
  for (int k = threadIdx.x; k < n_ops; k += kThreads) {
    const unsigned w = pack_op(ops_g + 5 * k, span);
    const int code = w & 7, off = static_cast<int>(w >> 12);
    ops[k] = w;
    if (code != C_G && code != C_C)  // F, ZeroR and the leaves name their node
      kinds[(kspan + off) >> ((w >> 3) & 15)] = static_cast<uint8_t>(code);
    if (w & W_EXIT) exits[off >> lg_lr] = k;
  }
  const int b0 = blockIdx.x * kWarps;
  {  // kLoads rows a thread in flight at once: element t is row t / 8, codeword t % 8
    constexpr int kLoads = 16;
    const int c = threadIdx.x % kWarps, b = b0 + c;
    S* xc = reinterpret_cast<S*>(smem + ops_bytes + c * cw_bytes);
    const typename Fam::In* src = llr + (b < batch ? b : batch - 1);
    for (int s0 = threadIdx.x / kWarps; s0 < span; s0 += kLoads * (kThreads / kWarps)) {
      S v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int s = s0 + u * (kThreads / kWarps);
        if (s < span) v[u] = static_cast<S>(src[static_cast<size_t>(s) * batch]);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int s = s0 + u * (kThreads / kWarps);
        if (s < span) xc[s] = v[u];
      }
    }
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = opaque(threadIdx.x & 31);
  clk.tick(16, lane);
  const long long sched_start = clk.now();
  S* x = reinterpret_cast<S*>(smem + ops_bytes + warp * cw_bytes);
  uint8_t* bits = reinterpret_cast<uint8_t*>(x + 2 * span);
  if (b0 + warp < batch) {
    int k = 0;
    unsigned w = ops[0];
    while (k < n_ops) {
      if (w & W_REG) {  // a register subtree's first op: the whole subtree
        const int off = static_cast<int>(w >> 12);
        k = exits[off >> lg_lr] + 1;
        const unsigned next = ops[k < n_ops ? k : 0];
        clk.tick(19, lane);  // the loop's own work
        reg_subtree<Fam>(kinds, (kspan + off) >> lg_lr, x, bits, span, off, lane, clk);
        __syncwarp();
        clk.tick(19, lane);
        w = next;
      } else {
        const unsigned next = ops[k + 1 < n_ops ? k + 1 : 0];
        clk.tick(19, lane);
        big_op<Fam>(w, x, bits, span, lane);
        __syncwarp();
        clk.tick(8 + (w & 7), lane);
        ++k;
        w = next;
      }
    }
    clk.add(17, sched_start, lane);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < span * kWarps; t += kThreads) {
    const int s = t / kWarps, c = t % kWarps, b = b0 + c;
    if (b >= batch) continue;
    const uint8_t bit =
        reinterpret_cast<const uint8_t*>(smem + ops_bytes + c * cw_bytes)[2 * span * sizeof(S) + s];
    const size_t at = static_cast<size_t>(s) * batch + b;
    if (kRoot) {
      static_cast<uint8_t*>(out)[at] = bit;
    } else {
      static_cast<typename Fam::In*>(out)[at] = Fam::bipolar(bit);
    }
  }
  clk.reset();  // (idle warps: from here)
  clk.tick(18, lane);
}

template <class Fam, bool kRoot>
int launch(const int* ops, int n_ops, const void* llr, void* out, int span, int batch,
           cudaStream_t stream) {
  // the op words, the nodes' kinds and the register subtrees' last ops
  const int kspan = span < 32 ? 32 : span, slots = span < kReg ? 1 : span / kReg;
  const int ops_bytes = ((n_ops * 4 + 15) & ~15) + ((2 * kspan + 15) & ~15) +
                        ((slots * 4 + 15) & ~15);
  // a codeword's LLR levels and bits, padded so that the block's
  // codewords start in different banks
  const int cw_bytes = ((2 * span * static_cast<int>(sizeof(typename Fam::State)) + span + 15) &
                        ~15) + 16;
  const size_t smem = static_cast<size_t>(ops_bytes) + static_cast<size_t>(kWarps) * cw_bytes;
  auto kernel = fastssc_kernel<Fam, kRoot>;
  static int raised[kMaxDevices] = {};  // the kernel's shared-memory limit set per card
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices || static_cast<int>(smem) > raised[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) raised[dev] = static_cast<int>(smem);
  }
  const int blocks = (batch + kWarps - 1) / kWarps;
  kernel<<<blocks, kThreads, smem, stream>>>(
      ops, n_ops, static_cast<const typename Fam::In*>(llr), out, span, batch, ops_bytes,
      cw_bytes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fastssc_subtree(const void* ops, int n_ops, const void* llr,
                               void* out, int family, int root, int span,
                               int batch, void* stream) {
  if (span < 1 || span > kMaxSpan || (span & (span - 1))) return -1;
  if (batch <= 0) return 0;
  auto o = static_cast<const int*>(ops);
  auto st = static_cast<cudaStream_t>(stream);
  switch (family) {
    case 0:
      return root ? launch<FloatFamily, true>(o, n_ops, llr, out, span, batch, st)
                  : launch<FloatFamily, false>(o, n_ops, llr, out, span, batch, st);
    case 1:
      return root ? launch<CharFamily, true>(o, n_ops, llr, out, span, batch, st)
                  : launch<CharFamily, false>(o, n_ops, llr, out, span, batch, st);
    case 2:
      return root ? launch<Bf16Family, true>(o, n_ops, llr, out, span, batch, st)
                  : launch<Bf16Family, false>(o, n_ops, llr, out, span, batch, st);
    default:
      return -1;
  }
}
