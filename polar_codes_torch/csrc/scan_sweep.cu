// SCAN sweeps (K4 fused, K5 stepped): soft-cancellation sweeps of the
// SCAN code tree for a batch of codewords, with one sweep routine behind
// two entry points.
//
// Replaces: polar_codes_tpu/ops/scan_kernel.py,
//   K4 build_scan_kernel.kernel: all sweeps fused, the inter-sweep node
//      memory kept on chip;
//   K5 build_scan_step_kernel.kernel: one sweep, the node memory read and
//      written as a packed [M, B] buffer (post-order _mem_layout), for
//      the CRC gate of FastSSCAN between sweeps.
// Their body _sweep is, per branch node with channel-side LLRs (a, b) and
// the right child's beta of the previous sweep m:
//   alpha_l = f(a, b + m); beta_l = sweep(left)
//   alpha_r = b + f(a, beta_l); beta_r = sweep(right); m' = beta_r
//   beta = [f(beta_l, b + beta_r), beta_r + f(beta_l, a)]
// with f the product-form min-sum sign(x)sign(y)min(|x|,|y|) (at a zero
// input, a zero with the XOR of the inputs' sign bits, as jnp.sign gives),
// rate-0 leaves beta = +inf and rate-1 leaves beta = 0.
//
// Interface, in the TPU kernels' batch-minor layouts:
//   fused:  llr [N, B] f32, sweeps -> beta [N, B] f32
//   step:   llr [N, B] f32, mem [M, B] f32 -> beta [N, B], mem' [M, B]
// The tree arrives as data: ops/scan_kernel.py kernel_ops derives from
// the post-order schedule a list of F, G, COMBINE and subtree records
// (layout below) in which leaves and the ops that only feed a leaf are
// gone (a leaf's beta is a constant, and its alpha is never read), and
// each branch node of length 8 is one subtree op. One kernel serves every
// code.
//
// Numerics: the sweep is elementwise (no reductions), every value that is
// computed is computed with the plain torch version's operations in its
// order (ops/scan_kernel.py _sweep), and the build disables FMA
// contraction and uses no fast-math flag, so the two agree bit for bit,
// +inf betas and signed zeros included; no NaN can arise (alphas stay
// finite, so no inf - inf, and f never multiplies 0 by inf). f is
// computed as min(|x|, |y|) carrying the XOR of the sign bits, which is
// the product form's value on every input that is not NaN: at a zero
// input sign(x) sign(y) is a signed zero or one and the minimum is +0.
//
// What bounds it on an H100: latency, not bytes. Four sweeps at
// (1024, 512), B = 2048 read 8 MiB and write 8 MiB (about 5 us at
// 3.35 TB/s), but each sweep is a chain of dependent ops: 857 in the
// post-order schedule, 427 without the leaves, 235 with the 41 subtrees
// of length 8 as one op each. Nothing in SCAN couples codewords (no
// reduction, prune or shared state), so the design shortens the chain and
// runs many chains at once:
//   - a warp per 1 or 2 codewords, warp-synchronous: an op of at most
//     32 items (half-length x codewords) is one lane step with no branch,
//     longer ones go 2 to 8 items a lane, loads before stores, and a
//     subtree op is one lane per codeword sweeping the 8 positions in
//     registers; ops are separated by __syncwarp, never by a block
//     barrier;
//   - the op list is staged into shared memory once per block (the one
//     __syncthreads, in the prologue) in a form for the warp layout, so
//     an op's fetch is a broadcast read, two ops ahead;
//   - each warp's alpha levels [2N] and betas [N] live in shared memory,
//     its codewords interleaved (12 KiB a codeword at N = 1024), and for
//     the fused entry the node memory [M] too where eight codewords'
//     state fits a block (25 KiB a codeword at N = 1024); otherwise it is
//     read and written in device memory, row r of codeword c at r * B + c,
//     where a block's eight consecutive codewords share 32-byte sectors;
//     the fused entry's first sweep reads no memory (it adds +0.0, as the
//     plain version adds its zeros);
//   - two codewords a warp where eight codewords' state fits a block and
//     the batch gives every SM eight (fewer instructions per codeword
//     where the SM is busy), else one; up to 8 codewords a block; a warp
//     past the batch returns after the prologue, and lanes of codewords
//     past the batch load the last codeword's values and store nothing.
// Measured (chip_profile.py scan_ops; NVIDIA H100 80GB HBM3, 700 W): an
// op of at most 32 items costs ~250-330 cycles of one warp's chain, mostly
// its instructions' dependent latencies, a subtree op ~800 and a long op
// ~400-450 on chip; in K5, which reads device memory, a subtree op
// ~1000-1850, a long op ~700-1350 and an F ~600-1300 (each F waits for
// its own load: loading it one F ahead saved nothing at B = 2048, 6% at
// B = 181, and was taken out).
//
// C interface (ctypes; every pointer and the stream are void*):
//   int scan_sweep_fused(const int4 *ops, int n_ops, const float *llr,
//                        float *beta, float *mem, int mem_rows,
//                        int mem_shared, int n, int batch, int sweeps,
//                        int per_block, int per_warp, cudaStream_t stream)
//     mem: an [M, B] scratch when mem_shared is 0 (its contents are not
//     read before they are written), else unused.
//   int scan_sweep_step(const int4 *ops, int n_ops, const float *llr,
//                       const float *mem_in, float *beta, float *mem_out,
//                       int mem_rows, int n, int batch, int per_block,
//                       int per_warp, cudaStream_t stream)
//     ops: kernel_ops, n_ops records; per_block: warps a block (1 to
//     8), per_warp: codewords a warp (1 or 2); 0 lets the kernel choose.
//   int scan_sweep_mem_on_chip(int n, int n_ops, int mem_rows)
//     1 if the fused entry places the node memory on chip by default.
//   int scan_sweep_smem_limit(void)
//     the current card's opt-in shared memory per block, in bytes.
// The entries return the cudaGetLastError() of the launch (or of the
// shared-memory attribute call), -1 for a length they do not take, or -2
// when one warp's state and the op list exceed the card's opt-in shared
// memory per block.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifdef SCAN_PROFILE
// Cycles per op kind and phase, summed over every warp (one chain) by its
// lane 0, and their counts at slot + 32 (chip_profile.py
// builds with -DSCAN_PROFILE and reads them with scan_sweep_profile):
// 0-2 F, G, COMBINE of at most 32 items, 3 any op of more; 4 the stage-in
// (prologue: op list, LLRs); 5 the stage-out (betas); 6 all sweeps; 7
// subtree ops. A warp sums in registers and adds once at its end.
__device__ unsigned long long scan_prof[64];
struct OpClock {
  unsigned long long cyc[8] = {}, cnt[8] = {};
  long long t = 0;
  __device__ void reset() { t = clock64(); }
  __device__ void tick(int slot) {
    const long long now = clock64();
    const unsigned long long d = static_cast<unsigned long long>(now - t);
    switch (slot) {
      case 0: cyc[0] += d; ++cnt[0]; break;
      case 1: cyc[1] += d; ++cnt[1]; break;
      case 2: cyc[2] += d; ++cnt[2]; break;
      case 3: cyc[3] += d; ++cnt[3]; break;
      case 4: cyc[4] += d; ++cnt[4]; break;
      case 5: cyc[5] += d; ++cnt[5]; break;
      case 6: cyc[6] += d; ++cnt[6]; break;
      default: cyc[7] += d; ++cnt[7]; break;
    }
    t = now;
  }
  __device__ void add(int slot, long long since) {  // a span that holds ticks
    cyc[slot] += static_cast<unsigned long long>(clock64() - since);
    ++cnt[slot];
  }
  __device__ void flush(int lane) {
    if (lane != 0) return;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      atomicAdd(&scan_prof[k], cyc[k]);
      atomicAdd(&scan_prof[k + 32], cnt[k]);
    }
  }
};
extern "C" int scan_sweep_profile(unsigned long long* out) {
  const cudaError_t err = cudaMemcpyFromSymbol(out, scan_prof, sizeof(scan_prof));
  const unsigned long long zero[64] = {};
  return static_cast<int>(err != cudaSuccess ? err
                                             : cudaMemcpyToSymbol(scan_prof, zero, sizeof(zero)));
}
#define SCAN_NOW() clock64()
#else
struct OpClock {
  __device__ void reset() {}
  __device__ void tick(int) {}
  __device__ void add(int, long long) {}
  __device__ void flush(int) {}
};
#define SCAN_NOW() 0LL
#endif

namespace {

// v, held in a register: the compiler may not recompute it in the loop
// (it would rematerialize the lane index and the warp's base with S2R and
// constant loads on the op chain)
__device__ __forceinline__ int opaque(int v) {
#ifdef __CUDA_ARCH__
  asm volatile("mov.b32 %0, %1;" : "=r"(v) : "r"(v));
#endif
  return v;
}

constexpr int kMaxN = 4096;
constexpr int kMaxPerBlock = 8;
constexpr int kMaxDevices = 64;
enum { OP_F = 0, OP_G = 1, OP_COMBINE = 2, OP_SUBTREE = 3 };

// product-form min-sum (sign(x) * sign(y)) * min(|x|, |y|) with jnp.sign's
// sgn(+-0) = +-0, as min(|x|, |y|) carrying the XOR of the sign bits: the
// two agree on every input that is not NaN (see the note above)
__device__ __forceinline__ float f_prod(float x, float y) {
  const unsigned s = (__float_as_uint(x) ^ __float_as_uint(y)) & 0x80000000u;
  return __uint_as_float(__float_as_uint(fminf(fabsf(x), fabsf(y))) | s);
}

// The kernels' schedule (ops/scan_kernel.py kernel_ops): one record an
// op, {x, y, z, w}: x = code | log2(length) << 2 | left child's kind << 6
// | right child's kind << 8, y = the alpha row of the node's level (the
// next level's row is y + length), z = the node's beta offset (G,
// COMBINE), w = its memory row. A child's kind is KIND_BRANCH or a leaf
// with a constant beta. Subtree records: see subtree_op.
enum { KIND_BRANCH = 0, KIND_RATE0 = 1, KIND_RATE1 = 2, KIND_NONE = 3 };
__device__ __forceinline__ float leaf_beta(int kind) { return kind == KIND_RATE0 ? INFINITY : 0.f; }

// A warp runs kC codewords together, its state interleaved: element e of
// codeword c at [e * kC + c]. An op of half-length h has kC * h items;
// item t is element i = t >> log2(kC) of codeword c = t & (kC - 1), so
// item t of a level that starts at row y lies at y * kC + t.

// The node memory of a warp's codewords: row r of codeword c at
// in[r * stride + c] (read by F) and out[r * stride + c] (written by
// COMBINE), the two the same when it is updated in place. In device
// memory, codewords past `last` lie past the batch: loads take codeword
// `last` instead, and stores are dropped.
struct Mem {
  const float* in;
  float* out;
  int stride, last;
};

// Where item t of row `row` lies in the node memory: row * kC + t on
// chip (kShared), else (row + element) * stride + codeword.
template <int kC, bool kShared>
__device__ __forceinline__ size_t mem_at(const Mem& mem, int row, int t) {
  constexpr int kLc = kC == 2 ? 1 : 0;
  if (kShared) return row * kC + t;
  const int c = t & (kC - 1);
  return static_cast<size_t>(row + (t >> kLc)) * mem.stride + (c < mem.last ? c : mem.last);
}

template <int kC>
__device__ __forceinline__ bool mem_valid(const Mem& mem, int t) {
  return (t & (kC - 1)) <= mem.last;
}

// An op as one lane sees it: its record's word x, items = kC * h, the
// lane's item t, where its level starts in the warp's state (xb = alpha
// row * kC), z (the beta offset * kC) and its memory row w.
struct Step {
  int x, items, t, xb, z, w;
};

// A record in the warp form (warp_op): x also holds items - 1 << 16, y is
// the level's row * kC and a G's or COMBINE's z its beta offset * kC.
template <int kC>
__device__ __forceinline__ int4 warp_op(int4 g) {
  const int code = g.x & 3, items = kC << (((g.x >> 2) & 15) - 1);
  return make_int4(code == OP_SUBTREE ? g.x : g.x | (items - 1) << 16, g.y * kC, g.z * kC, g.w);
}

__device__ __forceinline__ Step decode(int4 op, int lane) {
  const int mask = op.x >> 16;
  return Step{op.x, mask + 1, lane & mask, op.y, op.z, op.w};
}

// An op of at most 32 items: one lane step, the three kinds in one
// predicated stream with no branch. Lane l works on item t = l mod items;
// lanes with equal t compute equal values, so F and G store from every
// lane, and COMBINE, which rewrites what it reads, from lanes l < items
// only. A leaf child's beta is its constant. f is symmetric, so G's
// f(a, bl) is COMBINE's f(bl, a).
template <int kC, bool kShared>
__device__ __forceinline__ void small_op(const Step& s, float* alpha, float* beta,
                                         const Mem& mem, int lane, bool read) {
  const int code = s.x & 3, lk = (s.x >> 6) & 3, rk = (s.x >> 8) & 3;
  const int xo = s.xb + s.t, bo = s.z + s.t;
  const bool is_f = code == OP_F, is_c = code == OP_COMBINE;
  const float a = alpha[xo], b = alpha[xo + s.items];
  const float m = is_f && read ? mem.in[mem_at<kC, kShared>(mem, s.w, s.t)] : 0.f;
  float bl = leaf_beta(lk), br = leaf_beta(rk);
  if (!is_f && lk == KIND_BRANCH) bl = beta[bo];
  if (is_c && rk == KIND_BRANCH) br = beta[bo + s.items];
  const float lo = f_prod(is_f ? a : bl, b + (is_f ? m : br));  // F's alpha, COMBINE's left
  const float fab = f_prod(a, bl);
  if (!is_c) {
    alpha[xo + 2 * s.items] = is_f ? lo : b + fab;
  } else if (lane < s.items) {
    if (mem_valid<kC>(mem, s.t)) mem.out[mem_at<kC, kShared>(mem, s.w, s.t)] = br;
    beta[bo] = lo;
    beta[bo + s.items] = br + fab;
  }
}

// kU items of an op of more than 32 items, lane `lane`'s t = first + 32
// u for u < kU, all below items: loads first, then stores (X, Y and the
// two halves of B never overlap, and each item stays with one lane).
template <int kC, bool kShared, int kU>
__device__ __forceinline__ void long_batch(const Step& s, float* alpha, float* beta,
                                           const Mem& mem, int first, bool read) {
  const int code = s.x & 3, lk = (s.x >> 6) & 3, rk = (s.x >> 8) & 3, items = s.items;
  const float* X = alpha + s.xb + first;
  float* Y = alpha + s.xb + 2 * items + first;
  float* B = beta + s.z + first;
  float a[kU], b[kU], c[kU], d[kU];
  if (code == OP_F) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      a[u] = X[32 * u];
      b[u] = X[32 * u + items];
      c[u] = read ? mem.in[mem_at<kC, kShared>(mem, s.w, first + 32 * u)] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) Y[32 * u] = f_prod(a[u], b[u] + c[u]);
  } else if (code == OP_G) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      a[u] = X[32 * u];
      b[u] = X[32 * u + items];
      c[u] = lk ? leaf_beta(lk) : B[32 * u];
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) Y[32 * u] = b[u] + f_prod(a[u], c[u]);
  } else {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      a[u] = X[32 * u];
      b[u] = X[32 * u + items];
      c[u] = lk ? leaf_beta(lk) : B[32 * u];
      d[u] = rk ? leaf_beta(rk) : B[32 * u + items];
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = first + 32 * u;
      if (mem_valid<kC>(mem, t)) mem.out[mem_at<kC, kShared>(mem, s.w, t)] = d[u];
      B[32 * u] = f_prod(c[u], b[u] + d[u]);
      B[32 * u + items] = d[u] + f_prod(c[u], a[u]);
    }
  }
}

// An op of more than 32 items (a power of two): 64 and 128 in one batch,
// more in batches of 8 items a lane.
template <int kC, bool kShared>
__device__ __forceinline__ void long_op(const Step& s, float* alpha, float* beta,
                                        const Mem& mem, int lane, bool read) {
  if (s.items == 64) {
    long_batch<kC, kShared, 2>(s, alpha, beta, mem, lane, read);
  } else if (s.items == 128) {
    long_batch<kC, kShared, 4>(s, alpha, beta, mem, lane, read);
  } else {
    for (int first = lane; first < s.items; first += 256)
      long_batch<kC, kShared, 8>(s, alpha, beta, mem, first, read);
  }
}

// A subtree op (OP_SUBTREE): the sweep of a branch node of length
// kSubtree and of everything below it, by one lane per codeword in
// registers. Its record's x >> 2 holds the kinds of the node's
// descendants in heap order (node P's children are 2P and 2P + 1, the
// root 1; KIND_NONE where there is none), w the memory row of its first
// branch node in post-order. Each node's values are computed as in
// small_op and long_op, so the results are the same bits.
constexpr int kSubtree = 8;

__device__ __forceinline__ int sub_kind(unsigned kinds, int p) {
  return p == 1 ? KIND_BRANCH : static_cast<int>(kinds >> (2 * p - 4)) & 3;
}

// The memory rows of the subtree at node P of length L (post-order).
template <int L, int P>
__device__ __forceinline__ int sub_rows(unsigned kinds) {
  if constexpr (L == 1) {
    return 0;
  } else {
    if (sub_kind(kinds, P) != KIND_BRANCH) return 0;
    return L / 2 + sub_rows<L / 2, 2 * P>(kinds) + sub_rows<L / 2, 2 * P + 1>(kinds);
  }
}

// Where node P's F memory values go in the preloaded m[8].
__host__ __device__ constexpr int sub_slot(int p) { return p == 1 ? 0 : p == 2 ? 4 : 6; }

// Loads every F memory value of the subtree at node P (its rows from
// row0) into m, all at once, before any of its COMBINEs writes a row.
template <int L, int P, int kC, bool kShared>
__device__ __forceinline__ void sub_preload(unsigned kinds, int row0, const Mem& mem, int c,
                                            float (&m)[8]) {
  if constexpr (L >= 4) {
    if (sub_kind(kinds, P) != KIND_BRANCH) return;
    const int lrows = sub_rows<L / 2, 2 * P>(kinds);
    if (sub_kind(kinds, 2 * P) == KIND_BRANCH) {
      const int row = row0 + lrows + sub_rows<L / 2, 2 * P + 1>(kinds);
#pragma unroll
      for (int i = 0; i < L / 2; ++i)
        m[sub_slot(P) + i] = mem.in[mem_at<kC, kShared>(mem, row, i * kC + c)];
    }
    sub_preload<L / 2, 2 * P, kC, kShared>(kinds, row0, mem, c, m);
    sub_preload<L / 2, 2 * P + 1, kC, kShared>(kinds, row0 + lrows, mem, c, m);
  }
}

// The sweep of branch node P of length L on its alphas x: its betas into
// out, its memory row written.
template <int L, int P, int kC, bool kShared>
__device__ __forceinline__ void sub_sweep(const float (&x)[L], float (&out)[L], unsigned kinds,
                                          int row0, const Mem& mem, int c, bool read,
                                          const float (&m)[8]) {
  constexpr int H = L / 2;
  const int lk = sub_kind(kinds, 2 * P), rk = sub_kind(kinds, 2 * P + 1);
  const int lrows = sub_rows<H, 2 * P>(kinds);
  const int row = row0 + lrows + sub_rows<H, 2 * P + 1>(kinds);
  float bl[H], br[H];
  if constexpr (H >= 2) {
    if (lk == KIND_BRANCH) {
      float al[H];
#pragma unroll
      for (int i = 0; i < H; ++i) al[i] = f_prod(x[i], x[i + H] + (read ? m[sub_slot(P) + i] : 0.f));
      sub_sweep<H, 2 * P, kC, kShared>(al, bl, kinds, row0, mem, c, read, m);
    } else {
#pragma unroll
      for (int i = 0; i < H; ++i) bl[i] = leaf_beta(lk);
    }
    if (rk == KIND_BRANCH) {
      float ar[H];
#pragma unroll
      for (int i = 0; i < H; ++i) ar[i] = x[i + H] + f_prod(x[i], bl[i]);
      sub_sweep<H, 2 * P + 1, kC, kShared>(ar, br, kinds, row0 + lrows, mem, c, read, m);
    } else {
#pragma unroll
      for (int i = 0; i < H; ++i) br[i] = leaf_beta(rk);
    }
  } else {  // the children of a node of length 2 are leaves
    bl[0] = leaf_beta(lk);
    br[0] = leaf_beta(rk);
  }
#pragma unroll
  for (int i = 0; i < H; ++i) {
    if (mem_valid<kC>(mem, c)) mem.out[mem_at<kC, kShared>(mem, row, i * kC + c)] = br[i];
    out[i] = f_prod(bl[i], x[i + H] + br[i]);
    out[i + H] = br[i] + f_prod(bl[i], x[i]);
  }
}

// A subtree op: lane c < kC sweeps codeword c's subtree.
template <int kC, bool kShared>
__device__ __forceinline__ void subtree_op(const Step& s, float* alpha, float* beta,
                                           const Mem& mem, int lane, bool read) {
  if (lane >= kC) return;
  const unsigned kinds = static_cast<unsigned>(s.x) >> 2;
  float x[kSubtree], out[kSubtree], m[8];
#pragma unroll
  for (int e = 0; e < kSubtree; ++e) x[e] = alpha[s.xb + e * kC + lane];
  if (read) sub_preload<kSubtree, 1, kC, kShared>(kinds, s.w, mem, lane, m);
  sub_sweep<kSubtree, 1, kC, kShared>(x, out, kinds, s.w, mem, lane, read, m);
#pragma unroll
  for (int e = 0; e < kSubtree; ++e) beta[s.z + e * kC + lane] = out[e];
}

// One sweep of a warp's codewords over the schedule's n ops in shared
// memory. alpha [2N][kC] (level 0 = channel LLRs) and beta [N][kC] in
// shared memory. read: F reads the memory (else adds 0, the fused entry's
// first sweep). Op records are fetched two ops ahead.
template <int kC, bool kShared>
__device__ __forceinline__ void sweep(const int4* ops, int n, float* alpha, float* beta,
                                      const Mem& mem, int lane, bool read, OpClock& clk) {
  int4 cur = ops[0], nxt = ops[n > 1 ? 1 : 0];
  for (int k = 0; k < n; ++k) {
    const Step s = decode(cur, lane);
    cur = nxt;
    nxt = ops[k + 2 < n ? k + 2 : n - 1];
    const int code = s.x & 3;
    if (code == OP_SUBTREE)
      subtree_op<kC, kShared>(s, alpha, beta, mem, lane, read);
    else if (s.items <= 32)
      small_op<kC, kShared>(s, alpha, beta, mem, lane, read);
    else
      long_op<kC, kShared>(s, alpha, beta, mem, lane, read);
    __syncwarp();
    clk.tick(code == OP_SUBTREE ? 7 : s.items <= 32 ? code : 3);
  }
}

// Mem placement of the fused entry / the stepped entry.
enum { MEM_SHARED = 0, MEM_DEVICE = 1, MEM_STEP = 2 };

template <int kMem, int kC>
__global__ void __launch_bounds__(32 * kMaxPerBlock)
scan_kernel(const int4* __restrict__ ops_g, int n_ops, const float* __restrict__ llr,
            const float* mem_in, float* __restrict__ beta_out, float* mem_out, int n,
            int batch, int sweeps, int ops_bytes, int warp_floats) {
  constexpr int kLc = kC == 2 ? 1 : 0;
  extern __shared__ __align__(16) unsigned char smem[];
  OpClock clk;
  clk.reset();
  // prologue: the schedule into shared memory, for every warp of the block
  int4* ops = reinterpret_cast<int4*>(smem);
  for (int k = threadIdx.x; k < n_ops; k += blockDim.x) ops[k] = warp_op<kC>(ops_g[k]);
  __syncthreads();  // the only block barrier
  const int warp = threadIdx.x >> 5, lane = opaque(threadIdx.x & 31);
  const int c0 = (blockIdx.x * (blockDim.x >> 5) + warp) * kC;  // the warp's first codeword
  if (c0 >= batch) return;
  const int last = batch - c0 < kC ? batch - c0 - 1 : kC - 1;  // its last in the batch
  float* alpha = reinterpret_cast<float*>(smem + opaque(ops_bytes + warp * warp_floats * 4));
  float* beta = alpha + 2 * n * kC;
  for (int t = lane; t < n * kC; t += 32) {
    const int c = t & (kC - 1);
    alpha[t] = llr[static_cast<size_t>(t >> kLc) * batch + c0 + (c < last ? c : last)];
    beta[t] = 0.f;  // the result of zero sweeps
  }
  Mem mem;
  if (kMem == MEM_SHARED) {
    float* ms = beta + n * kC;
    mem = Mem{ms, ms, kC, kC - 1};
  } else if (kMem == MEM_DEVICE) {
    mem = Mem{mem_out + c0, mem_out + c0, batch, last};
  } else {
    mem = Mem{mem_in + c0, mem_out + c0, batch, last};
  }
  __syncwarp();
  clk.tick(4);
  const long long t0 = SCAN_NOW();
  for (int s = 0; s < sweeps; ++s)
    sweep<kC, kMem == MEM_SHARED>(ops, n_ops, alpha, beta, mem, lane, kMem == MEM_STEP || s > 0,
                                  clk);
  clk.add(6, t0);
  clk.reset();
  for (int t = lane; t < n * kC; t += 32) {
    const int c = t & (kC - 1);
    if (c <= last) beta_out[static_cast<size_t>(t >> kLc) * batch + c0 + c] = beta[t];
  }
  clk.tick(5);
  clk.flush(lane);
}

int smem_limit() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return 0;
  return optin;
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 1;
  return sms > 0 ? sms : 1;
}

size_t ops_bytes(int n_ops) { return static_cast<size_t>(n_ops) * sizeof(int4); }

size_t codeword_bytes(int n, int mem_rows, bool mem_shared) {
  return (static_cast<size_t>(3) * n + (mem_shared ? mem_rows : 0)) * sizeof(float);
}

// Codewords a warp: per_warp (1 or 2), or 0: two where shared memory
// holds kMaxPerBlock codewords' state and the batch gives every SM that
// many, else one (measured: two are 7-26% faster at N = 1024, B = 2048,
// one 15-30% faster at B = 181 and at N = 4096, where 4 fit an SM).
int codewords_per_warp(int n, int n_ops, int mem_rows, bool mem_shared, int batch,
                       int per_warp) {
  if (per_warp > 0) return per_warp >= 2 ? 2 : 1;
  const size_t room = static_cast<size_t>(smem_limit()) - ops_bytes(n_ops);
  const bool fits = room >= kMaxPerBlock * codeword_bytes(n, mem_rows, mem_shared);
  return fits && batch >= kMaxPerBlock * sm_count() ? 2 : 1;
}

// Warps a block of cw codewords a warp: the most that fit, at most
// per_block (0: as many as keep every SM busy, at most 8 codewords a
// block); 0 if one does not fit.
int warps_per_block(int n, int n_ops, int mem_rows, bool mem_shared, int batch, int cw,
                    int per_block) {
  const size_t limit = static_cast<size_t>(smem_limit()), fixed = ops_bytes(n_ops);
  const size_t per_warp = cw * codeword_bytes(n, mem_rows, mem_shared);
  if (fixed + per_warp > limit) return 0;
  int w = per_block > 0 ? per_block : 1;
  if (per_block <= 0)
    while (2 * w * cw <= kMaxPerBlock && 2 * w * cw * sm_count() <= batch) w *= 2;
  w = w > kMaxPerBlock ? kMaxPerBlock : w;
  while (w > 1 && fixed + w * per_warp > limit) --w;
  return w;
}

template <int kMem, int kC>
int launch(const int4* ops, int n_ops, const float* llr, const float* mem_in, float* beta,
           float* mem_out, int mem_rows, int n, int batch, int sweeps, int per_block,
           cudaStream_t stream) {
  const int w = warps_per_block(n, n_ops, mem_rows, kMem == MEM_SHARED, batch, kC, per_block);
  if (w == 0) return -2;
  const size_t per_warp = kC * codeword_bytes(n, mem_rows, kMem == MEM_SHARED);
  const size_t smem = ops_bytes(n_ops) + w * per_warp;
  auto kernel = scan_kernel<kMem, kC>;
  static int raised[kMaxDevices] = {};  // the kernel's shared-memory limit set per card
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices || static_cast<int>(smem) > raised[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) raised[dev] = static_cast<int>(smem);
  }
  const int per_block_cw = w * kC;
  kernel<<<(batch + per_block_cw - 1) / per_block_cw, 32 * w, smem, stream>>>(
      ops, n_ops, llr, mem_in, beta, mem_out, n, batch, sweeps,
      static_cast<int>(ops_bytes(n_ops)), static_cast<int>(per_warp / sizeof(float)));
  return static_cast<int>(cudaGetLastError());
}

template <int kMem>
int dispatch(const int4* ops, int n_ops, const float* llr, const float* mem_in, float* beta,
             float* mem_out, int mem_rows, int n, int batch, int sweeps, int per_block,
             int per_warp, cudaStream_t st) {
  return codewords_per_warp(n, n_ops, mem_rows, kMem == MEM_SHARED, batch, per_warp) == 2
             ? launch<kMem, 2>(ops, n_ops, llr, mem_in, beta, mem_out, mem_rows, n, batch,
                               sweeps, per_block, st)
             : launch<kMem, 1>(ops, n_ops, llr, mem_in, beta, mem_out, mem_rows, n, batch,
                               sweeps, per_block, st);
}

bool bad_length(int n) { return n < 2 || n > kMaxN || (n & (n - 1)); }

}  // namespace

// The fused entry keeps the node memory on chip where eight codewords'
// state fits one block.
extern "C" int scan_sweep_mem_on_chip(int n, int n_ops, int mem_rows) {
  return ops_bytes(n_ops) + kMaxPerBlock * codeword_bytes(n, mem_rows, true) <=
         static_cast<size_t>(smem_limit());
}

extern "C" int scan_sweep_smem_limit(void) { return smem_limit(); }

extern "C" int scan_sweep_fused(const void* ops, int n_ops, const void* llr, void* beta,
                                void* mem, int mem_rows, int mem_shared, int n, int batch,
                                int sweeps, int per_block, int per_warp, void* stream) {
  if (bad_length(n)) return -1;
  if (batch <= 0) return 0;
  auto o = static_cast<const int4*>(ops);
  auto x = static_cast<const float*>(llr);
  auto y = static_cast<float*>(beta);
  auto m = static_cast<float*>(mem);
  auto st = static_cast<cudaStream_t>(stream);
  return mem_shared ? dispatch<MEM_SHARED>(o, n_ops, x, m, y, m, mem_rows, n, batch, sweeps,
                                           per_block, per_warp, st)
                    : dispatch<MEM_DEVICE>(o, n_ops, x, m, y, m, mem_rows, n, batch, sweeps,
                                           per_block, per_warp, st);
}

extern "C" int scan_sweep_step(const void* ops, int n_ops, const void* llr, const void* mem_in,
                               void* beta, void* mem_out, int mem_rows, int n, int batch,
                               int per_block, int per_warp, void* stream) {
  if (bad_length(n)) return -1;
  if (batch <= 0) return 0;
  return dispatch<MEM_STEP>(static_cast<const int4*>(ops), n_ops, static_cast<const float*>(llr),
                            static_cast<const float*>(mem_in), static_cast<float*>(beta),
                            static_cast<float*>(mem_out), mem_rows, n, batch, 1, per_block,
                            per_warp, static_cast<cudaStream_t>(stream));
}
