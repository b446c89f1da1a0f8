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
// Interface, in the TPU kernel's layouts:
//   llr [w_in, span, B] (state type), metrics [B, w_in] f32, family
//     -> bits [span, B] i32 (bit l of a word = path l's decision),
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
// flip tables come in spc_tab. One kernel per list size and family serves
// every subtree of every code; nothing is generated per code.
//
// What bounds it on an H100: latency. One thread decodes one codeword (the
// TPU kernel's batch-on-lanes mapping: neighbouring threads touch
// neighbouring addresses), so a batch of 1024 codewords is 1024 threads,
// a few warps per SM, each running a long dependent chain of f/g passes,
// candidate scans and L-round prunes. The per-path LLR state lives in a
// global scratch [levels, L, span/2^d, B] of the state type (about 16 KB
// per codeword at L = 8, span 512 in f32, half that in int16 or bf16),
// which stays in L2 at B = 1024. Small blocks (8 threads for B <= ~1000)
// spread a small batch over all SMs; each warp then moves 32-byte sectors.
// Making it fast (a warp per codeword with the span on the lanes, state in
// shared memory) is later work.
//
// Numerics: every sum is sequential over the span in f32, in the order of
// the plain torch version (ops/scl_kernel_bl.py), and the build disables
// FMA contraction, so kernel and plain version agree bit for bit in each
// family. Prune order is (value descending, flat code l*C + c ascending).
//
// C interface (ctypes; every pointer and the stream are void*):
//   int scl_subtree(const int *ops, int n_ops, const int *enum_masks,
//                   const int *spc_tab, const void *llr, const float *met,
//                   void *scratch, int *bits, int *perm, float *met_out,
//                   int list_size, int w_in, int w_out, int span, int batch,
//                   int family, cudaStream_t stream)
// Returns cudaGetLastError() after the launch, or -1 for an unsupported
// list size or family.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kMaxCand = 32;
constexpr int kOpWords = 8;
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

template <int L, class Fam>
struct Thread {
  using S = typename Fam::State;
  const S* llr_in;
  S* scratch;
  int* bits;
  int span, batch, b;

  // [L, S_d, B] LLRs of tree level d. Level 0 is the call's input, which
  // is only read; levels d >= 1 follow each other in the scratch.
  __device__ S* level(int d) const {
    if (d == 0) return const_cast<S*>(llr_in);
    return scratch + (size_t)L * batch * (span - (span >> (d - 1)));
  }
  // state element i of path l at a level of span s, as f32
  __device__ float get(const S* x, int l, int i, int s) const { return Fam::load(x[at(l, i, s)]); }
  __device__ size_t at(int l, int i, int s) const {
    return ((size_t)l * s + i) * batch + b;
  }
  __device__ int& word(int pos) const { return bits[(size_t)pos * batch + b]; }
};

// Top-min(L, w*C) of the candidates m[l] + d[c*L + l] in (value desc, code
// l*C + c asc) order. While w*C <= L every candidate survives in l-major
// slots (progressive widening). Returns the new width.
template <int L>
__device__ int prune(const float* m, int w, const float* d, int n_cand,
                     float* nm, int* src, int* cand) {
  const int total = w * n_cand;
  if (total <= L) {
    for (int l = 0; l < w; ++l)
      for (int c = 0; c < n_cand; ++c) {
        const int s = l * n_cand + c;
        nm[s] = m[l] + d[c * L + l];
        src[s] = l;
        cand[s] = c;
      }
    return total;
  }
  float pv = 0.f;
  int pc = -1;
  for (int r = 0; r < L; ++r) {
    float bv = 0.f;
    int bc = -1;
    for (int l = 0; l < w; ++l)
      for (int c = 0; c < n_cand; ++c) {
        const int code = l * n_cand + c;
        const float v = m[l] + d[c * L + l];
        // skip what earlier rounds took: everything not after (pv, pc)
        if (pc >= 0 && !(v < pv || (v == pv && code > pc))) continue;
        if (bc < 0 || v > bv) {  // codes ascend, so ties keep the first
          bv = v;
          bc = code;
        }
      }
    nm[r] = bv;
    src[r] = bc / n_cand;
    cand[r] = bc % n_cand;
    pv = bv;
    pc = bc;
  }
  return L;
}

// `count` smallest |x| of path l over the leaf span and their first
// indices, each round excluding the positions already taken.
template <int L, class Fam>
__device__ void weakest(const Thread<L, Fam>& t, const typename Fam::State* x, int l,
                        int span, int count, float* ms, int* is) {
  for (int k = 0; k < count; ++k) {
    float best = 0.f;
    int bi = -1;
    for (int s = 0; s < span; ++s) {
      bool taken = false;
      for (int j = 0; j < k; ++j) taken |= (is[j * L + l] == s);
      if (taken) continue;
      const float v = fabsf(t.get(x, l, s, span));
      if (bi < 0 || v < best) {
        best = v;
        bi = s;
      }
    }
    ms[k * L + l] = best;
    is[k * L + l] = bi;
  }
}

template <int L, class Fam>
__global__ void scl_subtree_kernel(const int* __restrict__ ops, int n_ops,
                                   const int* __restrict__ enum_masks,
                                   const int* __restrict__ spc_tab,
                                   const typename Fam::State* __restrict__ llr,
                                   const float* __restrict__ met_in,
                                   typename Fam::State* __restrict__ scratch,
                                   int* __restrict__ bits,
                                   int* __restrict__ perm_out,
                                   float* __restrict__ met_out, int w_in,
                                   int w_out, int span, int batch) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  using S = typename Fam::State;
  Thread<L, Fam> t{llr, scratch, bits, span, batch, b};

  float m[L];
  int w = w_in;
  for (int l = 0; l < w_in; ++l) m[l] = met_in[(size_t)b * w_in + l];
  int P[kMaxLevels][L];  // perm of the node open at each level
  float dl[kMaxCand * L];  // candidate deltas [C][L]
  float nm[L];
  int src[L], cand[L];
  float ms[4 * L];
  int is[4 * L];
  int par[L];

  for (int k = 0; k < n_ops; ++k) {
    const int* op = ops + k * kOpWords;
    const int code = op[0], d = op[1], len = op[2], off = op[3];
    const S* X = t.level(d);
    if (code == OP_F || code == OP_G) {
      const int h = len >> 1;
      S* Y = t.level(d + 1);
      if (code == OP_F) {
        for (int l = 0; l < w; ++l)
          for (int i = 0; i < h; ++i)
            Y[t.at(l, i, h)] = Fam::store(Fam::f(t.get(X, l, i, len), t.get(X, l, i + h, len)));
      } else {
        const int* p = P[d + 1];  // left child's perm: slots -> parent slots
        for (int i = 0; i < h; ++i) {
          const int lw = t.word(off + i);
          for (int l = 0; l < w; ++l) {
            const float a = t.get(X, p[l], i, len);
            const float bb = t.get(X, p[l], i + h, len);
            Y[t.at(l, i, h)] = Fam::store(Fam::g(a, bb, (lw >> l) & 1));
          }
        }
        for (int l = 0; l < w; ++l) P[d][l] = p[l];
      }
      continue;
    }
    if (code == OP_COMBINE) {
      const int h = len >> 1;
      const int* p = P[d + 1];  // right child's perm
      for (int i = 0; i < h; ++i) {
        const int lw = t.word(off + i);
        int g = 0;
        for (int j = 0; j < w; ++j) g |= ((lw >> p[j]) & 1) << j;
        t.word(off + i) = g ^ t.word(off + h + i);
      }
      int comp[L];
      for (int j = 0; j < w; ++j) comp[j] = P[d][p[j]];
      for (int j = 0; j < w; ++j) P[d][j] = comp[j];
      continue;
    }

    // ---- LEAF ----------------------------------------------------------
    const int kind = op[4], aux = op[5], n_cand = op[6];
    if (kind == K_RATE0) {
      for (int l = 0; l < w; ++l) {
        float acc = 0.f;
        for (int s = 0; s < len; ++s) acc = acc + fminf(t.get(X, l, s, len), 0.f);
        m[l] = m[l] + acc;
        P[d][l] = l;
      }
      for (int s = 0; s < len; ++s) t.word(off + s) = 0;
      continue;
    }
    int nc;
    if (kind == K_REP) {
      nc = 2;
      for (int l = 0; l < w; ++l) {
        float z = 0.f, o = 0.f;
        for (int s = 0; s < len; ++s) {
          const float x = t.get(X, l, s, len);
          z = z + fminf(x, 0.f);
          o = o + fmaxf(x, 0.f);
        }
        dl[l] = z;
        dl[L + l] = -o;
      }
    } else if (kind == K_RATE1 && len == 1) {
      nc = 2;
      for (int l = 0; l < w; ++l) {
        dl[l] = 0.f;
        dl[L + l] = -fabsf(t.get(X, l, 0, 1));
      }
    } else if (kind == K_RATE1) {
      nc = 4;
      for (int l = 0; l < w; ++l) {
        weakest(t, X, l, len, 2, ms, is);
        const float m0 = ms[l], m1 = ms[L + l];
        dl[l] = 0.f;
        dl[L + l] = -m0;
        dl[2 * L + l] = -m1;
        dl[3 * L + l] = -m0 - m1;
      }
    } else if (kind == K_SPC) {
      nc = 8;
      for (int l = 0; l < w; ++l) {
        weakest(t, X, l, len, 4, ms, is);
        int neg = 0;
        for (int s = 0; s < len; ++s) neg += Fam::hard(t.get(X, l, s, len));
        par[l] = neg & 1;
        const float m0 = ms[l];
        for (int c = 0; c < 8; ++c) {
          const int tm = spc_tab[24 + c];
          float tc = 0.f;
          for (int j = 0; j < 3; ++j)
            if ((tm >> j) & 1) tc = tc + ms[(1 + j) * L + l];
          const float even = (spc_tab[16 + c] ? -m0 : -0.f * m0) - tc;
          const float odd = -m0 - tc;
          dl[c * L + l] = par[l] ? odd : even;
        }
      }
    } else {  // K_ENUM: score every codeword of the leaf subcode
      nc = n_cand;
      const int* masks = enum_masks + aux;
      for (int l = 0; l < w; ++l) {
        float sa = 0.f;
        for (int s = 0; s < len; ++s) sa = sa + fabsf(t.get(X, l, s, len));
        for (int c = 0; c < nc; ++c) {
          const int mk = masks[c];
          float sc = 0.f;
          for (int s = 0; s < len; ++s) {
            const float x = t.get(X, l, s, len);
            sc = sc + (((mk >> s) & 1) ? -x : x);
          }
          dl[c * L + l] = 0.5f * (sc - sa);
        }
      }
    }
    const int w2 = prune<L>(m, w, dl, nc, nm, src, cand);

    // decision bits of the surviving paths, packed one plane per path
    for (int s = 0; s < len; ++s) {
      int out = 0;
      for (int j = 0; j < w2; ++j) {
        const int l = src[j], c = cand[j];
        int bit;
        if (kind == K_REP) {
          bit = c != 0;
        } else if (kind == K_ENUM) {
          bit = (enum_masks[aux + c] >> s) & 1;
        } else {
          bit = Fam::hard(t.get(X, l, s, len));
          if (kind == K_RATE1 && len == 1) {
            bit ^= (c == 1);
          } else if (kind == K_RATE1) {
            bit ^= ((c == 1 || c == 3) && s == is[l]) ||
                   ((c == 2 || c == 3) && s == is[L + l]);
          } else {  // K_SPC
            const int fm = spc_tab[(par[l] ? 8 : 0) + c];
            int f = 0;
            for (int j4 = 0; j4 < 4; ++j4)
              f |= ((fm >> j4) & 1) && s == is[j4 * L + l];
            bit ^= f;
          }
        }
        out |= bit << j;
      }
      t.word(off + s) = out;
    }
    for (int j = 0; j < w2; ++j) {
      m[j] = nm[j];
      P[d][j] = src[j];
    }
    w = w2;
  }

  for (int j = 0; j < w_out; ++j) {
    perm_out[(size_t)b * w_out + j] = P[0][j];
    met_out[(size_t)b * w_out + j] = m[j];
  }
}

template <int L, class Fam>
int launch(const int* ops, int n_ops, const int* enum_masks, const int* spc_tab,
           const void* llr, const float* met, void* scratch, int* bits, int* perm,
           float* met_out, int w_in, int w_out, int span, int batch,
           cudaStream_t stream) {
  using S = typename Fam::State;
  // small blocks first: spread a small batch over every SM
  int threads = 8;
  while (threads < 128 && batch / (2 * threads) >= 132) threads *= 2;
  const int blocks = (batch + threads - 1) / threads;
  scl_subtree_kernel<L, Fam><<<blocks, threads, 0, stream>>>(
      ops, n_ops, enum_masks, spc_tab, static_cast<const S*>(llr), met,
      static_cast<S*>(scratch), bits, perm, met_out, w_in, w_out, span, batch);
  return static_cast<int>(cudaGetLastError());
}

template <class Fam>
int dispatch(const int* o, int n_ops, const int* e, const int* sp, const void* x,
             const float* mi, void* sc, int* bt, int* pr, float* mo, int list_size,
             int w_in, int w_out, int span, int batch, cudaStream_t st) {
  switch (list_size) {
    case 2: return launch<2, Fam>(o, n_ops, e, sp, x, mi, sc, bt, pr, mo, w_in, w_out, span, batch, st);
    case 4: return launch<4, Fam>(o, n_ops, e, sp, x, mi, sc, bt, pr, mo, w_in, w_out, span, batch, st);
    case 8: return launch<8, Fam>(o, n_ops, e, sp, x, mi, sc, bt, pr, mo, w_in, w_out, span, batch, st);
    case 16: return launch<16, Fam>(o, n_ops, e, sp, x, mi, sc, bt, pr, mo, w_in, w_out, span, batch, st);
    case 32: return launch<32, Fam>(o, n_ops, e, sp, x, mi, sc, bt, pr, mo, w_in, w_out, span, batch, st);
    default: return -1;
  }
}

}  // namespace

extern "C" int scl_subtree(const void* ops, int n_ops, const void* enum_masks,
                           const void* spc_tab, const void* llr,
                           const void* met, void* scratch, void* bits,
                           void* perm, void* met_out, int list_size, int w_in,
                           int w_out, int span, int batch, int family,
                           void* stream) {
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
    case 0: return dispatch<FloatFamily>(o, n_ops, e, sp, llr, mi, scratch, bt, pr, mo, list_size, w_in, w_out, span, batch, st);
    case 1: return dispatch<CharFamily>(o, n_ops, e, sp, llr, mi, scratch, bt, pr, mo, list_size, w_in, w_out, span, batch, st);
    case 2: return dispatch<Bf16Family>(o, n_ops, e, sp, llr, mi, scratch, bt, pr, mo, list_size, w_in, w_out, span, batch, st);
    default: return -1;
  }
}
