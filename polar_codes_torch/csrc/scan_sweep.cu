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
// The tree arrives as data, a post-order schedule of 5-int ops
//   {op, level, length, offset, aux}
// with op F, G, COMBINE (aux = the node's row in the memory) and LEAF
// (aux = 0 rate-0, 1 rate-1). One kernel serves every code.
//
// Numerics: the sweep is elementwise (no reductions), in the plain torch
// version's order (ops/scan_kernel.py), and the build disables FMA
// contraction and uses no fast-math flag, so the two agree bit for bit,
// +inf betas included; no NaN can arise (f never multiplies 0 by inf).
//
// What bounds it on an H100: latency, not bytes. Four sweeps at
// (1024, 512), B = 2048 read 8 MiB and write 8 MiB (about 5 us at
// 3.35 TB/s), but each sweep walks ~860 dependent ops of the schedule,
// most on nodes of 1 to 8 positions, with a barrier after each. The
// design keeps the working state on chip: a block of 128 threads decodes
// 4 codewords together (all run the same schedule), with the alpha levels
// [2N][4] and the betas [N][4] in shared memory, and for the fused entry
// the node memory [M][4] too where it fits (N = 1024: M = 3270, 100 KiB a
// block); otherwise, and always for the stepped entry, the memory is read
// and written in place in device memory, 4 neighbouring codewords per
// 16 bytes. Threads cover (position, codeword) pairs in every op.
//
// C interface (ctypes; every pointer and the stream are void*):
//   int scan_sweep_fused(const int *ops, int n_ops, const float *llr,
//                        float *beta, float *mem, int mem_rows,
//                        int mem_shared, int n, int batch, int sweeps,
//                        cudaStream_t stream)
//     mem: a zeroed [M, B] scratch when mem_shared is 0, else unused;
//     mem_shared must be scan_sweep_mem_on_chip(n, mem_rows).
//   int scan_sweep_mem_on_chip(int n, int mem_rows)
//   int scan_sweep_step(const int *ops, int n_ops, const float *llr,
//                       const float *mem_in, float *beta, float *mem_out,
//                       int mem_rows, int n, int batch, cudaStream_t stream)
// Each returns the cudaGetLastError() of its launch (or of the
// shared-memory attribute call), or -1 for a length it does not take.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCpb = 4;  // codewords per block
constexpr int kThreads = 128;
constexpr int kMaxN = 4096;
constexpr int kOpWords = 5;
enum { OP_F = 0, OP_G = 1, OP_COMBINE = 2, OP_LEAF = 3 };

// sign with jnp.sign's rule at zero: sgn(+-0) = +-0
__device__ __forceinline__ float sgn(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}

// product-form min-sum: (sign(x) * sign(y)) * min(|x|, |y|)
__device__ __forceinline__ float f_prod(float x, float y) {
  return (sgn(x) * sgn(y)) * fminf(fabsf(x), fabsf(y));
}

__device__ __forceinline__ int level_row(int d, int n) {
  return d == 0 ? 0 : 2 * n - (n >> (d - 1));
}

// The node memory: row r of codeword c lives at p[r * stride + c]; `in`
// and `out` coincide when the memory is updated in place. In device
// memory, codewords c >= n_valid lie past the batch and are not touched.
struct Mem {
  const float* in;
  float* out;
  int stride;
  bool valid_all;
  int n_valid;
};

// One sweep over the schedule. alpha [2N][kCpb] (level 0 = channel LLRs),
// beta [N][kCpb] in shared memory.
__device__ void sweep(const int* __restrict__ ops, int n_ops, float* alpha,
                      float* beta, const Mem& mem, int n) {
  const int tid = threadIdx.x;
  for (int k = 0; k < n_ops; ++k) {
    const int* op = ops + k * kOpWords;
    const int code = op[0], d = op[1], len = op[2], off = op[3], aux = op[4];
    float* B = beta + off * kCpb;
    if (code == OP_LEAF) {
      const float v = aux == 0 ? INFINITY : 0.f;
      for (int t = tid; t < len * kCpb; t += kThreads) B[t] = v;
    } else {
      const int h = len >> 1, hk = h * kCpb;
      const float* X = alpha + level_row(d, n) * kCpb;
      float* Y = alpha + level_row(d + 1, n) * kCpb;
      for (int t = tid; t < hk; t += kThreads) {
        const int i = t / kCpb, c = t % kCpb;
        const bool ok = mem.valid_all || c < mem.n_valid;
        const size_t m = (size_t)(aux + i) * mem.stride + c;
        const float a = X[t], b = X[t + hk];
        if (code == OP_F) {
          Y[t] = f_prod(a, b + (ok ? mem.in[m] : 0.f));
        } else if (code == OP_G) {
          Y[t] = b + f_prod(a, B[t]);
        } else {  // COMBINE
          const float bl = B[t], br = B[t + hk];
          if (ok) mem.out[m] = br;
          B[t] = f_prod(bl, b + br);
          B[t + hk] = br + f_prod(bl, a);
        }
      }
    }
    __syncthreads();
  }
}

__device__ void load_llr(const float* __restrict__ llr, float* alpha, float* beta,
                         int n, int batch, int b0) {
  for (int t = threadIdx.x; t < n * kCpb; t += kThreads) {
    const int s = t / kCpb, b = b0 + t % kCpb;
    alpha[t] = b < batch ? llr[(size_t)s * batch + b] : 0.f;
    beta[t] = 0.f;
  }
}

__device__ void store_beta(const float* beta, float* __restrict__ out, int n,
                           int batch, int b0) {
  for (int t = threadIdx.x; t < n * kCpb; t += kThreads) {
    const int s = t / kCpb, b = b0 + t % kCpb;
    if (b < batch) out[(size_t)s * batch + b] = beta[t];
  }
}

template <bool kMemShared>
__global__ void __launch_bounds__(kThreads)
scan_fused_kernel(const int* __restrict__ ops, int n_ops,
                  const float* __restrict__ llr, float* __restrict__ beta_out,
                  float* mem_g, int mem_rows, int n, int batch, int sweeps) {
  extern __shared__ __align__(16) float smem[];
  float* alpha = smem;                                // [2N][kCpb]
  float* beta = alpha + (size_t)2 * n * kCpb;         // [N][kCpb]
  const int b0 = blockIdx.x * kCpb;
  load_llr(llr, alpha, beta, n, batch, b0);
  Mem mem;
  if (kMemShared) {
    float* ms = beta + (size_t)n * kCpb;              // [M][kCpb]
    for (int t = threadIdx.x; t < mem_rows * kCpb; t += kThreads) ms[t] = 0.f;
    mem = Mem{ms, ms, kCpb, true, kCpb};
  } else {
    mem = Mem{mem_g + b0, mem_g + b0, batch, false, batch - b0};
  }
  __syncthreads();
  for (int s = 0; s < sweeps; ++s) sweep(ops, n_ops, alpha, beta, mem, n);
  store_beta(beta, beta_out, n, batch, b0);
}

__global__ void __launch_bounds__(kThreads)
scan_step_kernel(const int* __restrict__ ops, int n_ops,
                 const float* __restrict__ llr, const float* mem_in,
                 float* __restrict__ beta_out, float* mem_out, int n,
                 int batch) {
  extern __shared__ __align__(16) float smem[];
  float* alpha = smem;
  float* beta = alpha + (size_t)2 * n * kCpb;
  const int b0 = blockIdx.x * kCpb;
  load_llr(llr, alpha, beta, n, batch, b0);
  __syncthreads();
  const Mem mem{mem_in + b0, mem_out + b0, batch, false, batch - b0};
  sweep(ops, n_ops, alpha, beta, mem, n);
  store_beta(beta, beta_out, n, batch, b0);
}

template <class K>
int set_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

bool bad_length(int n) { return n < 2 || n > kMaxN || (n & (n - 1)); }

constexpr size_t kSmemMax = 232448;  // bytes of shared memory a block can use on sm_90

}  // namespace

// 1 if the fused entry keeps the node memory of an (n, mem_rows) tree in
// shared memory, 0 if it needs the zeroed [M, B] scratch.
extern "C" int scan_sweep_mem_on_chip(int n, int mem_rows) {
  return ((size_t)3 * n + mem_rows) * kCpb * sizeof(float) <= kSmemMax;
}

extern "C" int scan_sweep_fused(const void* ops, int n_ops, const void* llr,
                                void* beta, void* mem, int mem_rows,
                                int mem_shared, int n, int batch, int sweeps,
                                void* stream) {
  if (bad_length(n)) return -1;
  if (batch <= 0) return 0;
  const size_t smem = ((size_t)3 * n + (mem_shared ? mem_rows : 0)) * kCpb * sizeof(float);
  const int blocks = (batch + kCpb - 1) / kCpb;
  auto st = static_cast<cudaStream_t>(stream);
  auto o = static_cast<const int*>(ops);
  auto x = static_cast<const float*>(llr);
  auto y = static_cast<float*>(beta);
  auto m = static_cast<float*>(mem);
  int err;
  if (mem_shared) {
    if ((err = set_smem(scan_fused_kernel<true>, smem))) return err;
    scan_fused_kernel<true><<<blocks, kThreads, smem, st>>>(o, n_ops, x, y, m, mem_rows, n, batch, sweeps);
  } else {
    if ((err = set_smem(scan_fused_kernel<false>, smem))) return err;
    scan_fused_kernel<false><<<blocks, kThreads, smem, st>>>(o, n_ops, x, y, m, mem_rows, n, batch, sweeps);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int scan_sweep_step(const void* ops, int n_ops, const void* llr,
                               const void* mem_in, void* beta, void* mem_out,
                               int mem_rows, int n, int batch, void* stream) {
  (void)mem_rows;
  if (bad_length(n)) return -1;
  if (batch <= 0) return 0;
  const size_t smem = (size_t)3 * n * kCpb * sizeof(float);
  const int blocks = (batch + kCpb - 1) / kCpb;
  int err;
  if ((err = set_smem(scan_step_kernel, smem))) return err;
  scan_step_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ops), n_ops, static_cast<const float*>(llr),
      static_cast<const float*>(mem_in), static_cast<float*>(beta),
      static_cast<float*>(mem_out), n, batch);
  return static_cast<int>(cudaGetLastError());
}
