// Polar butterfly encoder (K2): all log2 N XOR stages, the systematic
// re-freeze and the second pass, for a batch of codewords.
//
// Replaces: polar_codes_tpu/ops/butterfly_kernel.py, build_encode_kernel
// (the Pallas kernel that keeps one [N, 128] bipolar float tile in VMEM for
// all stages of both passes).
//
// What bounds it on an H100: device memory, one u8 read and one u8 write
// per bit. The log2 N stages are shared-memory traffic: N bytes per
// codeword, 1 KB at N = 1024.
//
// Design: one block per codeword, N/2 threads, each thread owning one
// butterfly pair per stage, with __syncthreads() between stages. The state
// is {0,1} bytes and a stage is an XOR, so the result is exact: the TPU
// kernel's float sign-bit decision (and its -0.0 trap) has no counterpart.
//
// C interface (bound with ctypes): every pointer and the stream are void*.
//   int butterfly_encode(const uint8 *u [B, N], const uint8 *frozen [N],
//                        uint8 *out [B, N], int batch, int n_len,
//                        int systematic, cudaStream_t stream)
// u holds u-domain bits with the frozen positions already 0. Returns
// cudaGetLastError() after the launch. Requires 2 <= N <= 2048.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void stages(uint8_t* x, int half_len, int t) {
  for (int h = 1; h <= half_len; h <<= 1) {
    __syncthreads();
    const int i = ((t & ~(h - 1)) << 1) | (t & (h - 1));
    x[i] ^= x[i + h];
  }
  __syncthreads();
}

__global__ void butterfly_encode_kernel(const uint8_t* __restrict__ u,
                                        const uint8_t* __restrict__ frozen,
                                        uint8_t* __restrict__ out,
                                        int n_len, int systematic) {
  extern __shared__ uint8_t x[];
  const int t = threadIdx.x;
  const int half_len = n_len >> 1;
  const size_t row = (size_t)blockIdx.x * n_len;
  x[t] = u[row + t];
  x[t + half_len] = u[row + t + half_len];
  stages(x, half_len, t);
  if (systematic) {
    if (frozen[t]) x[t] = 0;
    if (frozen[t + half_len]) x[t + half_len] = 0;
    stages(x, half_len, t);
  }
  out[row + t] = x[t];
  out[row + t + half_len] = x[t + half_len];
}

}  // namespace

extern "C" int butterfly_encode(const void* u, const void* frozen, void* out,
                                int batch, int n_len, int systematic,
                                void* stream) {
  if (batch <= 0) return 0;
  butterfly_encode_kernel<<<batch, n_len / 2, n_len,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(u), static_cast<const uint8_t*>(frozen),
      static_cast<uint8_t*>(out), n_len, systematic);
  return static_cast<int>(cudaGetLastError());
}
