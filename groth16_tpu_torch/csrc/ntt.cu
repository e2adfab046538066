// K3: batched T-point radix-2 transforms over Fr, the inner step of the
// four-step NTT.
//
// Replaces groth16_tpu/ops/ntt_pallas.py::_ntt_call.  One block per T-point
// transform; the transform lives in dynamic shared memory as eight 32-bit
// limb planes ([8][T] words, so neighbouring threads hit neighbouring banks),
// which is 128 KB at T = 4096.  Forward = DIF (natural in, bit-reversed out)
// with the four-step outer twiddle as a post-multiply; inverse = DIT
// (bit-reversed in, natural out) with the outer twiddle (1/N folded in) as a
// pre-multiply.  Global layout is the TPU kernel's limb-major
// uint32[16, NB, T] of 16-bit limbs.  Bound on this card by shared-memory
// traffic: every stage reads and writes the whole transform once, log2(T)
// times, against one Fr product per butterfly.

#include <cuda_runtime.h>

#include "bn254_field.cuh"

using namespace bn254;

__device__ __forceinline__ Fr sm_get(const uint32_t* sm, int T, int j) {
  Fr r;
#pragma unroll
  for (int l = 0; l < 8; ++l) r.v[l] = sm[l * T + j];
  return r;
}

__device__ __forceinline__ void sm_put(uint32_t* sm, int T, int j, const Fr& a) {
#pragma unroll
  for (int l = 0; l < 8; ++l) sm[l * T + j] = a.v[l];
}

// roots: uint32[T/2, 16], Montgomery root^k in 16-bit limbs
__global__ void ntt_kernel(const uint32_t* __restrict__ x,
                           const uint32_t* __restrict__ tw,
                           const uint32_t* __restrict__ roots,
                           uint32_t* __restrict__ out, int T, long NB, int dit) {
  extern __shared__ uint32_t sm[];
  const long plane = NB * T;
  const long base = (long)blockIdx.x * T;
  const int half = T / 2;

  for (int j = threadIdx.x; j < T; j += blockDim.x) {
    Fr v = Fr::load(x + base + j, plane);
    if (dit && tw) v = v * Fr::load(tw + base + j, plane);
    sm_put(sm, T, j, v);
  }
  __syncthreads();

  if (!dit) {
    for (int h = half; h >= 1; h >>= 1) {
      const int step = T / (2 * h);
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        int off = p & (h - 1);
        int i = ((p - off) << 1) + off;
        Fr a = sm_get(sm, T, i), b = sm_get(sm, T, i + h);
        Fr w = Fr::load(roots + (long)off * step * 16);
        sm_put(sm, T, i, a + b);
        sm_put(sm, T, i + h, (a - b) * w);
      }
      __syncthreads();
    }
  } else {
    for (int h = 1; h < T; h <<= 1) {
      const int step = T / (2 * h);
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        int off = p & (h - 1);
        int i = ((p - off) << 1) + off;
        Fr a = sm_get(sm, T, i), b = sm_get(sm, T, i + h);
        Fr wb = b * Fr::load(roots + (long)off * step * 16);
        sm_put(sm, T, i, a + wb);
        sm_put(sm, T, i + h, a - wb);
      }
      __syncthreads();
    }
  }

  for (int j = threadIdx.x; j < T; j += blockDim.x) {
    Fr v = sm_get(sm, T, j);
    if (!dit && tw) v = v * Fr::load(tw + base + j, plane);
    v.store(out + base + j, plane);
  }
}

extern "C" int g16_ntt(const void* x, const void* tw, const void* roots,
                       void* out, int T, long NB, int dit, void* stream) {
  size_t smem = (size_t)T * 8 * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ntt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (NB > 0 && T > 0) {
    ntt_kernel<<<(unsigned)NB, 256, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (const uint32_t*)tw, (const uint32_t*)roots,
        (uint32_t*)out, T, NB, dit);
  }
  return (int)cudaGetLastError();
}
