// K3: batched T-point radix-2 transforms over Fr, the steps of the
// four-step NTT, and the quotient's pointwise step.
//
// Replaces groth16_tpu/ops/ntt_pallas.py::_ntt_call.  One block per T-point
// transform, B batches in the grid's second axis (the quotient runs A, B
// and C in one launch); the transform lives in dynamic shared memory as
// eight 32-bit limb planes (bn254_ntt.cuh), 32 KB at T = 1024.  Each launch
// reads its input through the strides it is given and writes its output the
// same way, so the four-step's transposes and the bit reversals are
// addresses, not passes: a coset shift is four launches (DIT; DIT with the
// inverse outer twiddle before its stages and eta^i after them; DIF with
// the forward outer twiddle after its stages; DIF) and no torch op between
// them.  Inputs and outputs are the wire format (uint32[..., 16] of 16-bit
// limbs) or the packed one (uint32[..., 8]), both read and written with
// 128-bit accesses; the tables (outer twiddles, eta powers, stage roots)
// are packed.  Bound on this card by the Fr products: log2(T) stages of
// T/2 products a transform, against 32 or 64 bytes read and written an
// element.
//
// g16_quotient_pointwise is the quotient's elementwise pass (A * B - C,
// the optional 1/Z, the conversion out of Montgomery form), memory-bound.

#include <cuda_runtime.h>

#include "bn254_ntt.cuh"

using namespace bn254;

__global__ void ntt_step_kernel(NttStep s) {
  extern __shared__ uint32_t sm[];
  const long b = blockIdx.y, i = blockIdx.x;
  const int T = s.T;
  for (int q = threadIdx.x; q < T; q += blockDim.x) ntt_load(s, b, i, q, sm);
  __syncthreads();
  if (s.dit) {
    for (int h = 1; h < T; h <<= 1) {
      for (int t = threadIdx.x; t < T / 2; t += blockDim.x) ntt_butterfly(s, h, t, sm);
      __syncthreads();
    }
  } else {
    for (int h = T / 2; h >= 1; h >>= 1) {
      for (int t = threadIdx.x; t < T / 2; t += blockDim.x) ntt_butterfly(s, h, t, sm);
      __syncthreads();
    }
  }
  for (int p = threadIdx.x; p < T; p += blockDim.x) ntt_store(s, b, i, p, sm);
}

__global__ void quotient_pointwise_kernel(const uint32_t* ev, long n, const uint32_t* scale,
                                          int standard, uint32_t* out) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n) quotient_point(ev, n, e, scale, standard, out);
}

// Threads a block: of the powers of two from min(T/2, 512) down to 64, the
// one that keeps the most threads resident on an SM (the occupancy
// calculator weighs this kernel's registers against its shared memory), the
// larger on a tie; 32 for T < 64.  At T = 1024 one block of 512 threads
// fills an SM's registers alone, while three blocks of 256 fit.  Read at
// every launch, for the current device.
static cudaError_t ntt_block(int T, size_t smem, int* bs) {
  const int top = T / 2 < 32 ? 32 : (T / 2 > 512 ? 512 : T / 2);
  int best = 0;
  *bs = top;
  for (int t = top; t >= 64; t /= 2) {
    int blocks = 0;
    const cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ntt_step_kernel, t, smem);
    if (e != cudaSuccess) return e;
    if (blocks * t > best) best = blocks * t, *bs = t;
  }
  return cudaSuccess;
}

static int ntt_step(NttStep s, long NB, int B, void* stream) {
  const size_t smem = (size_t)s.T * 8 * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ntt_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int threads = 0;
  const cudaError_t e = ntt_block(s.T, smem, &threads);
  if (e != cudaSuccess) return (int)e;
  if (NB > 0 && B > 0) {
    ntt_step_kernel<<<dim3((unsigned)NB, (unsigned)B), threads, smem, (cudaStream_t)stream>>>(s);
  }
  return (int)cudaGetLastError();
}

// strides: si, sq, oi, ok, xb, ob, gbits, gx, hbits, hx (elements; gbits and
// hbits are bit counts, gx and hx 0 for a step without split blocks)
extern "C" int g16_ntt_step(const void* x, void* out, const void* pre, const void* post,
                            const void* roots, const long* strides, int T, long NB, int B,
                            int dit, int wire_in, int wire_out, void* stream) {
  int log_t = 0;
  while ((1 << log_t) < T) ++log_t;
  const NttStep s{(const uint32_t*)x, (uint32_t*)out, (const uint32_t*)pre,
                  (const uint32_t*)post, (const uint32_t*)roots, strides[0], strides[1],
                  strides[2], strides[3], strides[4], strides[5], T, log_t, dit, wire_in,
                  wire_out, strides[7], strides[9], (int)strides[6], (int)strides[8]};
  return ntt_step(s, NB, B, stream);
}

extern "C" int g16_quotient_pointwise(const void* ev, long n, const void* scale, int standard,
                                      void* out, void* stream) {
  const int threads = 256;
  if (n > 0) {
    quotient_pointwise_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                                (cudaStream_t)stream>>>(
        (const uint32_t*)ev, n, (const uint32_t*)scale, standard, (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}
