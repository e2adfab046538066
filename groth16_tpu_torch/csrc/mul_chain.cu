// K9: k chained Fp Montgomery products per element, x <- x * b.
//
// Replaces tools/bench_mul_kernels.py::make_call, the JAX package's measure
// of raw field-multiply throughput.  The TPU tool timed two multiply schedules
// ("ks", "cios") of its 16-bit-limb field class; those were TPU schedules and
// _KFp.mul_cios is not ported, so this kernel runs the one product the port
// has: the header's Fp::operator* (`mont_mul`, carry chains in PTX).
//
// One thread per element, limb-major wire layout uint32[16, n] with the
// element axis minor, so limb loads coalesce; each thread loads its a and b
// once, runs the k products in registers and stores once.  Bound by integer
// multiply throughput: with n filling every SM (n >= 132 * 2048), the time
// over k * n products is the card's Fp-product rate, the compute side of
// every kernel bound in PERF.md.
//
// Beside it, a yardstick that only tools/bench_mul_kernels.py launches:
// issue_rate_kernel<KIND>, many independent chains of one multiply form in
// every thread of one 1024-thread block an SM, timed with the SM's clock64:
// how many of them the SM issues a clock.  KIND 0 mad.lo.u32 (IMAD), 1
// mul.wide.u32 (IMAD.WIDE.U32 alone: with a 64-bit addend ptxas splits
// mad.wide.u32 into three instructions), 2 the carry-chain pair
// mad.lo.cc.u32 / madc.hi.cc.u32 the product is written in, 3 mul.hi.u32
// (IMAD.HI.U32).

#include <cuda_runtime.h>

#include "bn254_field.cuh"

using namespace bn254;

__global__ void fp_mul_chain_kernel(const uint32_t* __restrict__ a,
                                    const uint32_t* __restrict__ b,
                                    uint32_t* __restrict__ out, int k, long n) {
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fp_mul_chain_lane(a, b, out, k, n, i);
}

constexpr int RATE_THREADS = 1024;
constexpr int RATE_UNROLL = 8;
constexpr int RATE_SMEM = 120 * 1024;   // more than half an SM's shared memory: one block an SM

template <int KIND>
__global__ void __launch_bounds__(RATE_THREADS)
issue_rate_kernel(uint32_t* __restrict__ out, long long* __restrict__ cycles, int iters) {
  const uint32_t c = 0x9e3779b9u * (threadIdx.x + 1) ^ blockIdx.x;
  uint32_t x[RATE_UNROLL];
  uint64_t w[RATE_UNROLL];
#pragma unroll
  for (int u = 0; u < RATE_UNROLL; ++u) {
    x[u] = c + 0x632be5abu * u;
    w[u] = ((uint64_t)x[u] << 32) | (x[u] ^ 0x5bd1e995u);
  }
  __syncthreads();
  const long long t0 = clock64();
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    if (KIND == 0) {
#pragma unroll
      for (int u = 0; u < RATE_UNROLL; ++u)
        asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(x[u]) : "r"(c), "r"(u));
    } else if (KIND == 1) {
#pragma unroll
      for (int u = 0; u < RATE_UNROLL; ++u)
        asm volatile("mul.wide.u32 %0, %1, %2;"
                     : "=l"(w[u]) : "r"((uint32_t)(w[u ^ 1] >> 32)), "r"(c));
    } else if (KIND == 3) {
#pragma unroll
      for (int u = 0; u < RATE_UNROLL; ++u)
        asm volatile("mul.hi.u32 %0, %1, %2;" : "=r"(x[u]) : "r"(x[u ^ 1]), "r"(c));
    } else {
#pragma unroll
      for (int u = 0; u < RATE_UNROLL; u += 2)
        asm volatile("mad.lo.cc.u32 %0, %2, %4, %0;\n\tmadc.hi.cc.u32 %1, %2, %4, %1;\n\t"
                     "madc.lo.cc.u32 %0, %3, %4, %0;\n\tmadc.hi.cc.u32 %1, %3, %4, %1;\n\t"
                     "madc.lo.cc.u32 %0, %2, %4, %0;\n\tmadc.hi.cc.u32 %1, %2, %4, %1;\n\t"
                     "madc.lo.cc.u32 %0, %3, %4, %0;\n\tmadc.hi.u32 %1, %3, %4, %1;"
                     : "+r"(x[u]), "+r"(x[u + 1]) : "r"(x[u + 1]), "r"(x[u]), "r"(c));
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  uint32_t acc = 0;
#pragma unroll
  for (int u = 0; u < RATE_UNROLL; ++u) acc ^= x[u] ^ (uint32_t)w[u] ^ (uint32_t)(w[u] >> 32);
  out[(long)blockIdx.x * RATE_THREADS + threadIdx.x] = acc;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

extern "C" int g16_fp_mul_chain(const void* a, const void* b, void* out, int k, long n,
                                void* stream) {
  if (n > 0) {
    fp_mul_chain_kernel<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, k, n);
  }
  return (int)cudaGetLastError();
}

// `blocks` blocks of RATE_THREADS (one an SM when blocks = the SM count);
// out uint32[blocks * RATE_THREADS], cycles int64[blocks].  Returns the
// CUDA error, or -1 for an unknown kind.
template <int KIND>
static int launch_rate(void* out, void* cycles, int blocks, int iters, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(issue_rate_kernel<KIND>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, RATE_SMEM);
  if (e != cudaSuccess) return (int)e;
  issue_rate_kernel<KIND><<<blocks, RATE_THREADS, RATE_SMEM, s>>>((uint32_t*)out,
                                                                  (long long*)cycles, iters);
  return (int)cudaGetLastError();
}

extern "C" int g16_issue_rate(int kind, void* out, void* cycles, int blocks, int iters,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == 0) return launch_rate<0>(out, cycles, blocks, iters, s);
  if (kind == 1) return launch_rate<1>(out, cycles, blocks, iters, s);
  if (kind == 2) return launch_rate<2>(out, cycles, blocks, iters, s);
  if (kind == 3) return launch_rate<3>(out, cycles, blocks, iters, s);
  return -1;
}

// PTX multiply instructions one thread issues per iteration of KIND: one a
// chain in KINDs 0, 1 and 3, eight in each of the RATE_UNROLL / 2 chains of 2
extern "C" int g16_issue_rate_ops(int kind) { return kind == 2 ? 4 * RATE_UNROLL : RATE_UNROLL; }
