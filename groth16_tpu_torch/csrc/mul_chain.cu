// K9: k chained Fp Montgomery products per element, x <- x * b.
//
// Replaces tools/bench_mul_kernels.py::make_call, the JAX package's measure
// of raw field-multiply throughput.  The TPU tool timed two multiply schedules
// ("ks", "cios") of its 16-bit-limb field class; those were TPU schedules and
// _KFp.mul_cios is not ported, so this kernel runs the one product the port
// has: the header's Fp::operator* (CIOS on eight 32-bit limbs).
//
// One thread per element, limb-major wire layout uint32[16, n] with the
// element axis minor, so limb loads coalesce; each thread loads its a and b
// once, runs the k products in registers and stores once.  Bound by integer
// multiply throughput: with n filling every SM (n >= 132 * 2048), the time
// over k * n products is the card's Fp-product rate, the compute side of
// every kernel bound in PERF.md.

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

extern "C" int g16_fp_mul_chain(const void* a, const void* b, void* out, int k, long n,
                                void* stream) {
  if (n > 0) {
    fp_mul_chain_kernel<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, k, n);
  }
  return (int)cudaGetLastError();
}
