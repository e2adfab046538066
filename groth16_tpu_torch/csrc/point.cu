// K1: batched complete point add / double for G1 (Fp) and G2 (Fp2).
//
// Replaces groth16_tpu/ops/kernels.py::_point_call (point_add /
// point_double).  One thread per point: it reads the wire layout
// (uint32[n, NC], 16-bit limbs), packs limb pairs into 8 x 32-bit words in
// registers, runs the RCB15 formula of bn254_curve.cuh and stores the wire
// layout again.  Bound on this card by integer multiply throughput (a G1 add
// is 14 Fp products of 64 32x32->64 multiplies each) and by registers: a G2
// add keeps six Fp2 coordinates and ~10 Fp2 temporaries live, so the G2
// launch uses smaller blocks than G1.

#include <cuda_runtime.h>

#include "bn254_curve.cuh"

using namespace bn254;

template <class C>
__global__ void point_add_kernel(const uint32_t* __restrict__ x1,
                                 const uint32_t* __restrict__ y1,
                                 const uint32_t* __restrict__ z1,
                                 const uint32_t* __restrict__ x2,
                                 const uint32_t* __restrict__ y2,
                                 const uint32_t* __restrict__ z2,
                                 uint32_t* x3, uint32_t* y3, uint32_t* z3,
                                 long n) {
  typedef typename C::F F;
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long o = i * C::NC;
  Proj<F> P{F::load(x1 + o), F::load(y1 + o), F::load(z1 + o)};
  Proj<F> Q{F::load(x2 + o), F::load(y2 + o), F::load(z2 + o)};
  Proj<F> R = rcb_add<C>(P, Q);
  R.X.store(x3 + o);
  R.Y.store(y3 + o);
  R.Z.store(z3 + o);
}

template <class C>
__global__ void point_double_kernel(const uint32_t* __restrict__ x1,
                                    const uint32_t* __restrict__ y1,
                                    const uint32_t* __restrict__ z1,
                                    uint32_t* x3, uint32_t* y3, uint32_t* z3,
                                    long n) {
  typedef typename C::F F;
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long o = i * C::NC;
  Proj<F> P{F::load(x1 + o), F::load(y1 + o), F::load(z1 + o)};
  Proj<F> R = rcb_double<C>(P);
  R.X.store(x3 + o);
  R.Y.store(y3 + o);
  R.Z.store(z3 + o);
}

template <class C>
static int block_size() {
  return C::NC == 16 ? 256 : 128;
}

template <class C>
static int launch_add(const void* x1, const void* y1, const void* z1,
                      const void* x2, const void* y2, const void* z2,
                      void* x3, void* y3, void* z3, long n, void* stream) {
  if (n > 0) {
    int bs = block_size<C>();
    long grid = (n + bs - 1) / bs;
    point_add_kernel<C><<<(unsigned)grid, bs, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1,
        (const uint32_t*)x2, (const uint32_t*)y2, (const uint32_t*)z2,
        (uint32_t*)x3, (uint32_t*)y3, (uint32_t*)z3, n);
  }
  return (int)cudaGetLastError();
}

template <class C>
static int launch_double(const void* x1, const void* y1, const void* z1,
                         void* x3, void* y3, void* z3, long n, void* stream) {
  if (n > 0) {
    int bs = block_size<C>();
    long grid = (n + bs - 1) / bs;
    point_double_kernel<C><<<(unsigned)grid, bs, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1,
        (uint32_t*)x3, (uint32_t*)y3, (uint32_t*)z3, n);
  }
  return (int)cudaGetLastError();
}

extern "C" {

int g16_point_add(int g2, const void* x1, const void* y1, const void* z1,
                  const void* x2, const void* y2, const void* z2, void* x3,
                  void* y3, void* z3, long n, void* stream) {
  return g2 ? launch_add<G2>(x1, y1, z1, x2, y2, z2, x3, y3, z3, n, stream)
            : launch_add<G1>(x1, y1, z1, x2, y2, z2, x3, y3, z3, n, stream);
}

int g16_point_double(int g2, const void* x1, const void* y1, const void* z1,
                     void* x3, void* y3, void* z3, long n, void* stream) {
  return g2 ? launch_double<G2>(x1, y1, z1, x3, y3, z3, n, stream)
            : launch_double<G1>(x1, y1, z1, x3, y3, z3, n, stream);
}

}  // extern "C"
